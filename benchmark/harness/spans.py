"""Spans around the calls into each layer of the program, recorded from
the benchmark's side with ``torch.profiler.record_function`` during the
traced run only.

The program's functions are wrapped where its modules look them up, and
put back on exit:

  - ``bench.shade``: the shading entry of each wavefront chunk
    (``renderer.shade_wavefront``, ``renderer.shade_wavefront_iter``);
  - ``bench.trace``: every call into the intersection backend that
    ``renderer.make_trace_fn`` returns, and ``bench.trace.primary`` for
    the first closest-hit call of each shading entry, the camera rays';
  - ``bench.binning``: Phase A, ``ops/binning.py`` and
    ``ops/stream_binning.py`` as the trace modules call them;
  - ``bench.backward``: ``Tensor.backward``, autograd's backward.
"""

from __future__ import annotations

import contextlib
import functools
import types

import torch
from torch.profiler import record_function


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapper


class _State:
    primary_pending = False


class _SpannedTrace:
    """An intersection backend whose calls record spans; attributes that
    are not callables (the rank map) pass through unchanged."""

    _CLOSEST = ("__call__", "with_rows")

    def __init__(self, fn, state: _State):
        self._fn = fn
        self._state = state

    def _name(self, attr: str) -> str:
        if attr in self._CLOSEST and self._state.primary_pending:
            self._state.primary_pending = False
            return "bench.trace.primary"
        return "bench.trace"

    def __call__(self, *args, **kwargs):
        with record_function(self._name("__call__")):
            return self._fn(*args, **kwargs)

    def __getattr__(self, attr):
        value = getattr(self._fn, attr)  # AttributeError where absent
        if not callable(value):
            return value

        def call(*args, **kwargs):
            with record_function(self._name(attr)):
                return value(*args, **kwargs)

        return call


def _patch(stack: contextlib.ExitStack, owner, attr: str, new):
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    stack.callback(setattr, owner, attr, old)


@contextlib.contextmanager
def layer_spans():
    """Record the layer spans while the block runs."""
    from crt_tpu_torch import renderer
    from crt_tpu_torch.ops import cluster_trace, stream_binning, stream_trace

    state = _State()
    with contextlib.ExitStack() as stack:
        make = renderer.make_trace_fn
        _patch(stack, renderer, "make_trace_fn",
               lambda *a, **k: _SpannedTrace(make(*a, **k), state))
        for attr in ("shade_wavefront", "shade_wavefront_iter"):
            fn = getattr(renderer, attr)

            def shade(*a, _fn=fn, **k):
                state.primary_pending = True
                with record_function("bench.shade"):
                    return _fn(*a, **k)

            _patch(stack, renderer, attr, shade)
        for attr in ("bin_rays", "bin_apex_shared"):
            _patch(stack, cluster_trace, attr,
                   _spanned("bench.binning", getattr(cluster_trace, attr)))
        _patch(stack, stream_trace, "tile_bounds",
               _spanned("bench.binning", stream_trace.tile_bounds))
        for attr, fn in list(vars(stream_binning).items()):
            if isinstance(fn, types.FunctionType) \
                    and fn.__module__ == stream_binning.__name__:
                _patch(stack, stream_binning, attr,
                       _spanned("bench.binning", fn))
        _patch(stack, torch.Tensor, "backward",
               _spanned("bench.backward", torch.Tensor.backward))
        yield
