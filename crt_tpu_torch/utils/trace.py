"""The port's spans and counters: one registry for all of them.

Spans.  ``span(name)`` marks host time under ``name`` in a
``torch.profiler`` trace (``record_function``), and only while a profiler
records; otherwise it returns a shared null context after one check.  A
span shares the profiler's clock with the device operations, so a kernel
belongs to the span whose interval holds its launch.  The port's spans:

  - ``crt.frame``: one frame (``renderer._render_flat``,
    ``renderer._render_aov_flat``);
  - ``crt.tables.<kind>``: the tables a tracer is built with (``cluster``,
    ``stream``, ``rank``, ``triangles``) and those it builds on first use
    (``rows``, ``glass``);
  - ``crt.shade``: one chunk of either wavefront, and
    ``crt.shade.bounce.<b>`` each bounce of the iterative one;
  - ``crt.shade.march``: the transmissive branch of a scene with live
    refraction's shadows (``shade._occlusion_masks``): the glass-flag
    split pass and the bend-walk, their traces included;
  - ``crt.trace.primary``: the camera rays' closest hit;
    ``crt.trace.shadow``: the opaque point-light shadow pass
    (``tracer.shadow`` in ``shade._occlusion_masks``), its Phase A
    included; ``crt.trace``: every other call into an intersection
    backend (a reader of the prefix ``crt.trace`` takes all three);
  - ``crt.binning``: Phase A (frusta, shafts, pair lists), no table build;
  - ``crt.tree.walk``: one lock-step KD walk of the ``tree`` backend
    (``traverse._walk``), inside the ``crt.trace*`` span of its call
    (outside that prefix, so a reader of ``crt.trace`` takes it once);
  - ``crt.fit.forward`` / ``crt.fit.backward`` / ``crt.fit.optimizer``: a
    fit step's render and loss, its backward and reduce, its update.

Counters.  ``count(name, n)`` adds ``n`` while tracing is on: a profiler
records, or the caller is inside ``recording()``.  ``n`` is a host int or
a tensor, which is summed on its own device with no host read (one or two
kernels; every ``_FOLD`` sums fold into one).  ``counters()``
reads every counter into ints, the one host read; ``recording()`` yields
the counters of its block, filled when the block exits; ``reset()`` clears
them.  The port's counters:

  - ``crt.launches.<kernel>[.<mode or layout>]``: CUDA kernel launches
    (the plain versions launch nothing and count nothing); Phase A of the
    cluster path counts ``crt.launches.cluster_bin.<rays, apex, shared,
    shared_uncapped, shared_glass>``, one a ``bin_rays`` /
    ``bin_apex_shared`` call, and of the streaming path
    ``crt.launches.stream_bin.<rays, shaft_capped, shaft_exact, shaft>``,
    one a ``bin_stream`` call (its pack launch not counted apart);
  - ``crt.host_reads.<site>``: each point of the hot path where the host
    waits for the device: a read of a device value (``nonzero``,
    ``bool(t.any())``, ``float(loss)``), or a copy of a host value to the
    card from pageable memory, which waits for the stream;
  - ``crt.shade.lanes`` / ``crt.shade.live_lanes``: lanes the iterative
    wavefront shades, and those of them that are live (a bounce on its
    gathered live lanes counts those and its dead padding);
  - ``crt.shade.bounces`` / ``crt.shade.compacted_bounces``: bounces of
    the iterative wavefront, and those of them shaded on their gathered
    live lanes (``crt.host_reads.shade_compact``: each bounce's
    ``nonzero`` of its live lanes, past the camera rays');
  - ``crt.binning.pairs.cluster`` / ``crt.binning.pairs.supercluster``:
    (tile, cluster) and (tile, supercluster) pairs listed by Phase A;
    ``crt.binning.pairs.hull``: the light-side shaft's (tile,
    supercluster) pairs that the per-lane test then prunes ("shaft_exact");
  - ``crt.shadow.pairs`` / ``crt.shadow.lanes``: the (tile, cluster)
    pairs of the cluster backend's shadow lists (``bin_apex_shared`` for
    K2 in any mode, ``bin_rays``' apex mode for K5; the same pairs are in
    ``crt.binning.pairs.cluster``), and the active shadow lanes they were
    binned for;
  - ``crt.shadow.lane_tests`` / ``crt.shadow.repacks``: counted by the
    any-hit kernels themselves (K2, K5, K6; ``cluster_trace.walk_stats``,
    only while tracing is on): member tests issued by the lanes of the
    warps that tested (32 x 16 x the clusters of each batch a warp tests,
    finished lanes included), and the repacks of the long walks' unfinished
    lanes to the front of the block;
  - ``crt.shade.refracted_lanes`` / ``crt.shade.tir_lanes``: refractive
    hits of either wavefront that refract, and those that totally
    reflect;
  - ``crt.march.lanes`` / ``crt.march.walk_lanes``: shadow lanes that
    enter the transmissive branch, and those of them that the split pass
    leaves to the bend-walk (all of them where there is no split);
  - ``crt.march.traces``: closest hits of the transmissive shadow march;
  - ``crt.tree.walks`` / ``crt.tree.iterations``: KD-tree walks and
    their loop iterations; ``crt.tree.leaf_lanes``: the lanes tested at
    a hit leaf (``crt.host_reads.tree_walk``: the walk's reads of its
    lists and of its loop condition).

Every name starts with ``crt.``; a per-mode split is a name suffix, and
``total(counts, prefix)`` adds a name and its suffixes.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_host: dict = {}  # name -> int
_dev: dict = {}  # (name, device) -> [int64 scalar tensors on the device]
_FOLD = 256
_recording = 0


def enabled() -> bool:
    """Whether counts are taken now."""
    return _recording > 0 or _profiling()


def span(name: str):
    """A context that records ``name`` while a profiler records."""
    if not _profiling():
        return _NULL
    return record_function(name)


def spanned(name: str):
    """Decorator: the function's calls run under ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a tensor summed on its device) to ``name``
    while tracing is on."""
    if not (_recording or _profiling()):
        return
    if isinstance(n, torch.Tensor):
        s = n.detach().sum(dtype=torch.int64)
        with _lock:
            sums = _dev.setdefault((name, s.device), [])
            sums.append(s)
            if len(sums) >= _FOLD:
                sums[:] = [torch.stack(sums).sum()]
    else:
        with _lock:
            _host[name] = _host.get(name, 0) + int(n)


def counters() -> collections.Counter:
    """Every counter as an int (missing names read 0)."""
    with _lock:
        host = dict(_host)
        dev = [(key, list(sums)) for key, sums in _dev.items()]
    out = collections.Counter(host)
    for (name, _), sums in dev:
        out[name] += int(torch.stack(sums).sum())
    return out


def reset() -> None:
    """Clear every counter."""
    with _lock:
        _host.clear()
        _dev.clear()


@contextlib.contextmanager
def recording():
    """Count within the block; yields a Counter of the block's counts,
    filled when the block exits.  The counts also go to the counters
    outside the block.  Blocks nest; they are the process's, not a
    thread's (autograd's backward thread counts into the caller's)."""
    global _host, _dev, _recording
    with _lock:
        outer = (_host, _dev)
        _host, _dev = {}, {}
        _recording += 1
    block = collections.Counter()
    try:
        yield block
    finally:
        block.update(counters())
        with _lock:
            _recording -= 1
            _host, _dev = outer
            for name, v in block.items():
                _host[name] = _host.get(name, 0) + v


def total(counts, prefix: str) -> int:
    """The sum of ``counts`` under ``prefix`` and its ``.``-suffixes."""
    return sum(v for k, v in counts.items()
               if k == prefix or k.startswith(prefix + "."))
