"""Numerical hygiene checks.

Counterpart of ``crt_tpu/utils/checks.py``:

  - ``check_finite``: render with a NaN check on the output of every torch
    op (the counterpart of ``jax_debug_nans``), which raises at the op that
    made the first NaN, then demand finite pixels;
  - ``check_deterministic``: two forward renders must agree bit for bit
    (the port's determinism is forward only: K3's atomics may order a
    gradient's last bits differently between runs);
  - ``check_grads_finite``: the gradients of an image-sum loss with respect
    to every trainable group must be finite.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from crt_tpu_torch.optim import default_trainable_params
from crt_tpu_torch.renderer import render_image
from crt_tpu_torch.scene.types import RenderSettings, Scene


class _NaNCheck(TorchDispatchMode):
    """Raise FloatingPointError at the first torch op that returns a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and bool(torch.isnan(o).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


def check_finite(scene: Scene, settings: RenderSettings | None = None):
    """Render with every op's output checked for NaN; raises
    FloatingPointError at the producing op, AssertionError on non-finite
    pixels.  Returns the image."""
    settings = settings or RenderSettings()
    with torch.no_grad(), _NaNCheck():
        img = render_image(scene, settings)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels in render")
    return img


def check_deterministic(scene: Scene, settings: RenderSettings | None = None):
    """Two forward renders must agree bit for bit."""
    settings = settings or RenderSettings()
    a = render_image(scene, settings)
    b = render_image(scene, settings)
    if not torch.equal(a, b):
        diff = (a - b).abs()
        raise AssertionError(
            f"non-deterministic render: "
            f"{int((diff.amax(-1) > 0).sum())} pixels differ, max "
            f"{float(diff.max())}")
    return a


def check_grads_finite(scene: Scene, settings: RenderSettings | None = None,
                       params: dict | None = None):
    """Gradients of a sum loss with respect to every trainable group
    (``optim.default_trainable_params``) must be finite; returns them."""
    settings = settings or RenderSettings()
    params = params or default_trainable_params(scene)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    render_image(scene.replace(**params), settings).sum().backward()
    # a group the frame does not read (jax.grad's zeros) has no .grad
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items()}
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"non-finite gradients in {bad}")
    return grads
