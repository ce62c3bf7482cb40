"""Inverse rendering: optimize scene parameters against a target image.

Counterpart of ``crt_tpu/optim.py``: fit
vertices, texture colors, light intensities or the camera to a target
render by gradient descent on an L2 image loss.  ``torch.optim.Adam`` with
lr 1e-2 stands in for ``optax.adam(1e-2)`` (the same update rule, eps
1e-8); checkpoints are ``torch.save`` files, at most two kept, and an
interrupted fit resumes from the latest.  Each step takes the row-sharded
gradient of ``parallel/sharded.py``: on the rows of ``mesh=``, all-reduced
once, the single-device gradient on every rank; without a mesh, the
single-device gradient itself.  (crt_tpu's sharded step sums
gradients that AD has already all-reduced, so its step is the mesh size
times the single-device one; the port does not carry that.)
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

import torch
import torch.distributed as dist

from crt_tpu_torch.parallel.sharded import (
    OneDeviceMesh,
    default_trainable_params,
    sharded_backward,
)
from crt_tpu_torch.renderer import _render_flat
from crt_tpu_torch.scene.types import RenderSettings, Scene
from crt_tpu_torch.utils import trace as tracing

_CKPT_RE = re.compile(r"^step_(\d+)\.pt$")
_CKPT_KEEP = 2


def make_loss_fn(scene: Scene, settings: RenderSettings,
                 target: torch.Tensor):
    """L2 image loss as a function of a trainable-parameter dict."""

    def loss_fn(params: dict) -> torch.Tensor:
        img = _render_flat(scene.replace(**params), settings)
        return torch.mean((img - target) ** 2)

    return loss_fn


def _checkpoints(directory: str) -> list[tuple[int, str]]:
    """(step, path) of the checkpoints in ``directory``, oldest first."""
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def _save_checkpoint(directory: str, step: int, params: dict, opt) -> None:
    path = os.path.join(directory, f"step_{step}.pt")
    tmp = path + ".tmp"
    torch.save({"params": {k: p.detach() for k, p in params.items()},
                "opt_state": opt.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)
    for _, old in _checkpoints(directory)[:-_CKPT_KEEP]:
        os.unlink(old)


def fit_scene(
    scene: Scene,
    target: torch.Tensor,
    params: Optional[dict] = None,
    settings: Optional[RenderSettings] = None,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    steps: int = 100,
    mesh=None,
    callback: Optional[Callable[[int, float], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
):
    """Gradient-descend scene parameters toward ``target``.

    Returns (params, losses): the fitted parameter dict (detached tensors
    on the scene's device) and the loss before each step taken.  ``params``
    maps Scene field names to start values (default:
    ``default_trainable_params``); ``optimizer`` is a callable from the
    list of parameter tensors to a ``torch.optim.Optimizer`` (default:
    Adam, lr 1e-2).  ``checkpoint_dir`` enables save / restore: an
    interrupted fit resumes from the latest saved step.  ``mesh`` (a
    ``parallel.sharded.make_mesh`` mesh) splits each step's rows over its
    first axis: every rank runs this call with the same arguments and
    takes the same steps; only global rank 0 writes checkpoints.
    """
    settings = settings or RenderSettings()
    device = scene.device
    start = params if params is not None else default_trainable_params(scene)
    keys = list(start)
    params = {
        k: torch.as_tensor(start[k], dtype=torch.float32, device=device)
        .detach().clone().requires_grad_(True)
        for k in keys
    }
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-2))
    opt = make_opt([params[k] for k in keys])
    start_step = 0

    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        saved = _checkpoints(checkpoint_dir)
        if saved:
            state = torch.load(saved[-1][1], map_location=device,
                               weights_only=True)
            with torch.no_grad():
                for k in keys:
                    params[k].copy_(state["params"][k])
            opt.load_state_dict(state["opt_state"])
            start_step = state["step"] + 1

    target = torch.as_tensor(target, device=device)
    mesh = mesh if mesh is not None else OneDeviceMesh()
    writer = not dist.is_initialized() or dist.get_rank() == 0
    losses = []
    for i in range(start_step, steps):
        opt.zero_grad(set_to_none=True)
        loss = sharded_backward(scene, target, params, settings, mesh)
        with tracing.span("crt.fit.optimizer"):
            opt.step()
        tracing.count("crt.host_reads.fit_loss")
        losses.append(float(loss.detach()))
        if callback:
            callback(i, losses[-1])
        if checkpoint_dir and writer and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            _save_checkpoint(checkpoint_dir, i, params, opt)
    if checkpoint_dir and writer:
        _save_checkpoint(checkpoint_dir, steps - 1, params, opt)
    return {k: p.detach() for k, p in params.items()}, losses
