"""Inverse rendering: optimize scene parameters against a target image.

Counterpart of the single-device branch of ``crt_tpu/optim.py``: fit
vertices, texture colors, light intensities or the camera to a target
render by gradient descent on an L2 image loss.  ``torch.optim.Adam`` with
lr 1e-2 stands in for ``optax.adam(1e-2)`` (the same update rule, eps
1e-8); checkpoints are ``torch.save`` files, at most two kept, and an
interrupted fit resumes from the latest.  The sharded step (``mesh=``) is
ROADMAP A13.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

import torch

from crt_tpu_torch.renderer import _render_flat
from crt_tpu_torch.scene.types import RenderSettings, Scene

_CKPT_RE = re.compile(r"^step_(\d+)\.pt$")
_CKPT_KEEP = 2


def default_trainable_params(scene: Scene) -> dict:
    """The differentiable scene-parameter dict used by inverse rendering."""
    return {
        "vertices": scene.vertices,
        "tex_color_a": scene.tex_color_a,
        "tex_color_b": scene.tex_color_b,
        "light_intensity": scene.light_intensity,
        "cam_position": scene.cam_position,
    }


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
    interrupted fit resumes from the latest saved step.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded fit (mesh=) is not ported yet (ROADMAP A13)")
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

    loss_fn = make_loss_fn(scene, settings,
                           torch.as_tensor(target, device=device))
    losses = []
    for i in range(start_step, steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if callback:
            callback(i, losses[-1])
        if checkpoint_dir and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            _save_checkpoint(checkpoint_dir, i, params, opt)
    if checkpoint_dir:
        _save_checkpoint(checkpoint_dir, steps - 1, params, opt)
    return {k: p.detach() for k, p in params.items()}, losses
