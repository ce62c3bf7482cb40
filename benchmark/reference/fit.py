"""Plain reference of the first steps of an inverse-rendering fit: the L2
image loss of the whole frame against a target, its gradient with respect
to every parameter leaf, and Adam (lr, betas 0.9 / 0.999, eps 1e-8, the
bias-corrected update) written out."""

from __future__ import annotations

import math

import torch

from reference.render import PARAM_KEYS, Renderer

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def target_frame(r: Renderer, moved: dict, cam_rotation):
    """The target: the frame with the parameters in ``moved`` (NumPy
    arrays) in place of the renderer's, without gradient."""
    keep = r.params
    params = dict(keep)
    for k, v in moved.items():
        params[k] = torch.as_tensor(v, device=r.dev).to(r.dtype)
    r.with_params(params)
    with torch.no_grad():
        img = r.frame(cam_rotation)
    r.with_params(keep)
    return img


def fit_steps(r: Renderer, target, cam_rotation, steps: int = 3,
              lr: float = 1e-2) -> dict:
    """``steps`` steps of Adam from the renderer's parameters -> {"loss":
    [loss before each step], "grad0": {leaf: first gradient}, "delta":
    {leaf: change of the parameters after the steps}}."""
    start = {k: r.params[k].detach().clone() for k in PARAM_KEYS}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    losses, grad0 = [], None
    n = target.numel()
    for step in range(1, steps + 1):
        r.with_params(params)
        for p in params.values():
            p.grad = None
        loss = ((r.frame(cam_rotation) - target) ** 2).sum() / n
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in params.items()}
            if grad0 is None:
                grad0 = {k: g.clone() for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k]
                m[k] = BETA1 * m[k] + (1 - BETA1) * g
                v2[k] = BETA2 * v2[k] + (1 - BETA2) * g * g
                mh = m[k] / (1 - BETA1 ** step)
                vh = v2[k] / (1 - BETA2 ** step)
                p -= lr * mh / (torch.sqrt(vh) + EPS)
    delta = {k: params[k].detach() - start[k] for k in PARAM_KEYS}
    r.with_params(start)
    return {"loss": losses, "grad0": grad0, "delta": delta}


def leaf_norm(x) -> float:
    return math.sqrt(float((x.double() ** 2).sum()))
