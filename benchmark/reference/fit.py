"""Plain reference of the first steps of an inverse-rendering fit: the L2
image loss of the whole frame against a target, its gradient with respect
to every parameter leaf, and Adam (lr, betas 0.9 / 0.999, eps 1e-8, the
bias-corrected update) written out.

The renderer is the one the cell's scene kind gives (a subclass of
``reference.render.Renderer`` where a configuration brings its own), with
diffuse GI where the scene has it on.  A check file's ``pixel_block``
renders the target, and each step's loss and gradient, in blocks of that
many pixels in raster order (without it, the whole frame is one block):
each pixel's colour, GI streams included, depends on its raster x / y
alone, and the loss is a sum over pixels, so the blocks' losses add up to
the frame's and their backward passes, each into the same leaves'
``.grad``, to its gradient; only the order of the float sums differs."""

from __future__ import annotations

import math

import torch

from reference.render import PARAM_KEYS, Renderer

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def pixel_blocks(r: Renderer, block=None):
    """(start, px, py) of the frame's pixels in raster order, ``block`` at
    a time (None: the whole frame)."""
    W, n = r.s.width, r.s.width * r.s.height
    block = block or n
    for s in range(0, n, block):
        i = torch.arange(s, min(s + block, n), device=r.dev)
        yield s, i % W, i // W


def target_frame(r: Renderer, moved: dict, cam_rotation, block=None):
    """The target: the frame with the parameters in ``moved`` (NumPy
    arrays) in place of the renderer's, without gradient, rendered in
    blocks of ``block`` pixels."""
    keep = r.params
    params = dict(keep)
    for k, v in moved.items():
        params[k] = torch.as_tensor(v, device=r.dev).to(r.dtype)
    r.with_params(params)
    with torch.no_grad():
        img = torch.cat([r.pixels(px, py, cam_rotation) for _, px, py
                         in pixel_blocks(r, block)]
                        ).reshape(r.s.height, r.s.width, 3)
    r.with_params(keep)
    return img


def _loss_backward(r: Renderer, target, cam_rotation, block) -> float:
    """sum((frame - target)^2) / n, with its backward into the leaves, in
    blocks of ``block`` pixels."""
    n = target.numel()
    flat = target.reshape(-1, 3)
    total = 0.0
    for s, px, py in pixel_blocks(r, block):
        part = ((r.pixels(px, py, cam_rotation) - flat[s:s + px.numel()])
                ** 2).sum() / n
        if part.requires_grad:  # a block of background alone has no graph
            part.backward()
        total += float(part.detach())
    return total


def fit_steps(r: Renderer, target, cam_rotation, steps: int = 3,
              lr: float = 1e-2, block=None) -> dict:
    """``steps`` steps of Adam from the renderer's parameters -> {"loss":
    [loss before each step], "grad0": {leaf: first gradient}, "delta":
    {leaf: change of the parameters after the steps}}; each step's loss
    and gradient in blocks of ``block`` pixels."""
    start = {k: r.params[k].detach().clone() for k in PARAM_KEYS}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    losses, grad0 = [], None
    for step in range(1, steps + 1):
        r.with_params(params)
        for p in params.values():
            p.grad = None
        losses.append(_loss_backward(r, target, cam_rotation, block))
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
