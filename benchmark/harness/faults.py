"""Faults planted in the program under a run, to show that the check
fails them.  Each is a context manager that patches the program where the
timed path looks it up and puts it back on exit.

  - ``half_frame``: each frame comes back with its lower half never
    rendered (black): half of the work left out;
  - ``altered``: each frame comes back with one 32 x 32 tile in eight
    brighter by 0.05: answers altered where they are produced;
  - ``half_batch``: a fit step's loss is the mean over the upper half of
    the rows only, and its gradient is that loss's;
  - ``frozen_state``: a fit step returns its state unchanged (Adam's
    update does nothing).
"""

from __future__ import annotations

import contextlib

import torch

FRAME_FAULTS = ("half_frame", "altered")
STEP_FAULTS = ("half_batch", "frozen_state")


def _half_frame(img):
    out = img.clone()
    out[img.shape[0] // 2:] = 0.0
    return out


def _altered(img):
    H, W = img.shape[:2]
    ty = torch.arange(H, device=img.device)[:, None] // 32
    tx = torch.arange(W, device=img.device)[None, :] // 32
    hit = ((ty * 7 + tx) % 8 == 0)[..., None]
    return torch.where(hit, img + 0.05, img)


@contextlib.contextmanager
def planted(name: str):
    from crt_tpu_torch import renderer
    from crt_tpu_torch.parallel import sharded

    with contextlib.ExitStack() as stack:
        if name in FRAME_FAULTS:
            real = renderer.render_image
            change = _half_frame if name == "half_frame" else _altered

            def render_image(*a, **k):
                return change(real(*a, **k))

            renderer.render_image = render_image
            stack.callback(setattr, renderer, "render_image", real)
        elif name == "half_batch":
            real_loss = sharded._rows_loss

            def rows_loss(img_rows, target, row_start, height, width):
                half = height // 2
                return real_loss(img_rows[:half], target[:half], row_start,
                                 half, width)

            sharded._rows_loss = rows_loss
            stack.callback(setattr, sharded, "_rows_loss", real_loss)
        elif name == "frozen_state":
            real_step = torch.optim.Adam.step

            def step(self, closure=None):
                return None

            torch.optim.Adam.step = step
            stack.callback(setattr, torch.optim.Adam, "step", real_step)
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
