"""Progressive multi-pass GI accumulation with checkpoint and resume.

Counterpart of ``crt_tpu/progressive.py``.  The reference renders GI in one
pass of K hemisphere samples per diffuse hit; noise falls as
1/sqrt(samples), so a converged frame wants more samples than one pass
holds (K multiplies every per-bounce buffer).  ``render_progressive``
accumulates passes instead: pass p renders the whole frame with every
pixel's PCG32 stream forked by salt p (``ops/rng.salt_stream``), and the
running mean converges to the many-sample image.  Pass 0 takes the
unsalted streams, so a one-pass accumulation is ``render_image`` bit for
bit.

Checkpoints: with ``checkpoint_dir`` the running sum and the number of
passes done are written with ``torch.save`` every ``checkpoint_every``
passes and at the end, and a later call with the same directory resumes
from them; pass p's image depends on p only, so a resumed accumulation
equals an uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from crt_tpu_torch.renderer import render_image
from crt_tpu_torch.scene.types import RenderSettings, Scene

CHECKPOINT_FILE = "progressive.pt"


def render_progressive(
    scene: Scene,
    settings: RenderSettings | None = None,
    passes: int = 8,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    callback: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """The mean of ``passes`` decorrelated GI renders -> [h, w, 3].

    ``callback(pass_idx, running_mean)`` is called after each pass.  With
    ``checkpoint_dir`` the accumulation is saved every ``checkpoint_every``
    passes (0: only at the end), and a directory holding a checkpoint
    resumes where it left off."""
    settings = settings or RenderSettings()
    accum = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                        device=scene.device)
    start = 0
    path = (os.path.join(checkpoint_dir, CHECKPOINT_FILE)
            if checkpoint_dir else None)
    if path is not None and os.path.exists(path):
        saved = torch.load(path, map_location=scene.device)
        accum = saved["accum"]
        start = int(saved["passes_done"])

    for p in range(start, passes):
        accum = accum + render_image(scene, settings, gi_salt=p)
        done = p + 1
        if callback is not None:
            callback(p, accum / done)
        if path is not None and (
                done == passes
                or (checkpoint_every and done % checkpoint_every == 0)):
            _save(path, accum, done)
    return accum / max(passes, 1)


def _save(path: str, accum: torch.Tensor, passes_done: int) -> None:
    """Write the checkpoint through a temporary file, so an interrupted
    write leaves the previous checkpoint whole."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"accum": accum.detach(), "passes_done": passes_done}, tmp)
    os.replace(tmp, path)
