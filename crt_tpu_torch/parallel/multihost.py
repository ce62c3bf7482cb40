"""Multi-process runtime: process-group set-up, render dispatch, recovery.

Counterpart of ``crt_tpu/parallel/multihost.py``.

  - ``initialize()`` joins the process group whose rendezvous torch's own
    variables describe (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE``
    / ``RANK``, as ``torchrun`` sets them); with none set it does nothing
    and returns False (one process).
  - ``render_image_multihost()`` renders with the rows split over every
    rank (``sharded.render_image_sharded``) and returns the whole frame on
    every rank.
  - Recovery: renders are stateless, so a lost worker loses only its row
    block.  ``render_rows_local()`` renders any block on this process, and
    ``render_blocks_with_recovery()`` cuts a frame into blocks and
    re-dispatches a block that fails; a block that fails every attempt
    raises, and is never filled with zeros.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from crt_tpu_torch.parallel.sharded import (
    _render_rows,
    make_mesh,
    render_image_sharded,
)
from crt_tpu_torch.scene.types import RenderSettings, Scene


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=10)
               ) -> bool:
    """Join the process group.  Returns True if distributed mode is active.

    ``init_method`` defaults to ``env://`` when ``MASTER_ADDR`` is set,
    ``world_size`` / ``rank`` to ``WORLD_SIZE`` / ``RANK``; with no
    rendezvous configured this is a no-op returning False.  ``backend``
    defaults to NCCL where there is a card (each rank then takes the card
    ``LOCAL_RANK`` names) and gloo otherwise.
    """
    if dist.is_initialized():
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kwargs)
    return True


def global_mesh(axis_name: str = "rays"):
    """Mesh over every rank of every process."""
    return make_mesh(axis_names=(axis_name,))


def render_image_multihost(scene: Scene,
                           settings: RenderSettings | None = None,
                           mesh=None) -> np.ndarray:
    """Render with rows split over every rank; every rank returns the
    assembled [H, W, 3] framebuffer."""
    mesh = mesh if mesh is not None else global_mesh()
    return render_image_sharded(scene, settings, mesh).cpu().numpy()


def render_rows_local(scene: Scene, row_start: int, num_rows: int,
                      settings: RenderSettings | None = None
                      ) -> torch.Tensor:
    """Render an arbitrary row block on the local process -> [num_rows, W,
    3]: the unit of work a scheduler re-dispatches when a worker is
    lost."""
    settings = settings or RenderSettings()
    with torch.no_grad():
        return _render_rows(scene, settings, row_start, num_rows)


class BlockRenderError(RuntimeError):
    """A row block failed after exhausting its retries."""


def render_blocks_with_recovery(scene: Scene,
                                settings: RenderSettings | None = None,
                                num_blocks: int = 4, render_block=None,
                                max_attempts: int = 3) -> np.ndarray:
    """Block scheduler with failure detection and re-dispatch.

    The frame is cut into ``num_blocks`` row blocks, each rendered by
    ``render_block(scene, row_start, num_rows, settings)`` (default: the
    local ``render_rows_local``); a block that raises is queued again, up
    to ``max_attempts`` attempts, and the frame is assembled from the
    attempts that succeeded.  ``render_block`` can route blocks to other
    workers, or inject faults in a test.

    Raises BlockRenderError when a block exhausts its attempts: a lost
    block is never filled with zeros.
    """
    settings = settings or RenderSettings()
    if render_block is None:
        render_block = render_rows_local

    h, w = scene.height, scene.width
    rows_per = -(-h // num_blocks)
    queue = [(b, 0) for b in range(num_blocks)]
    results: dict[int, np.ndarray] = {}
    while queue:
        b, attempt = queue.pop(0)
        start = b * rows_per
        n = min(rows_per, h - start)
        if n <= 0:
            continue
        try:
            block = render_block(scene, start, n, settings)
            if isinstance(block, torch.Tensor):
                block = block.detach().cpu().numpy()
            results[b] = np.asarray(block)
        except Exception as e:  # noqa: BLE001 — any worker failure re-queues
            if attempt + 1 >= max_attempts:
                raise BlockRenderError(
                    f"row block {b} (rows {start}..{start + n}) failed "
                    f"{max_attempts} times: {e}"
                ) from e
            queue.append((b, attempt + 1))

    frame = np.zeros((h, w, 3), np.float32)
    for b, block in results.items():
        start = b * rows_per
        frame[start:start + block.shape[0]] = block[:h - start]
    return frame
