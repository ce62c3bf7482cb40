"""Rays sharded over a device mesh: each rank renders a block of rows.

Counterpart of ``crt_tpu/parallel/sharded.py``.  One process per device
(``torch.distributed``): every rank holds the whole scene and renders its
``ceil(h / n)`` rows of the frame, in the renderer's 32x32 pixel tiles,
with the rows' own raster coordinates (so the GI streams are the single
frame's).  The frame is assembled on every rank by one all-reduce (a sum
over a zero frame), the one collective that gloo and NCCL both carry for
CUDA tensors.  Gradients of the replicated scene parameters are each
rank's partial sums over its rows, all-reduced once, together with the
loss: the result is the single-device gradient.  With no process group this is the
single-device step itself, which ``optim.fit_scene`` takes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes:
1-D ``("rays",)`` here, 2-D ``("rays", "scene")`` for
``parallel/scene_sharded.py``.  ``make_mesh`` builds one over the ranks of
the default process group; without one (no ``init_process_group``), every
function runs as a one-device mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crt_tpu_torch.renderer import _render_flat
from crt_tpu_torch.scene.types import RenderSettings, Scene
from crt_tpu_torch.utils import trace as tracing

__all__ = [
    "default_trainable_params",
    "inverse_render_step",
    "make_mesh",
    "render_image_sharded",
    "sharded_value_and_grad",
]


def default_trainable_params(scene: Scene) -> dict:
    """The differentiable scene-parameter dict used by inverse rendering."""
    return {
        "vertices": scene.vertices,
        "tex_color_a": scene.tex_color_a,
        "tex_color_b": scene.tex_color_b,
        "light_intensity": scene.light_intensity,
        "cam_position": scene.cam_position,
    }


class OneDeviceMesh:
    """The mesh of a process that belongs to no process group: every axis
    of size 1, no group.  It answers the ``DeviceMesh`` calls used here."""

    def __init__(self, axis_names=("rays",)):
        self.mesh_dim_names = tuple(axis_names)
        self.shape = (1,) * len(self.mesh_dim_names)

    def size(self, dim=None) -> int:
        return 1

    def get_group(self, name=None):
        return None

    def get_local_rank(self, name=None) -> int:
        return 0


def make_mesh(shape=None, axis_names=("rays",)):
    """A mesh over every rank of the default process group, ``shape``
    (default: all ranks on the first axis) named ``axis_names``; a
    ``OneDeviceMesh`` when no process group is initialised."""
    axis_names = tuple(axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        return OneDeviceMesh(axis_names)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    # The mesh's device type only places DTensors, which nothing here
    # makes; the collectives run on the groups' backend and the tensors'
    # device (gloo carries CUDA tensors too).
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=axis_names)


def mesh_axis(mesh, name: str):
    """(process group, size, this rank's index) of the mesh axis ``name``;
    the group is None on an axis of one rank."""
    n = mesh.size(mesh.mesh_dim_names.index(name))
    if n == 1:
        return None, 1, 0
    return mesh.get_group(name), n, mesh.get_local_rank(name)


def all_reduce(t: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (SUM by default); a
    no-op for ``group`` None (one rank)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``: the backward sums the
    ranks' cotangents, so each rank's input gets every rank's."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def assemble_rows(rows: torch.Tensor, row_start: int, height: int,
                  group=None) -> torch.Tensor:
    """Every rank's row block [rows_per, w, C] -> the [height, w, C] frame
    on every rank: each writes its rows into a zero frame of
    ``row_start``-aligned blocks and one all-reduce sums them."""
    if group is None:
        return rows[:height]
    n = dist.get_world_size(group)
    rows_per = rows.shape[0]
    frame = rows.new_zeros((rows_per * n,) + tuple(rows.shape[1:]))
    frame[row_start:row_start + rows_per] = rows
    return all_reduce(frame, group=group)[:height]


def _render_rows(scene: Scene, settings: RenderSettings, row_start: int,
                 num_rows: int) -> torch.Tensor:
    """Render ``num_rows`` image rows beginning at ``row_start`` ->
    [num_rows, w, 3]: the renderer's frame (its wavefront policy, chunks
    and 32x32 tiles) over those rows."""
    return _render_flat(scene, settings, row_offset=row_start,
                        num_rows=num_rows)


def render_image_sharded(scene: Scene, settings: RenderSettings | None = None,
                         mesh=None) -> torch.Tensor:
    """Forward render with the pixel rows split over the mesh's first
    axis -> the [height, width, 3] frame on every rank.  Every rank renders
    its block of ``ceil(height / n)`` rows against its own copy of the
    scene; no ray data crosses ranks, only the frame's assembly."""
    settings = settings or RenderSettings()
    mesh = mesh if mesh is not None else make_mesh()
    group, n, k = mesh_axis(mesh, mesh.mesh_dim_names[0])
    rows_per = -(-scene.height // n)
    with torch.no_grad():
        rows = _render_rows(scene, settings, k * rows_per, rows_per)
        return assemble_rows(rows, k * rows_per, scene.height, group)


def _rows_loss(img_rows, target, row_start, height, width):
    """The L2 loss of a row block against the matching rows of ``target``
    [height, width, 3], rows past the frame masked: its share of
    sum((img - target)^2) / (height * width * 3)."""
    n = img_rows.shape[0]
    valid = min(max(height - row_start, 0), n)
    err = img_rows[:valid] - target[row_start:row_start + valid]
    return torch.sum(err * err) / (height * width * 3)


def reduce_loss_and_grads(loss: torch.Tensor, params: dict, group=None):
    """One all-reduce of ``loss`` and every parameter's ``.grad`` (zeros
    where a parameter got none) over ``group``; the grads are written
    back.  Returns the reduced loss.  With ``group`` None the grads stay
    as the backward left them."""
    if group is None:
        return loss.detach()
    flat = [loss.detach().reshape(1).to(torch.float32)]
    for p in params.values():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        flat.append(g.reshape(-1))
    buf = all_reduce(torch.cat(flat), group=group)
    off = 1
    for p in params.values():
        p.grad = buf[off:off + p.numel()].view_as(p).clone()
        off += p.numel()
    return buf[0]


def sharded_backward(scene: Scene, target: torch.Tensor, params: dict,
                     settings: RenderSettings, mesh) -> torch.Tensor:
    """The sharded loss's backward into ``params`` (leaf tensors that
    require grad, their ``.grad`` set to the single-device gradient on
    every rank) -> the loss."""
    group, n, k = mesh_axis(mesh, mesh.mesh_dim_names[0])
    h, w = scene.height, scene.width
    rows_per = -(-h // n)
    with tracing.span("crt.fit.forward"):
        img = _render_rows(scene.replace(**params), settings, k * rows_per,
                           rows_per)
        loss = _rows_loss(img, target, k * rows_per, h, w)
    with tracing.span("crt.fit.backward"):
        loss.backward()
        return reduce_loss_and_grads(loss, params, group)


def _grads(leaves: dict) -> dict:
    """The leaves' gradients, zeros where the loss did not reach one."""
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in leaves.items()}


def _leaves(params: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            .detach().clone().requires_grad_(True)
            for k, v in params.items()}


def sharded_value_and_grad(scene: Scene, target: torch.Tensor,
                           params: dict | None = None,
                           settings: RenderSettings | None = None,
                           mesh=None):
    """The L2 loss of the row-sharded render against ``target`` [H, W, 3]
    and its gradients with respect to ``params`` (default:
    ``default_trainable_params``) -> (loss, grads), both the same on every
    rank and equal to the single-device ``mean((img - target)^2)`` and its
    gradient.  Each rank differentiates its rows' share; the shares of the
    loss and of every gradient are all-reduced once, together."""
    settings = settings or RenderSettings()
    mesh = mesh if mesh is not None else make_mesh()
    params = params if params is not None else default_trainable_params(scene)
    leaves = _leaves(params, scene.device)
    target = torch.as_tensor(target, device=scene.device)
    loss = sharded_backward(scene, target, leaves, settings, mesh)
    return loss, _grads(leaves)


def inverse_render_step(scene: Scene, target: torch.Tensor,
                        params: dict | None = None,
                        settings: RenderSettings | None = None, mesh=None,
                        lr: float = 1e-2):
    """One sharded SGD step on the scene parameters toward ``target`` (see
    ``sharded_value_and_grad``) -> (new_params, loss)."""
    params = params if params is not None else default_trainable_params(scene)
    loss, grads = sharded_value_and_grad(scene, target, params, settings,
                                         mesh)
    new_params = {k: torch.as_tensor(v, device=scene.device).detach()
                  - lr * grads[k] for k, v in params.items()}
    return new_params, loss
