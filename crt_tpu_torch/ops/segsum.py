"""Segment sum of per-ray cotangents and the packed-row adapters it backs.

Counterpart of ``crt_tpu/ops/pallas_segsum.py``.  The shader reads one row
of the packed [K, T] per-triangle table per ray; the backward of that read
adds [K, R] cotangents into [K, T]:

    out[k, t] = sum over rays r with ids[r] == t of g[k, r]

  - ``segment_accumulate`` (K3, ``csrc/segsum.cu``) replaces ``_kernel`` as
    launched by ``segment_accumulate_matmul``.  It launches the CUDA kernel
    for CUDA tensors (or raises) and takes ``segment_accumulate_plain``
    only for CPU tensors.  ``utils/trace.py``'s registry counts each
    launch as ``crt.launches.segsum`` (the plain version does not count).
  - ``segment_accumulate_banded`` remaps triangle ids to Morton ranks first,
    so that the rays of one pixel tile fall into a narrow id band, and
    returns the sums in original ids.
  - ``packed_rows_from_kernel``, ``packed_gather`` and
    ``packed_gather_ranked`` are the ``torch.autograd.Function`` adapters
    whose backward is the segment sum.

The JAX module's ``packed_gather_ranked_fused`` carries the rank as an
extra f32 row of the table to avoid a slow one-row gather on its compiler;
PyTorch's index of a [T] table is an ordinary gather, so the port computes
``rank[tri]`` directly.  The shard_map plumbing is not ported (ROADMAP A14).
"""

from __future__ import annotations

import torch

from crt_tpu_torch.utils import trace as tracing


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def segment_accumulate_plain(ids: torch.Tensor, g: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Plain version of ``segment_accumulate``: ``index_add_`` into
    [K, T + 1] with every skipped id sent to column T, which is dropped."""
    T = num_segments
    col = torch.where((ids >= 0) & (ids < T), ids, T).long()
    out = torch.zeros((g.shape[0], T + 1), dtype=g.dtype, device=g.device)
    out.index_add_(1, col, g)
    return out[:, :T]


def segment_accumulate(ids: torch.Tensor, g: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """K3: per-segment sums of the columns of ``g`` -> [K, num_segments] f32.

    ids: [R] i32 segment ids, anything outside [0, num_segments) is
    skipped (-1 marks a miss); g: [K, R] f32 cotangents, rays on the minor
    axis.  Both contiguous and on one device.
    """
    T = int(num_segments)
    dev = g.device
    _require(g.dim() == 2 and g.dtype == torch.float32 and g.is_contiguous(),
             "g must be a contiguous float32 [K, R]")
    K, R = g.shape
    _require(ids.device == dev and ids.dtype == torch.int32
             and ids.is_contiguous() and tuple(ids.shape) == (R,),
             f"ids must be a contiguous int32 [{R}] on {dev}")
    _require(T >= 0 and R < 2**31, "num_segments >= 0 and R < 2^31 required")

    if dev.type == "cpu":
        return segment_accumulate_plain(ids, g, T)
    if dev.type != "cuda":
        raise NotImplementedError(f"segment_accumulate has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib
    from crt_tpu_torch.ops.cluster_trace import _cuda_stream, _raise_on

    lib, _ = cuda_lib.load()
    out = torch.empty((K, T), dtype=torch.float32, device=dev)
    if K and T:  # the entry point zeroes out, then launches when R > 0
        with torch.cuda.device(dev):
            err = lib.crt_segment_accumulate(
                g.data_ptr(), ids.data_ptr(), K, R, T,
                out.data_ptr(), _cuda_stream(dev),
            )
        _raise_on(err, "segment_accumulate")
        if R:
            tracing.count("crt.launches.segsum")
    return out


def segment_accumulate_banded(tri: torch.Tensor, g: torch.Tensor,
                              num_segments: int,
                              rank: torch.Tensor) -> torch.Tensor:
    """Segment sum through Morton ranks: ``rank[t]`` is a permutation of
    the segment ids that keeps spatial neighbours close, so each
    pixel-coherent run of rays spans a narrow band of ranks.  ``tri < 0``
    lanes are dropped.  Returns [K, num_segments] in ORIGINAL ids."""
    ranked = torch.where(tri >= 0, rank[tri.clamp(min=0).long()], -1)
    ranked = ranked.to(torch.int32)
    out_ranked = segment_accumulate(ranked.contiguous(), g, num_segments)
    return out_ranked[:, rank.long()]


def _cotangent(g: torch.Tensor) -> torch.Tensor:
    """The incoming gradient as the kernel takes it: it may reach a
    Function as a strided view or in another float type."""
    return g.to(torch.float32).contiguous()


class _PackedRowsFromKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, data, ranked, rank):
        ctx.save_for_backward(ranked, rank)
        ctx.num_segments = packed.shape[1]
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        ranked, rank = ctx.saved_tensors
        out_ranked = segment_accumulate(ranked, _cotangent(g),
                                        ctx.num_segments)
        # rank space -> original segment ids
        return out_ranked[:, rank.long()], None, None, None


def packed_rows_from_kernel(packed, data, ranked, rank):
    """Autograd adapter for rows the closest-hit kernel emitted.

    ``data`` [K, R] are the emitted rows (bit-identical to
    ``packed[:, tri]``, so no gather runs); ``ranked`` [R] i32 are the
    kernel's slot indices (the hit triangle's Morton rank, -1 on a miss);
    ``rank`` [T] i32 maps triangle id -> Morton rank.  The forward returns
    ``data`` untouched; the backward routes the cotangents into ``packed``'s
    [K, T] layout through the segment sum in rank space.
    """
    _require(data.dim() == 2 and ranked.dim() == 1,
             "packed_rows_from_kernel takes data [K, R] and ranked [R]")
    return _PackedRowsFromKernel.apply(packed, data, ranked.contiguous(),
                                       rank)


class _PackedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, tri):
        ctx.save_for_backward(tri)
        ctx.num_segments = packed.shape[1]
        return packed[:, tri.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (tri,) = ctx.saved_tensors
        return segment_accumulate(tri, _cotangent(g), ctx.num_segments), None


def packed_gather(packed, tri):
    """``packed[:, max(tri, 0)]`` whose backward is the segment sum.

    packed: [K, T]; tri: [R] i32 ids below T.  A lane with id -1 reads
    column 0 and the backward skips it (its output must be discarded).
    """
    _require(tri.dim() == 1, "packed_gather takes tri [R]")
    return _PackedGather.apply(packed, tri.to(torch.int32).contiguous())


class _PackedGatherRanked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, tri, rank):
        ctx.save_for_backward(tri, rank)
        ctx.num_segments = packed.shape[1]
        return packed[:, tri.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        tri, rank = ctx.saved_tensors
        grad = segment_accumulate_banded(tri, _cotangent(g),
                                         ctx.num_segments, rank)
        return grad, None, None


def packed_gather_ranked(packed, tri, rank):
    """``packed[:, max(tri, 0)]`` whose backward is the banded segment sum.

    ``tri`` may carry -1 on miss lanes: the forward clamps them to id 0
    (their outputs are masked downstream and their cotangents are exactly
    zero) and the backward DROPS them, so they cannot widen a tile's band.
    The backward computes ``rank[tri]`` directly, where the JAX package
    rides the rank through the gather as an extra f32 row.
    """
    _require(tri.dim() == 1, "packed_gather_ranked takes tri [R]")
    return _PackedGatherRanked.apply(packed, tri, rank)
