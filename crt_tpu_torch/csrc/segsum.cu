// K3: per-segment accumulation of per-ray cotangents (segment sum).
//
// Replaces crt_tpu/ops/pallas_segsum.py `_kernel`, launched there by
// `segment_accumulate_matmul`: the backward of the packed-row adapters
// (`packed_rows_from_kernel`, `packed_gather_ranked`, `packed_gather`).
//
// What it computes: out[k, t] += sum over rays r with ids[r] == t of
// g[k, r].  g is [K, R] f32 with rays on the minor axis, ids is [R] i32
// (the hit triangle's Morton rank; ids outside [0, T) are skipped, -1 marks
// a miss), out is [K, T] f32 and arrives zeroed.  The TPU kernel does this
// as a one-hot matmul on the matrix unit; here it is a segmented f32
// reduction.
//
// What bounds it on an H100: bytes.  Every g value is read once
// ((K + 1) * R * 4 bytes in, K * T * 4 out) and takes one addition.
//
// What the design does about it, and about the two properties of the data:
//   - Contention: a few triangles own most rays (a floor fills half the
//     frame), so one atomic per (k, ray) would serialise on a few
//     addresses.  A warp reads 32 consecutive rays (coalesced, KC rows in
//     flight), groups its lanes by equal id (__match_any_sync) and reduces
//     each group with a shuffle tree; only the group's first lane adds, into
//     a shared-memory accumulator that covers the block's id band
//     [lo, hi].  Consecutive rays are one pixel tile and Morton ranks of
//     neighbouring triangles are close, so the band is narrow.  The block
//     flushes one partial per touched (k, id) to global memory at the end.
//     A band too wide for shared memory (K * W > CRT_SEGSUM_ACC) sends the
//     group sums to global memory directly: wide bands mean many distinct
//     ids, hence little contention.
//   - Accuracy: the sum is hierarchical (tree over a warp's group, then
//     the block's 32-ray groups, then the blocks), so a segment of 10^6
//     rays sees ~log2(32) + CRT_SEGSUM_RAYS / 32 + R / CRT_SEGSUM_RAYS
//     sequential f32 additions, not 10^6.
//   - The shared and global stages use atomics, so the order of the
//     partials, and with it the last bits, can change from run to run.

#include <cuda_runtime.h>

#define CRT_SEGSUM_BLOCK 256
#define CRT_SEGSUM_WARPS (CRT_SEGSUM_BLOCK / 32)
#define CRT_SEGSUM_RAYS 4096   // rays per block (a multiple of 32)
#define CRT_SEGSUM_KC 8        // g rows in flight per warp step
#define CRT_SEGSUM_ACC 12000   // floats of shared accumulator (< 48 KB)

namespace {

// Sum x[j] over the lanes of `peers` (the lanes holding the same id); the
// group's first lane ends with the total.  A pairwise tree over the
// group's members in lane order: deterministic.  All 32 lanes call it.
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             float (&x)[CRT_SEGSUM_KC]) {
  const unsigned full = 0xffffffffu;
  int rel = __popc(peers & ((1u << lane) - 1u));  // position within group
  peers &= (0xfffffffeu << lane);                 // members above this lane
  while (__any_sync(full, peers != 0u)) {
    const int next = __ffs((int)peers);  // 1 + lane of the next member, or 0
#pragma unroll
    for (int j = 0; j < CRT_SEGSUM_KC; ++j) {
      const float t = __shfl_sync(full, x[j], (next - 1) & 31);
      if (next) x[j] += t;
    }
    // members at odd positions were just absorbed by their predecessor
    peers &= ~__ballot_sync(full, rel & 1);
    rel >>= 1;
  }
}

__global__ void __launch_bounds__(CRT_SEGSUM_BLOCK) segment_accumulate_kernel(
    const float* __restrict__ g, const int* __restrict__ ids, int K, int R,
    int T, float* __restrict__ out) {
  __shared__ float acc[CRT_SEGSUM_ACC];
  __shared__ int s_lo[CRT_SEGSUM_WARPS], s_hi[CRT_SEGSUM_WARPS];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long start = (long long)blockIdx.x * CRT_SEGSUM_RAYS;
  const int r0 = (int)start;
  const int r1 = (int)min(start + CRT_SEGSUM_RAYS, (long long)R);

  // the block's id band
  int lo = 0x7fffffff, hi = -1;
  for (int r = r0 + tid; r < r1; r += CRT_SEGSUM_BLOCK) {
    const int id = ids[r];
    if (id >= 0 && id < T) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(full, lo, s));
    hi = max(hi, __shfl_xor_sync(full, hi, s));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < CRT_SEGSUM_WARPS; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
  if (hi < 0) return;  // no live ray in this block (uniform)
  const int W = hi - lo + 1;
  const bool in_smem = (long long)K * W <= CRT_SEGSUM_ACC;
  if (in_smem) {
    for (int i = tid; i < K * W; i += CRT_SEGSUM_BLOCK) acc[i] = 0.0f;
  }
  __syncthreads();

  // each warp takes every CRT_SEGSUM_WARPS-th group of 32 consecutive rays
  for (int base = r0 + warp * 32; base < r1; base += CRT_SEGSUM_BLOCK) {
    const int r = base + lane;
    int id = (r < r1) ? ids[r] : -1;
    if (id >= T) id = -1;
    const bool live = id >= 0;
    const unsigned peers = __match_any_sync(full, id);
    const bool first = live && lane == __ffs((int)peers) - 1;
    for (int k0 = 0; k0 < K; k0 += CRT_SEGSUM_KC) {
      float x[CRT_SEGSUM_KC];
#pragma unroll
      for (int j = 0; j < CRT_SEGSUM_KC; ++j) {
        x[j] = (live && k0 + j < K) ? g[(size_t)(k0 + j) * R + r] : 0.0f;
      }
      reduce_peers(peers, lane, x);
      if (first) {
#pragma unroll
        for (int j = 0; j < CRT_SEGSUM_KC; ++j) {
          if (k0 + j < K) {
            if (in_smem) {
              atomicAdd(&acc[(k0 + j) * W + (id - lo)], x[j]);
            } else {
              atomicAdd(&out[(size_t)(k0 + j) * T + id], x[j]);
            }
          }
        }
      }
    }
  }

  if (in_smem) {
    __syncthreads();
    for (int i = tid; i < K * W; i += CRT_SEGSUM_BLOCK) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(&out[(size_t)(i / W) * T + lo + i % W], v);
    }
  }
}

}  // namespace

// Host entry, bound with ctypes.  g [K, R] f32, ids [R] i32 and the zeroed
// out [K, T] f32 are contiguous device arrays on the device that owns
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int crt_segment_accumulate(const float* g, const int* ids, int K,
                                      int R, int T, float* out,
                                      void* stream) {
  if (K <= 0 || R <= 0 || T <= 0) return 0;
  const int blocks = (R + CRT_SEGSUM_RAYS - 1) / CRT_SEGSUM_RAYS;
  segment_accumulate_kernel<<<blocks, CRT_SEGSUM_BLOCK, 0,
                              (cudaStream_t)stream>>>(g, ids, K, R, T, out);
  return (int)cudaGetLastError();
}
