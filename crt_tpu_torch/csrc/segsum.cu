// K3: per-segment accumulation of per-ray cotangents (segment sum).
//
// Replaces crt_tpu/ops/pallas_segsum.py `_kernel`, launched there by
// `segment_accumulate_matmul`: the backward of the packed-row adapters
// (`packed_rows_from_kernel`, `packed_gather_ranked`, `packed_gather`).
//
// What it computes: out[k, t] += sum over rays r with ids[r] == t of
// g[k, r].  g is [K, R] f32 with rays on the minor axis, ids is [R] i32
// (the hit triangle's Morton rank; ids outside [0, T) are skipped, -1 marks
// a miss), out is [K, T] f32, zeroed by the entry point.  The TPU kernel
// does this as a one-hot matmul on the matrix unit; here it is a segmented
// f32 reduction.
//
// What bounds it on an H100: bytes.  Every id is read once, and the g
// values of the rays with a valid id (a miss's cotangents are never read):
// 4 R + 4 K live bytes in, 4 K T out; one addition per value read.
//
// The design, one point per thing that held the earlier kernel (8 rows of
// 32 rays in flight per warp, then a match of equal ids and a shuffle tree
// per group of them, and a shared-memory f32 atomic per group and row,
// which sm_90 executes as a compare-and-swap loop):
//   - A lane per row.  A warp walks its rays (up to 128) 32 at a time (a
//     step); lane k reads row k's 32 values of the step (eight 16-byte
//     loads, one 128-byte line) and adds them to its running sum of the
//     current run of equal ids.  The ids are the same for every lane, so every branch
//     is uniform: a step of one id takes a tree sum of its 32 values, a
//     step of several walks them in order; a run is added to the
//     accumulator once, when the id changes, by each row's lane at its own
//     row: no shuffle per row, no atomic in shared memory.  More than 32
//     rows take the walk again for each 32.
//   - Misses cost no row bytes.  A warp loads the ids of its steps first,
//     all in flight at once; a step whose ids are all skipped is neither
//     loaded nor walked, and a block whose ids all are (a bounce pool is
//     mostly dead) returns after its ids.
//   - Blocks of 1,024 rays, as many as the rays need: the card's scheduler
//     spreads the work where the live rays crowd into a part of the
//     wavefront (the first bank of a bounce pool).  Where 4 steps a warp
//     would leave SMs without a block, a warp takes fewer steps (down to
//     one), so a few rays are walked by several warps side by side, not
//     one after another by one.
//   - A launch whose rays fit one block, with every id's accumulators in
//     shared memory (the glass backward's ior row: 66 rays, 4 ids), owns
//     the output: the block stores every (k, id) of it, zeros included,
//     and the entry point skips the zeroing.
//   - Accumulators: a copy of [K, W] per warp in shared memory over the
//     block's id band [lo, lo + W) (consecutive rays are one pixel tile and
//     Morton ranks of neighbouring triangles are close, so the band is
//     narrow), so a warp's adds are plain loads and stores; the block
//     flushes one partial per touched (k, id), the sum of its warps'
//     copies, with a global atomic.  A band too wide for it sends the run
//     sums to global memory directly (a wide band means many distinct
//     ids, hence little contention).
//   - Accuracy: the sum is hierarchical (32 values of a step by a tree, a
//     warp's 4 steps, the block's warps, then the blocks), so a segment of
//     10^6 rays sees about 5 + 4 + 8 + 10^6 / 1,024 sequential f32
//     additions, not 10^6.
//   - The global stage uses atomics, so the order of the partials, and
//     with it the last bits, can change from run to run.  That is the
//     port's determinism contract, settled as "forward only", which is
//     what crt_tpu checks (crt_tpu/utils/checks.py compares two renders):
//     two forward renders give the same bits (the card test
//     test_forward_render_is_deterministic, chip_smoke.py's [big]); a
//     gradient through this kernel is held to its stated tolerance and may
//     differ in the last bits between runs.
// Two other designs were built and timed against this one and lost:
// rows staged by cp.async through a shared-memory ring and reduced by a
// warp segmented scan over run flags found once a chunk, on a persistent
// grid (measure/segsum_scan_ring.cu), and this kernel's lane per row on a
// persistent grid of equal ray ranges (measure/segsum_persistent.cu); their
// times are in PERF.md, from measure/redesign_turns.py.

#include <cuda_runtime.h>

#include <cstdint>

#define CRT_SEGSUM_BLOCK 256
#define CRT_SEGSUM_WARPS (CRT_SEGSUM_BLOCK / 32)
#define CRT_SEGSUM_STEP 32  // rays a warp takes a step
#define CRT_SEGSUM_STEPS 4  // most steps of a warp's range
#define CRT_SEGSUM_ACC 11776  // most floats of the warps' accumulators

// The accumulators and id_band's arrays stay within the 48 KB of shared
// memory a launch may take without opting in to more.
static_assert(CRT_SEGSUM_ACC * 4 + 2 * CRT_SEGSUM_WARPS * 4 <= 48 * 1024,
              "K3's shared memory exceeds the default 48 KB");

namespace {

struct SegArgs {
  const float* g;
  const int* ids;
  int K, R, T;
  float* out;
};

// The id of ray r, -1 where it is skipped (outside [0, T), or r >= r1).
__device__ __forceinline__ int ray_id(const SegArgs& a, int r, int r1) {
  if (r >= r1) return -1;
  const int id = __ldg(a.ids + r);
  return (id >= 0 && id < a.T) ? id : -1;
}

// A row's values of a step: 32 from src (n of them before the range's
// end, zeros after), in 16-byte loads where the row's address allows it.
__device__ __forceinline__ void load_step(const float* src, int n,
                                          float (&x)[CRT_SEGSUM_STEP]) {
  if (n >= CRT_SEGSUM_STEP &&
      (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
#pragma unroll
    for (int i = 0; i < CRT_SEGSUM_STEP / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CRT_SEGSUM_STEP; ++i)
      x[i] = i < n ? __ldg(src + i) : 0.0f;
  }
}

// The id band [lo, hi] of the block's valid ids, from each lane's `ids`
// (hi < 0: none).  Uniform over the block.
__device__ __forceinline__ void id_band(const int (&ids)[CRT_SEGSUM_STEPS],
                                        int& lo, int& hi) {
  __shared__ int s_lo[CRT_SEGSUM_WARPS], s_hi[CRT_SEGSUM_WARPS];
  const unsigned full = 0xffffffffu;
  lo = 0x7fffffff;
  hi = -1;
#pragma unroll
  for (int m = 0; m < CRT_SEGSUM_STEPS; ++m) {
    if (ids[m] >= 0) {
      lo = min(lo, ids[m]);
      hi = max(hi, ids[m]);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(full, lo, s));
    hi = max(hi, __shfl_xor_sync(full, hi, s));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < CRT_SEGSUM_WARPS; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
}

// steps: the warp's range is steps * 32 rays (1 to CRT_SEGSUM_STEPS).
// own: the grid is this one block and the accumulators hold every id; it
// stores all of out, which nothing zeroed.
__global__ void __launch_bounds__(CRT_SEGSUM_BLOCK) segment_accumulate_kernel(
    SegArgs a, int acc_floats, int steps, bool own) {
  extern __shared__ float acc[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int range = steps * CRT_SEGSUM_STEP;
  const int r0 = (int)min(
      ((long long)blockIdx.x * CRT_SEGSUM_WARPS + warp) * range,
      (long long)a.R);
  const int r1 = min(r0 + range, a.R);

  // the warp's ids, every load in flight at once, and the block's id band
  int ids[CRT_SEGSUM_STEPS];
#pragma unroll
  for (int m = 0; m < CRT_SEGSUM_STEPS; ++m)
    ids[m] = ray_id(a, r0 + m * CRT_SEGSUM_STEP + lane, r1);
  int lo = 0, hi = a.T - 1;
  if (!own) {  // uniform over the block
    id_band(ids, lo, hi);
    if (hi < 0) return;  // no valid id in the block's rays
  }

  // the accumulators: a copy of [K, W] per warp where they fit, else none
  const int W = hi - lo + 1;
  const long long kw = (long long)a.K * W;
  const bool in_smem = kw * CRT_SEGSUM_WARPS <= acc_floats;
  if (in_smem) {
    for (int i = threadIdx.x; i < kw * CRT_SEGSUM_WARPS; i += CRT_SEGSUM_BLOCK)
      acc[i] = 0.0f;
    __syncthreads();
  }
  float* mine = acc + warp * kw;
  unsigned live = 0u;  // bit m: step m of the warp has a valid id
#pragma unroll
  for (int m = 0; m < CRT_SEGSUM_STEPS; ++m)
    if (__any_sync(full, ids[m] >= 0)) live |= 1u << m;

  for (int k0 = 0; k0 < a.K; k0 += 32) {
    const int k = k0 + lane;
    const bool row = k < a.K;
    const float* g_row = a.g + (long long)(row ? k : 0) * a.R;
    int run_id = -1;  // the run of equal ids this lane's row is summing
    float run = 0.0f;
    auto add_run = [&]() {
      if (!row || run_id < 0) return;
      if (in_smem)
        mine[k * W + (run_id - lo)] += run;
      else
        atomicAdd(&a.out[(long long)k * a.T + run_id], run);
    };
    auto take = [&](int id, float v) {  // uniform over the warp
      if (id != run_id) {
        add_run();
        run_id = id;
        run = 0.0f;
      }
      run += v;
    };
    for (unsigned rest = live; rest; rest &= rest - 1u) {  // live steps
      const int m = __ffs(rest) - 1;
      const int base = r0 + m * CRT_SEGSUM_STEP;
      float x[CRT_SEGSUM_STEP];
      if (row) load_step(g_row + base, r1 - base, x);
      int id = -1;
#pragma unroll
      for (int i = 0; i < CRT_SEGSUM_STEPS; ++i)
        if (i == m) id = ids[i];
      const int id0 = __shfl_sync(full, id, 0);
      if (__all_sync(full, id == id0)) {  // one id: a tree sum
        float p[CRT_SEGSUM_STEP / 4];
#pragma unroll
        for (int i = 0; i < CRT_SEGSUM_STEP / 4; ++i)
          p[i] = (x[4 * i] + x[4 * i + 1]) + (x[4 * i + 2] + x[4 * i + 3]);
        take(id0, ((p[0] + p[1]) + (p[2] + p[3])) +
                      ((p[4] + p[5]) + (p[6] + p[7])));
      } else {  // several: in ray order, the skipped ones left out
#pragma unroll
        for (int j = 0; j < CRT_SEGSUM_STEP; ++j) {
          const int id_j = __shfl_sync(full, id, j);
          if (id_j >= 0) take(id_j, x[j]);
        }
      }
    }
    add_run();
  }

  if (in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < kw; i += CRT_SEGSUM_BLOCK) {
      float v = acc[i];
      for (int c = 1; c < CRT_SEGSUM_WARPS; ++c) v += acc[c * kw + i];
      float* dst = &a.out[(long long)(i / W) * a.T + lo + i % W];
      if (own)
        *dst = v;
      else if (v != 0.0f)
        atomicAdd(dst, v);
    }
  }
}

}  // namespace

// Host entry, bound with ctypes.  g [K, R] f32, ids [R] i32 and out [K, T]
// f32 are contiguous device arrays on the device that owns `stream`, the
// current device; every element of out is written (zeroed here unless the
// launch owns it).  Returns the first CUDA error of the zeroing and the
// launch (cudaGetLastError() after it).
extern "C" int crt_segment_accumulate(const float* g, const int* ids, int K,
                                      int R, int T, float* out,
                                      void* stream) {
  if (K <= 0 || T <= 0 || R < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
  }
  // steps a warp: the fewest that still give every SM a block, at most 4
  const long long wave = (long long)sms * CRT_SEGSUM_BLOCK;
  const long long want = ((long long)R + wave - 1) / wave;
  const int steps = (int)(want < 1 ? 1
                          : want > CRT_SEGSUM_STEPS ? CRT_SEGSUM_STEPS
                                                    : want);
  const long long per_block = (long long)CRT_SEGSUM_BLOCK * steps;
  const long long blocks = ((long long)R + per_block - 1) / per_block;
  // the warps' accumulators: all T ids where K T fits 8 times, else the
  // most (a block's narrower band may still fit)
  const long long kt8 = (long long)K * T * CRT_SEGSUM_WARPS;
  const int acc_floats = (int)(kt8 < CRT_SEGSUM_ACC ? kt8 : CRT_SEGSUM_ACC);
  const bool own = blocks == 1 && kt8 <= CRT_SEGSUM_ACC;
  if (!own &&
      (err = cudaMemsetAsync(out, 0, (size_t)K * (size_t)T * sizeof(float),
                             st)) != cudaSuccess)
    return (int)err;
  if (R == 0) return 0;
  segment_accumulate_kernel<<<(unsigned)blocks, CRT_SEGSUM_BLOCK,
                              acc_floats * sizeof(float), st>>>(
      SegArgs{g, ids, K, R, T, out}, acc_floats, steps, own);
  return (int)cudaGetLastError();
}
