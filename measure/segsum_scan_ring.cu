// A design of K3, the segment sum, built and timed beside the kernel in
// crt_tpu_torch/csrc/segsum.cu and not taken (times in PERF.md, by
// measure/redesign_turns.py).  It is on no path of the port.
//
// What it computes is K3's: out[k, t] = sum over rays r with ids[r] == t
// of g[k, r], g [K, R] f32 with rays on the minor axis, ids [R] i32 (ids
// outside [0, T) skipped), out [K, T] f32, zeroed by the entry point.  Its
// entry point has K3's signature.
//
// The design, one point per thing that held the earlier kernel (a block
// per 4,096 rays, a band pass before any row was read, 8 rows of 32 rays
// in flight per warp, then a shuffle tree per group of equal ids):
//   - A persistent grid.  As many 256-thread blocks as are resident on the
//     card at once take contiguous ray ranges of equal length (cut at
//     multiples of 4 rays), so the waves are even.
//   - Staging through a ring.  A block streams its range in chunks of
//     CRT_SEGSUM_CHUNK rays; each chunk is its ids row and its K g rows,
//     copied by cp.async (16 bytes a thread where the row's address allows
//     it, else 4-byte copies) in slots of CRT_SEGSUM_ROWS rows, a ring of
//     CRT_SEGSUM_SLOTS slots: CRT_SEGSUM_SLOTS - 1 slots are in flight
//     while one is reduced.  Rows of any K and any R (a row k starts at
//     element k * R, 16-byte aligned only when that divides by 4) take the
//     same ring.  The first slots are issued before the band pass, which
//     then overlaps them.
//   - Runs found once a chunk.  A thread takes 4 consecutive rays.  Its
//     ids give the run boundaries inside it, its neighbours' (one shuffle
//     each way) those at its edges, and the flags of a warp's segmented
//     scan (Hillis-Steele, 5 rounds) are folded into 5 bits, once per
//     chunk.  Each g row then costs a fold of the thread's last run, 5
//     shuffles with the precomputed adds (the sum of each run over the
//     lanes before it), and one add per run end, in place of a peer match
//     and a tree per group.
//   - Contention: a few triangles own most rays (a floor fills half the
//     frame).  A run adds once per warp it touches, into a shared-memory
//     accumulator [K, W] over the block's id band [lo, hi] (found by one
//     pass over the block's ids; consecutive rays are one pixel tile and
//     Morton ranks of neighbouring triangles are close, so the band is
//     narrow); the block flushes one partial per touched (k, id) to global
//     memory at the end.  A band too wide for it (K * W > CRT_SEGSUM_ACC,
//     as at 65,536 triangles and more) sends the run sums to global memory
//     directly: wide bands mean many distinct ids, hence little contention.
//   - Accuracy: the sum is hierarchical (a thread's 4 rays, the warp's
//     scan, the block's warp partials, then the blocks), so a segment of
//     10^6 rays sees about 4 + 5 + (rays of a block) / 128 + (blocks)
//     sequential f32 additions, not 10^6.
//   - The shared and global stages use atomics, so the order of the
//     partials, and with it the last bits, can change from run to run.
//     That is the port's determinism contract, settled as "forward only",
//     which is what crt_tpu checks (crt_tpu/utils/checks.py compares two
//     renders): two forward renders give the same bits (the card test
//     test_forward_render_is_deterministic, chip_smoke.py's [big]); a
//     gradient through this kernel is held to its stated tolerance and may
//     differ in the last bits between runs.

#include <cuda_runtime.h>

#include <cstdint>

#define CRT_SEGSUM_BLOCK 256
#define CRT_SEGSUM_WARPS (CRT_SEGSUM_BLOCK / 32)
#define CRT_SEGSUM_CHUNK (4 * CRT_SEGSUM_BLOCK)  // rays of a chunk
#define CRT_SEGSUM_ROWS 4                        // rows of a slot
#define CRT_SEGSUM_SLOTS 4                       // slots in the ring
#define CRT_SEGSUM_SLOT_FLOATS (CRT_SEGSUM_ROWS * CRT_SEGSUM_CHUNK)
#define CRT_SEGSUM_ACC 11776  // floats of shared accumulator
// 64 KB of ring and 46 KB of accumulator: two blocks a multiprocessor
#define CRT_SEGSUM_SMEM \
  ((CRT_SEGSUM_SLOTS * CRT_SEGSUM_SLOT_FLOATS + CRT_SEGSUM_ACC) * 4)

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct SegArgs {
  const float* g;
  const int* ids;
  int K, R, T;
  float* out;
};

// The block's rays [r0, r1) and chunk count.
struct Range {
  int r0, r1, chunks;
};

// This thread's 4 ids of chunk `chunk` of the block's range (-1 past its
// end), loaded a chunk ahead of the copies that need them.
__device__ __forceinline__ int4 chunk_ids(const SegArgs& a, const Range& rg,
                                          int chunk) {
  const int r = rg.r0 + chunk * CRT_SEGSUM_CHUNK + 4 * (int)threadIdx.x;
  if (chunk >= rg.chunks || r >= rg.r1) return make_int4(-1, -1, -1, -1);
  if (r + 4 <= rg.r1 &&
      (reinterpret_cast<uintptr_t>(a.ids + r) & 15u) == 0)
    return __ldg(reinterpret_cast<const int4*>(a.ids + r));
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = r + i < rg.r1 ? __ldg(a.ids + r + i) : -1;
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ bool valid_id(int id, int T) {
  return id >= 0 && id < T;
}

// Fill slot `s` of the block's walk (chunk s / groups, rows
// [R q, R q + R) of {ids, g row 0, ..., g row K-1}, R = CRT_SEGSUM_ROWS,
// q = s % groups) in ring place s % CRT_SEGSUM_SLOTS: the thread's ids
// (`ids`, its 4 of the chunk) stored, its 4 values of each g row copied by
// cp.async, and only where one of its 4 ids is valid (misses and skipped
// ids cost no g bytes; the reduction never reads their values).  Commits
// one cp.async group, empty past the walk (uniform over the block).
__device__ __forceinline__ void issue_slot(float* ring, const SegArgs& a,
                                           const Range& rg, int groups,
                                           int s, int4 ids) {
  if (s < rg.chunks * groups) {
    const int c0 = rg.r0 + (s / groups) * CRT_SEGSUM_CHUNK;
    const int n = min(CRT_SEGSUM_CHUNK, rg.r1 - c0);
    const int q = s % groups;
    float* slot = ring + (s % CRT_SEGSUM_SLOTS) * CRT_SEGSUM_SLOT_FLOATS;
    const int e = 4 * threadIdx.x;
    const int j0 = CRT_SEGSUM_ROWS * q;
    const bool live = valid_id(ids.x, a.T) || valid_id(ids.y, a.T) ||
                      valid_id(ids.z, a.T) || valid_id(ids.w, a.T);
    for (int j = j0; j < min(j0 + CRT_SEGSUM_ROWS, a.K + 1); ++j) {
      float* dst = slot + (j - j0) * CRT_SEGSUM_CHUNK + e;
      if (j == 0) {
        *reinterpret_cast<int4*>(dst) = ids;
        continue;
      }
      if (!live) continue;
      const float* src = a.g + (long long)(j - 1) * a.R + c0;
      if (e + 4 <= n && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        cp_async16(dst, src + e);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e + i < n) cp_async4(dst + i, src + e + i);
      }
    }
  }
  cp_async_commit();
}

// The id band [lo, hi] of the block's valid ids (hi < 0: none).
__device__ __forceinline__ void id_band(const SegArgs& a, const Range& rg,
                                        int& lo, int& hi) {
  __shared__ int s_lo[CRT_SEGSUM_WARPS], s_hi[CRT_SEGSUM_WARPS];
  const unsigned full = 0xffffffffu;
  lo = 0x7fffffff;
  hi = -1;
  auto take = [&](int id) {
    if (id >= 0 && id < a.T) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  };
  // 4 ids a thread a step, several steps' loads in flight
  const bool vec = (reinterpret_cast<uintptr_t>(a.ids + rg.r0) & 15u) == 0;
#pragma unroll 4
  for (int r = rg.r0 + 4 * (int)threadIdx.x; r < rg.r1;
       r += 4 * CRT_SEGSUM_BLOCK) {
    if (vec && r + 4 <= rg.r1) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(a.ids + r));
      take(v.x);
      take(v.y);
      take(v.z);
      take(v.w);
    } else {
      for (int i = r; i < min(r + 4, rg.r1); ++i) take(__ldg(a.ids + i));
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

// A thread's 4 rays of the current chunk: their ids (-1 where skipped),
// where runs end among them, and the warp scan's adds.
struct Runs {
  int id[4];
  bool end[4];   // a run ends at ray p (the next ray has another id)
  bool cont;     // ray 0 continues the run of the lane before
  bool b1, b2, b3, whole;  // boundaries inside the thread
  unsigned add;  // bit i: round i of the scan adds the lane 2^i below
  bool any;      // some ray of the warp has a valid id
};

__device__ __forceinline__ Runs find_runs(const int4 raw, int T) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  Runs u;
  const int v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) u.id[p] = (v[p] >= 0 && v[p] < T) ? v[p] : -1;
  u.b1 = u.id[1] != u.id[0];
  u.b2 = u.id[2] != u.id[1];
  u.b3 = u.id[3] != u.id[2];
  u.whole = !u.b1 && !u.b2 && !u.b3;
  u.any = __any_sync(full, u.id[0] >= 0 || u.id[1] >= 0 || u.id[2] >= 0 ||
                               u.id[3] >= 0);
  const int prev_tail = __shfl_up_sync(full, u.id[3], 1);
  const int next_head = __shfl_down_sync(full, u.id[0], 1);
  u.cont = lane > 0 && prev_tail == u.id[0];
  u.end[0] = u.b1;
  u.end[1] = u.b2;
  u.end[2] = u.b3;
  // a run still open at the warp's last lane is added there too: runs
  // cross warps and chunks as partial sums
  u.end[3] = lane == 31 || next_head != u.id[3];
  // segmented scan of the lanes' last-run sums: a lane's sum goes on from
  // the lane before only when the whole lane continues its run
  bool head = !(u.whole && u.cont);
  u.add = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 1 << i;
    const bool other = __shfl_up_sync(full, head, s);
    if (lane >= s) {
      if (!head) u.add |= 1u << i;
      head = head || other;
    }
  }
  return u;
}

__device__ __forceinline__ void add_run(const SegArgs& a, float* acc,
                                        bool in_smem, int W, int lo, int k,
                                        int id, float v) {
  if (id < 0) return;
  if (in_smem)
    atomicAdd(&acc[k * W + (id - lo)], v);
  else
    atomicAdd(&a.out[(long long)k * a.T + id], v);
}

// Rows k0 .. k0 + CRT_SEGSUM_ROWS - 1 of the chunk (those in [0, K)) for
// this thread's 4 rays x[i]: each run's sum goes to the accumulator once,
// where it ends in this thread.  The rows are independent, so their
// shuffles interleave.
__device__ __forceinline__ void reduce_rows(const SegArgs& a, const Runs& u,
                                            const float4 (&x)[CRT_SEGSUM_ROWS],
                                            int k0, float* acc, bool in_smem,
                                            int W, int lo) {
  const unsigned full = 0xffffffffu;
  float scan[CRT_SEGSUM_ROWS];
#pragma unroll
  for (int i = 0; i < CRT_SEGSUM_ROWS; ++i) {
    // the sum of the thread's last run, then its sum from the run's start
    float tail = x[i].w;
    if (!u.b3) tail = x[i].z + tail;
    if (!u.b3 && !u.b2) tail = x[i].y + tail;
    if (u.whole) tail = x[i].x + tail;
    scan[i] = tail;
  }
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < CRT_SEGSUM_ROWS; ++i) {
      const float o = __shfl_up_sync(full, scan[i], 1 << r);
      if ((u.add >> r) & 1u) scan[i] += o;
    }
  }
#pragma unroll
  for (int i = 0; i < CRT_SEGSUM_ROWS; ++i) {
    const float before = __shfl_up_sync(full, scan[i], 1);
    const int k = k0 + i;
    if (k < 0 || k >= a.K) continue;  // the ids row, or past the last row
    float run = u.cont ? before + x[i].x : x[i].x;
    if (u.end[0]) {
      add_run(a, acc, in_smem, W, lo, k, u.id[0], run);
      run = x[i].y;
    } else {
      run += x[i].y;
    }
    if (u.end[1]) {
      add_run(a, acc, in_smem, W, lo, k, u.id[1], run);
      run = x[i].z;
    } else {
      run += x[i].z;
    }
    if (u.end[2]) {
      add_run(a, acc, in_smem, W, lo, k, u.id[2], run);
      run = x[i].w;
    } else {
      run += x[i].w;
    }
    if (u.end[3]) add_run(a, acc, in_smem, W, lo, k, u.id[3], run);
  }
}

__global__ void __launch_bounds__(CRT_SEGSUM_BLOCK) segment_accumulate_kernel(
    SegArgs a, int per_block) {
  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* acc = ring + CRT_SEGSUM_SLOTS * CRT_SEGSUM_SLOT_FLOATS;
  Range rg;
  rg.r0 = (int)min((long long)blockIdx.x * per_block, (long long)a.R);
  rg.r1 = min(rg.r0 + per_block, a.R);
  rg.chunks = (rg.r1 - rg.r0 + CRT_SEGSUM_CHUNK - 1) / CRT_SEGSUM_CHUNK;
  const int groups = (a.K + 1 + CRT_SEGSUM_ROWS - 1) / CRT_SEGSUM_ROWS;
  const int slots = rg.chunks * groups;

  // the producer's ids: of the chunk it issues, and of the next one
  int pchunk = 0;
  int4 pids = chunk_ids(a, rg, 0), nids = chunk_ids(a, rg, 1);
  auto issue = [&](int sp) {
    if (sp % groups == 0 && sp / groups > pchunk) {
      pids = nids;
      ++pchunk;
      nids = chunk_ids(a, rg, pchunk + 1);
    }
    issue_slot(ring, a, rg, groups, sp, pids);
  };
#pragma unroll
  for (int s = 0; s < CRT_SEGSUM_SLOTS - 1; ++s) issue(s);

  // The accumulator: a copy per warp where K x T fits that many times (no
  // warp waits on another's adds), else one over the block's id band, else
  // none (direct global adds).
  int lo = 0, W = a.T;
  if ((long long)a.K * a.T * CRT_SEGSUM_WARPS > CRT_SEGSUM_ACC) {
    int hi;
    id_band(a, rg, lo, hi);
    if (hi < 0) {  // no valid id in the block's range (uniform)
      cp_async_wait<0>();
      return;
    }
    W = hi - lo + 1;
  }
  const long long kw = (long long)a.K * W;
  const int copies = kw * CRT_SEGSUM_WARPS <= CRT_SEGSUM_ACC ? CRT_SEGSUM_WARPS
                     : kw <= CRT_SEGSUM_ACC                  ? 1
                                                             : 0;
  const bool in_smem = copies > 0;
  for (int i = threadIdx.x; i < copies * kw; i += CRT_SEGSUM_BLOCK)
    acc[i] = 0.0f;
  float* my_acc =
      acc + (copies == CRT_SEGSUM_WARPS ? (threadIdx.x >> 5) * kw : 0);
  __syncthreads();  // the accumulator is zeroed

  // A thread reads back only the ring columns it filled itself, so the
  // walk needs no barrier: each warp streams at its own pace.
  Runs u;
  for (int s = 0; s < slots; ++s) {
    cp_async_wait<CRT_SEGSUM_SLOTS - 2>();  // this thread's copies of s
    issue(s + CRT_SEGSUM_SLOTS - 1);
    const float* slot =
        ring + (s % CRT_SEGSUM_SLOTS) * CRT_SEGSUM_SLOT_FLOATS +
        4 * threadIdx.x;
    float4 x[CRT_SEGSUM_ROWS];
#pragma unroll
    for (int i = 0; i < CRT_SEGSUM_ROWS; ++i)
      x[i] = *reinterpret_cast<const float4*>(slot + i * CRT_SEGSUM_CHUNK);
    const int q = s % groups;
    if (q == 0)  // the chunk's ids row
      u = find_runs(make_int4(__float_as_int(x[0].x), __float_as_int(x[0].y),
                              __float_as_int(x[0].z), __float_as_int(x[0].w)),
                    a.T);
    if (u.any)  // uniform over the warp: its 128 rays hold a valid id
      reduce_rows(a, u, x, CRT_SEGSUM_ROWS * q - 1, my_acc, in_smem, W, lo);
  }
  cp_async_wait<0>();

  if (in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < kw; i += CRT_SEGSUM_BLOCK) {
      float v = acc[i];
      for (int c = 1; c < copies; ++c) v += acc[c * kw + i];
      if (v != 0.0f)
        atomicAdd(&a.out[(long long)(i / W) * a.T + lo + i % W], v);
    }
  }
}

}  // namespace

// Host entry, bound with ctypes.  g [K, R] f32, ids [R] i32 and out [K, T]
// f32 are contiguous device arrays on the device that owns `stream`; out
// is zeroed here.  Returns the first CUDA error of the zeroing and the
// launch (cudaGetLastError() after it).
extern "C" int crt_segment_accumulate(const float* g, const int* ids, int K,
                                      int R, int T, float* out,
                                      void* stream) {
  if (K <= 0 || T <= 0 || R < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)K * (size_t)T * sizeof(float), st);
  if (err != cudaSuccess || R == 0) return (int)err;
  const void* kernel = (const void*)segment_accumulate_kernel;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           CRT_SEGSUM_SMEM)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, CRT_SEGSUM_BLOCK, CRT_SEGSUM_SMEM)) !=
          cudaSuccess)
    return (int)err;
  // equal ranges of whole 4-ray groups, at most one block per chunk
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long chunks = ((long long)R + CRT_SEGSUM_CHUNK - 1) /
                           CRT_SEGSUM_CHUNK;
  long long grid = chunks < full ? chunks : full;
  const long long per = (((long long)R + grid - 1) / grid + 3) / 4 * 4;
  grid = ((long long)R + per - 1) / per;
  segment_accumulate_kernel<<<(unsigned)grid, CRT_SEGSUM_BLOCK,
                              CRT_SEGSUM_SMEM, st>>>(
      SegArgs{g, ids, K, R, T, out}, (int)per);
  return (int)cudaGetLastError();
}
