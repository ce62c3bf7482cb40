// A design of K3, the segment sum, built and timed beside the kernel in
// crt_tpu_torch/csrc/segsum.cu and not taken (times in PERF.md, by
// measure/redesign_turns.py).  It is on no path of the port.
//
// What it computes is K3's, with K3's entry point: out[k, t] = sum over
// rays r with ids[r] == t of g[k, r].  The design: a lane per row, as in
// K3, on a persistent grid: as many warps as are resident on the card take
// contiguous ray ranges of equal length (whole steps of 32 rays) and walk
// them 32 rays a step, loading the next step's ids while the current one is
// summed; runs of equal ids are summed in registers and added into a copy
// of [K, W] per warp in shared memory over the block's id band (found by a
// pass over the block's ids only when all T ids do not fit), flushed with
// one global atomic per touched (k, id); a band too wide for it adds each
// run to global memory directly.
#include <cuda_runtime.h>
#include <cstdint>

#define BS_BLOCK 256
#define BS_WARPS (BS_BLOCK / 32)
#ifndef BS_ACC
#define BS_ACC 11776
#endif

namespace {

struct SegArgs {
  const float* g;
  const int* ids;
  int K, R, T;
  float* out;
};

__device__ __forceinline__ int load_id(const SegArgs& a, int r, int r1) {
  if (r >= r1) return -1;
  const int id = __ldg(a.ids + r);
  return (id >= 0 && id < a.T) ? id : -1;
}

__global__ void __launch_bounds__(BS_BLOCK) seg_b_kernel(SegArgs a, int per_warp) {
  extern __shared__ float acc[];
  __shared__ int s_lo[BS_WARPS], s_hi[BS_WARPS];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * BS_WARPS + w;
  const int r0 = (int)min(gw * per_warp, (long long)a.R);
  const int r1 = min(r0 + per_warp, a.R);
  // band of the block
  int lo = 0, W = a.T;
  if ((long long)a.K * a.T * BS_WARPS > BS_ACC) {
    int l = 0x7fffffff, h = -1;
    for (int r = r0 + lane; r < r1; r += 32) {
      const int id = load_id(a, r, r1);
      if (id >= 0) { l = min(l, id); h = max(h, id); }
    }
    for (int s = 16; s > 0; s >>= 1) {
      l = min(l, __shfl_xor_sync(full, l, s));
      h = max(h, __shfl_xor_sync(full, h, s));
    }
    if (lane == 0) { s_lo[w] = l; s_hi[w] = h; }
    __syncthreads();
    l = 0x7fffffff; h = -1;
    for (int i = 0; i < BS_WARPS; ++i) { l = min(l, s_lo[i]); h = max(h, s_hi[i]); }
    if (h < 0) return;
    lo = l; W = h - l + 1;
  }
  const long long kw = (long long)a.K * W;
  const int copies = kw * BS_WARPS <= BS_ACC ? BS_WARPS : 0;
  for (long long i = threadIdx.x; i < copies * kw; i += BS_BLOCK) acc[i] = 0.0f;
  __syncthreads();
  float* my = acc + (copies ? w * kw : 0);

  for (int k0 = 0; k0 < a.K; k0 += 32) {
    const int k = k0 + lane;
    const bool row = k < a.K;
    const float* grow = a.g + (long long)(row ? k : 0) * a.R;
    int run_id = -1;
    float run = 0.0f;
    auto flush = [&]() {
      if (row && run_id >= 0) {
        if (copies) my[k * W + (run_id - lo)] += run;
        else atomicAdd(&a.out[(long long)k * a.T + run_id], run);
      }
    };
    int nid = load_id(a, r0 + lane, r1);
    for (int base = r0; base < r1; base += 32) {
      const int id = nid;
      nid = load_id(a, base + 32 + lane, r1);
      const unsigned live = __ballot_sync(full, id >= 0);
      if (live == 0u) continue;
      float x[32];
      const float* src = grow + base;
      const int n = min(32, r1 - base);
      if (row) {
        if (n == 32 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
            x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z; x[4 * i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) x[i] = i < n ? __ldg(src + i) : 0.0f;
        }
      }
      const int id0 = __shfl_sync(full, id, 0);
      if (__all_sync(full, id == id0)) {  // one id (valid) for all 32 rays
        float s = 0.0f;
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = (x[4 * i] + x[4 * i + 1]) + (x[4 * i + 2] + x[4 * i + 3]);
        s = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
        if (id0 != run_id) { flush(); run_id = id0; run = 0.0f; }
        run += s;
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int ij = __shfl_sync(full, id, j);
          if (ij < 0) continue;
          if (ij != run_id) { flush(); run_id = ij; run = 0.0f; }
          run += x[j];
        }
      }
    }
    flush();
  }
  if (copies) {
    __syncthreads();
    for (long long i = threadIdx.x; i < kw; i += BS_BLOCK) {
      float v = acc[i];
      for (int c = 1; c < copies; ++c) v += acc[c * kw + i];
      if (v != 0.0f) atomicAdd(&a.out[(long long)(i / W) * a.T + lo + i % W], v);
    }
  }
}

}  // namespace

extern "C" int crt_segment_accumulate(const float* g, const int* ids, int K, int R, int T,
                                      float* out, void* stream) {
  if (K <= 0 || T <= 0 || R < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)K * T * sizeof(float), st);
  if (err != cudaSuccess || R == 0) return (int)err;
  const void* kernel = (const void*)seg_b_kernel;
  const int smem = BS_ACC * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BS_BLOCK, smem);
  long long warps = (long long)sms * (per_sm > 0 ? per_sm : 1) * BS_WARPS;
  long long groups = ((long long)R + 31) / 32;
  if (warps > groups) warps = groups;
  long long per = ((R + warps - 1) / warps + 31) / 32 * 32;
  long long nw = (R + per - 1) / per;
  long long grid = (nw + BS_WARPS - 1) / BS_WARPS;
  seg_b_kernel<<<(unsigned)grid, BS_BLOCK, smem, st>>>(SegArgs{g, ids, K, R, T, out}, (int)per);
  return (int)cudaGetLastError();
}
