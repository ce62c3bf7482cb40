// Shared pieces of the cluster-walk kernels (closest_hit.cu, occlusion_w.cu,
// occlusion_d.cu; stream_trace.cu stages its own member-major records).
//
// A cluster is 16 Morton-consecutive triangles.  Its test constants live in
// the cluster-major tables built by crt_tpu_torch/ops/cluster_tables.py
// (the rows layout of the streaming kernels):
//   n [L,16,3], nv0 [L,16], m [L,16,9], c [L,16,3], nobf [L,16], tid [L,16].
// A 256-thread block stages one cluster's constants (256 floats + 16 nobf +
// 16 ids, and where a kernel restricts hits to a triangle subset the 16
// floats of its member mask) in shared memory with one load per thread,
// then every thread tests its own ray against the 16 members.
//
// Arithmetic follows crt_tpu/ops/pallas_trace.py:1242-1267 operation by
// operation.  The library is built with -fmad=false and without fast math,
// so every a*b+c rounds twice and every division is IEEE, exactly as the
// PyTorch plain versions round: the kernels are held to them bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define CRT_CLUSTER_SIZE 16
#define CRT_BLOCK 256
#define CRT_PARALLEL_EPS 1e-6f

struct ClusterSmem {
  float n[CRT_CLUSTER_SIZE * 3];
  float nv0[CRT_CLUSTER_SIZE];
  float m[CRT_CLUSTER_SIZE * 9];
  float c[CRT_CLUSTER_SIZE * 3];
  float nobf[CRT_CLUSTER_SIZE];
  int tid[CRT_CLUSTER_SIZE];
  float gm[CRT_CLUSTER_SIZE];  // member mask [L,16]: 1.0 = in the subset
};

// Block-cooperative copy of cluster `cl` into shared memory.  Needs exactly
// CRT_BLOCK threads: 48 + 16 + 144 + 48 = 256 floats, one per thread, then
// nobf and ids on the first 16 and the member mask on the next 16.  `tid`
// may be null (the occlusion kernel needs no ids), and so may `gm`.
__device__ __forceinline__ void stage_cluster(
    ClusterSmem& s, int cl, const float* __restrict__ n,
    const float* __restrict__ nv0, const float* __restrict__ m,
    const float* __restrict__ c, const float* __restrict__ nobf,
    const int* __restrict__ tid, const float* __restrict__ gm = nullptr) {
  const int t = threadIdx.x;
  const long long base = (long long)cl * CRT_CLUSTER_SIZE;
  if (t < 48) {
    s.n[t] = n[base * 3 + t];
  } else if (t < 64) {
    s.nv0[t - 48] = nv0[base + (t - 48)];
  } else if (t < 208) {
    s.m[t - 64] = m[base * 9 + (t - 64)];
  } else {
    s.c[t - 208] = c[base * 3 + (t - 208)];
  }
  if (t < CRT_CLUSTER_SIZE) {
    s.nobf[t] = nobf[base + t];
    if (tid != nullptr) s.tid[t] = tid[base + t];
  } else if (t < 2 * CRT_CLUSTER_SIZE && gm != nullptr) {
    s.gm[t - CRT_CLUSTER_SIZE] = gm[base + (t - CRT_CLUSTER_SIZE)];
  }
}

// The streaming backend's fused-column tables hold, per slot, 18 columns:
// n xyz | nv0 | m (9) | c (3) | nobf | id as f32
// (crt_tpu_torch/ops/stream_binning.py build_fused_table); the kernels read
// the first 17 and take ids from the int32 `tid` table beside them.
#define CRT_FUSED_COLS 18

// Whether the line (ox,oy,oz) + t*(dx,dy,dz) hits member j of the staged
// cluster at t >= 0, and that t: plane test with the PARALLEL_EPS gate, the
// backface gate, t >= 0, then the three edge half-spaces
// (mo - c) + t*md >= 0.  Dot products sum x, y, z left to right.
__device__ __forceinline__ bool member_hit(const ClusterSmem& s, int j,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float& t) {
  const float nx = s.n[3 * j], ny = s.n[3 * j + 1], nz = s.n[3 * j + 2];
  const float nd = nx * dx + ny * dy + nz * dz;
  const float no = nx * ox + ny * oy + nz * oz;
  const float opd = s.nv0[j] - no;
  const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
  const bool face_ok = (opd < 0.0f) || (s.nobf[j] > 0.5f);
  t = opd / (not_parallel ? nd : 1.0f);
  bool valid = not_parallel && face_ok && (t >= 0.0f);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* me = &s.m[9 * j + 3 * e];
    const float md = me[0] * dx + me[1] * dy + me[2] * dz;
    const float mo = me[0] * ox + me[1] * oy + me[2] * oz;
    valid = valid && ((mo - s.c[3 * j + e]) + t * md >= 0.0f);
  }
  return valid;
}

// The hit distance of member j, or +inf when it is not hit.
__device__ __forceinline__ float member_t(const ClusterSmem& s, int j,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  float t;
  return member_hit(s, j, ox, oy, oz, dx, dy, dz, t) ? t : CUDART_INF_F;
}
