// Shared pieces of the cluster-walk kernels (closest_hit.cu, occlusion_w.cu,
// occlusion_d.cu, stream_trace.cu).
//
// A cluster is 16 Morton-consecutive triangles.  Its test constants live in
// the cluster-major tables built by crt_tpu_torch/ops/cluster_tables.py
// (the rows layout of the streaming kernels):
//   n [L,16,3], nv0 [L,16], m [L,16,9], c [L,16,3], nobf [L,16], tid [L,16].
// Two ways to stage them in shared memory:
//   - stage_cluster (occlusion_d.cu): a 256-thread block copies one
//     cluster's constants (256 floats + 16 nobf) with one load per thread,
//     two barriers a cluster, for member_hit;
//   - ClusterRing (closest_hit.cu, occlusion_w.cu): batches of CRT_BATCH
//     clusters copied by cp.async into member-major records, a ring of
//     CRT_STAGES batches, one barrier a batch; stream_trace.cu stages the
//     same records from its own tables.
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
};

// Block-cooperative copy of cluster `cl` into shared memory.  Needs exactly
// CRT_BLOCK threads: 48 + 16 + 144 + 48 = 256 floats, one per thread, then
// nobf on the first 16.
__device__ __forceinline__ void stage_cluster(
    ClusterSmem& s, int cl, const float* __restrict__ n,
    const float* __restrict__ nv0, const float* __restrict__ m,
    const float* __restrict__ c, const float* __restrict__ nobf) {
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
  if (t < CRT_CLUSTER_SIZE) s.nobf[t] = nobf[base + t];
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

// ---------------------------------------------------------------------------
// Member-major records
// ---------------------------------------------------------------------------
//
// A slot's record is 20 floats, five 16-byte words, so a test reads it with
// five 16-byte shared loads:
//   {n.x n.y n.z nv0} {m0 m1 m2 c0} {m3 m4 m5 c1} {m6 m7 m8 c2}
//   {nobf, id (int bits), member mask, unused}
// (stream_trace.cu fills the first 17 floats; its ids stay in global
// memory).
#define CRT_SLOT_FLOATS 20
#define CRT_RECORD_ID 17
#define CRT_RECORD_MASK 18

// Place of fused column `col` (< 17: n xyz | nv0 | m (9) | c (3) | nobf) in
// a slot's record.
__device__ __forceinline__ int record_pos(int col) {
  if (col < 4) return col;
  if (col < 13) return 4 + 4 * ((col - 4) / 3) + (col - 4) % 3;
  if (col < 16) return 7 + 4 * (col - 13);
  return 16;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
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

// ---------------------------------------------------------------------------
// The batched ring of the cluster kernels (K1, K4, K7, K2)
// ---------------------------------------------------------------------------

#define CRT_BATCH 8   // clusters staged per barrier
#define CRT_STAGES 3  // batches in the ring
#define CRT_CLUSTER_FLOATS (CRT_CLUSTER_SIZE * CRT_SLOT_FLOATS)  // 320
#define CRT_BATCH_FLOATS (CRT_BATCH * CRT_CLUSTER_FLOATS)

// 30,720 bytes of records, the batches' cluster ids and (closest_hit.cu)
// per cluster the members no ray of the block can hit.
struct ClusterRing {
  alignas(16) float rec[CRT_STAGES * CRT_BATCH_FLOATS];
  int cl[CRT_STAGES * CRT_BATCH];
  unsigned skip[CRT_STAGES * CRT_BATCH];
};

// One float of a cluster that this thread copies: it lies at
// src + cluster * per_cluster + off and goes to rec[dst] of the cluster's
// record image.
struct ClusterCopy {
  const float* src;
  int per_cluster;
  int off;
  int dst;
};

// The tables of a walk: the six arrays of cluster_tables.py and, where a
// kernel restricts hits to a subset, the member mask [L,16] (else null).
struct ClusterTables {
  const float* n;
  const float* nv0;
  const float* m;
  const float* c;
  const float* nobf;
  const int* tid;
  const float* gm;
};

// The plan of float f (< 256) of the 256 n | nv0 | m | c floats, or (f >=
// 256) of the 16-float column k = (f - 256) / 16 of {nobf, id, mask}.
__device__ __forceinline__ ClusterCopy cluster_copy(const ClusterTables& tb,
                                                    int f) {
  ClusterCopy p;
  if (f < 48) {
    p = {tb.n, 48, f, (f / 3) * CRT_SLOT_FLOATS + f % 3};
  } else if (f < 64) {
    const int e = f - 48;
    p = {tb.nv0, 16, e, e * CRT_SLOT_FLOATS + 3};
  } else if (f < 208) {
    const int e = f - 64;
    p = {tb.m, 144, e, (e / 9) * CRT_SLOT_FLOATS + record_pos(4 + e % 9)};
  } else if (f < 256) {
    const int e = f - 208;
    p = {tb.c, 48, e, (e / 3) * CRT_SLOT_FLOATS + record_pos(13 + e % 3)};
  } else {
    const int k = (f - 256) / 16, e = (f - 256) % 16;
    const float* col = k == 0   ? tb.nobf
                       : k == 1 ? reinterpret_cast<const float*>(tb.tid)
                                : tb.gm;
    p = {col, 16, e, e * CRT_SLOT_FLOATS + 16 + k};
  }
  return p;
}

// A thread's two copies of every staged cluster: float threadIdx.x of the
// 256, and, on the first 16 threads nobf, on the next 16 the ids (when the
// tables carry them), on the next 16 the member mask (when they carry it).
struct ClusterPlan {
  ClusterCopy a, b;
  bool has_b;
  __device__ __forceinline__ explicit ClusterPlan(const ClusterTables& tb) {
    const int t = threadIdx.x;
    a = cluster_copy(tb, t);
    has_b = t < 16 || (t < 32 && tb.tid != nullptr) ||
            (t >= 32 && t < 48 && tb.gm != nullptr);
    b = cluster_copy(tb, has_b ? 256 + t : 256);
  }
};

// Stage clusters list[i0 .. i0 + count) into batch `stage` of the ring and
// commit them as one cp.async group, empty or not (uniform over the
// block).  Needs CRT_BLOCK threads.
__device__ __forceinline__ void issue_clusters(ClusterRing& ring, int stage,
                                               const int* __restrict__ list,
                                               int i0, int count,
                                               const ClusterPlan& pl) {
  float* img = ring.rec + stage * CRT_BATCH_FLOATS;
  for (int k = 0; k < count; ++k) {
    const long long cl = list[i0 + k];
    float* rec = img + k * CRT_CLUSTER_FLOATS;
    cp_async4(rec + pl.a.dst, pl.a.src + cl * pl.a.per_cluster + pl.a.off);
    if (pl.has_b)
      cp_async4(rec + pl.b.dst, pl.b.src + cl * pl.b.per_cluster + pl.b.off);
  }
  if ((int)threadIdx.x < count)
    ring.cl[stage * CRT_BATCH + threadIdx.x] = list[i0 + threadIdx.x];
  cp_async_commit();
}

// The clusters of batch bi of a walk of `count` clusters.
__device__ __forceinline__ int batch_size(int bi, int count) {
  return bi * CRT_BATCH < count ? min(CRT_BATCH, count - bi * CRT_BATCH) : 0;
}

// A slot's plane word and tail word, and edge word e.
__device__ __forceinline__ float4 rec_word(const float* slot, int w) {
  return *reinterpret_cast<const float4*>(slot + 4 * w);
}

// The three edge half-spaces of a slot (mo - c) + t * md >= 0, as
// member_hit computes them.
__device__ __forceinline__ bool rec_edges(const float* slot, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t) {
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float4 me = rec_word(slot, 1 + e);
    const float md = me.x * dx + me.y * dy + me.z * dz;
    const float mo = me.x * ox + me.y * oy + me.z * oz;
    ok = ok && ((mo - me.w) + t * md >= 0.0f);
  }
  return ok;
}

// The persistent schedule: block b takes units b, b + G, b + 2G, ... (G the
// grid) and calls visit(u, count) for each, count the list length of its
// tile (units_per_tile units a tile).  The counts of CRT_BLOCK units are
// read at once into `s_count`, so a unit with an empty list costs no load
// latency.  Uniform over the block.
template <typename Visit>
__device__ __forceinline__ void for_each_unit(long long units,
                                              int units_per_tile,
                                              const int* __restrict__ counts,
                                              int* s_count, Visit visit) {
  for (long long u0 = blockIdx.x; u0 < units;
       u0 += (long long)CRT_BLOCK * gridDim.x) {
    __syncthreads();  // the previous chunk's counts are read
    const long long mine = u0 + (long long)threadIdx.x * gridDim.x;
    s_count[threadIdx.x] = mine < units ? counts[mine / units_per_tile] : 0;
    __syncthreads();
    for (int k = 0; k < CRT_BLOCK; ++k) {
      const long long u = u0 + (long long)k * gridDim.x;
      if (u >= units) break;
      visit(u, s_count[k]);
    }
  }
}

// The number of blocks of a persistent launch of `kernel`: as many as are
// resident at once on the current device, at most `units`.  0 on an error
// (the caller then returns cudaGetLastError()).
inline long long persistent_grid(const void* kernel, long long units) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    CRT_BLOCK, 0) !=
          cudaSuccess)
    return 0;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return units < full ? units : full;
}
