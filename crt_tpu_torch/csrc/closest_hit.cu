// K1: binned closest hit with emitted packed rows.
//
// Replaces crt_tpu/ops/pallas_trace.py `_trace_kernel` (body
// `_trace_tile_body`), launched there by `_closest_hit_binned`.
//
// What it computes: for each ray of a 1024-ray tile, the closest hit over
// the tile's binned list of 16-triangle clusters, walked in list order.
// Within a cluster the minimum t wins and, among equal t, the smallest
// triangle id; across clusters a later cluster replaces the running best
// only with a strictly smaller t, so an exact-t tie goes to the cluster
// walked first.  With kp > 0 it also writes the winning slot's kp packed
// attribute values (emit_rows_table) into rows_out [kp, R], coalesced over
// R; lanes with no hit get t = +inf, tri = -1 and zero rows.
//
// What bounds it on an H100: FP32 ALU work.  Each ray-cluster pair costs
// 16 x ~45 flops against 288 constants that every ray of the tile shares;
// the tables (a few KB for the benchmark scene, ~4.7 MB at 65k triangles)
// stay resident in the 50 MB L2, and ray I/O is 24 bytes in, 8 + 4 kp out.
//
// What the design does about it: one thread per ray, 256-thread blocks,
// grid (tile_rays / 256, tiles) so the four blocks of a tile walk the same
// cluster list.  Each walked cluster is staged once per block into shared
// memory (one global load per thread) and read back as broadcasts, so the
// inner loop is pure register arithmetic with no divergence except the
// winner bookkeeping.  A tile with an empty list writes the miss result
// without touching the tables.  The TPU kernel's 0/1 masked-sum row select
// becomes a plain copy of the winning slot's row: the same bits.

#include "cluster_common.cuh"

namespace {

__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ n, const float* __restrict__ nv0,
    const float* __restrict__ m, const float* __restrict__ c,
    const float* __restrict__ nobf, const int* __restrict__ tid,
    const int* __restrict__ cluster_list, const int* __restrict__ counts,
    const float* __restrict__ rows_table, int num_clusters, int tile_rays,
    int kp, long long num_rays, float* __restrict__ best_t_out,
    int* __restrict__ best_tri_out, float* __restrict__ rows_out) {
  __shared__ ClusterSmem s;
  const int tile = blockIdx.y;
  const long long r = (long long)tile * tile_rays +
                      (long long)blockIdx.x * CRT_BLOCK + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const int count = counts[tile];
  const int* list = cluster_list + (long long)tile * num_clusters;

  float best_t = CUDART_INF_F;
  int best_tri = -1;
  int best_slot = -1;
  for (int i = 0; i < count; ++i) {
    const int cl = list[i];
    __syncthreads();  // every thread is done with the previous cluster
    stage_cluster(s, cl, n, nv0, m, c, nobf, tid);
    __syncthreads();

    // lexicographic (t, id) minimum over the 16 members
    float cl_best = CUDART_INF_F;
    int cl_tri = 1 << 30;
    int cl_j = 0;
#pragma unroll
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
      const float t = member_t(s, j, ox, oy, oz, dx, dy, dz);
      const int id = s.tid[j];
      if (t < cl_best || (t == cl_best && id < cl_tri)) {
        cl_best = t;
        cl_tri = id;
        cl_j = j;
      }
    }
    if (cl_best < best_t) {  // strict: the first cluster walked wins ties
      best_t = cl_best;
      best_tri = cl_tri;
      best_slot = cl * CRT_CLUSTER_SIZE + cl_j;
    }
  }

  best_t_out[r] = best_t;
  best_tri_out[r] = best_tri;
  for (int k = 0; k < kp; ++k) {
    rows_out[(long long)k * num_rays + r] =
        best_slot >= 0 ? rows_table[(long long)best_slot * kp + k] : 0.0f;
  }
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int crt_closest_hit(
    const float* o, const float* d, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf, const int* tid,
    const int* cluster_list, const int* counts, const float* rows_table,
    int num_clusters, int num_tiles, int tile_rays, int kp, float* best_t,
    int* best_tri, float* rows_out, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(tile_rays / CRT_BLOCK, num_tiles);
  const long long num_rays = (long long)num_tiles * tile_rays;
  closest_hit_kernel<<<grid, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, n, nv0, m, c, nobf, tid, cluster_list, counts, rows_table,
      num_clusters, tile_rays, kp, num_rays, best_t, best_tri, rows_out);
  return (int)cudaGetLastError();
}
