// K1: binned closest hit with emitted packed rows; K4: the same over the
// live tiles only; K7: the same with `merge` tiles per block.
//
// K1 replaces crt_tpu/ops/pallas_trace.py `_trace_kernel` (body
// `_trace_tile_body`), launched there by `_closest_hit_binned`; K4 replaces
// `_trace_kernel_compact`, launched by `_closest_hit_binned_compact`; K7
// replaces `_trace_kernel_merged`, launched by `_closest_hit_binned_merged`
// when CRT_TILE_MERGE > 1.
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
// tile_rays / 256 consecutive blocks per tile, so the four blocks of a tile
// walk the same cluster list.  Each walked cluster is staged once per block
// into shared memory (one global load per thread) and read back as
// broadcasts, so the inner loop is pure register arithmetic with no
// divergence except the winner bookkeeping.  A tile with an empty list
// writes the miss result without touching the tables.  The TPU kernel's 0/1
// masked-sum row select becomes a plain copy of the winning slot's row: the
// same bits.
//
// K4 (live-tile compaction).  A sparse wavefront (a bounce pool whose banks
// are mostly dead) leaves most tiles with an empty list.  `tile_ids` is a
// permutation of the tiles with the `n_live` live ones first, built on the
// device; block group p takes tile tile_ids[p], so the blocks that have a
// walk to do are scheduled first and together.  Origins are read from tile
// tile_ids[p] % tile_mod when tile_mod > 0 (per-light shadow tiles share
// one copy of the pixel origins).  The grid covers every tile and reads
// n_live on the device, so the launch needs no device-to-host read: group
// p >= n_live writes its dead tile's miss result (t = +inf, tri = -1, rows
// 0) and returns.  The walk is K1's, so the outputs are K1's bit for bit.
//
// K7 (tile merging).  On the TPU one grid step walks `merge` consecutive
// tiles' lists back to back on static lane windows of one fat block, which
// amortises the per-step fixed cost over sparse lists (about 1.6 clusters
// a tile) while the binning stays at 1024-ray tiles.  Here block (g, b) of
// a (tiles / merge) x (tile_rays / 256) grid runs K1's walk for lanes
// b*256 .. b*256+255 of tiles g*merge + sub, sub = 0 .. merge-1, in turn:
// fewer, longer blocks over the same walks.  A sub-tile with an empty list
// writes its miss result and the loop goes on; the next sub-tile's first
// barrier still orders its staging after every read of the cluster staged
// before.  A cluster staged for one sub-tile is not kept for the next even
// when that list starts with the same id.  The walk and the tie rule are
// K1's, so the outputs are K1's bit for bit.

#include "cluster_common.cuh"

namespace {

// The walk of one block over its tile's list: rays `r_o` (origin) and `r`
// (direction, outputs), list and count of `tile`.
__device__ __forceinline__ void walk_tile(
    ClusterSmem& s, long long r_o, long long r, int tile,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ n, const float* __restrict__ nv0,
    const float* __restrict__ m, const float* __restrict__ c,
    const float* __restrict__ nobf, const int* __restrict__ tid,
    const int* __restrict__ cluster_list, const int* __restrict__ counts,
    const float* __restrict__ rows_table, int num_clusters, int kp,
    long long num_rays, float* __restrict__ best_t_out,
    int* __restrict__ best_tri_out, float* __restrict__ rows_out) {
  const float ox = o[3 * r_o], oy = o[3 * r_o + 1], oz = o[3 * r_o + 2];
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
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int tile = blockIdx.x / blocks_per_tile;
  const long long r = (long long)blockIdx.x * CRT_BLOCK + threadIdx.x;
  walk_tile(s, r, r, tile, o, d, n, nv0, m, c, nobf, tid, cluster_list,
            counts, rows_table, num_clusters, kp, num_rays, best_t_out,
            best_tri_out, rows_out);
}

__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_compact_kernel(
    const int* __restrict__ n_live, const int* __restrict__ tile_ids,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ n, const float* __restrict__ nv0,
    const float* __restrict__ m, const float* __restrict__ c,
    const float* __restrict__ nobf, const int* __restrict__ tid,
    const int* __restrict__ cluster_list, const int* __restrict__ counts,
    const float* __restrict__ rows_table, int num_clusters, int tile_rays,
    int tile_mod, int kp, long long num_rays, float* __restrict__ best_t_out,
    int* __restrict__ best_tri_out, float* __restrict__ rows_out) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int group = blockIdx.x / blocks_per_tile;
  const int lane = (blockIdx.x % blocks_per_tile) * CRT_BLOCK + threadIdx.x;
  const int tile = tile_ids[group];
  const long long r = (long long)tile * tile_rays + lane;
  if (group >= n_live[0]) {  // a dead tile: the miss result, no walk
    best_t_out[r] = CUDART_INF_F;
    best_tri_out[r] = -1;
    for (int k = 0; k < kp; ++k) rows_out[(long long)k * num_rays + r] = 0.0f;
    return;
  }
  const int o_tile = tile_mod > 0 ? tile % tile_mod : tile;
  const long long r_o = (long long)o_tile * tile_rays + lane;
  walk_tile(s, r_o, r, tile, o, d, n, nv0, m, c, nobf, tid, cluster_list,
            counts, rows_table, num_clusters, kp, num_rays, best_t_out,
            best_tri_out, rows_out);
}

__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_merged_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ n, const float* __restrict__ nv0,
    const float* __restrict__ m, const float* __restrict__ c,
    const float* __restrict__ nobf, const int* __restrict__ tid,
    const int* __restrict__ cluster_list, const int* __restrict__ counts,
    const float* __restrict__ rows_table, int num_clusters, int tile_rays,
    int merge, int kp, long long num_rays, float* __restrict__ best_t_out,
    int* __restrict__ best_tri_out, float* __restrict__ rows_out) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int group = blockIdx.x / blocks_per_tile;
  const int lane = (blockIdx.x % blocks_per_tile) * CRT_BLOCK + threadIdx.x;
  for (int sub = 0; sub < merge; ++sub) {  // uniform over the block
    const int tile = group * merge + sub;
    const long long r = (long long)tile * tile_rays + lane;
    walk_tile(s, r, r, tile, o, d, n, nv0, m, c, nobf, tid, cluster_list,
              counts, rows_table, num_clusters, kp, num_rays, best_t_out,
              best_tri_out, rows_out);
  }
}

}  // namespace

// Host entries, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  Each returns cudaGetLastError() after the
// launch.
extern "C" int crt_closest_hit(
    const float* o, const float* d, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf, const int* tid,
    const int* cluster_list, const int* counts, const float* rows_table,
    int num_clusters, int num_tiles, int tile_rays, int kp, float* best_t,
    int* best_tri, float* rows_out, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long num_rays = (long long)num_tiles * tile_rays;
  closest_hit_kernel<<<(unsigned)blocks, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, n, nv0, m, c, nobf, tid, cluster_list, counts, rows_table,
      num_clusters, tile_rays, kp, num_rays, best_t, best_tri, rows_out);
  return (int)cudaGetLastError();
}

extern "C" int crt_closest_hit_compact(
    const int* n_live, const int* tile_ids, const float* o, const float* d,
    const float* n, const float* nv0, const float* m, const float* c,
    const float* nobf, const int* tid, const int* cluster_list,
    const int* counts, const float* rows_table, int num_clusters,
    int num_tiles, int tile_rays, int tile_mod, int kp,
    float* best_t, int* best_tri, float* rows_out, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0 || tile_mod < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long num_rays = (long long)num_tiles * tile_rays;
  closest_hit_compact_kernel<<<(unsigned)blocks, CRT_BLOCK, 0,
                               (cudaStream_t)stream>>>(
      n_live, tile_ids, o, d, n, nv0, m, c, nobf, tid, cluster_list, counts,
      rows_table, num_clusters, tile_rays, tile_mod, kp, num_rays, best_t,
      best_tri, rows_out);
  return (int)cudaGetLastError();
}

// K7: `merge` tiles per block; num_tiles must divide by merge.
extern "C" int crt_closest_hit_merged(
    const float* o, const float* d, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf, const int* tid,
    const int* cluster_list, const int* counts, const float* rows_table,
    int num_clusters, int num_tiles, int tile_rays, int merge, int kp,
    float* best_t, int* best_tri, float* rows_out, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0 || merge < 1 || num_tiles % merge != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)(num_tiles / merge) * (tile_rays / CRT_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long num_rays = (long long)num_tiles * tile_rays;
  closest_hit_merged_kernel<<<(unsigned)blocks, CRT_BLOCK, 0,
                              (cudaStream_t)stream>>>(
      o, d, n, nv0, m, c, nobf, tid, cluster_list, counts, rows_table,
      num_clusters, tile_rays, merge, kp, num_rays, best_t, best_tri,
      rows_out);
  return (int)cudaGetLastError();
}
