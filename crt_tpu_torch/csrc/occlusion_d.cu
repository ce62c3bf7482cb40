// K5 and K6: direction-form any-hit occlusion over binned cluster lists.
//
// K5 replaces crt_tpu/ops/pallas_trace.py `_occl_kernel_compact`, launched
// there by `_occluded_binned_compact` (the `shadow_apex` path); K6 replaces
// `_occlusion_kernel`, launched by `occluded_pallas_flat`.
//
// What it computes: for each lane, with its origin o, unit direction d and
// squared reach r2, whether some member of the clusters on its tile's list
// is hit at t >= 0 with t * t <= r2 (the reference's hit_dist^2 <=
// light_dist^2).  The two launches differ in what surrounds that test:
//   K5 (seed == null)  the shadow pass.  Tile `tile` reads its origins from
//                      tile `tile % tile_mod` when tile_mod > 0 (the lights
//                      share one copy of the pixel origins).  No lane is
//                      seeded, and a tile with an empty list is all false:
//                      the TPU launcher's `counts > 0` mask.
//   K6 (seed != null)  the any-hit query over every tile.  A lane starts
//                      from seed[lane] (1 = not consumed, so it returns
//                      blocked), and a tile with an empty list returns its
//                      seed.
//
// What bounds it on an H100: FP32 ALU work, as in occlusion_w.cu: 16 x ~47
// flops per ray-cluster pair against L2-resident tables; I/O is 28 bytes in
// (12 of them shared between the lights of a K5 pass) and one byte out per
// lane.
//
// What the design does about it: the layout of occlusion_w.cu (one thread
// per lane, 256-thread blocks, tile_rays / 256 consecutive blocks per tile,
// each walked cluster staged once per block).  The TPU's live-tile
// compaction becomes a block that returns at once on an empty list.  The
// output is an OR, so a thread stops testing once its lane is blocked and
// the block leaves the walk once all 256 of its lanes are.  The TPU runs K5
// without that exit and K6 with it; here both have it, since a lane that is
// not blocked keeps the block walking and so no lane's answer changes.

#include "cluster_common.cuh"

namespace {

__global__ void __launch_bounds__(CRT_BLOCK) occlusion_d_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ r2, const unsigned char* __restrict__ seed,
    const float* __restrict__ n, const float* __restrict__ nv0,
    const float* __restrict__ m, const float* __restrict__ c,
    const float* __restrict__ nobf, const int* __restrict__ cluster_list,
    const int* __restrict__ counts, int num_clusters, int tile_rays,
    int tile_mod, unsigned char* __restrict__ occ) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int tile = blockIdx.x / blocks_per_tile;
  const int lane = (blockIdx.x % blocks_per_tile) * CRT_BLOCK + threadIdx.x;
  const long long r = (long long)tile * tile_rays + lane;
  int blocked = seed != nullptr ? (seed[r] != 0) : 0;
  const int count = counts[tile];
  if (count == 0) {  // uniform over the block
    occ[r] = (unsigned char)blocked;
    return;
  }
  const int o_tile = tile_mod > 0 ? tile % tile_mod : tile;
  const long long r_o = (long long)o_tile * tile_rays + lane;
  const float ox = o[3 * r_o], oy = o[3 * r_o + 1], oz = o[3 * r_o + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float reach2 = r2[r];
  const int* list = cluster_list + (long long)tile * num_clusters;

  for (int i = 0; i < count; ++i) {
    // barrier before restaging, and the block-wide exit
    if (__syncthreads_and(blocked)) break;
    stage_cluster(s, list[i], n, nv0, m, c, nobf);
    __syncthreads();
    if (!blocked) {
#pragma unroll
      for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
        float t;
        if (member_hit(s, j, ox, oy, oz, dx, dy, dz, t) && t * t <= reach2) {
          blocked = 1;
          break;
        }
      }
    }
  }
  occ[r] = (unsigned char)blocked;
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  `o` holds tile_mod tiles when tile_mod > 0,
// else num_tiles; `seed` [num_tiles * tile_rays] bytes or null.  Returns
// cudaGetLastError() after the launch.
extern "C" int crt_occlusion_d(
    const float* o, const float* d, const float* r2,
    const unsigned char* seed, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf,
    const int* cluster_list, const int* counts, int num_clusters,
    int num_tiles, int tile_rays, int tile_mod, unsigned char* occ,
    void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays <= 0 || tile_rays % CRT_BLOCK != 0 || tile_mod < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  occlusion_d_kernel<<<(unsigned)blocks, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, r2, seed, n, nv0, m, c, nobf, cluster_list, counts, num_clusters,
      tile_rays, tile_mod, occ);
  return (int)cudaGetLastError();
}
