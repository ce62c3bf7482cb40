// K2: point-light shadow occlusion with in-kernel directions (w form).
//
// Replaces crt_tpu/ops/pallas_trace.py `_occl_kernel_compact_w`, launched
// there by `_occluded_binned_compact_w`, in its capped mode.
//
// What it computes: the shadow wavefront of Ll lights over R pixel lanes is
// Ll * tpl tiles (tpl = R / tile_rays), light-major.  Tile `tile` uses the
// pixel tile `tile % tpl` (biased origins o, unbiased hit points p, shared
// by every light) and the light `tile / tpl`.  Each lane's unnormalized
// direction w = light - p is built in the kernel; the lane is blocked when
// some triangle of the tile's binned clusters is hit at 0 <= s <= 1 along
// w (the reference's hit_dist^2 <= light_dist^2, since |w| cancels).  The
// parallel test reads |n.w| >= PARALLEL_EPS, as the TPU kernel does.  A
// tile with an empty list is all false, which is the TPU launcher's
// `counts > 0` mask.
//
// What bounds it on an H100: FP32 ALU work, as in closest_hit.cu: 16 x ~45
// flops per ray-cluster pair against L2-resident tables; I/O is 36 bytes in
// and one byte out per lane.
//
// What the design does about it: the layout of closest_hit.cu (one thread
// per lane, 256-thread blocks, grid (tile_rays / 256, Ll * tpl), each
// walked cluster staged once per block).  The TPU's live-tile compaction
// becomes a block that returns at once on an empty list.  The output is an
// OR, so a thread stops testing once its lane is blocked, and the whole
// block leaves the walk once all 256 of its lanes are blocked.

#include "cluster_common.cuh"

namespace {

__global__ void __launch_bounds__(CRT_BLOCK) occlusion_w_kernel(
    const float* __restrict__ o, const float* __restrict__ p,
    const float* __restrict__ lights, const float* __restrict__ n,
    const float* __restrict__ nv0, const float* __restrict__ m,
    const float* __restrict__ c, const float* __restrict__ nobf,
    const int* __restrict__ cluster_list, const int* __restrict__ counts,
    int num_clusters, int tiles_per_light, int tile_rays,
    unsigned char* __restrict__ occ) {
  __shared__ ClusterSmem s;
  const int tile = blockIdx.y;
  const int lane = blockIdx.x * CRT_BLOCK + threadIdx.x;
  const long long out = (long long)tile * tile_rays + lane;
  const int count = counts[tile];
  if (count == 0) {  // uniform over the block
    occ[out] = 0;
    return;
  }
  const long long src = (long long)(tile % tiles_per_light) * tile_rays + lane;
  const int light = tile / tiles_per_light;
  const float ox = o[3 * src], oy = o[3 * src + 1], oz = o[3 * src + 2];
  const float wx = lights[3 * light] - p[3 * src];
  const float wy = lights[3 * light + 1] - p[3 * src + 1];
  const float wz = lights[3 * light + 2] - p[3 * src + 2];
  const int* list = cluster_list + (long long)tile * num_clusters;

  int blocked = 0;
  for (int i = 0; i < count; ++i) {
    // barrier before restaging, and the block-wide exit
    if (__syncthreads_and(blocked)) break;
    stage_cluster(s, list[i], n, nv0, m, c, nobf, nullptr);
    __syncthreads();
    if (!blocked) {
#pragma unroll
      for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
        if (member_t(s, j, ox, oy, oz, wx, wy, wz) <= 1.0f) {
          blocked = 1;
          break;
        }
      }
    }
  }
  occ[out] = (unsigned char)blocked;
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int crt_occlusion_w(
    const float* o, const float* p, const float* lights, const float* n,
    const float* nv0, const float* m, const float* c, const float* nobf,
    const int* cluster_list, const int* counts, int num_clusters,
    int num_tiles, int tiles_per_light, int tile_rays, unsigned char* occ,
    void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0 || tiles_per_light <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tile_rays / CRT_BLOCK, num_tiles);
  occlusion_w_kernel<<<grid, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      o, p, lights, n, nv0, m, c, nobf, cluster_list, counts, num_clusters,
      tiles_per_light, tile_rays, occ);
  return (int)cudaGetLastError();
}
