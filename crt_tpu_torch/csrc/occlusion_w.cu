// K2: point-light shadow occlusion with in-kernel directions (w form).
//
// Replaces crt_tpu/ops/pallas_trace.py `_occl_kernel_compact_w`, launched
// there by `_occluded_binned_compact_w`, in all its modes: capped,
// `capped=False`, `member_masked` and `glass_flag`.
//
// What it computes: the shadow wavefront of Ll lights over R pixel lanes is
// Ll * tpl tiles (tpl = R / tile_rays), light-major.  Tile `tile` uses the
// pixel tile `tile % tpl` (biased origins o, unbiased hit points p, shared
// by every light) and the light `tile / tpl`.  Each lane's unnormalized
// direction w = light - p is built in the kernel.  A member of the tile's
// binned clusters is a `base` hit of the lane when it is hit at s >= 0
// along w (the parallel test reads |n.w| >= PARALLEL_EPS, as the TPU kernel
// does).  Then, by mode:
//   capped          blocked |= base && s <= 1   (the reference's
//                   hit_dist^2 <= light_dist^2, since |w| cancels);
//   uncapped        blocked |= base             (any hit on the whole ray);
//   member-masked   base &&= gm[cluster, slot] > 0.5 before either;
//   glass flag      blocked as in capped over all members, and a second
//                   output glass |= base && gm > 0.5, uncapped: some member
//                   of the subset lies anywhere on the ray.
// A tile with an empty list is all false in every output, which is the TPU
// launcher's `counts > 0` mask.
//
// What bounds it on an H100: FP32 ALU work, as in closest_hit.cu: 16 x ~45
// flops per ray-cluster pair against L2-resident tables; I/O is 36 bytes in
// and one or two bytes out per lane.
//
// What the design does about it: the layout of closest_hit.cu (one thread
// per lane, 256-thread blocks, tile_rays / 256 consecutive blocks per tile,
// each walked cluster staged once per block, the member mask with it).  The
// TPU's live-tile compaction becomes a block that returns at once on an
// empty list.  Every output is an OR, so a thread stops testing once its
// lane has nothing left to learn (blocked, and with the glass flag also
// flagged: a lane blocked by an early opaque cluster still has to find the
// glass in a later one), and the block leaves the walk once that holds for
// all 256 of its lanes.

#include "cluster_common.cuh"

namespace {

template <bool CAPPED, bool MASKED, bool GLASS>
__global__ void __launch_bounds__(CRT_BLOCK) occlusion_w_kernel(
    const float* __restrict__ o, const float* __restrict__ p,
    const float* __restrict__ lights, const float* __restrict__ n,
    const float* __restrict__ nv0, const float* __restrict__ m,
    const float* __restrict__ c, const float* __restrict__ nobf,
    const float* __restrict__ gm, const int* __restrict__ cluster_list,
    const int* __restrict__ counts, int num_clusters, int tiles_per_light,
    int tile_rays, unsigned char* __restrict__ occ,
    unsigned char* __restrict__ glass_out) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int tile = blockIdx.x / blocks_per_tile;
  const int lane = (blockIdx.x % blocks_per_tile) * CRT_BLOCK + threadIdx.x;
  const long long out = (long long)tile * tile_rays + lane;
  const int count = counts[tile];
  if (count == 0) {  // uniform over the block
    occ[out] = 0;
    if (GLASS) glass_out[out] = 0;
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
  int glass = 0;
  for (int i = 0; i < count; ++i) {
    const int done = GLASS ? (blocked && glass) : blocked;
    // barrier before restaging, and the block-wide exit
    if (__syncthreads_and(done)) break;
    stage_cluster(s, list[i], n, nv0, m, c, nobf, nullptr,
                  (MASKED || GLASS) ? gm : nullptr);
    __syncthreads();
    if (!done) {
#pragma unroll
      for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
        float t;
        bool base = member_hit(s, j, ox, oy, oz, wx, wy, wz, t);
        if (MASKED) base = base && (s.gm[j] > 0.5f);
        if (base && (!CAPPED || t <= 1.0f)) blocked = 1;
        if (GLASS) {
          if (base && (s.gm[j] > 0.5f)) glass = 1;
          if (blocked && glass) break;
        } else if (blocked) {
          break;
        }
      }
    }
  }
  occ[out] = (unsigned char)blocked;
  if (GLASS) glass_out[out] = (unsigned char)glass;
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  `gm` [L,16] is needed when `member_masked` or
// `glass_flag` is set, `glass_out` when `glass_flag` is.  Returns
// cudaGetLastError() after the launch.
extern "C" int crt_occlusion_w(
    const float* o, const float* p, const float* lights, const float* n,
    const float* nv0, const float* m, const float* c, const float* nobf,
    const float* gm, const int* cluster_list, const int* counts,
    int num_clusters, int num_tiles, int tiles_per_light, int tile_rays,
    int capped, int member_masked, int glass_flag, unsigned char* occ,
    unsigned char* glass_out, void* stream) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0 || tiles_per_light <= 0)
    return (int)cudaErrorInvalidValue;
  if ((member_masked || glass_flag) && gm == nullptr)
    return (int)cudaErrorInvalidValue;
  if (glass_flag && (glass_out == nullptr || member_masked))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
#define CRT_LAUNCH_OCCL(CAP, MSK, GLS)                                       \
  occlusion_w_kernel<CAP, MSK, GLS><<<grid, CRT_BLOCK, 0, st>>>(             \
      o, p, lights, n, nv0, m, c, nobf, gm, cluster_list, counts,            \
      num_clusters, tiles_per_light, tile_rays, occ, glass_out)
  if (glass_flag) {
    if (capped) CRT_LAUNCH_OCCL(true, false, true);
    else CRT_LAUNCH_OCCL(false, false, true);
  } else if (member_masked) {
    if (capped) CRT_LAUNCH_OCCL(true, true, false);
    else CRT_LAUNCH_OCCL(false, true, false);
  } else {
    if (capped) CRT_LAUNCH_OCCL(true, false, false);
    else CRT_LAUNCH_OCCL(false, false, false);
  }
#undef CRT_LAUNCH_OCCL
  return (int)cudaGetLastError();
}
