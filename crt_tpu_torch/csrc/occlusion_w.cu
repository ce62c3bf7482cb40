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
// What bounds it on an H100.  The lists of the scenes the cluster backend
// serves are short and most shadow tiles of a bounce pool have none, so
// the fixed cost of a tile and the one or two output bytes a lane; where
// lists are long (4,096 clusters), FP32 issue: ~59 FP32 instructions a
// member test under -fmad=false, against L2-resident tables.  A lane's
// answer needs one test once it is blocked, but every member before its
// blocker, and a lane that is never blocked needs them all.
//
// The design (closest_hit.cu's grid and staging, with the any-hit's exits;
// PERF.md, section 6):
//   - A persistent grid of resident 256-thread blocks takes quarter tiles
//     (units) at a stride of the grid; a unit with an empty list stores its
//     zero bytes four to a thread, with no block launch and no barrier.
//   - CRT_BATCH clusters are staged per barrier by cp.async into the
//     member-major records of cluster_common.cuh's ClusterRing, the member
//     mask in each slot's tail word, CRT_STAGES - 1 batches ahead
//     (cluster_common.cuh walk_any_hit, which K5 / K6 walk too).
//   - Repeated rays are walked once (pack_rays).  A lane whose ray (o and
//     w, bit for bit) is an earlier lane's of its warp (on lists of at most
//     CRT_VOTE_LIST clusters: its warp's first lane's) takes the first such
//     lane's answer, and the other rays are packed to the front of the
//     block, so the warps past them have nothing to test.  A frame's lanes
//     without a hit all carry the camera's ray, and they are walked, since
//     their bits are part of the output: at 65,536 triangles they are most
//     of the tests.
//   - Every output is an OR, so a lane with nothing left to learn (blocked,
//     and with the glass flag also flagged: a lane blocked by an early
//     opaque cluster still has to find the glass in a later one) tests no
//     more: a warp whose lanes are all done skips the batch (warp vote),
//     and the block leaves the walk when every lane is done at a batch
//     barrier.  A member outside the member mask is skipped by every lane.
//     On lists of at most CRT_VOTE_LIST clusters a warp also skips a
//     member's divide when no lane passes the plane, face and done gates,
//     and its edges when no lane's hit could change an output; on longer
//     lists those votes cost more than they skip.
//   - On lists longer than CRT_VOTE_LIST a lane's walk is a long chain of
//     dependent member tests, and a unit's distinct unfinished rays often
//     fill one or two warps (at 65,536 triangles a unit packs about 32
//     rays, few of them ever blocked), so without copies the other warps
//     idle and a walk takes as long as one warp's chain.  There the batch
//     barrier counts the unfinished lanes, moves them to the front of the
//     block when they would fill fewer warps than hold them (repack_rays),
//     and keeps them in as many copies as the block's 8 warps hold (1, 2,
//     4 or 8 warps a copy); copy k tests clusters k, k + copies, ... of
//     each batch, and the copies OR their flags at every barrier.  A moved
//     ray takes along its flags and the place whose answer it owns; a
//     finished lane leaves its answer at its place first.  Shorter lists
//     keep the plain barrier.
//   Every operation done is the member test's (cluster_common.cuh), in its
//   order, and every output an OR of the same tests in list order, so no
//   bit changes.

#include "cluster_common.cuh"

namespace {

struct OcclArgs {
  const float* o;
  const float* p;
  const float* lights;
  ClusterTables tb;
  const int* cluster_list;
  const int* counts;
  int num_clusters, tiles_per_light, tile_rays;
  unsigned char* occ;
  unsigned char* glass_out;
  unsigned long long* stats;  // WalkCount's totals, or null
};

// The unit's 256 zero bytes of each output, four a thread.
template <bool GLASS>
__device__ __forceinline__ void write_unit_zero(const OcclArgs& a,
                                                long long u) {
  if (threadIdx.x < CRT_BLOCK / 4) {
    const long long w = u * (CRT_BLOCK / 4) + threadIdx.x;
    reinterpret_cast<unsigned*>(a.occ)[w] = 0u;
    if (GLASS) reinterpret_cast<unsigned*>(a.glass_out)[w] = 0u;
  }
}

// Clusters first, first + step, ... of the `count` staged at `img` against
// one lane's ray (origin o, unnormalized direction w), in list order, into
// its flags.  Every operation done is the member test's; a member is
// skipped only where no lane of the warp (VOTE) or no lane at all (outside
// the member mask) could change an output with it.
template <bool CAPPED, bool MASKED, bool GLASS, bool VOTE>
__device__ __forceinline__ void test_batch(const float* img, int count,
                                           int first, int step, float ox,
                                           float oy, float oz, float wx,
                                           float wy, float wz, bool& blocked,
                                           bool& glass) {
  for (int k = first; k < count; k += step) {
    const float* rec = img + k * CRT_CLUSTER_FLOATS;
#pragma unroll
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
      const float* slot = rec + j * CRT_SLOT_FLOATS;
      const float4 tw = rec_word(slot, 4);
      const bool in_subset = tw.z > 0.5f;
      if (MASKED && !in_subset) continue;  // the same for every lane
      const float4 pw = rec_word(slot, 0);
      const float nd = pw.x * wx + pw.y * wy + pw.z * wz;
      const float no = pw.x * ox + pw.y * oy + pw.z * oz;
      const float opd = pw.w - no;
      const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
      bool ok = not_parallel && ((opd < 0.0f) || (tw.x > 0.5f));
      if (GLASS)
        ok = ok && (!blocked || (!glass && in_subset));
      else
        ok = ok && !blocked;
      if (VOTE && !__any_sync(0xffffffffu, ok)) continue;
      const float t = opd / (not_parallel ? nd : 1.0f);
      const bool in_cap = !CAPPED || t <= 1.0f;
      ok = ok && (t >= 0.0f);
      if (GLASS)
        ok = ok && ((!blocked && in_cap) || (!glass && in_subset));
      else
        ok = ok && in_cap;
      if (VOTE && !__any_sync(0xffffffffu, ok)) continue;
      ok = ok && rec_edges(slot, ox, oy, oz, wx, wy, wz, t);
      if (GLASS) {
        blocked = blocked || (ok && in_cap);
        glass = glass || (ok && in_subset);
      } else {
        blocked = blocked || ok;
      }
    }
  }
}

// One lane's packed ray (o and w) and flags, walked by walk_any_hit.
template <bool CAPPED, bool MASKED, bool GLASS>
struct WRay {
  static constexpr int kDone = GLASS ? 3 : 1;
  float r[6];
  bool blocked, glass;
  int place;  // the place whose answer it holds (pack_rays)
  __device__ __forceinline__ bool done() const {
    return GLASS ? (blocked && glass) : blocked;
  }
  __device__ __forceinline__ unsigned char flags() const {
    return (unsigned char)(blocked | (glass << 1));
  }
  __device__ __forceinline__ void set_flags(int f) {
    blocked = (f & 1) != 0;
    glass = (f & 2) != 0;
  }
  template <bool VOTE>
  __device__ __forceinline__ void test(const float* img, int count,
                                       int first, int step) {
    test_batch<CAPPED, MASKED, GLASS, VOTE>(img, count, first, step, r[0],
                                            r[1], r[2], r[3], r[4], r[5],
                                            blocked, glass);
  }
};

template <bool CAPPED, bool MASKED, bool GLASS>
__device__ __forceinline__ void walk_unit(ClusterRing& ring,
                                          RayPack<6>& pk,
                                          const ClusterPlan& pl,
                                          const OcclArgs& a, long long u,
                                          int tile, int count,
                                          WalkCount* wc) {
  const int per_tile = a.tile_rays / CRT_BLOCK;
  const int lane = (int)(u % per_tile) * CRT_BLOCK + threadIdx.x;
  const long long out = u * CRT_BLOCK + threadIdx.x;
  const long long src =
      (long long)(tile % a.tiles_per_light) * a.tile_rays + lane;
  const int light = tile / a.tiles_per_light;
  float ray[6] = {a.o[3 * src], a.o[3 * src + 1], a.o[3 * src + 2],
                  a.lights[3 * light] - a.p[3 * src],
                  a.lights[3 * light + 1] - a.p[3 * src + 1],
                  a.lights[3 * light + 2] - a.p[3 * src + 2]};
  int live;
  const int from = pack_rays(pk, ray, true, count > CRT_VOTE_LIST, live);
  const bool no_ray = (int)threadIdx.x >= live;  // nothing to learn
  WRay<CAPPED, MASKED, GLASS> s{{ray[0], ray[1], ray[2], ray[3], ray[4],
                                 ray[5]},
                                no_ray, no_ray, (int)threadIdx.x};
  walk_any_hit(ring, pk, pl,
               a.cluster_list + (long long)tile * a.num_clusters, count, s,
               wc);
  const unsigned char res = answer_at(pk, s, from);
  a.occ[out] = res & 1;
  if (GLASS) a.glass_out[out] = (res >> 1) & 1;
}

template <bool CAPPED, bool MASKED, bool GLASS>
__global__ void __launch_bounds__(CRT_BLOCK) occlusion_w_kernel(
    OcclArgs a, long long units) {
  __shared__ ClusterRing ring;
  __shared__ RayPack<6> pk;
  __shared__ int s_count[CRT_BLOCK];
  __shared__ WalkCount s_walk;
  WalkCount* wc = a.stats != nullptr ? &s_walk : nullptr;
  if (wc != nullptr) walk_count_init(s_walk);
  const ClusterPlan pl(a.tb);
  const int per_tile = a.tile_rays / CRT_BLOCK;
  for_each_unit(units, per_tile, a.counts, s_count,
                [&](long long u, int count) {
                  if (count == 0)
                    write_unit_zero<GLASS>(a, u);
                  else
                    walk_unit<CAPPED, MASKED, GLASS>(
                        ring, pk, pl, a, u, (int)(u / per_tile), count, wc);
                });
  if (wc != nullptr) walk_count_flush(s_walk, a.stats);
}

template <bool CAPPED, bool MASKED, bool GLASS>
int launch(const OcclArgs& a, long long units, cudaStream_t st) {
  const void* k = (const void*)occlusion_w_kernel<CAPPED, MASKED, GLASS>;
  const long long grid = persistent_grid(k, units);
  if (grid <= 0) return (int)cudaGetLastError();
  occlusion_w_kernel<CAPPED, MASKED, GLASS>
      <<<(unsigned)grid, CRT_BLOCK, 0, st>>>(a, units);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  `gm` [L,16] is needed when `member_masked` or
// `glass_flag` is set, `glass_out` when `glass_flag` is; `occ` and
// `glass_out` are 4-byte aligned.  `stats` (2 words, or null) gets the
// walks' repacks and member tests added (WalkCount); it comes last, so
// the other arguments keep their places in a library built without it.
// Returns cudaGetLastError() after the launch.
extern "C" int crt_occlusion_w(
    const float* o, const float* p, const float* lights, const float* n,
    const float* nv0, const float* m, const float* c, const float* nobf,
    const float* gm, const int* cluster_list, const int* counts,
    int num_clusters, int num_tiles, int tiles_per_light, int tile_rays,
    int capped, int member_masked, int glass_flag, unsigned char* occ,
    unsigned char* glass_out, void* stream, unsigned long long* stats) {
  if (num_tiles <= 0) return 0;
  if (tile_rays % CRT_BLOCK != 0 || tiles_per_light <= 0)
    return (int)cudaErrorInvalidValue;
  if ((member_masked || glass_flag) && gm == nullptr)
    return (int)cudaErrorInvalidValue;
  if (glass_flag && (glass_out == nullptr || member_masked))
    return (int)cudaErrorInvalidValue;
  if (((size_t)occ | (size_t)glass_out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const bool mask = member_masked || glass_flag;
  const OcclArgs a{o, p, lights,
                   ClusterTables{n, nv0, m, c, nobf, nullptr,
                                 mask ? gm : nullptr},
                   cluster_list, counts, num_clusters, tiles_per_light,
                   tile_rays, occ, glass_out, stats};
  const long long units = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  if (glass_flag)
    return capped ? launch<true, false, true>(a, units, st)
                  : launch<false, false, true>(a, units, st);
  if (member_masked)
    return capped ? launch<true, true, false>(a, units, st)
                  : launch<false, true, false>(a, units, st);
  return capped ? launch<true, false, false>(a, units, st)
                : launch<false, false, false>(a, units, st);
}
