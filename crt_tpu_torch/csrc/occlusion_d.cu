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
// What bounds it on an H100: as for occlusion_w.cu, whose capped mode does
// the same member work on the same wavefronts.  The shadow lists of the
// scenes the cluster backend serves are short and the passes after the
// first bounce are sparse, so the fixed cost of a unit and the byte a
// lane; where lists are long (4,096 clusters), FP32 issue: ~59 FP32
// instructions a member test under -fmad=false, against L2-resident
// tables.  A lane's answer needs one test once it is blocked, but every
// member before its blocker, and a lane that is never blocked needs them
// all.  I/O is 28 bytes in (12 of them shared between the lights of a K5
// pass) and one byte out per lane.
//
// The design (occlusion_w.cu's, in the direction form; PERF.md, section
// 6):
//   - A persistent grid of resident 256-thread blocks takes 256-lane units
//     at a stride of the grid, reading their tiles' counts 256 at a time; a
//     unit with an empty list stores its 256 bytes four to a thread (K5
//     zeros, K6 its seed bytes), with no block launch and no barrier.
//   - CRT_BATCH clusters are staged per barrier by cp.async into the
//     member-major records of cluster_common.cuh's ClusterRing,
//     CRT_STAGES - 1 batches ahead, and read with 16-byte shared loads
//     (walk_any_hit, K2's walk).
//   - On lists of more than CRT_VOTE_LIST clusters repeated rays are
//     walked once (pack_rays, K2's packing).  A lane whose ray (o, d and
//     r2, bit for bit) is an earlier unseeded lane's of its warp takes the
//     first such lane's answer, and the other unseeded rays are packed to
//     the front of the block, so the warps past them have nothing to
//     test; a seeded lane (K6) takes no place, and a unit whose lanes are
//     all seeded walks nothing.  On shorter lists each lane walks its own
//     ray, a seeded one blocked from the start.
//   - The output is an OR, so a blocked lane tests no more: a warp whose
//     lanes are all blocked skips the batch (warp vote), and the block
//     leaves the walk when every lane is blocked at a batch barrier.  On
//     lists longer than CRT_VOTE_LIST that barrier counts the unblocked
//     lanes, moves them to the front of the block when they would fill
//     fewer warps than hold them and keeps them in copies that share each
//     batch's clusters (repack_rays, K2's repack: a moved ray takes along
//     its flag and the place whose answer it owns).  On lists of at most
//     CRT_VOTE_LIST clusters a warp also skips a member's divide when no
//     lane passes the plane and face gates, and its edges when no lane
//     passes t >= 0 and t * t <= r2.
//     The TPU runs K5 without these exits and K6 with them; here both have
//     them, since a lane that is not blocked keeps testing every member and
//     so no lane's answer changes.  Every operation done is the member
//     test's (cluster_common.cuh), in its order, so no bit changes.

#include "cluster_common.cuh"

// The floats of a packed ray: o, d, r2.
#define CRT_RAY_D 7

namespace {

struct OcclDArgs {
  const float* o;
  const float* d;
  const float* r2;
  const unsigned char* seed;
  ClusterTables tb;
  const int* cluster_list;
  const int* counts;
  int num_clusters, tile_rays, tile_mod;
  unsigned char* occ;
  unsigned long long* stats;  // WalkCount's totals, or null
};

// The 256 bytes of a unit with an empty list, four a thread: zeros, or the
// unit's seed bytes.
__device__ __forceinline__ void write_unit_seed(const OcclDArgs& a,
                                                long long u) {
  if (threadIdx.x < CRT_BLOCK / 4) {
    const long long w = u * (CRT_BLOCK / 4) + threadIdx.x;
    reinterpret_cast<unsigned*>(a.occ)[w] =
        a.seed != nullptr ? reinterpret_cast<const unsigned*>(a.seed)[w]
                          : 0u;
  }
}

// Clusters first, first + step, ... of the `count` staged at `img` against
// one lane's ray, in list order, into `blocked`: the member test's
// operations in its order; a stage is skipped only where no lane of the
// warp (VOTE) still passes the gates before it.
template <bool VOTE>
__device__ __forceinline__ void test_batch(const float* img, int count,
                                           int first, int step, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float reach2,
                                           bool& blocked) {
  for (int k = first; k < count; k += step) {
    const float* rec = img + k * CRT_CLUSTER_FLOATS;
#pragma unroll
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
      const float* slot = rec + j * CRT_SLOT_FLOATS;
      // nobf is read before the gates: read under the face gate's ||, it
      // cost a branch and a reconvergence a member (PERF.md, section 6)
      const float4 tw = rec_word(slot, 4);
      const float4 pw = rec_word(slot, 0);
      const float nd = pw.x * dx + pw.y * dy + pw.z * dz;
      const float no = pw.x * ox + pw.y * oy + pw.z * oz;
      const float opd = pw.w - no;
      const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
      bool ok = not_parallel && ((opd < 0.0f) || (tw.x > 0.5f));
      ok = ok && !blocked;
      if (VOTE && !__any_sync(0xffffffffu, ok)) continue;
      const float t = opd / (not_parallel ? nd : 1.0f);
      const bool in_reach = t * t <= reach2;
      ok = ok && (t >= 0.0f);
      ok = ok && in_reach;
      if (VOTE && !__any_sync(0xffffffffu, ok)) continue;
      ok = ok && rec_edges(slot, ox, oy, oz, dx, dy, dz, t);
      blocked = blocked || ok;
    }
  }
}

// One lane's packed ray (o, d, r2) and flag, walked by walk_any_hit.
struct DRay {
  static constexpr int kDone = 1;
  float r[CRT_RAY_D];
  bool blocked;
  int place;  // the place whose answer it holds (pack_rays)
  __device__ __forceinline__ bool done() const { return blocked; }
  __device__ __forceinline__ unsigned char flags() const {
    return (unsigned char)blocked;
  }
  __device__ __forceinline__ void set_flags(int f) { blocked = (f & 1) != 0; }
  template <bool VOTE>
  __device__ __forceinline__ void test(const float* img, int count,
                                       int first, int step) {
    test_batch<VOTE>(img, count, first, step, r[0], r[1], r[2], r[3], r[4],
                     r[5], r[6], blocked);
  }
};

__device__ __forceinline__ void walk_unit(ClusterRing& ring,
                                          RayPack<CRT_RAY_D>& pk,
                                          const ClusterPlan& pl,
                                          const OcclDArgs& a, long long u,
                                          int count, WalkCount* wc) {
  const int per_tile = a.tile_rays / CRT_BLOCK;
  const int tile = (int)(u / per_tile);
  const int lane = (int)(u % per_tile) * CRT_BLOCK + threadIdx.x;
  const long long r = u * CRT_BLOCK + threadIdx.x;
  const long long src =
      (long long)(a.tile_mod > 0 ? tile % a.tile_mod : tile) * a.tile_rays +
      lane;
  float ray[CRT_RAY_D] = {a.o[3 * src],     a.o[3 * src + 1],
                          a.o[3 * src + 2], a.d[3 * r],
                          a.d[3 * r + 1],   a.d[3 * r + 2],
                          a.r2[r]};
  const bool seeded = a.seed != nullptr && a.seed[r] != 0;
  // Repeated rays are packed on lists longer than CRT_VOTE_LIST; on shorter
  // ones each lane walks its own ray (there the packing's barriers cost
  // more than it saves: PERF.md, section 6).
  const bool pack = count > CRT_VOTE_LIST;  // uniform over the block
  int from = threadIdx.x, live = CRT_BLOCK;
  if (pack) from = pack_rays(pk, ray, !seeded, true, live);
  // nothing to learn: seeded, or no packed ray at this place
  DRay s{{ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], ray[6]},
         pack ? (int)threadIdx.x >= live : seeded,
         (int)threadIdx.x};
  // uniform; a packed unit whose lanes are all seeded walks nothing
  if (live > 0)
    walk_any_hit(ring, pk, pl,
                 a.cluster_list + (long long)tile * a.num_clusters, count, s,
                 wc);
  // where rays moved (packed, or repacked in a long walk) each answer is
  // read back from its place
  const bool moved = pack || count > CRT_VOTE_LIST;
  const bool blocked = moved ? answer_at(pk, s, from) != 0 : s.blocked;
  a.occ[r] = (unsigned char)(seeded || blocked);
}

__global__ void __launch_bounds__(CRT_BLOCK) occlusion_d_kernel(
    OcclDArgs a, long long units) {
  __shared__ ClusterRing ring;
  __shared__ RayPack<CRT_RAY_D> pk;
  __shared__ int s_count[CRT_BLOCK];
  __shared__ WalkCount s_walk;
  WalkCount* wc = a.stats != nullptr ? &s_walk : nullptr;
  if (wc != nullptr) walk_count_init(s_walk);
  const ClusterPlan pl(a.tb);
  for_each_unit(units, a.tile_rays / CRT_BLOCK, a.counts, s_count,
                [&](long long u, int count) {
                  if (count == 0)
                    write_unit_seed(a, u);
                  else
                    walk_unit(ring, pk, pl, a, u, count, wc);
                });
  if (wc != nullptr) walk_count_flush(s_walk, a.stats);
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  `o` holds tile_mod tiles when tile_mod > 0,
// else num_tiles; `seed` [num_tiles * tile_rays] bytes or null; `seed` and
// `occ` are 4-byte aligned.  `stats` (2 words, or null, last) as for
// crt_occlusion_w.  Returns cudaGetLastError() after the launch.
extern "C" int crt_occlusion_d(
    const float* o, const float* d, const float* r2,
    const unsigned char* seed, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf,
    const int* cluster_list, const int* counts, int num_clusters,
    int num_tiles, int tile_rays, int tile_mod, unsigned char* occ,
    void* stream, unsigned long long* stats) {
  if (num_tiles <= 0) return 0;
  if (tile_rays <= 0 || tile_rays % CRT_BLOCK != 0 || tile_mod < 0)
    return (int)cudaErrorInvalidValue;
  if (((size_t)occ | (size_t)seed) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const OcclDArgs a{o, d, r2, seed,
                    ClusterTables{n, nv0, m, c, nobf, nullptr, nullptr},
                    cluster_list, counts, num_clusters, tile_rays, tile_mod,
                    occ, stats};
  const long long units = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  const long long grid =
      persistent_grid((const void*)occlusion_d_kernel, units);
  if (grid <= 0) return (int)cudaGetLastError();
  occlusion_d_kernel<<<(unsigned)grid, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      a, units);
  return (int)cudaGetLastError();
}
