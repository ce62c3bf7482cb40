// K8 and K9: the streaming backend's closest hit and any-hit occlusion over
// a tile-major list of (tile, supercluster) pairs, on the fused table; K10
// and K11: the same two kernels on the lane and rows table layouts.
//
// They replace crt_tpu/ops/pallas_stream.py `_make_f_kernel(occl=False)`
// (tests `_f_test_closest`, launched by `_launch_stream_kernel` from
// `closest_hit_stream_flat`) and `_make_f_kernel(occl=True)` (tests
// `_f_test_occl`, launched by `_launch_stream_occl` from
// `occluded_stream_flat`) on the fused [L,16,18] layout (K8, K9), the
// same factory with `lane_sc=sc` on the lane layout [L2,18,sc*16] (K10),
// and `_stream_kernel` / `_stream_occl_kernel` on the rows layout, the six
// cluster-major arrays (K11).  `CRT_STREAM_LAYOUT` (or `layout=`) chooses.
//
// What they compute.  A supercluster is `sc` (<= 32) consecutive clusters
// of the Morton order.  Phase A (plain torch) lists, for every ray tile,
// the superclusters its rays can reach, and for each such pair a 32-bit
// mask of the member clusters that survive the member test.  Tile `tile`
// owns pairs [tile_start[tile], tile_start[tile + 1]).
//   closest hit: the closest hit of each lane over its tile's pairs in list
//       order, the live members of a pair in ascending order.  Within a
//       cluster the minimum t wins and, among equal t, the smallest
//       triangle id; a later cluster replaces the running best only with a
//       strictly smaller t.  On an ascending pair list that is
//       closest_hit.cu's walk of an ascending cluster list, so the hits are
//       the same bits.  A tile without pairs is all misses (t = +inf,
//       tri = -1).
//   any-hit: per lane, starting from seed[lane] (1 = the lane is not
//       consumed and returns blocked), the OR over the same members of "hit
//       at t >= 0 with t * t <= r2".  A tile without pairs returns its seed.
// The layouts hold the same floats, staged into the same shared-memory
// fields, so every layout gives every lane the same bits.
//
// What the TPU design needed and the card does not: one grid step per pair
// with the tile's output block resident across consecutive pairs, a
// "first pair of the tile" test to initialise it, launches cut at 16,384
// pairs with the result carried between them, a patch for tiles no pair
// touched, and a 5-bit-packed live-first member permutation walked to a
// count.  Here a block owns 256 lanes of one tile and loops over the
// tile's pair range: the loop's start is the initialisation, an empty
// range writes the miss or the seed, one launch serves any pair count, and
// the set bits of the member mask, taken lowest first, are that
// permutation's live prefix.  On the TPU the layout decides how a pair's
// table slice is copied into VMEM (the rows layout pads every [16, X] tile
// to 128 lanes, the lane layout needs a lane rotate and a transpose per
// member); here only the stager differs, and it stages one live member at
// a time.
//
// What a live member reads from device memory (staged once per block and
// shared by its 256 lanes; the ids only for the closest hit):
//   fused: one contiguous run of 1,152 bytes (272 of its 288 floats used)
//          + 64 bytes of ids;
//   lane:  17 runs of 64 bytes at a stride of sc*64 bytes (1,088 bytes,
//          the id column skipped) + 64 bytes of ids;
//   rows:  5 runs, one per array (n 192, nv0 64, m 576, c 192, nobf 64
//          bytes: 1,088) + 64 bytes of ids.
// What bounds them on an H100, in every layout: FP32 ALU work (16 x ~45
// flops per ray-cluster pair) against those ~1.1 KB per member and 24 to
// 29 bytes of ray input per lane.  The four blocks of a tile stage the
// same members, which the 50 MB L2 serves.  The any-hit leaves a tile's
// walk once every lane of the block is blocked.

#include "cluster_common.cuh"

namespace {

enum StreamLayout { kFused = 0, kLane = 1, kRows = 2 };

// The streamed table in one layout: `t0` is the fused table, the lane slab
// or (rows) the n array; the other four are the rows layout's nv0, m, c,
// nobf and null otherwise.
struct StreamTable {
  const float* t0;
  const float* nv0;
  const float* m;
  const float* c;
  const float* nobf;
};

// Stage member `member` of supercluster `sc_idx` from the table's layout.
template <int LAYOUT>
__device__ __forceinline__ void stage_member(ClusterSmem& s,
                                             const StreamTable& tb,
                                             long long sc_idx, int member,
                                             int sc,
                                             const int* __restrict__ tid) {
  const long long cl = sc_idx * sc + member;
  if (LAYOUT == kFused) {
    stage_fused(s, cl, tb.t0, tid);
  } else if (LAYOUT == kLane) {
    stage_lane(s, sc_idx, member, sc, tb.t0, tid);
  } else {
    stage_cluster(s, (int)cl, tb.t0, tb.nv0, tb.m, tb.c, tb.nobf, tid);
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    StreamTable tb, const int* __restrict__ tid,
    const int* __restrict__ pair_sc, const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, int sc, int tile_rays,
    float* __restrict__ best_t_out, int* __restrict__ best_tri_out) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int tile = blockIdx.x / blocks_per_tile;
  const long long r = (long long)blockIdx.x * CRT_BLOCK + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const int p_end = tile_start[tile + 1];

  float best_t = CUDART_INF_F;
  int best_tri = -1;
  for (int p = tile_start[tile]; p < p_end; ++p) {
    const long long sc_idx = pair_sc[p];
    unsigned bits = pair_bits[p];  // uniform over the block
    while (bits != 0u) {
      const int member = __ffs((int)bits) - 1;
      bits &= bits - 1u;
      __syncthreads();  // every thread is done with the previous cluster
      stage_member<LAYOUT>(s, tb, sc_idx, member, sc, tid);
      __syncthreads();

      // lexicographic (t, id) minimum over the 16 slots
      float cl_best = CUDART_INF_F;
      int cl_tri = 1 << 30;
#pragma unroll
      for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
        const float t = member_t(s, j, ox, oy, oz, dx, dy, dz);
        const int id = s.tid[j];
        if (t < cl_best || (t == cl_best && id < cl_tri)) {
          cl_best = t;
          cl_tri = id;
        }
      }
      if (cl_best < best_t) {  // strict: the first cluster walked wins ties
        best_t = cl_best;
        best_tri = cl_tri;
      }
    }
  }
  best_t_out[r] = best_t;
  best_tri_out[r] = best_tri;
}

template <int LAYOUT>
__global__ void __launch_bounds__(CRT_BLOCK) occlusion_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ r2, const unsigned char* __restrict__ seed,
    StreamTable tb, const int* __restrict__ pair_sc,
    const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, int sc, int tile_rays,
    unsigned char* __restrict__ occ) {
  __shared__ ClusterSmem s;
  const int blocks_per_tile = tile_rays / CRT_BLOCK;
  const int tile = blockIdx.x / blocks_per_tile;
  const long long r = (long long)blockIdx.x * CRT_BLOCK + threadIdx.x;
  int blocked = seed[r] != 0;
  const int p_begin = tile_start[tile], p_end = tile_start[tile + 1];
  if (p_begin == p_end) {  // uniform over the block
    occ[r] = (unsigned char)blocked;
    return;
  }
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float reach2 = r2[r];

  bool done = false;
  for (int p = p_begin; p < p_end && !done; ++p) {
    const long long sc_idx = pair_sc[p];
    unsigned bits = pair_bits[p];  // uniform over the block
    while (bits != 0u) {
      // barrier before restaging, and the block-wide exit
      if (__syncthreads_and(blocked)) {
        done = true;
        break;
      }
      const int member = __ffs((int)bits) - 1;
      bits &= bits - 1u;
      stage_member<LAYOUT>(s, tb, sc_idx, member, sc, nullptr);  // no ids
      __syncthreads();
      if (!blocked) {
#pragma unroll
        for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
          float t;
          if (member_hit(s, j, ox, oy, oz, dx, dy, dz, t) &&
              t * t <= reach2) {
            blocked = 1;
            break;
          }
        }
      }
    }
  }
  occ[r] = (unsigned char)blocked;
}

bool bad_shape(int sc, int num_tiles, int tile_rays) {
  return sc < 1 || sc > 32 || tile_rays <= 0 || tile_rays % CRT_BLOCK != 0 ||
         (long long)num_tiles * (tile_rays / CRT_BLOCK) > 0x7fffffffLL;
}

bool bad_table(int layout, const StreamTable& tb) {
  if (tb.t0 == nullptr) return true;
  if (layout == kRows)
    return tb.nv0 == nullptr || tb.m == nullptr || tb.c == nullptr ||
           tb.nobf == nullptr;
  return layout != kFused && layout != kLane;
}

}  // namespace

// Host entries, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`: o, d [num_tiles * tile_rays, 3]; the table in
// `layout` (0 fused: t0 = [L,16,18]; 1 lane: t0 = [L/sc, 18, sc*16]; 2
// rows: t0..t4 = n [L,16,3], nv0 [L,16], m [L,16,9], c [L,16,3], nobf
// [L,16]; t1..t4 null for the first two) and tid [L,16], L a multiple of
// sc; pair_sc, pair_bits [P]; tile_start [num_tiles + 1].  Each returns
// cudaGetLastError() after the launch.
extern "C" int crt_closest_hit_stream(
    const float* o, const float* d, int layout, const float* t0,
    const float* t1, const float* t2, const float* t3, const float* t4,
    const int* tid, const int* pair_sc, const unsigned* pair_bits,
    const int* tile_start, int sc, int num_tiles, int tile_rays,
    float* best_t, int* best_tri, void* stream) {
  if (num_tiles <= 0) return 0;
  const StreamTable tb{t0, t1, t2, t3, t4};
  if (bad_shape(sc, num_tiles, tile_rays) || bad_table(layout, tb) ||
      tid == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)num_tiles * (tile_rays / CRT_BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
#define CRT_LAUNCH(L)                                                   \
  closest_hit_stream_kernel<L><<<blocks, CRT_BLOCK, 0, st>>>(           \
      o, d, tb, tid, pair_sc, pair_bits, tile_start, sc, tile_rays,     \
      best_t, best_tri)
  if (layout == kFused) CRT_LAUNCH(kFused);
  else if (layout == kLane) CRT_LAUNCH(kLane);
  else CRT_LAUNCH(kRows);
#undef CRT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int crt_occlusion_stream(
    const float* o, const float* d, const float* r2,
    const unsigned char* seed, int layout, const float* t0, const float* t1,
    const float* t2, const float* t3, const float* t4, const int* pair_sc,
    const unsigned* pair_bits, const int* tile_start, int sc, int num_tiles,
    int tile_rays, unsigned char* occ, void* stream) {
  if (num_tiles <= 0) return 0;
  const StreamTable tb{t0, t1, t2, t3, t4};
  if (bad_shape(sc, num_tiles, tile_rays) || bad_table(layout, tb) ||
      seed == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)num_tiles * (tile_rays / CRT_BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
#define CRT_LAUNCH(L)                                                   \
  occlusion_stream_kernel<L><<<blocks, CRT_BLOCK, 0, st>>>(             \
      o, d, r2, seed, tb, pair_sc, pair_bits, tile_start, sc, tile_rays, \
      occ)
  if (layout == kFused) CRT_LAUNCH(kFused);
  else if (layout == kLane) CRT_LAUNCH(kLane);
  else CRT_LAUNCH(kRows);
#undef CRT_LAUNCH
  return (int)cudaGetLastError();
}
