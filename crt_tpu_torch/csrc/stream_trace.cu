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
// owns pairs [tile_start[tile], tile_start[tile + 1]).  A tile's walk is
// its pairs in list order, the live members of a pair in ascending order.
//   closest hit: the closest hit of each lane over its tile's walk.
//       Within a cluster the minimum t wins and, among equal t, the
//       smallest triangle id; a later cluster replaces the running best
//       only with a strictly smaller t.  On an ascending pair list that is
//       closest_hit.cu's walk of an ascending cluster list, so the hits are
//       the same bits.  A tile without pairs is all misses (t = +inf,
//       tri = -1).
//   any-hit: per lane, starting from seed[lane] (1 = the lane is not
//       consumed and returns blocked), the OR over the same members of "hit
//       at t >= 0 with t * t <= r2".  A tile without pairs returns its seed.
// The layouts hold the same floats, so every layout gives every lane the
// same bits.
//
// What bounds them on an H100: FP32 issue.  A member test is ~51 flops
// (chip_smoke.py prices it so, at 67 TFLOP/s), but the library is built
// with -fmad=false, so every multiply and add is an instruction of its own
// and the IEEE divide a sequence: a bit-exact kernel issues ~59 FP32
// instructions per test that passes every gate, at 33.5 T/s.  A live
// member reads ~1.1 KB of table; the 50 MB L2 serves the tiles that share
// it.
//
// The design, one point per thing that held the one-block-a-tile walk back:
//   - Long walks split across blocks.  A tile's walk (up to ~10^4 live
//     members after phase 2's compaction) is cut into chunks of at most
//     `chunk` live members; each chunk of each work tile is an item.  The
//     wrapper builds the items on the device (stream_trace.stream_items):
//     the work tiles longest walk first and the prefix sum of their chunk
//     counts, and each pair's offset in the walk.  A persistent grid of as
//     many blocks as fit on the card takes items from a counter, so long
//     tiles start first and no block holds the tail for a whole list.
//       any-hit: `occ` starts as the seed; a chunk that blocks a lane
//       stores 1 there (an OR in any order) and re-reads its lanes there
//       at every batch, so chunks of one tile share what they found; it
//       leaves once its lanes are all blocked.
//       closest hit: per lane a 64-bit key, (bits of t with -0.0 made +0.0)
//       << 32 | the member's index in the walk, combined across chunks by
//       atomicMin.  Among non-negative floats the bits order as the values
//       do, so the least key is the least t and, among equal t, the first
//       cluster walked.  A small second kernel re-tests the winning
//       cluster of each lane with the (t, id) rule and writes t and tri.
//       A chunk reads the lane's key at every batch and skips a member
//       whose t cannot beat it, so chunks of one tile prune each other.
//   - Staging in batches.  A block stages CRT_STREAM_BATCH members per
//     barrier into a ring of CRT_STREAM_STAGES batches with cp.async,
//     CRT_STREAM_STAGES - 1 batches ahead of the tests, so the copy of the
//     next batches overlaps the tests of this one: one barrier a batch,
//     not two a member.  Each copy is 4 bytes and lands at the float's
//     place in a member-major record image (per slot {n, nv0} {m0-2, c0}
//     {m3-5, c1} {m6-8, c2} {nobf}), the thread's source and destination
//     offsets fixed for the launch, so the tests read a slot with four
//     16-byte shared loads and one 4-byte load, and no float goes through
//     a per-column branch.
//   - A block serves 256 lanes of a tile (a work tile), one ray a
//     thread; a warp's rays are 32 consecutive lanes.  Two or four rays a
//     thread (a whole 1,024-lane tile a block, each member staged once a
//     tile) measured no faster on the card (PERF.md), so they were not
//     kept.
//   - Early decisions.  The plane gates come before the divide, then
//     t * t <= r2 (any-hit) or "t beats the lane's key" (closest hit)
//     before the three edge half-spaces; a stage is skipped where no
//     lane of the warp can still pass, and within a stage every ray
//     computes without branches.  Every condition and every operation of
//     the member test (cluster_common.cuh) stays as it is, so no bit
//     changes.
//   - The any-hit repacks its unblocked rays to the front of the block at
//     a batch barrier whenever that empties a warp, and a warp whose rays
//     are all blocked skips the tests: blocked lanes stop costing issue
//     slots, where before they idled inside partly live warps.

#include "cluster_common.cuh"

#define CRT_STREAM_BATCH 8   // members staged per barrier
#define CRT_STREAM_STAGES 3  // batches in the ring
#define CRT_MEMBER_FLOATS (CRT_CLUSTER_SIZE * CRT_SLOT_FLOATS)
#define CRT_STAGE_FLOATS (CRT_STREAM_BATCH * CRT_MEMBER_FLOATS)
#define CRT_RING_BYTES (CRT_STREAM_STAGES * CRT_STAGE_FLOATS * 4)  // 30,720
#define CRT_MEMBER_LOADS (CRT_CLUSTER_SIZE * (CRT_FUSED_COLS - 1))  // 272
#define CRT_NO_KEY 0xffffffffffffffffull

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

// The work items (stream_trace.stream_items): work tile w is lane group
// w % groups of tile w / groups; item i is chunk i - item_end[pos - 1] of
// work tile order[pos], pos the first with item_end[pos] > i.
struct StreamItems {
  const int* order;     // [wtiles] work tiles, longest walk first
  const int* item_end;  // [wtiles] inclusive prefix sum of their chunks
  const int* pair_off;  // [P + 1] live members before each pair
  int* next;            // the next item to take; 0 at launch
  int wtiles, groups, chunk;
};

// One float of a member that this thread copies: it lies at
// src + sc_idx * per_sc + member * per_member + off, and goes to dst in the
// member's record image.
struct CopyPlan {
  const float* src;
  long long per_sc;
  int per_member;
  int off;
  int dst;
};

// The plan for float f (< 272) of a member: fused, slot-major runs of 18
// floats (the id column skipped); lane, 17 column runs of 16 slots at a
// stride of sc*16; rows, the five arrays' runs.
template <int LAYOUT>
__device__ CopyPlan copy_plan(const StreamTable& tb, int f, int sc) {
  CopyPlan p;
  if (LAYOUT == kFused) {
    const int j = f / (CRT_FUSED_COLS - 1), col = f % (CRT_FUSED_COLS - 1);
    p.src = tb.t0;
    p.per_member = CRT_CLUSTER_SIZE * CRT_FUSED_COLS;
    p.off = j * CRT_FUSED_COLS + col;
    p.dst = j * CRT_SLOT_FLOATS + record_pos(col);
  } else if (LAYOUT == kLane) {
    const int col = f / CRT_CLUSTER_SIZE, j = f % CRT_CLUSTER_SIZE;
    const int S = sc * CRT_CLUSTER_SIZE;
    p.src = tb.t0;
    p.per_member = CRT_CLUSTER_SIZE;
    p.off = col * S + j;
    p.dst = j * CRT_SLOT_FLOATS + record_pos(col);
    p.per_sc = (long long)CRT_FUSED_COLS * S;
    return p;
  } else {
    int width, e, col0;
    if (f < 48) {
      p.src = tb.t0, width = 3, e = f, col0 = 0;
    } else if (f < 64) {
      p.src = tb.nv0, width = 1, e = f - 48, col0 = 3;
    } else if (f < 208) {
      p.src = tb.m, width = 9, e = f - 64, col0 = 4;
    } else if (f < 256) {
      p.src = tb.c, width = 3, e = f - 208, col0 = 13;
    } else {
      p.src = tb.nobf, width = 1, e = f - 256, col0 = 16;
    }
    p.per_member = CRT_CLUSTER_SIZE * width;
    p.off = e;
    p.dst = (e / width) * CRT_SLOT_FLOATS + record_pos(col0 + e % width);
  }
  p.per_sc = (long long)sc * p.per_member;  // clusters are sc_idx*sc+member
  return p;
}

// The walk's position: pair p and its members not yet taken.
struct Cursor {
  int p;
  unsigned bits;
  long long sc_idx;
};

// Stage the next `count` members of the walk into `stage` (uniform over
// the block) and commit them as one cp.async group, empty or not.
__device__ __forceinline__ void issue_batch(
    float* stage, int count, Cursor& cur, const CopyPlan& a,
    const CopyPlan& b, bool has_b, const int* __restrict__ pair_sc,
    const unsigned* __restrict__ pair_bits) {
  for (int m = 0; m < count; ++m) {
    while (cur.bits == 0u) {
      ++cur.p;
      cur.bits = pair_bits[cur.p];
      cur.sc_idx = pair_sc[cur.p];
    }
    const int member = __ffs((int)cur.bits) - 1;
    cur.bits &= cur.bits - 1u;
    float* img = stage + m * CRT_MEMBER_FLOATS;
    cp_async4(img + a.dst,
              a.src + cur.sc_idx * a.per_sc + member * a.per_member + a.off);
    if (has_b)
      cp_async4(img + b.dst, b.src + cur.sc_idx * b.per_sc +
                                 member * b.per_member + b.off);
  }
  cp_async_commit();
}

// A thread's ray: lane gbase + lane of the launch, gbase the first lane of
// the work tile.  A warp tests 32 consecutive lanes, which lie close on
// the image (a pixel tile's rows, or phase 2's compacted survivors in pixel
// order), so its gates more often fail together.  The any-hit repacks its
// unblocked rays to the front of the block as lanes get blocked
// (compact_rays), so a ray carries its lane.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

template <bool OCCL>
struct LaneState;

// any-hit: whether the lane is blocked, its squared reach.
template <>
struct LaneState<true> {
  bool blocked;
  float reach2;
  int lane;
  __device__ __forceinline__ bool live() const { return !blocked; }
  __device__ __forceinline__ bool gate(float t, unsigned) const {
    return t * t <= reach2;
  }
};

// closest hit: the least key seen, and its t (as +0.0 for a zero) and walk
// index: a member passes the gate when its key would be smaller.
template <>
struct LaneState<false> {
  unsigned long long best;
  float bt;
  unsigned bg;
  bool dirty;
  int lane;
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ bool gate(float t, unsigned g) const {
    return t < bt || (t == bt && g < bg);
  }
  __device__ __forceinline__ void set(unsigned long long key) {
    best = key;
    if (key == CRT_NO_KEY) {  // nothing yet: no t passes that is not < inf
      bt = CUDART_INF_F;
      bg = 0u;
    } else {
      bt = __uint_as_float((unsigned)(key >> 32));
      bg = (unsigned)key;
    }
  }
};

// Test the thread's ray against the `count` members staged in `stage`, the
// first of them member g_first of the walk.
template <bool OCCL>
__device__ __forceinline__ void test_batch(const float* stage, int count,
                                           unsigned g_first, const Ray& ray,
                                           LaneState<OCCL>& st,
                                           unsigned char* occ,
                                           long long gbase) {
  for (int m = 0; m < count; ++m) {
    // a warp whose lanes are all blocked is done
    if (OCCL && __all_sync(0xffffffffu, !st.live())) return;
    const float* rec = stage + m * CRT_MEMBER_FLOATS;
    const unsigned g = g_first + (unsigned)m;
#pragma unroll 4
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
      const float* slot = rec + j * CRT_SLOT_FLOATS;
      const float4 pl = *reinterpret_cast<const float4*>(slot);
      const float nd = pl.x * ray.dx + pl.y * ray.dy + pl.z * ray.dz;
      const float no = pl.x * ray.ox + pl.y * ray.oy + pl.z * ray.oz;
      const float opd = pl.w - no;
      const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
      bool ok = st.live() && not_parallel &&
                ((opd < 0.0f) || (slot[16] > 0.5f));
      if (!__any_sync(0xffffffffu, ok)) continue;
      // from here on without branches: every lane computes, ok masks
      const float t = opd / (not_parallel ? nd : 1.0f);
      ok = ok && (t >= 0.0f) && st.gate(t, g);
      if (!__any_sync(0xffffffffu, ok)) continue;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float4 me = *reinterpret_cast<const float4*>(slot + 4 + 4 * e);
        const float md = me.x * ray.dx + me.y * ray.dy + me.z * ray.dz;
        const float mo = me.x * ray.ox + me.y * ray.oy + me.z * ray.oz;
        ok = ok && ((mo - me.w) + t * md >= 0.0f);
      }
      if (!ok) continue;
      if constexpr (OCCL) {
        st.blocked = true;
        occ[gbase + st.lane] = 1;
      } else {
        const float tz = t == 0.0f ? 0.0f : t;  // -0.0 -> +0.0
        st.set(((unsigned long long)__float_as_uint(tz) << 32) | g);
        st.dirty = true;
      }
    }
  }
}

// Share the lane's state with the other chunks of the tile: the any-hit
// re-reads `occ`; the closest hit pushes an improved key with atomicMin
// (whose old value is the freshest) or re-reads it.
template <bool OCCL>
__device__ __forceinline__ void exchange(LaneState<OCCL>& st,
                                         unsigned char* occ,
                                         unsigned long long* key,
                                         long long gbase) {
  const long long r = gbase + st.lane;
  if constexpr (OCCL) {
    if (!st.blocked)
      st.blocked = *reinterpret_cast<volatile unsigned char*>(occ + r);
  } else {
    unsigned long long seen;
    if (st.dirty) {
      seen = atomicMin(key + r, st.best);
      st.dirty = false;
    } else {
      seen = *reinterpret_cast<volatile unsigned long long*>(key + r);
    }
    if (seen < st.best) st.set(seen);
  }
}

// Move the block's `live` unblocked rays to the front, in their order, and
// block the rest, so that the warps past them have nothing to test.
// `buf` holds 8 words a ray, `s_scan` an int a warp.  Uniform over the
// block.
__device__ void compact_rays(Ray& ray, LaneState<true>& st, int live,
                             float* buf, int* s_scan) {
  const unsigned mask = __ballot_sync(0xffffffffu, !st.blocked);
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (ln == 0) s_scan[w] = __popc(mask);
  __syncthreads();
  if (!st.blocked) {
    int pos = __popc(mask & ((1u << ln) - 1u));
    for (int i = 0; i < w; ++i) pos += s_scan[i];
    buf[pos] = ray.ox, buf[CRT_BLOCK + pos] = ray.oy;
    buf[2 * CRT_BLOCK + pos] = ray.oz, buf[3 * CRT_BLOCK + pos] = ray.dx;
    buf[4 * CRT_BLOCK + pos] = ray.dy, buf[5 * CRT_BLOCK + pos] = ray.dz;
    buf[6 * CRT_BLOCK + pos] = st.reach2;
    reinterpret_cast<int*>(buf)[7 * CRT_BLOCK + pos] = st.lane;
  }
  __syncthreads();
  const int i = threadIdx.x;
  st.blocked = i >= live;
  if (i < live) {
    ray.ox = buf[i], ray.oy = buf[CRT_BLOCK + i];
    ray.oz = buf[2 * CRT_BLOCK + i], ray.dx = buf[3 * CRT_BLOCK + i];
    ray.dy = buf[4 * CRT_BLOCK + i], ray.dz = buf[5 * CRT_BLOCK + i];
    st.reach2 = buf[6 * CRT_BLOCK + i];
    st.lane = reinterpret_cast<const int*>(buf)[7 * CRT_BLOCK + i];
  }
}

// Bytes of dynamic shared memory a walk takes: the ring, and for the
// any-hit compact_rays' buffer; both fit the default 48 KB.
constexpr int walk_smem_bytes(bool occl) {
  return CRT_RING_BYTES + (occl ? 8 * 4 * CRT_BLOCK : 0);
}
static_assert(walk_smem_bytes(true) <= 48 * 1024, "walk shared memory");

// The chunked walk: a persistent block takes items until none is left.
template <int LAYOUT, bool OCCL>
__device__ __forceinline__ void walk_items(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ r2, const StreamTable& tb,
    const int* __restrict__ pair_sc, const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, const StreamItems& it, int sc,
    int tile_rays, unsigned char* occ, unsigned long long* key) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  float* pack = ring + CRT_RING_BYTES / 4;  // compact_rays' buffer
  __shared__ int s_item;
  __shared__ int s_live[2][CRT_BLOCK / 32];
  __shared__ int s_scan[CRT_BLOCK / 32];

  const int f2 = threadIdx.x + CRT_BLOCK;
  const bool has_b = f2 < CRT_MEMBER_LOADS;
  const CopyPlan pa = copy_plan<LAYOUT>(tb, threadIdx.x, sc);
  const CopyPlan pb = copy_plan<LAYOUT>(tb, has_b ? f2 : 0, sc);
  const int n_items = it.item_end[it.wtiles - 1];

  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(it.next, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;  // uniform

    // the item: chunk c of work tile wt, members [g0, g0 + n_mem) of the
    // walk
    int lo = 0, hi = it.wtiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (it.item_end[mid] > item) hi = mid;
      else lo = mid + 1;
    }
    const int wt = it.order[lo];
    const int c = item - (lo ? it.item_end[lo - 1] : 0);
    const int tile = wt / it.groups, group = wt % it.groups;
    const int p_lo = tile_start[tile], p_hi = tile_start[tile + 1];
    const int g0 = it.pair_off[p_lo] + c * it.chunk;
    const int n_mem = min(it.chunk, it.pair_off[p_hi] - g0);
    // the pair that holds member g0: the last with pair_off <= g0
    int a = p_lo, b = p_hi - 1;
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (it.pair_off[mid] <= g0) a = mid;
      else b = mid - 1;
    }
    Cursor cur{a, pair_bits[a], (long long)pair_sc[a]};
    for (int k = g0 - it.pair_off[a]; k > 0; --k) cur.bits &= cur.bits - 1u;

    const long long gbase =
        (long long)tile * tile_rays + (long long)group * CRT_BLOCK;
    const long long r = gbase + threadIdx.x;
    Ray ray{o[3 * r], o[3 * r + 1], o[3 * r + 2],
            d[3 * r], d[3 * r + 1], d[3 * r + 2]};
    LaneState<OCCL> st;
    st.lane = threadIdx.x;
    if constexpr (OCCL) {
      st.blocked = false;
      st.reach2 = r2[r];
    } else {
      st.set(CRT_NO_KEY);
      st.dirty = false;
    }

    const int nb = (n_mem + CRT_STREAM_BATCH - 1) / CRT_STREAM_BATCH;
#pragma unroll
    for (int s = 0; s < CRT_STREAM_STAGES - 1; ++s)
      issue_batch(ring + s * CRT_STAGE_FLOATS,
                  s < nb ? min(CRT_STREAM_BATCH, n_mem - s * CRT_STREAM_BATCH)
                         : 0,
                  cur, pa, pb, has_b, pair_sc, pair_bits);
    for (int bi = 0; bi < nb; ++bi) {
      cp_async_wait<CRT_STREAM_STAGES - 2>();  // this thread's batch bi
      exchange(st, occ, key, gbase);
      // one barrier a batch: batch bi is in, batch bi - 1 is tested; the
      // any-hit counts its live rays per warp into s_live beside it (two
      // buffers by batch parity: a warp that runs ahead writes the other)
      if constexpr (OCCL) {
        int* live_w = s_live[bi & 1];
        const unsigned mask = __ballot_sync(0xffffffffu, !st.blocked);
        if ((threadIdx.x & 31) == 0) live_w[threadIdx.x >> 5] = __popc(mask);
        __syncthreads();
        int live = 0, warps = 0;
#pragma unroll
        for (int w = 0; w < CRT_BLOCK / 32; ++w) {
          live += live_w[w];
          warps += live_w[w] > 0 ? 1 : 0;
        }
        if (live == 0) break;  // every lane of the chunk is blocked
        if ((live + 31) / 32 < warps) compact_rays(ray, st, live, pack, s_scan);
      } else {
        __syncthreads();
      }
      const int nx = bi + CRT_STREAM_STAGES - 1;
      issue_batch(ring + (nx % CRT_STREAM_STAGES) * CRT_STAGE_FLOATS,
                  nx < nb ? min(CRT_STREAM_BATCH,
                                n_mem - nx * CRT_STREAM_BATCH)
                          : 0,
                  cur, pa, pb, has_b, pair_sc, pair_bits);
      test_batch<OCCL>(ring + (bi % CRT_STREAM_STAGES) * CRT_STAGE_FLOATS,
                       min(CRT_STREAM_BATCH, n_mem - bi * CRT_STREAM_BATCH),
                       (unsigned)(g0 + bi * CRT_STREAM_BATCH), ray, st, occ,
                       gbase);
    }
    cp_async_wait<0>();
    if constexpr (!OCCL) exchange(st, occ, key, gbase);
    __syncthreads();  // the ring and s_item are free for the next item
  }
}

// The two walks as kernels of their own names (profiles read them so).
template <int LAYOUT>
__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_stream_walk(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ r2, StreamTable tb,
    const int* __restrict__ pair_sc, const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, StreamItems it, int sc,
    int tile_rays, unsigned char* occ, unsigned long long* key) {
  walk_items<LAYOUT, false>(o, d, r2, tb, pair_sc, pair_bits, tile_start,
                            it, sc, tile_rays, occ, key);
}

template <int LAYOUT>
__global__ void __launch_bounds__(CRT_BLOCK) occlusion_stream_walk(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ r2, StreamTable tb,
    const int* __restrict__ pair_sc, const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, StreamItems it, int sc,
    int tile_rays, unsigned char* occ, unsigned long long* key) {
  walk_items<LAYOUT, true>(o, d, r2, tb, pair_sc, pair_bits, tile_start,
                           it, sc, tile_rays, occ, key);
}

// Slot j of the cluster (sc_idx, member) from device memory, in fused
// column order (17 floats).
template <int LAYOUT>
__device__ __forceinline__ void load_slot(const StreamTable& tb,
                                          long long sc_idx, int member,
                                          int sc, int j, float* v) {
  const long long cl = sc_idx * sc + member;
  if (LAYOUT == kFused) {
    const float* src =
        tb.t0 + (cl * CRT_CLUSTER_SIZE + j) * CRT_FUSED_COLS;
#pragma unroll
    for (int col = 0; col < CRT_FUSED_COLS - 1; ++col) v[col] = src[col];
  } else if (LAYOUT == kLane) {
    const long long S = (long long)sc * CRT_CLUSTER_SIZE;
    const float* src = tb.t0 + sc_idx * CRT_FUSED_COLS * S +
                       member * CRT_CLUSTER_SIZE + j;
#pragma unroll
    for (int col = 0; col < CRT_FUSED_COLS - 1; ++col) v[col] = src[col * S];
  } else {
    const long long s = cl * CRT_CLUSTER_SIZE + j;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = tb.t0[3 * s + k];
    v[3] = tb.nv0[s];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[4 + k] = tb.m[9 * s + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[13 + k] = tb.c[3 * s + k];
    v[16] = tb.nobf[s];
  }
}

// The member test (cluster_common.cuh) on a slot in fused column order,
// the hit distance or +inf: the same operations in the same order.
__device__ __forceinline__ float slot_t(const float* v, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  const float nd = v[0] * dx + v[1] * dy + v[2] * dz;
  const float no = v[0] * ox + v[1] * oy + v[2] * oz;
  const float opd = v[3] - no;
  const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
  const bool face_ok = (opd < 0.0f) || (v[16] > 0.5f);
  const float t = opd / (not_parallel ? nd : 1.0f);
  bool valid = not_parallel && face_ok && (t >= 0.0f);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* me = v + 4 + 3 * e;
    const float md = me[0] * dx + me[1] * dy + me[2] * dz;
    const float mo = me[0] * ox + me[1] * oy + me[2] * oz;
    valid = valid && ((mo - v[13 + e]) + t * md >= 0.0f);
  }
  return valid ? t : CUDART_INF_F;
}

// The closest hit's last step: per lane, the cluster its key names,
// re-tested with the (t, id) rule; a lane without a key misses.
template <int LAYOUT>
__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_stream_finish(
    const float* __restrict__ o, const float* __restrict__ d,
    StreamTable tb, const int* __restrict__ tid,
    const int* __restrict__ pair_sc, const unsigned* __restrict__ pair_bits,
    const int* __restrict__ tile_start, const int* __restrict__ pair_off,
    int sc, int tile_rays, long long R,
    const unsigned long long* __restrict__ key, float* __restrict__ best_t,
    int* __restrict__ best_tri) {
  const long long r = (long long)blockIdx.x * CRT_BLOCK + threadIdx.x;
  if (r >= R) return;
  const unsigned long long k = key[r];
  if (k == CRT_NO_KEY) {
    best_t[r] = CUDART_INF_F;
    best_tri[r] = -1;
    return;
  }
  const int g = (int)(unsigned)k;
  const int tile = (int)(r / tile_rays);
  int a = tile_start[tile], b = tile_start[tile + 1] - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (pair_off[mid] <= g) a = mid;
    else b = mid - 1;
  }
  unsigned bits = pair_bits[a];
  for (int s = g - pair_off[a]; s > 0; --s) bits &= bits - 1u;
  const int member = __ffs((int)bits) - 1;
  const long long sc_idx = pair_sc[a];
  const long long cl = sc_idx * sc + member;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float cl_best = CUDART_INF_F;
  int cl_tri = 1 << 30;
  for (int j = 0; j < CRT_CLUSTER_SIZE; ++j) {
    float v[CRT_FUSED_COLS - 1];
    load_slot<LAYOUT>(tb, sc_idx, member, sc, j, v);
    const float t = slot_t(v, ox, oy, oz, dx, dy, dz);
    const int id = tid[cl * CRT_CLUSTER_SIZE + j];
    if (t < cl_best || (t == cl_best && id < cl_tri)) {
      cl_best = t;
      cl_tri = id;
    }
  }
  best_t[r] = cl_best;
  best_tri[r] = cl_tri;
}

bool bad_shape(int sc, int num_tiles, int tile_rays, const StreamItems& it) {
  return sc < 1 || sc > 32 || tile_rays <= 0 || it.groups < 1 ||
         it.groups * CRT_BLOCK != tile_rays || it.chunk < 1 ||
         (long long)num_tiles * it.groups != it.wtiles ||
         (long long)num_tiles * tile_rays > 0x7fffffffLL;
}

bool bad_table(int layout, const StreamTable& tb) {
  if (tb.t0 == nullptr) return true;
  if (layout == kRows)
    return tb.nv0 == nullptr || tb.m == nullptr || tb.c == nullptr ||
           tb.nobf == nullptr;
  return layout != kFused && layout != kLane;
}

// The walk of `layout` on a persistent grid: as many blocks as the card
// holds at once, and no more than `max_items`.
template <bool OCCL>
void launch_walk(int layout, const float* o, const float* d, const float* r2,
                 const StreamTable& tb, const int* pair_sc,
                 const unsigned* pair_bits, const int* tile_start,
                 const StreamItems& it, int sc, int tile_rays, int max_items,
                 unsigned char* occ, unsigned long long* key,
                 cudaStream_t st) {
  using Walk = void (*)(const float*, const float*, const float*, StreamTable,
                        const int*, const unsigned*, const int*, StreamItems,
                        int, int, unsigned char*, unsigned long long*);
  const Walk walks[2][3] = {
      {closest_hit_stream_walk<kFused>, closest_hit_stream_walk<kLane>,
       closest_hit_stream_walk<kRows>},
      {occlusion_stream_walk<kFused>, occlusion_stream_walk<kLane>,
       occlusion_stream_walk<kRows>}};
  const Walk kernel = walks[OCCL][layout];
  constexpr int smem = walk_smem_bytes(OCCL);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CRT_BLOCK,
                                                smem);
  const int grid = max(1, min(max_items, sms * max(per_sm, 1)));
  kernel<<<grid, CRT_BLOCK, smem, st>>>(o, d, r2, tb, pair_sc, pair_bits,
                                        tile_start, it, sc, tile_rays, occ,
                                        key);
}

}  // namespace

// Host entries, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`: o, d [num_tiles * tile_rays, 3]; the table in
// `layout` (0 fused: t0 = [L,16,18]; 1 lane: t0 = [L/sc, 18, sc*16]; 2
// rows: t0..t4 = n [L,16,3], nv0 [L,16], m [L,16,9], c [L,16,3], nobf
// [L,16]; t1..t4 null for the first two) and tid [L,16], L a multiple of
// sc; pair_sc, pair_bits [P]; tile_start [num_tiles + 1]; the items of
// stream_trace.stream_items: order, item_end [wtiles], pair_off [P + 1]
// and `next`, one int set to 0; `groups` work tiles of 256 lanes a tile
// (groups * 256 == tile_rays), `chunk` live
// members an item at most, `max_items` a bound on the item count.  Each
// returns cudaGetLastError() after its launches.
//
// The closest hit takes `key` [R] u64, every bit set at launch (the
// combine's scratch), and writes best_t, best_tri [R].
extern "C" int crt_closest_hit_stream(
    const float* o, const float* d, int layout, const float* t0,
    const float* t1, const float* t2, const float* t3, const float* t4,
    const int* tid, const int* pair_sc, const unsigned* pair_bits,
    const int* tile_start, const int* order, const int* item_end,
    const int* pair_off, int* next, int sc, int num_tiles, int tile_rays,
    int groups, int chunk, int max_items, unsigned long long* key,
    float* best_t, int* best_tri, void* stream) {
  if (num_tiles <= 0) return 0;
  const StreamTable tb{t0, t1, t2, t3, t4};
  const StreamItems it{order, item_end, pair_off, next, num_tiles * groups,
                       groups, chunk};
  if (bad_shape(sc, num_tiles, tile_rays, it) || bad_table(layout, tb) ||
      tid == nullptr || key == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (max_items > 0)
    launch_walk<false>(layout, o, d, nullptr, tb, pair_sc, pair_bits,
                       tile_start, it, sc, tile_rays, max_items, nullptr, key,
                       st);
  const long long R = (long long)num_tiles * tile_rays;
  const unsigned blocks = (unsigned)((R + CRT_BLOCK - 1) / CRT_BLOCK);
#define CRT_FINISH(L)                                                       \
  closest_hit_stream_finish<L><<<blocks, CRT_BLOCK, 0, st>>>(               \
      o, d, tb, tid, pair_sc, pair_bits, tile_start, pair_off, sc,          \
      tile_rays, R, key, best_t, best_tri)
  if (layout == kFused) CRT_FINISH(kFused);
  else if (layout == kLane) CRT_FINISH(kLane);
  else CRT_FINISH(kRows);
#undef CRT_FINISH
  return (int)cudaGetLastError();
}

// The any-hit takes `occ` [R] u8 holding the seed at launch, and leaves
// the answer there.
extern "C" int crt_occlusion_stream(
    const float* o, const float* d, const float* r2, int layout,
    const float* t0, const float* t1, const float* t2, const float* t3,
    const float* t4, const int* pair_sc, const unsigned* pair_bits,
    const int* tile_start, const int* order, const int* item_end,
    const int* pair_off, int* next, int sc, int num_tiles, int tile_rays,
    int groups, int chunk, int max_items, unsigned char* occ,
    void* stream) {
  if (num_tiles <= 0) return 0;
  const StreamTable tb{t0, t1, t2, t3, t4};
  const StreamItems it{order, item_end, pair_off, next, num_tiles * groups,
                       groups, chunk};
  if (bad_shape(sc, num_tiles, tile_rays, it) || bad_table(layout, tb) ||
      occ == nullptr)
    return (int)cudaErrorInvalidValue;
  if (max_items > 0)
    launch_walk<true>(layout, o, d, r2, tb, pair_sc, pair_bits, tile_start,
                      it, sc, tile_rays, max_items, occ, nullptr,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
