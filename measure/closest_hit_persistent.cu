// A design of K7, the tile-merged closest hit, built and timed beside the
// kernel in crt_tpu_torch/csrc/closest_hit.cu and not taken (times in
// PERF.md section 6, by measure/merged_variants.py).  It is on no path of
// the port.  The file is a whole closest_hit.cu: measure/merged_variants.py
// builds it in place of that file, with the rest of crt_tpu_torch/csrc.
// K1 and K4 are the kernel's, their walk split into walk_list; K7 takes
// (merge group, 256-lane window) items from a counter on a persistent grid
// and walks a list that a sub-tile repeats from the staged ring.
//
// K1: binned closest hit with emitted packed rows; K4: the same over the
// live tiles only; K7: the same over groups of `merge` tiles.
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
// What bounds it on an H100.  On the small scenes the cluster backend
// serves (a few clusters, lists of ~2 on the opaque primary, a bounce pool
// of mostly empty lists) the outputs, 8 + 4 kp bytes a lane against 24
// read, and a fixed cost per tile.  On the largest scene it serves (4,096
// clusters, lists of ~60) FP32 issue: a member test is ~51 flops, which
// -fmad=false and the IEEE divide make ~59 FP32 instructions, against
// tables that stay in the 50 MB L2.
//
// The design, one point per thing that held the earlier walk (a block per
// quarter tile, a cluster staged per two barriers, 18 scalar shared loads
// a member test) back (PERF.md, section 6):
//   - A persistent grid.  As many 256-thread blocks as are resident on the
//     card at once take quarter tiles (256 lanes, a unit) at a stride of
//     the grid, reading the counts of 256 units at once
//     (cluster_common.cuh for_each_unit).  A unit with an empty list costs
//     its miss stores: no block launch, no barrier, no load latency.
//   - Staging in batches.  A block stages CRT_BATCH clusters per barrier
//     (ClusterRing) by cp.async into member-major records, CRT_STAGES - 1
//     batches ahead of the tests, so a member is read with five 16-byte
//     shared loads.  Batches are walked in list order, clusters in a batch
//     in list order, so the strict < across clusters is the list's.
//   - The shared origin.  When every ray of a unit starts at one point (a
//     pinhole camera's primary wavefront) the block computes the origin's
//     terms of each staged member once, opd = nv0 - n.o and mo - c per
//     edge, with the member test's operations, and the rays read them: a
//     test costs ~35 FP32 instructions instead of ~59, with the same bits.
//   - Members no ray can hit are not tested: a pad (zero normal) and, with
//     the shared origin, a face that the member test's face gate rejects
//     for that origin, marked per cluster at staging (a uniform branch).  A
//     cluster without one is tested without any branch: per-member warp
//     votes measured slower on long lists than the tests they skip.
//   - The epilogue reads the winning slot's row four values at a time, all
//     loads before the stores, and writes [kp, R] coalesced over R.
//
// K4 (live-tile compaction).  A sparse wavefront (a bounce pool whose banks
// are mostly dead) leaves most tiles with an empty list.  K4 takes K1's
// persistent loop over a live-first tile list built on the device:
//   - live_tiles_kernel, one block of CRT_LIST_THREADS threads, writes the
//     tile ids with a list (counts > 0) first, then the others, each part
//     in ascending order, and their number n_live behind them: a pass
//     counts the live tiles, a second places each tile by its warp's ballot
//     and a block-wide scan, batches of chunks of 1024 tiles a step with
//     coalesced loads in flight.  A stable scan rather than a warp-aggregated
//     append: one block needs no counter zeroed before it and the list is
//     the plain version's (an argsort of the dead flags) to the bit, which
//     the card tests compare; on the 16,320 tiles of a bounce pool it is a
//     few microseconds.  It replaces the wrapper's compare, sum, radix-sort
//     argsort and cast (five or more device kernels and their host time).
//   - closest_hit_compact_kernel: as many resident 256-thread blocks as
//     the card holds take items at a stride of the grid
//     (cluster_common.cuh for_each_listed_item): first the live tiles'
//     256-lane units in list order, so the blocks walk them together
//     (walk_unit, K1's walk: K1's outputs bit for bit), then one item per
//     dead tile, whose miss result (t = +inf, tri = -1, rows 0) the block
//     writes with 16-byte stores, four lanes a thread.  Origins are read
//     from tile % tile_mod when tile_mod > 0 (per-light shadow tiles share
//     one copy of the pixel origins).  Both kernels read n_live on the
//     device, so the launch needs no device-to-host read.

// K7 (tile merging).  On the TPU one grid step walks `merge` consecutive
// tiles' lists back to back on static lane windows of one fat block, which
// amortises the per-step fixed cost over sparse lists while the binning
// stays at 1024-ray tiles.  Here:
//   - An item is one (merge group, 256-lane window).  A persistent grid
//     takes the items one at a time from a counter (zeroed by the host
//     entry on the launch's stream), and an item whose sub-tiles are all
//     empty costs its miss stores (16-byte stores, as K4's dead tiles).
//   - The ring keeps the last list the block staged, when it fits
//     (count <= CRT_STAGES * CRT_BATCH), prepared for its origin.  A
//     sub-tile with the same list (count and ids compared in one barrier)
//     walks the staged batches again: no cp.async copy, no prepare_batch,
//     no staging barrier.  The prepared records and the culling bits hold
//     the shared origin's terms, so the block restages unless both walks
//     take the shared-origin path with the same origin bit for bit, or
//     neither takes it.
//   - The walk, the tests, the tie rule and the epilogue are K1's
//     (walk_list, test_batch, write_hit): the same records in the same
//     order, so the outputs are K1's bit for bit.
// What bounds it: K1's walk, whose time on the bench shapes is its member
// tests (the reuse measured no gain there, PERF.md), and where long lists
// neighbour each other, the chain of an item's sub-tiles walked in turn,
// which K1 walks in parallel.

#include "cluster_common.cuh"

namespace {

struct HitArgs {
  const float* o;
  const float* d;
  ClusterTables tb;
  const int* cluster_list;
  const int* counts;
  const float* rows_table;
  int num_clusters, tile_rays, kp;
  long long num_rays;
  float* best_t;
  int* best_tri;
  float* rows_out;
};

// Lane r's outputs: t, tri and, with kp > 0, the kp values of slot `slot`
// (zeros where slot < 0).
__device__ __forceinline__ void write_hit(const HitArgs& a, long long r,
                                          float t, int tri, int slot) {
  a.best_t[r] = t;
  a.best_tri[r] = tri;
  if (a.kp == 0) return;
  const bool hit = slot >= 0;
  const float* __restrict__ row = a.rows_table + (long long)(hit ? slot : 0) * a.kp;
  float* out = a.rows_out + r;
  const long long R = a.num_rays;
  int k = 0;
  for (; k + 4 <= a.kp; k += 4) {
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
    if (hit) {
      v0 = __ldg(row + k);
      v1 = __ldg(row + k + 1);
      v2 = __ldg(row + k + 2);
      v3 = __ldg(row + k + 3);
    }
    out[k * R] = v0;
    out[(k + 1) * R] = v1;
    out[(k + 2) * R] = v2;
    out[(k + 3) * R] = v3;
  }
  for (; k < a.kp; ++k) out[k * R] = hit ? __ldg(row + k) : 0.0f;
}

// One member's test for one ray, the member test's arithmetic, and the
// (t, id) rule into cl_best / cl_tri / cl_j.  SHARED: the record holds the ray
// origin's terms (opd in nv0's place, mo - c in each c's; prepare_batch).
template <bool SHARED>
__device__ __forceinline__ void test_member(const float* slot, int j,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float& cl_best, int& cl_tri,
                                            int& cl_j) {
  const float4 pw = rec_word(slot, 0);
  const float nd = pw.x * dx + pw.y * dy + pw.z * dz;
  float opd;
  if (SHARED) {
    opd = pw.w;
  } else {
    const float no = pw.x * ox + pw.y * oy + pw.z * oz;
    opd = pw.w - no;
  }
  const bool not_parallel = fabsf(nd) >= CRT_PARALLEL_EPS;
  const float4 tw = rec_word(slot, 4);
  bool ok = not_parallel && ((opd < 0.0f) || (tw.x > 0.5f));
  const float t = opd / (not_parallel ? nd : 1.0f);
  ok = ok && (t >= 0.0f);
  if (SHARED) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float4 me = rec_word(slot, 1 + e);
      const float md = me.x * dx + me.y * dy + me.z * dz;
      ok = ok && (me.w + t * md >= 0.0f);
    }
  } else {
    ok = ok && rec_edges(slot, ox, oy, oz, dx, dy, dz, t);
  }
  const int id = __float_as_int(tw.y);
  if (ok && (t < cl_best || (t == cl_best && id < cl_tri))) {
    cl_best = t;
    cl_tri = id;
    cl_j = j;
  }
}

// The (t, id) minimum of a cluster's 16 members (record `rec`) for one
// ray.  `skip` (uniform over the block) marks members that no ray of the
// block can hit; a cluster without one is tested without branches.
template <bool SHARED>
__device__ __forceinline__ void test_cluster(const float* rec, unsigned skip,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float& cl_best, int& cl_tri,
                                             int& cl_j) {
  if (skip == 0u) {
#pragma unroll
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j)
      test_member<SHARED>(rec + j * CRT_SLOT_FLOATS, j, ox, oy, oz, dx, dy,
                          dz, cl_best, cl_tri, cl_j);
  } else {
#pragma unroll
    for (int j = 0; j < CRT_CLUSTER_SIZE; ++j)
      if (!((skip >> j) & 1u))
        test_member<SHARED>(rec + j * CRT_SLOT_FLOATS, j, ox, oy, oz, dx,
                            dy, dz, cl_best, cl_tri, cl_j);
  }
}

// Prepare the `count` staged clusters of batch `st` for the tests (one
// slot a thread), then a barrier.  With the block's shared origin
// (`shared`), put the origin's terms into each record: opd = nv0 - n.o in
// nv0's place, mo - c in each c's, computed as the member test computes
// them, so every ray reads them instead of computing them.  Mark in
// ring.skip the members no ray can hit: a zero normal (a pad: |n.d| is 0
// or NaN, never >= PARALLEL_EPS) and, with the shared origin, a face that
// the member test's face gate rejects for that origin.
__device__ __forceinline__ void prepare_batch(ClusterRing& ring, int st,
                                              int count, bool shared,
                                              float ox, float oy, float oz) {
  bool skip = false;
  if ((int)threadIdx.x < count * CRT_CLUSTER_SIZE) {
    float* slot = ring.rec + st * CRT_BATCH_FLOATS +
                  threadIdx.x * CRT_SLOT_FLOATS;
    skip = slot[0] == 0.0f && slot[1] == 0.0f && slot[2] == 0.0f;
    if (shared) {
      const float no = slot[0] * ox + slot[1] * oy + slot[2] * oz;
      const float opd = slot[3] - no;
      slot[3] = opd;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float* me = slot + 4 + 4 * e;
        const float mo = me[0] * ox + me[1] * oy + me[2] * oz;
        me[3] = mo - me[3];
      }
      skip = skip || !((opd < 0.0f) || (slot[16] > 0.5f));
    }
  }
  // a warp's 32 slots are two clusters' 16
  const unsigned bits = __ballot_sync(0xffffffffu, skip);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && 2 * w < CRT_BATCH) {
    ring.skip[st * CRT_BATCH + 2 * w] = bits & 0xffffu;
    ring.skip[st * CRT_BATCH + 2 * w + 1] = bits >> 16;
  }
  __syncthreads();
}

// Whether every ray of the block starts at one point, bit for bit (a
// pinhole camera's wavefront): this thread's origin against that of the
// block's first ray r_o - threadIdx.x.  A barrier; uniform over the block.
__device__ __forceinline__ bool block_shares_origin(const HitArgs& a,
                                                    long long r_o, float ox,
                                                    float oy, float oz) {
  const unsigned* o0 =
      reinterpret_cast<const unsigned*>(a.o + 3 * (r_o - threadIdx.x));
  return __syncthreads_and(__float_as_uint(ox) == o0[0] &&
                           __float_as_uint(oy) == o0[1] &&
                           __float_as_uint(oz) == o0[2]);
}

// A ray and its running (t, tri, slot) best.
struct WalkRay {
  float ox, oy, oz, dx, dy, dz;
  float best_t;
  int best_tri, best_slot;
};

// Test the `nc` prepared clusters of batch `st` in list order.
__device__ __forceinline__ void test_batch(const ClusterRing& ring, int st,
                                           int nc, bool shared, WalkRay& w) {
  for (int k = 0; k < nc; ++k) {
    const float* rec =
        ring.rec + st * CRT_BATCH_FLOATS + k * CRT_CLUSTER_FLOATS;
    const unsigned skip = ring.skip[st * CRT_BATCH + k];
    // lexicographic (t, id) minimum over the 16 members (an all-miss
    // cluster leaves cl_best = inf, which never wins)
    float cl_best = CUDART_INF_F;
    int cl_tri = 1 << 30;
    int cl_j = 0;
    if (shared)  // uniform over the block
      test_cluster<true>(rec, skip, w.ox, w.oy, w.oz, w.dx, w.dy, w.dz,
                         cl_best, cl_tri, cl_j);
    else
      test_cluster<false>(rec, skip, w.ox, w.oy, w.oz, w.dx, w.dy, w.dz,
                          cl_best, cl_tri, cl_j);
    if (cl_best < w.best_t) {  // strict: the first cluster walked wins ties
      w.best_t = cl_best;
      w.best_tri = cl_tri;
      w.best_slot = ring.cl[st * CRT_BATCH + k] * CRT_CLUSTER_SIZE + cl_j;
    }
  }
}

// The walk of one block over the `count` clusters of `list`: stage, prepare
// (for the block's shared origin, when `shared`) and test batch by batch.
// Uniform over the block; leaves the ring free.  A list of at most
// CRT_STAGES batches stays in the ring after it, batch b in stage b,
// prepared.  `staged` (K7) walks those batches again, without a copy, a
// prepare or a barrier, in the same loop body, so the member tests are
// compiled once (a loop of its own for the staged walk, a second copy of
// them, measured up to 15 % slower on the bench primary: PERF.md).
__device__ __forceinline__ void walk_list(ClusterRing& ring,
                                          const ClusterPlan& pl,
                                          const int* list, int count,
                                          bool shared, bool staged,
                                          WalkRay& w) {
  const int nb = (count + CRT_BATCH - 1) / CRT_BATCH;
  if (!staged) {
#pragma unroll
    for (int s = 0; s < CRT_STAGES - 1; ++s)
      issue_clusters(ring, s, list, s * CRT_BATCH, batch_size(s, count), pl);
  }
  for (int bi = 0; bi < nb; ++bi) {
    const int st = bi % CRT_STAGES;
    const int nc = batch_size(bi, count);
    if (!staged) {  // uniform over the block
      cp_async_wait<CRT_STAGES - 2>();  // this thread's copies of batch bi
      __syncthreads();  // batch bi is in; batch bi - 1 is tested
      const int nx = bi + CRT_STAGES - 1;
      issue_clusters(ring, nx % CRT_STAGES, list, nx * CRT_BATCH,
                     batch_size(nx, count), pl);
      prepare_batch(ring, st, nc, shared, w.ox, w.oy, w.oz);
    }
    test_batch(ring, st, nc, shared, w);
  }
  if (!staged) {
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next walk
  }
}

// The walk of one block over the `count` (> 0 or 0) clusters of `tile`'s
// list for its rays r_o (origins) and r (directions, outputs).  Uniform
// over the block; leaves the ring free.
__device__ __forceinline__ void walk_unit(ClusterRing& ring,
                                          const ClusterPlan& pl,
                                          const HitArgs& a, long long r_o,
                                          long long r, int tile, int count) {
  WalkRay w{a.o[3 * r_o], a.o[3 * r_o + 1], a.o[3 * r_o + 2],
            a.d[3 * r],   a.d[3 * r + 1],   a.d[3 * r + 2],
            CUDART_INF_F, -1,               -1};
  // one origin for every ray of the block (a pinhole camera's wavefront)?
  bool shared = false;
  if (count > 0) shared = block_shares_origin(a, r_o, w.ox, w.oy, w.oz);
  walk_list(ring, pl, a.cluster_list + (long long)tile * a.num_clusters,
            count, shared, false, w);
  write_hit(a, r, w.best_t, w.best_tri, w.best_slot);
}

__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_kernel(HitArgs a,
                                                                long long units) {
  __shared__ ClusterRing ring;
  __shared__ int s_count[CRT_BLOCK];
  const ClusterPlan pl(a.tb);
  for_each_unit(units, a.tile_rays / CRT_BLOCK, a.counts, s_count,
                [&](long long u, int count) {
                  const long long r = u * CRT_BLOCK + threadIdx.x;
                  if (count == 0)
                    write_hit(a, r, CUDART_INF_F, -1, -1);
                  else
                    walk_unit(ring, pl, a, r, r,
                              (int)(u / (a.tile_rays / CRT_BLOCK)), count);
                });
}

// The miss result of lanes r .. r + 3 in 16-byte stores (the outputs are
// 16-byte aligned and r divides by 4).
__device__ __forceinline__ void write_miss4(const HitArgs& a, long long r) {
  const float inf = CUDART_INF_F;
  *reinterpret_cast<float4*>(a.best_t + r) = make_float4(inf, inf, inf, inf);
  *reinterpret_cast<int4*>(a.best_tri + r) = make_int4(-1, -1, -1, -1);
  for (int k = 0; k < a.kp; ++k)
    *reinterpret_cast<float4*>(a.rows_out + k * a.num_rays + r) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The miss result of a whole dead tile, four lanes a thread (tile_rays
// divides by 4).
__device__ __forceinline__ void write_miss_tile(const HitArgs& a, int tile) {
  const long long base = (long long)tile * a.tile_rays;
  for (int q = 4 * (int)threadIdx.x; q < a.tile_rays; q += 4 * CRT_BLOCK)
    write_miss4(a, base + q);
}

#define CRT_LIST_THREADS 1024
#define CRT_LIST_BATCH 16  // 1024-tile chunks whose flags a thread holds

// The live-first tile list of `counts` [tiles] into list [tiles + 1]:
// live tiles (counts > 0) ascending, then dead ones ascending, then n_live.
// Thread t takes tiles t, t + 1024, ... (coalesced loads, a batch of them
// in flight) and places each from its warp's ballot and a scan of the
// (chunk, warp) counts.  A dead tile's place needs n_live: with more tiles
// than one batch holds, a first pass counts them.
__global__ void __launch_bounds__(CRT_LIST_THREADS) live_tiles_kernel(
    const int* __restrict__ counts, int tiles, int* __restrict__ list) {
  __shared__ int s_pre[CRT_LIST_BATCH * 32];  // live before (chunk, warp)
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int step = CRT_LIST_BATCH * CRT_LIST_THREADS;

  int n_live = 0;
  if (tiles > step) {
    int mine = 0;
    for (int b0 = 0; b0 < tiles; b0 += step) {
#pragma unroll
      for (int i = 0; i < CRT_LIST_BATCH; ++i) {
        const int tile = b0 + i * CRT_LIST_THREADS + t;
        mine += tile < tiles && counts[tile] > 0;
      }
    }
    mine = __reduce_add_sync(full, mine);
    if (lane == 0) s_warp[w] = mine;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; ++i) n_live += s_warp[i];
  }
  if (t == 0) s_carry = 0;

  for (int b0 = 0; b0 < tiles; b0 += step) {
    bool live[CRT_LIST_BATCH];
    unsigned bits[CRT_LIST_BATCH];
#pragma unroll
    for (int i = 0; i < CRT_LIST_BATCH; ++i) {
      const int tile = b0 + i * CRT_LIST_THREADS + t;
      live[i] = tile < tiles && counts[tile] > 0;
    }
#pragma unroll
    for (int i = 0; i < CRT_LIST_BATCH; ++i) {
      bits[i] = __ballot_sync(full, live[i]);
      if (lane == 0) s_pre[i * 32 + w] = __popc(bits[i]);
    }
    __syncthreads();
    if (w == 0) {  // exclusive scan over (chunk, warp), in tile order
      int v[CRT_LIST_BATCH], sum = 0;
#pragma unroll
      for (int i = 0; i < CRT_LIST_BATCH; ++i) {
        v[i] = s_pre[lane * CRT_LIST_BATCH + i];
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(full, incl, s);
        if (lane >= s) incl += y;
      }
      int at = s_carry + incl - sum;
#pragma unroll
      for (int i = 0; i < CRT_LIST_BATCH; ++i) {
        s_pre[lane * CRT_LIST_BATCH + i] = at;
        at += v[i];
      }
      __syncwarp();
      if (lane == 31) s_carry = at;
    }
    __syncthreads();
    if (tiles <= step) n_live = s_carry;  // one batch: its total
#pragma unroll
    for (int i = 0; i < CRT_LIST_BATCH; ++i) {
      const int tile = b0 + i * CRT_LIST_THREADS + t;
      if (tile < tiles) {
        // live tiles before this one
        const int before =
            s_pre[i * 32 + w] + __popc(bits[i] & ((1u << lane) - 1u));
        list[live[i] ? before : n_live + (tile - before)] = tile;
      }
    }
    __syncthreads();  // s_pre and s_carry are read before the next batch
  }
  if (t == 0) list[tiles] = n_live;
}

__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_compact_kernel(
    HitArgs a, const int* __restrict__ list, int tiles, int tile_mod) {
  __shared__ ClusterRing ring;
  __shared__ int s_tile[CRT_BLOCK];
  __shared__ int s_count[CRT_BLOCK];
  const ClusterPlan pl(a.tb);
  const int units_per_tile = a.tile_rays / CRT_BLOCK;
  for_each_listed_item(
      tiles, units_per_tile, list, a.counts, s_tile, s_count,
      [&](long long i, int tile, int count) {
        if (count == 0) {
          write_miss_tile(a, tile);
          return;
        }
        const int lane = (int)(i % units_per_tile) * CRT_BLOCK + threadIdx.x;
        const int o_tile = tile_mod > 0 ? tile % tile_mod : tile;
        walk_unit(ring, pl, a, (long long)o_tile * a.tile_rays + lane,
                  (long long)tile * a.tile_rays + lane, tile, count);
      });
}

// K7's merge groups: bit sub (< 31) of a group's mask is set when sub-tile
// sub has a list, bit 31 when any sub-tile from 31 on has one.
__device__ __forceinline__ unsigned group_mask(const int* __restrict__ counts,
                                               int group, int merge) {
  unsigned mask = 0;
  for (int sub = 0; sub < merge; ++sub)
    if (counts[group * merge + sub] > 0) mask |= 1u << min(sub, 31);
  return mask;
}

// K7's items handed out so far in the current launch (zeroed before it).
__device__ unsigned k7_items_taken;

// K7: items (merge group g, 256-lane window) in group order, taken one at
// a time from k7_items_taken (taken at the grid's stride, as K1 takes its
// units, the bench primary measured 11 % slower at merge 2: PERF.md).  An item walks lanes window*256 ..
// +255 of sub-tiles g*merge + sub in turn, a repeated list from the ring
// (above).  The block's item and held list are uniform and live in shared
// memory, which leaves the registers to the walk.
__global__ void __launch_bounds__(CRT_BLOCK) closest_hit_merged_kernel(
    HitArgs a, int merge, int items) {
  __shared__ ClusterRing ring;
  __shared__ int s_item;
  __shared__ unsigned s_mask;
  // the list held in the ring (count, 0: none), whether it was prepared
  // for a shared origin, and that origin's bits
  __shared__ int s_held;
  __shared__ unsigned s_origin[4];
  const ClusterPlan pl(a.tb);
  const int windows = a.tile_rays / CRT_BLOCK;
  if (threadIdx.x == 0) s_held = 0;
  for (;;) {
    __syncthreads();  // the previous item's s_item and s_mask are read
    if (threadIdx.x == 0) {
      s_item = (int)atomicAdd(&k7_items_taken, 1u);
      s_mask = s_item < items ? group_mask(a.counts, s_item / windows, merge)
                              : 0u;
    }
    __syncthreads();
    const int i = s_item;
    if (i >= items) break;
    const unsigned mask = s_mask;
    const int tile0 = i / windows * merge;
    const int window = i % windows * CRT_BLOCK;  // its first lane
    if (mask == 0u) {  // every sub-tile empty: the misses only
      for (int q = threadIdx.x; q < merge * (CRT_BLOCK / 4); q += CRT_BLOCK)
        write_miss4(a, (long long)(tile0 + q / (CRT_BLOCK / 4)) *
                               a.tile_rays + window + 4 * (q % (CRT_BLOCK / 4)));
      continue;
    }
    for (int sub = 0; sub < merge; ++sub) {  // uniform over the block
      const int tile = tile0 + sub;
      const long long r =
          (long long)tile * a.tile_rays + window + threadIdx.x;
      const int count = ((mask >> min(sub, 31)) & 1u) ? a.counts[tile] : 0;
      if (count == 0) {
        write_hit(a, r, CUDART_INF_F, -1, -1);
        continue;
      }
      WalkRay w{a.o[3 * r], a.o[3 * r + 1], a.o[3 * r + 2],
                a.d[3 * r], a.d[3 * r + 1], a.d[3 * r + 2],
                CUDART_INF_F, -1,           -1};
      const bool shared = block_shares_origin(a, r, w.ox, w.oy, w.oz);
      const int* list = a.cluster_list + (long long)tile * a.num_clusters;
      // with a shared origin every thread holds the block's, so the
      // origin test is uniform too
      bool again = s_held == count && s_origin[3] == (unsigned)shared &&
                   (!shared || (__float_as_uint(w.ox) == s_origin[0] &&
                                __float_as_uint(w.oy) == s_origin[1] &&
                                __float_as_uint(w.oz) == s_origin[2]));
      if (again)  // cluster i of a held list is ring.cl[i]
        again = __syncthreads_and((int)threadIdx.x >= count ||
                                  list[threadIdx.x] == ring.cl[threadIdx.x]);
      walk_list(ring, pl, list, count, shared, again, w);
      if (!again && threadIdx.x == 0) {  // read after the next barrier
        s_held = count <= CRT_STAGES * CRT_BATCH ? count : 0;
        s_origin[0] = __float_as_uint(w.ox);
        s_origin[1] = __float_as_uint(w.oy);
        s_origin[2] = __float_as_uint(w.oz);
        s_origin[3] = shared;
      }
      write_hit(a, r, w.best_t, w.best_tri, w.best_slot);
    }
  }
}

HitArgs hit_args(const float* o, const float* d, const float* n,
                 const float* nv0, const float* m, const float* c,
                 const float* nobf, const int* tid, const int* cluster_list,
                 const int* counts, const float* rows_table,
                 int num_clusters, int num_tiles, int tile_rays, int kp,
                 float* best_t, int* best_tri, float* rows_out) {
  return HitArgs{o, d, ClusterTables{n, nv0, m, c, nobf, tid, nullptr},
                 cluster_list, counts, rows_table, num_clusters, tile_rays,
                 kp, (long long)num_tiles * tile_rays, best_t, best_tri,
                 rows_out};
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
  const long long units = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  const long long grid =
      persistent_grid((const void*)closest_hit_kernel, units);
  if (grid <= 0) return (int)cudaGetLastError();
  closest_hit_kernel<<<(unsigned)grid, CRT_BLOCK, 0, (cudaStream_t)stream>>>(
      hit_args(o, d, n, nv0, m, c, nobf, tid, cluster_list, counts,
               rows_table, num_clusters, num_tiles, tile_rays, kp, best_t,
               best_tri, rows_out),
      units);
  return (int)cudaGetLastError();
}

// The live-first tile list of counts [tiles] into list [tiles + 1].
extern "C" int crt_live_tiles(const int* counts, int tiles, int* list,
                              void* stream) {
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  live_tiles_kernel<<<1, CRT_LIST_THREADS, 0, (cudaStream_t)stream>>>(
      counts, tiles, list);
  return (int)cudaGetLastError();
}

// K4: the live-tile list into `list` [num_tiles + 1] (scratch, written
// here), then the closest hit over it.  best_t, best_tri and rows_out must
// be 16-byte aligned.
extern "C" int crt_closest_hit_compact(
    int* list, const float* o, const float* d, const float* n,
    const float* nv0, const float* m, const float* c, const float* nobf,
    const int* tid, const int* cluster_list, const int* counts,
    const float* rows_table, int num_clusters, int num_tiles, int tile_rays,
    int tile_mod, int kp, float* best_t, int* best_tri, float* rows_out,
    void* stream) {
  if (num_tiles <= 0) return 0;
  const unsigned long long aligned =
      (unsigned long long)best_t | (unsigned long long)best_tri |
      (unsigned long long)rows_out;
  if (tile_rays % CRT_BLOCK != 0 || tile_mod < 0 || (aligned & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const int err = crt_live_tiles(counts, num_tiles, list, stream);
  if (err != 0) return err;
  const long long units = (long long)num_tiles * (tile_rays / CRT_BLOCK);
  const long long grid =
      persistent_grid((const void*)closest_hit_compact_kernel, units);
  if (grid <= 0) return (int)cudaGetLastError();
  closest_hit_compact_kernel<<<(unsigned)grid, CRT_BLOCK, 0,
                               (cudaStream_t)stream>>>(
      hit_args(o, d, n, nv0, m, c, nobf, tid, cluster_list, counts,
               rows_table, num_clusters, num_tiles, tile_rays, kp, best_t,
               best_tri, rows_out),
      list, num_tiles, tile_mod);
  return (int)cudaGetLastError();
}

// K7: `merge` consecutive tiles a group; num_tiles must divide by merge.
// best_t, best_tri and rows_out must be 16-byte aligned.  Launches on one
// stream at a time: the item counter is the module's.
extern "C" int crt_closest_hit_merged(
    const float* o, const float* d, const float* n, const float* nv0,
    const float* m, const float* c, const float* nobf, const int* tid,
    const int* cluster_list, const int* counts, const float* rows_table,
    int num_clusters, int num_tiles, int tile_rays, int merge, int kp,
    float* best_t, int* best_tri, float* rows_out, void* stream) {
  if (num_tiles <= 0) return 0;
  const unsigned long long aligned =
      (unsigned long long)best_t | (unsigned long long)best_tri |
      (unsigned long long)rows_out;
  if (tile_rays % CRT_BLOCK != 0 || merge < 1 || num_tiles % merge != 0 ||
      (aligned & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  // items and the counter stay below 2^31 (the counter passes items by
  // at most the grid)
  const long long items =
      (long long)(num_tiles / merge) * (tile_rays / CRT_BLOCK);
  if (items > 0x7fffffffLL - (1LL << 24)) return (int)cudaErrorInvalidValue;
  const long long grid =
      persistent_grid((const void*)closest_hit_merged_kernel, items);
  if (grid <= 0) return (int)cudaGetLastError();
  void* taken = nullptr;  // the item counter, zeroed on the launch's stream
  if (cudaGetSymbolAddress(&taken, k7_items_taken) != cudaSuccess ||
      cudaMemsetAsync(taken, 0, sizeof(unsigned), (cudaStream_t)stream) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  closest_hit_merged_kernel<<<(unsigned)grid, CRT_BLOCK, 0,
                              (cudaStream_t)stream>>>(
      hit_args(o, d, n, nv0, m, c, nobf, tid, cluster_list, counts,
               rows_table, num_clusters, num_tiles, tile_rays, kp, best_t,
               best_tri, rows_out),
      merge, (int)items);
  return (int)cudaGetLastError();
}
