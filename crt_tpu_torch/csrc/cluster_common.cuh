// Shared pieces of the cluster-walk kernels (closest_hit.cu, occlusion_w.cu,
// occlusion_d.cu, stream_trace.cu).
//
// A cluster is 16 Morton-consecutive triangles.  Its test constants live in
// the cluster-major tables built by crt_tpu_torch/ops/cluster_tables.py
// (the rows layout of the streaming kernels):
//   n [L,16,3], nv0 [L,16], m [L,16,9], c [L,16,3], nobf [L,16], tid [L,16].
// The cluster kernels stage them in batches of CRT_BATCH clusters copied by
// cp.async into member-major records, a ring of CRT_STAGES batches, one
// barrier a batch (ClusterRing); stream_trace.cu stages the same records
// from its own tables.
//
// The member test.  Whether the line o + t*d hits a member at t >= 0, and
// that t: the plane word first (nd = n.d, opd = nv0 - n.o, the parallel
// gate |nd| >= PARALLEL_EPS, the face gate opd < 0 || nobf > 0.5), then t
// = opd / nd (1 in place of a parallel nd) and t >= 0, then the three edge
// half-spaces (mo - c) + t*md >= 0 (rec_edges).  Dot products sum x, y, z
// left to right.  Every kernel keeps these operations in this order (a
// kernel may skip a test whose answer cannot change its output, or compute
// an origin's terms once for many rays with the same operations), as
// occlusion_d.cu's test_batch shows plainly and the plain versions'
// `_member_hit` (ops/cluster_trace.py) computes them.
//
// Arithmetic follows crt_tpu/ops/pallas_trace.py:1242-1267 operation by
// operation.  The library is built with -fmad=false and without fast math,
// so every a*b+c rounds twice and every division is IEEE, exactly as the
// PyTorch plain versions round: the kernels are held to them bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define CRT_CLUSTER_SIZE 16
#define CRT_BLOCK 256
#define CRT_PARALLEL_EPS 1e-6f

// The streaming backend's fused-column tables hold, per slot, 18 columns:
// n xyz | nv0 | m (9) | c (3) | nobf | id as f32
// (crt_tpu_torch/ops/stream_binning.py build_fused_table); the kernels read
// the first 17 and take ids from the int32 `tid` table beside them.
#define CRT_FUSED_COLS 18

// ---------------------------------------------------------------------------
// Member-major records
// ---------------------------------------------------------------------------
//
// A slot's record is 20 floats, five 16-byte words, so a test reads it with
// five 16-byte shared loads:
//   {n.x n.y n.z nv0} {m0 m1 m2 c0} {m3 m4 m5 c1} {m6 m7 m8 c2}
//   {nobf, id (int bits), member mask, unused}
// (stream_trace.cu fills the first 17 floats; its ids stay in global
// memory).
#define CRT_SLOT_FLOATS 20
#define CRT_RECORD_ID 17
#define CRT_RECORD_MASK 18

// Place of fused column `col` (< 17: n xyz | nv0 | m (9) | c (3) | nobf) in
// a slot's record.
__device__ __forceinline__ int record_pos(int col) {
  if (col < 4) return col;
  if (col < 13) return 4 + 4 * ((col - 4) / 3) + (col - 4) % 3;
  if (col < 16) return 7 + 4 * (col - 13);
  return 16;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The batched ring of the cluster kernels (K1, K4, K7, K2)
// ---------------------------------------------------------------------------

#define CRT_BATCH 8   // clusters staged per barrier
#define CRT_STAGES 3  // batches in the ring
#define CRT_CLUSTER_FLOATS (CRT_CLUSTER_SIZE * CRT_SLOT_FLOATS)  // 320
#define CRT_BATCH_FLOATS (CRT_BATCH * CRT_CLUSTER_FLOATS)

// 30,720 bytes of records, the batches' cluster ids and (closest_hit.cu)
// per cluster the members no ray of the block can hit.
struct ClusterRing {
  alignas(16) float rec[CRT_STAGES * CRT_BATCH_FLOATS];
  int cl[CRT_STAGES * CRT_BATCH];
  unsigned skip[CRT_STAGES * CRT_BATCH];
};

// One float of a cluster that this thread copies: it lies at
// src + cluster * per_cluster + off and goes to rec[dst] of the cluster's
// record image.
struct ClusterCopy {
  const float* src;
  int per_cluster;
  int off;
  int dst;
};

// The tables of a walk: the six arrays of cluster_tables.py and, where a
// kernel restricts hits to a subset, the member mask [L,16] (else null).
struct ClusterTables {
  const float* n;
  const float* nv0;
  const float* m;
  const float* c;
  const float* nobf;
  const int* tid;
  const float* gm;
};

// The plan of float f (< 256) of the 256 n | nv0 | m | c floats, or (f >=
// 256) of the 16-float column k = (f - 256) / 16 of {nobf, id, mask}.
__device__ __forceinline__ ClusterCopy cluster_copy(const ClusterTables& tb,
                                                    int f) {
  ClusterCopy p;
  if (f < 48) {
    p = {tb.n, 48, f, (f / 3) * CRT_SLOT_FLOATS + f % 3};
  } else if (f < 64) {
    const int e = f - 48;
    p = {tb.nv0, 16, e, e * CRT_SLOT_FLOATS + 3};
  } else if (f < 208) {
    const int e = f - 64;
    p = {tb.m, 144, e, (e / 9) * CRT_SLOT_FLOATS + record_pos(4 + e % 9)};
  } else if (f < 256) {
    const int e = f - 208;
    p = {tb.c, 48, e, (e / 3) * CRT_SLOT_FLOATS + record_pos(13 + e % 3)};
  } else {
    const int k = (f - 256) / 16, e = (f - 256) % 16;
    const float* col = k == 0   ? tb.nobf
                       : k == 1 ? reinterpret_cast<const float*>(tb.tid)
                                : tb.gm;
    p = {col, 16, e, e * CRT_SLOT_FLOATS + 16 + k};
  }
  return p;
}

// A thread's two copies of every staged cluster: float threadIdx.x of the
// 256, and, on the first 16 threads nobf, on the next 16 the ids (when the
// tables carry them), on the next 16 the member mask (when they carry it).
struct ClusterPlan {
  ClusterCopy a, b;
  bool has_b;
  __device__ __forceinline__ explicit ClusterPlan(const ClusterTables& tb) {
    const int t = threadIdx.x;
    a = cluster_copy(tb, t);
    has_b = t < 16 || (t < 32 && tb.tid != nullptr) ||
            (t >= 32 && t < 48 && tb.gm != nullptr);
    b = cluster_copy(tb, has_b ? 256 + t : 256);
  }
};

// Stage clusters list[i0 .. i0 + count) into batch `stage` of the ring and
// commit them as one cp.async group, empty or not (uniform over the
// block).  Needs CRT_BLOCK threads.
__device__ __forceinline__ void issue_clusters(ClusterRing& ring, int stage,
                                               const int* __restrict__ list,
                                               int i0, int count,
                                               const ClusterPlan& pl) {
  float* img = ring.rec + stage * CRT_BATCH_FLOATS;
  for (int k = 0; k < count; ++k) {
    const long long cl = list[i0 + k];
    float* rec = img + k * CRT_CLUSTER_FLOATS;
    cp_async4(rec + pl.a.dst, pl.a.src + cl * pl.a.per_cluster + pl.a.off);
    if (pl.has_b)
      cp_async4(rec + pl.b.dst, pl.b.src + cl * pl.b.per_cluster + pl.b.off);
  }
  if ((int)threadIdx.x < count)
    ring.cl[stage * CRT_BATCH + threadIdx.x] = list[i0 + threadIdx.x];
  cp_async_commit();
}

// The clusters of batch bi of a walk of `count` clusters.
__device__ __forceinline__ int batch_size(int bi, int count) {
  return bi * CRT_BATCH < count ? min(CRT_BATCH, count - bi * CRT_BATCH) : 0;
}

// A slot's plane word and tail word, and edge word e.
__device__ __forceinline__ float4 rec_word(const float* slot, int w) {
  return *reinterpret_cast<const float4*>(slot + 4 * w);
}

// The three edge half-spaces of a slot (mo - c) + t * md >= 0, in the
// member test's order.
__device__ __forceinline__ bool rec_edges(const float* slot, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t) {
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float4 me = rec_word(slot, 1 + e);
    const float md = me.x * dx + me.y * dy + me.z * dz;
    const float mo = me.x * ox + me.y * oy + me.z * oz;
    ok = ok && ((mo - me.w) + t * md >= 0.0f);
  }
  return ok;
}

// The persistent schedule: block b takes units b, b + G, b + 2G, ... (G the
// grid) and calls visit(u, count) for each, count the list length of its
// tile (units_per_tile units a tile).  The counts of CRT_BLOCK units are
// read at once into `s_count`, so a unit with an empty list costs no load
// latency.  Uniform over the block.
template <typename Visit>
__device__ __forceinline__ void for_each_unit(long long units,
                                              int units_per_tile,
                                              const int* __restrict__ counts,
                                              int* s_count, Visit visit) {
  for (long long u0 = blockIdx.x; u0 < units;
       u0 += (long long)CRT_BLOCK * gridDim.x) {
    __syncthreads();  // the previous chunk's counts are read
    const long long mine = u0 + (long long)threadIdx.x * gridDim.x;
    s_count[threadIdx.x] = mine < units ? counts[mine / units_per_tile] : 0;
    __syncthreads();
    for (int k = 0; k < CRT_BLOCK; ++k) {
      const long long u = u0 + (long long)k * gridDim.x;
      if (u >= units) break;
      visit(u, s_count[k]);
    }
  }
}

// The persistent schedule over a live-first tile list (K4).  `list` holds
// `tiles` tile ids, those with a cluster list first (list[tiles] of them,
// n_live), then the others, and n_live at list[tiles].  Items i <
// n_live * units_per_tile are the live tiles' units in list order (item i
// is unit i % units_per_tile of tile list[i / units_per_tile]); each later
// item is one whole dead tile.  Block b takes items b, b + G, b + 2G, ...
// (G the grid), so the resident blocks walk the live units together and
// then only store misses, and calls visit(i, tile, count), count 0 for a
// dead tile.  The tiles of CRT_BLOCK items (and the live ones' counts) are
// read at once into s_tile / s_count.  Uniform over the block.
template <typename Visit>
__device__ __forceinline__ void for_each_listed_item(
    int tiles, int units_per_tile, const int* __restrict__ list,
    const int* __restrict__ counts, int* s_tile, int* s_count, Visit visit) {
  const int n_live = list[tiles];
  const long long live_units = (long long)n_live * units_per_tile;
  const long long items = live_units + (tiles - n_live);
  for (long long i0 = blockIdx.x; i0 < items;
       i0 += (long long)CRT_BLOCK * gridDim.x) {
    __syncthreads();  // the previous chunk's tiles are read
    const long long mine = i0 + (long long)threadIdx.x * gridDim.x;
    int tile = 0, count = 0;
    if (mine < items) {
      const bool live = mine < live_units;
      tile = list[live ? mine / units_per_tile
                       : n_live + (mine - live_units)];
      count = live ? counts[tile] : 0;
    }
    s_tile[threadIdx.x] = tile;
    s_count[threadIdx.x] = count;
    __syncthreads();
    for (int k = 0; k < CRT_BLOCK; ++k) {
      const long long i = i0 + (long long)k * gridDim.x;
      if (i >= items) break;
      visit(i, s_tile[k], s_count[k]);
    }
  }
}

// The number of blocks of a persistent launch of `kernel`: as many as are
// resident at once on the current device, at most `units`.  0 on an error
// (the caller then returns cudaGetLastError()).
inline long long persistent_grid(const void* kernel, long long units) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    CRT_BLOCK, 0) !=
          cudaSuccess)
    return 0;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return units < full ? units : full;
}

// ---------------------------------------------------------------------------
// The any-hit walk of the shadow kernels (K2 in occlusion_w.cu, K5 / K6 in
// occlusion_d.cu)
// ---------------------------------------------------------------------------

// Lists of at most this many clusters are walked with warp votes that skip
// a member's divide and edges where no lane needs them, longer ones
// without (votes on every list, or on none, measured slower: PERF.md).
#define CRT_VOTE_LIST 32

// A block's packed rays (RAY floats each, component-major), the answers
// of their walks, and what a long walk's batch barriers exchange: each
// thread's flags (fl), the unfinished lanes of each warp (live) and, where
// a repack moves a ray, its place and flags (tag).
template <int RAY>
struct RayPack {
  float ray[RAY * CRT_BLOCK];
  int tag[CRT_BLOCK];
  int scan[CRT_BLOCK / 32];
  int live[CRT_BLOCK / 32];
  unsigned char res[CRT_BLOCK];
  unsigned char fl[CRT_BLOCK];
};

// What a block's walks did, counted only while the launch is given a
// `stats` buffer: each warp's member tests issued (32 lanes x 16 members
// x the clusters of every batch the warp tests, whether or not a lane is
// finished) and the repacks.  Added to stats[1] and stats[0] once a
// block, at the end of the launch (walk_count_flush).
struct WalkCount {
  unsigned long long tests[CRT_BLOCK / 32];
  unsigned long long repacks;
};

// Zero the block's counts; before the first barrier of the launch.
__device__ __forceinline__ void walk_count_init(WalkCount& wc) {
  if (threadIdx.x < CRT_BLOCK / 32) wc.tests[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) wc.repacks = 0ull;
}

// Add the block's counts to stats (repacks, lane tests); every thread
// calls it at the end of the launch.
__device__ __forceinline__ void walk_count_flush(const WalkCount& wc,
                                                 unsigned long long* stats) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tests = 0ull;
#pragma unroll
    for (int w = 0; w < CRT_BLOCK / 32; ++w) tests += wc.tests[w];
    atomicAdd(stats, wc.repacks);
    atomicAdd(stats + 1, tests);
  }
}

// Repeated rays are walked once.  Of the `open` lanes (those with something
// to learn), a lane whose ray is, bit for bit, an earlier open lane's of
// its warp (`distinct`; else its warp's first open lane's) takes the first
// such lane's answer, and the rays of the others are packed to the front
// of the block, so the warps past them have nothing to test.  (A frame's
// lanes without a hit all carry the camera's ray, so with `distinct` a
// warp walks it once for all its misses, whichever lane comes first; the
// walks of long lists take it, short ones the cheaper first-lane test.)
// `ray` becomes the packed ray at this thread's place and `live` the
// number of packed rays (places >= live hold none).  Returns the place
// whose answer this lane takes (unused by a lane that is not open).  Every
// thread of the block calls it, with the same `distinct`; two barriers.
template <int RAY>
__device__ __forceinline__ int pack_rays(RayPack<RAY>& pk, float (&ray)[RAY],
                                         bool open, bool distinct,
                                         int& live) {
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const unsigned opens = __ballot_sync(0xffffffffu, open);
  int lead;
  if (distinct) {
    unsigned same = opens;
#pragma unroll
    for (int k = 0; k < RAY; ++k)  // every lane takes part in each match
      same &= __match_any_sync(0xffffffffu, __float_as_uint(ray[k]));
    lead = same != 0u ? __ffs(same) - 1 : ln;
  } else {
    lead = opens != 0u ? __ffs(opens) - 1 : 0;
    bool same = true;
#pragma unroll
    for (int k = 0; k < RAY; ++k) {  // every lane takes part in each shuffle
      const float first = __shfl_sync(0xffffffffu, ray[k], lead);
      same = same && __float_as_uint(ray[k]) == __float_as_uint(first);
    }
    lead = same ? lead : ln;
  }
  const bool own = open && lead == ln;
  const unsigned mask = __ballot_sync(0xffffffffu, own);
  if (ln == 0) pk.scan[wp] = __popc(mask);
  __syncthreads();
  int pos = __popc(mask & ((1u << ln) - 1u));
  live = 0;
#pragma unroll
  for (int w = 0; w < CRT_BLOCK / 32; ++w) {
    pos += w < wp ? pk.scan[w] : 0;
    live += pk.scan[w];
  }
  const int lead_pos = __shfl_sync(0xffffffffu, pos, lead);
  if (own) {
#pragma unroll
    for (int k = 0; k < RAY; ++k) pk.ray[k * CRT_BLOCK + pos] = ray[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RAY; ++k) ray[k] = pk.ray[k * CRT_BLOCK + threadIdx.x];
  return own ? pos : lead_pos;
}

// The answer at place `from` of the walks' answers, once every walked
// state has left its answer at its place (`s`: the state this thread
// holds after the walk, at place s.place, or none where s.place < 0).
// Every thread calls it, after the walk.
template <int RAY, class State>
__device__ __forceinline__ unsigned char answer_at(RayPack<RAY>& pk,
                                                   const State& s,
                                                   int from) {
  if (s.place >= 0) pk.res[s.place] = s.flags();
  __syncthreads();
  return pk.res[from];
}

// The repack of a long walk.  The block's rays sit in `copies` copies of
// `group` warps each (group * copies = 8 warps; thread t holds slot t %
// (32 group) of copy t / (32 group)), every copy the same rays and, after
// the merge at each barrier, the same flags; copy k tests clusters k, k +
// copies, ... of each batch.  This moves copy 0's `live` unfinished rays
// to the front of a new layout of `regroup` warps a copy, in their order,
// each to every copy.  `done` says whether this lane is finished, `open`
// is its warp's ballot of unfinished lanes and `live_w` copy 0's
// unfinished lanes of each warp (all read at the batch barrier).  A
// finished lane of copy 0 leaves its answer at its place first; a moved
// ray takes its flags along, and copy 0's also its place, so the answers
// stay where answer_at reads them.  A thread past `live` in its copy holds
// no ray after it (finished), and a thread outside copy 0 no place (-1).
// Every thread of the block calls it; one barrier.
template <int RAY, class State>
__device__ __forceinline__ void repack_rays(RayPack<RAY>& pk, State& s,
                                            bool done, unsigned open,
                                            const int* live_w, int live,
                                            int group, int regroup) {
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  if (wp < group) {  // copy 0
    if (done) {
      if (s.place >= 0) pk.res[s.place] = s.flags();
    } else {
      int pos = __popc(open & ((1u << ln) - 1u));
#pragma unroll
      for (int w = 0; w < CRT_BLOCK / 32; ++w) pos += w < wp ? live_w[w] : 0;
#pragma unroll
      for (int k = 0; k < RAY; ++k) pk.ray[k * CRT_BLOCK + pos] = s.r[k];
      pk.tag[pos] = s.place | (s.flags() << 8);
    }
  }
  __syncthreads();
  const int slots = 32 * regroup;
  const int i = (int)threadIdx.x % slots;
  if (i < live) {
#pragma unroll
    for (int k = 0; k < RAY; ++k) s.r[k] = pk.ray[k * CRT_BLOCK + i];
    const int tag = pk.tag[i];
    s.place = (int)threadIdx.x < slots ? tag & 0xff : -1;
    s.set_flags(tag >> 8);
  } else {
    s.place = -1;
    s.set_flags(State::kDone);
  }
}

// Every copy's flags of a slot ORed into each copy of it (the layout of
// repack_rays: `copies` copies of `group` warps).  Every thread of the
// block calls it; one barrier.
template <int RAY, class State>
__device__ __forceinline__ void merge_copies(RayPack<RAY>& pk, State& s,
                                             int group, int copies) {
  pk.fl[threadIdx.x] = s.flags();
  __syncthreads();
  const int slot = (int)threadIdx.x % (32 * group);
  int f = 0;
  for (int c = 0; c < copies; ++c) f |= pk.fl[c * 32 * group + slot];
  s.set_flags(f);
}

// The warps a copy takes for `need` warps of rays: 1, 2, 4 or 8.
__device__ __forceinline__ int copy_group(int need) {
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

// The walk of a tile's `count` clusters of `list` by an any-hit ray state
// `s`: its ray s.r[RAY], the place s.place whose answer it holds, its
// flags (s.flags(), s.set_flags(); State::kDone a finished state's),
// s.done() (nothing left to learn; the outputs are ORs) and
// s.test<VOTE>(img, n, first, step) (clusters first, first + step, ... <
// n of the n staged at img, in list order; VOTE: warp votes may skip a
// member's later stages, on lists of at most CRT_VOTE_LIST clusters).
// CRT_BATCH clusters are staged per barrier, CRT_STAGES - 1 batches ahead;
// a warp whose lanes are all done skips the batch.
//
// On lists of at most CRT_VOTE_LIST clusters the barrier is
// __syncthreads_and(done) and the block leaves the walk when every lane is
// done.  On longer ones a lane's walk is a chain of dependent member tests
// over the whole list, and a block's unfinished rays often fill one or two
// of its warps; so there the block keeps its rays in copies (repack_rays):
// at each batch barrier the copies merge their flags (an OR: each output
// is an OR of member tests), the block leaves when no lane is unfinished,
// and when copy 0's unfinished lanes would fill fewer warps than hold
// them, or fit a smaller copy, they move to the front of a new layout
// with as many copies as fit.  Each copy then tests its share of each
// batch, so every warp takes part and a lane's chain is shorter.  No
// member test changes, and none whose answer could change an output is
// skipped.  `wc` counts the tests and repacks (null: no count).  Every
// thread of the block calls it; the ring is free after.
template <int RAY, class State>
__device__ __forceinline__ void walk_any_hit(ClusterRing& ring,
                                             RayPack<RAY>& pk,
                                             const ClusterPlan& pl,
                                             const int* __restrict__ list,
                                             int count, State& s,
                                             WalkCount* wc) {
#pragma unroll
  for (int st = 0; st < CRT_STAGES - 1; ++st)
    issue_clusters(ring, st, list, st * CRT_BATCH, batch_size(st, count), pl);
  const int nb = (count + CRT_BATCH - 1) / CRT_BATCH;
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  if (count <= CRT_VOTE_LIST) {  // uniform over the block
    for (int bi = 0; bi < nb; ++bi) {
      cp_async_wait<CRT_STAGES - 2>();  // this thread's copies of batch bi
      const bool done = s.done();
      // the batch barrier, and the block-wide exit
      if (__syncthreads_and(done)) break;
      const int nx = bi + CRT_STAGES - 1;
      issue_clusters(ring, nx % CRT_STAGES, list, nx * CRT_BATCH,
                     batch_size(nx, count), pl);
      if (__all_sync(0xffffffffu, done)) continue;  // the warp is done
      const float* img = ring.rec + (bi % CRT_STAGES) * CRT_BATCH_FLOATS;
      const int nc = batch_size(bi, count);
      if (wc != nullptr && ln == 0)
        wc->tests[wp] += 32ull * CRT_CLUSTER_SIZE * (unsigned long long)nc;
      s.template test<true>(img, nc, 0, 1);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next walk
    return;
  }
  int group = CRT_BLOCK / 32;  // warps a copy (uniform)
  int copies = 1, first = 0;   // copies, and this warp's copy
  for (int bi = 0; bi < nb; ++bi) {
    cp_async_wait<CRT_STAGES - 2>();  // this thread's copies of batch bi
    // the batch barrier: the copies' flags merged, copy 0's unfinished
    // lanes counted, the block-wide exit, the repack
    if (copies > 1)
      merge_copies(pk, s, group, copies);
    else
      __syncthreads();
    bool done = s.done();
    const unsigned open = __ballot_sync(0xffffffffu, !done);
    if (ln == 0 && wp < group) pk.live[wp] = __popc(open);
    __syncthreads();
    int live = 0, warps = 0;
    for (int w = 0; w < group; ++w) {
      live += pk.live[w];
      warps += pk.live[w] > 0 ? 1 : 0;
    }
    if (live == 0) break;
    const int need = (live + 31) / 32;
    const int regroup = copy_group(need);
    if (need < warps || regroup < group) {
      repack_rays(pk, s, done, open, pk.live, live, group, regroup);
      group = regroup;
      copies = CRT_BLOCK / 32 / group;
      first = wp / group;
      done = s.done();
      if (wc != nullptr && threadIdx.x == 0) ++wc->repacks;
    }
    const int nx = bi + CRT_STAGES - 1;
    issue_clusters(ring, nx % CRT_STAGES, list, nx * CRT_BATCH,
                   batch_size(nx, count), pl);
    if (__all_sync(0xffffffffu, done)) continue;  // the warp is done
    const float* img = ring.rec + (bi % CRT_STAGES) * CRT_BATCH_FLOATS;
    const int nc = batch_size(bi, count);
    if (wc != nullptr && ln == 0)
      wc->tests[wp] += 32ull * CRT_CLUSTER_SIZE *
                       (unsigned long long)((nc - first + copies - 1) / copies);
    s.template test<false>(img, nc, first, copies);
  }
  cp_async_wait<0>();
  if (copies > 1) merge_copies(pk, s, group, copies);  // the last batch's
  __syncthreads();  // the ring is free for the next walk
}
