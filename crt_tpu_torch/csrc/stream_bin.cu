// Phase A of the streaming trace: each tile's (tile, supercluster) pairs,
// their order, and each pair's word of live member clusters, in one launch
// a call, and a second launch that packs the tiles' rows into the list once
// the host knows its length.
//
// Replaces no pallas_call: crt_tpu computes this in XLA
// (crt_tpu/ops/pallas_stream.py :132 `_tile_bounds`, :148
// `lane_exact_sc_mask`, :228 `_member_mask`, :321 `_member_runs`, :350
// `bin_pairs`).  Its plain PyTorch version (ops/stream_binning.py
// `bin_stream_plain`: `tile_bounds`, `pair_mask`, `lane_exact_sc_mask`,
// `bin_pairs`, `_member_runs`) is a chain of ops over [tiles, L2] arrays
// and, for the per-lane test, [8192, tile_rays, 3] temporaries a chunk of
// pairs, with two `nonzero`s.  This kernel computes a call's list with the
// same float32 operations and gives the same (pair_sc, pair_bits,
// tile_start) bit for bit.
//
// What it computes, per tile of `tile_rays` consecutive lanes: the tile's
// bounds over its active lanes (`tile_bounds`), then for every supercluster
// box the conservative test of the mode:
//   rays          the frustum slab, t >= 0 (`_frustum_box_mask`); pairs in
//                 ascending supercluster order;
//   shaft         the light-side shaft from the tile's apex with its cone
//                 and wedges (`apex_shaft_mask`); pairs nearest first: by
//                 the squared distance of the box centre from the origin
//                 box's centre, ties in index order (the stable
//                 `torch.sort`, NaN after +inf);
//   shaft_capped  the shaft's pairs nearest first, cut where the row's
//                 sorted place (the refused superclusters, keyed 3.4e38,
//                 sort among them) reaches `cap`;
//   shaft_exact   the shaft AND the per-lane test: some lane's own segment
//                 (t <= sqrt(r2) * (1 + 1e-4) + 2 * slack, -1 on an inactive
//                 lane, which can still pass from inside a box as in the
//                 plain version) reaches the box inflated by 2 * slack;
//                 nearest first.
// A tile with no active lane lists nothing.  Each listed pair's member word
// has bit m set when member cluster sc * pair + m passes the same test of
// the mode against its own box (`_member_mask`).
//
// Arithmetic: as cluster_bin.cu's note sets out (the tests themselves are
// bin_common.cuh's, shared with it): every float32 operation of the plain
// version in its order, IEEE division (the per-lane slab divides, as the
// plain version does, with no reciprocal), sqrtf, PyTorch's rounding of the
// constants, min / max that keep a NaN, and -fmad=false.
//
// What bounds it on an H100: each call reads its wavefront once (24 bytes a
// lane, 28 with the per-lane test's reach and one mask byte: 2.07 M lanes
// at 1080p are 60 MB, 0.018 ms at 3.35 TB/s), the supercluster boxes (L2 x
// 24 bytes, in L2 cache) and, for the list, the member boxes of each pair
// (768 bytes) and 8 bytes a pair written.  The per-lane test is hull pairs
// x tile_rays lane tests of 6 IEEE divisions (about 40 FP32 slots each):
// 300,000 pairs are 12 G slots, about 0.2 ms at the card's 60 TFLOP/s.
// The plain version took 74 ms a 1 M frame for the three calls.
//
// The design:
//   - stream_bin_kernel: one 256-thread block a tile.  The block folds its
//     lanes' bounds (bin_common.cuh), then tests the supercluster boxes in
//     chunks of 256 and ballots the answers into a shared-memory bitset.
//   - shaft_exact: each thread holds 4 lanes (origin, safe direction, the
//     small-direction flags, reach) in registers; every warp walks the
//     hull's bits a word at a time, skips the pairs another warp already
//     kept, tests its 128 lanes against each candidate, and ORs the word of
//     its hits into a second bitset (a warp reduction and one shared
//     atomic a word), with no block barrier in the walk.
//   - Near-first order: the live pairs' keys (order bits of the distance,
//     index) in shared memory (global scratch past 227 KB), each ranked by
//     counting the keys below it: a stable sort with no barrier a stage;
//     n live pairs cost n^2 / 256 comparisons a thread, broadcast reads.
//   - The tile writes its row of superclusters (in list order) to a
//     [tiles, width] scratch and its bounds to a [tiles, 12] one; the last
//     block to finish (a ticket counter) scans the counts into tile_start.
//   - stream_pack_kernel: one block a tile with pairs, a warp a pair; lane
//     m tests member cluster m and __ballot_sync gives the word, written
//     with the supercluster at tile_start[tile] + its place.

#include "bin_common.cuh"

namespace {

enum { MODE_RAYS = 0, MODE_SHAFT = 1, MODE_EXACT = 2 };

struct StreamBinArgs {
  const float* o;               // [R, 3]
  const float* d;               // [R, 3]: the frustum's and the lane test's
  const float* r2;              // [R]: the lane test's squared reach
  const unsigned char* active;  // [R] bool, or null: every lane
  const float* apex;            // [tiles, 3]: the shaft modes' lights
  const float* sc_min;          // [L2, 3] supercluster boxes
  const float* sc_max;
  long long lanes;              // R
  int num_sc, tile_rays, words, width, cap;  // cap < 0: none
  float slack;
  unsigned long long* gkeys;    // [tiles, L2] sort keys, or null: shared
  int* rows;                    // [tiles, width] superclusters, list order
  float* bounds;                // [tiles, kBounds]
  int* counts;                  // [tiles]
  int* tile_start;              // [tiles + 1]
  unsigned int* sync;           // [2], zeroed: blocks done, hull pairs
};

// A float's place in torch.sort's ascending order as an unsigned key: -0
// equals +0, and every NaN comes after +inf, equal to the others.
__device__ __forceinline__ unsigned int order_bits(float x) {
  if (x != x) return 0xffffffffu;
  unsigned int u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One lane of the per-lane test (`lane_exact_sc_mask`): its origin, its
// direction with 1 in place of a component under 1e-12 (`small`), and its
// reach.
struct Lane {
  float o[3], ds[3], tmax;
  bool small[3], in;
};

__device__ __forceinline__ bool lane_reaches(const Lane& l, const float* lo,
                                             const float* hi) {
  float ent = 0.f, ext = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tlo, thi;
    if (l.small[k]) {  // parallel to the slab: inside it for every t or none
      const bool inside = l.o[k] >= lo[k] && l.o[k] <= hi[k];
      tlo = inside ? -kInf : kInf;
      thi = inside ? kInf : -kInf;
    } else {
      const float t1 = (lo[k] - l.o[k]) / l.ds[k];
      const float t2 = (hi[k] - l.o[k]) / l.ds[k];
      tlo = min_nan(t1, t2);
      thi = max_nan(t1, t2);
    }
    ent = k ? max_nan(ent, tlo) : tlo;
    ext = k ? min_nan(ext, thi) : thi;
  }
  return ent <= ext && ext >= 0.f && ent <= l.tmax;
}

// The per-lane test of the hull's pairs of one tile: s_keep gets the bits
// of those some lane reaches.  Called by the whole block; s_keep zeroed.
__device__ void keep_reached(const StreamBinArgs& a, long long tile,
                             const unsigned int* s_hull,
                             unsigned int* s_keep, float s2) {
  const int tid = threadIdx.x, lane_id = tid & 31;
  volatile unsigned int* keep = s_keep;
  for (int base = 0; base < a.tile_rays; base += kLanes * kBlock) {
    Lane l[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int i = base + j * kBlock + tid;
      l[j].in = i < a.tile_rays;
      const long long r = tile * a.tile_rays + (l[j].in ? i : 0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        l[j].o[k] = __ldg(a.o + 3 * r + k);
        const float dk = __ldg(a.d + 3 * r + k);
        l[j].small[k] = fabsf(dk) < kTiny;
        l[j].ds[k] = l[j].small[k] ? 1.f : dk;
      }
      const bool act = a.active == nullptr || __ldg(a.active + r) != 0;
      l[j].tmax = act ? sqrtf(clamp0(__ldg(a.r2 + r))) * kCap + s2 : -1.f;
    }
    for (int w = 0; w < a.words; ++w) {
      unsigned int cand = lane_id == 0 ? s_hull[w] & ~keep[w] : 0u;
      cand = __shfl_sync(0xffffffffu, cand, 0);
      unsigned int hits = 0u;
      while (cand) {
        const int bit = __ffs(cand) - 1;
        cand &= cand - 1u;
        float lo[3], hi[3];
        load_box(a.sc_min, w * 32 + bit, lo);
        load_box(a.sc_max, w * 32 + bit, hi);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = lo[k] - s2;
          hi[k] = hi[k] + s2;
        }
#pragma unroll
        for (int j = 0; j < kLanes; ++j)
          if (l[j].in && lane_reaches(l[j], lo, hi)) {
            hits |= 1u << bit;
            break;
          }
      }
      hits = __reduce_or_sync(0xffffffffu, hits);
      if (lane_id == 0 && hits) atomicOr(s_keep + w, hits);
    }
  }
}

// Exclusive scan of counts [n] into out [n + 1] by one block.
__device__ void scan_counts(const int* counts, int* out, int n) {
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  int carry = 0;
  for (int base = 0; base < n; base += kBlock) {
    const int i = base + tid;
    const int v = i < n ? __ldcg(counts + i) : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane_id >= off) x += y;
    }
    if (lane_id == 31) s_warp[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (i < n) out[i] = carry + before + x - v;
    carry += total;
    __syncthreads();  // s_warp is written again
  }
  if (tid == 0) out[n] = carry;
}

template <int MODE>
__global__ void __launch_bounds__(kBlock) stream_bin_kernel(StreamBinArgs a) {
  extern __shared__ unsigned long long s_dyn[];  // [L2] keys, bitsets
  __shared__ float s_part[kWarps][kBounds];
  __shared__ int s_any[1], s_last;
  constexpr bool SHAFT = MODE != MODE_RAYS, EXACT = MODE == MODE_EXACT;
  constexpr int NB = SHAFT ? 6 : 12;
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const long long tile = blockIdx.x;
  const int L2 = a.num_sc;
  const bool keys_shared = a.gkeys == nullptr;
  unsigned long long* keys = keys_shared ? s_dyn : a.gkeys + tile * L2;
  unsigned int* s_hull =
      (unsigned int*)(s_dyn + (SHAFT && keys_shared ? L2 : 0));
  unsigned int* s_keep = s_hull + a.words;
  if (tid == 0) s_any[0] = 0;
  __syncthreads();

  float b[kBounds];
  fold_tile_bounds<NB>(a.o, a.d, a.active, a.lanes, a.active ? 1 : 0, tile,
                       a.tile_rays, s_any, s_part, b);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) a.bounds[tile * kBounds + k] = b[k];
  }
  const bool tile_any = a.active == nullptr || s_any[0] != 0;

  // The hull: a ballot word a warp and chunk of 256 superclusters.
  const float s2 = 2.f * a.slack;
  Shaft sh;
  if (SHAFT && tile_any) {
    float p[3] = {a.apex[3 * tile], a.apex[3 * tile + 1], a.apex[3 * tile + 2]};
    make_shaft(sh, p, b, b + 3, a.slack, true);
  }
  int hull = 0;
  for (int base = 0; base < L2; base += kBlock) {
    const int c = base + tid;
    bool bit = false;
    if (tile_any && c < L2) {
      float bmin[3], bmax[3];
      load_box(a.sc_min, c, bmin);
      load_box(a.sc_max, c, bmax);
      bit = SHAFT ? shaft_admits(sh, bmin, bmax, s2)
                  : slab_clamped<false>(b, b + 3, b + 6, b + 9, bmin, bmax);
    }
    const unsigned int word = __ballot_sync(0xffffffffu, bit);
    if (lane_id == 0) {
      s_hull[(base >> 5) + warp] = word;
      if (EXACT) s_keep[(base >> 5) + warp] = 0u;
    }
    hull += __syncthreads_count(bit);
  }
  if (EXACT) {
    if (hull) {
      if (tid == 0) atomicAdd(a.sync + 1, (unsigned int)hull);
      keep_reached(a, tile, s_hull, s_keep, s2);
    }
    __syncthreads();
  }
  auto live = [&](int w) { return EXACT ? s_hull[w] & s_keep[w] : s_hull[w]; };

  // The row: each live supercluster at its place.  `p` is its rank among
  // the live ones in index order.
  int* row = a.rows + tile * a.width;
  float oc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) oc[k] = 0.5f * (b[k] + b[3 + k]);
  int n_live = 0;
  for (int base = 0; base < L2; base += kBlock) {
    const int w0 = base >> 5, c = base + tid;
    if (c < L2 && (live(c >> 5) >> (c & 31)) & 1u) {
      int p = n_live + __popc(live(c >> 5) & ((1u << (c & 31)) - 1u));
      for (int i = w0; i < (c >> 5); ++i) p += __popc(live(i));
      if (!SHAFT) {
        row[p] = c;
      } else {  // bin_pairs' near_first key
        float lo[3], hi[3], sq[3];
        load_box(a.sc_min, c, lo);
        load_box(a.sc_max, c, hi);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float diff = 0.5f * (lo[k] + hi[k]) - oc[k];
          sq[k] = diff * diff;
        }
        const float dist = (sq[0] + sq[1]) + sq[2];
        keys[p] = ((unsigned long long)order_bits(dist) << 32) |
                  (unsigned int)c;
      }
    }
    for (int i = w0; i < w0 + kWarps; ++i) n_live += __popc(live(i));
  }
  int count = n_live;
  if (SHAFT) {
    __syncthreads();  // the keys
    // A key's rank among the live keys is its place in the list; in the
    // plain version's full sort the refused superclusters (key 3.4e38, in
    // index order) come before it too where its key is not below theirs.
    const unsigned int dead = order_bits(kInf);
    count = 0;
    for (int base = 0; base < n_live; base += kBlock) {
      const int p = base + tid;
      bool kept = false;
      if (p < n_live) {
        const unsigned long long key = keys[p];
        int rank = 0;
        for (int q = 0; q < n_live; ++q) rank += keys[q] < key;
        const unsigned int k32 = (unsigned int)(key >> 32);
        const int c = (int)(key & 0xffffffffu);
        const int place =
            rank + (k32 < dead ? 0 : (k32 == dead ? c - p : L2 - n_live));
        kept = a.cap < 0 || place < a.cap;
        if (kept) row[rank] = c;
      }
      count += __syncthreads_count(kept);
    }
  }

  // The count, and the scan by the last block to finish.
  if (tid == 0) {
    a.counts[tile] = count;
    __threadfence();
    s_last = atomicAdd(a.sync, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    scan_counts(a.counts, a.tile_start, gridDim.x);
  }
}

struct PackArgs {
  const int* rows;        // [tiles, width]
  const float* bounds;    // [tiles, kBounds]
  const int* counts;      // [tiles]
  const int* tile_start;  // [tiles + 1]
  const float* apex;      // [tiles, 3], the shaft modes
  const float* cl_min;    // [L2 * sc, 3] cluster boxes
  const float* cl_max;
  int sc, width;
  float slack;
  int* pair_sc;           // [P]
  int* pair_bits;         // [P]
};

template <bool SHAFT>
__global__ void __launch_bounds__(kBlock) stream_pack_kernel(PackArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const long long tile = blockIdx.x;
  const int n = a.counts[tile];
  if (n == 0) return;
  const int start = a.tile_start[tile];
  float b[kBounds];
#pragma unroll
  for (int k = 0; k < kBounds; ++k) b[k] = a.bounds[tile * kBounds + k];
  const float s2 = 2.f * a.slack;
  Shaft sh;
  if (SHAFT) {
    float p[3] = {a.apex[3 * tile], a.apex[3 * tile + 1], a.apex[3 * tile + 2]};
    make_shaft(sh, p, b, b + 3, a.slack, true);
  }
  for (int k = warp; k < n; k += kWarps) {
    const int c = a.rows[tile * a.width + k];
    bool bit = false;
    if (lane_id < a.sc) {
      float bmin[3], bmax[3];
      load_box(a.cl_min, c * a.sc + lane_id, bmin);
      load_box(a.cl_max, c * a.sc + lane_id, bmax);
      bit = SHAFT ? shaft_admits(sh, bmin, bmax, s2)
                  : slab_clamped<false>(b, b + 3, b + 6, b + 9, bmin, bmax);
    }
    const unsigned int word = __ballot_sync(0xffffffffu, bit);
    if (lane_id == 0) {
      a.pair_sc[start + k] = c;
      a.pair_bits[start + k] = (int)word;
    }
  }
}

template <int MODE>
int launch_bin(const StreamBinArgs& a, int tiles, size_t smem,
               cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_bin_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stream_bin_kernel<MODE><<<(unsigned)tiles, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entries, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.
//
// crt_stream_bin: mode 0 rays (d read), 1 shaft (apex; cap >= 0 cuts each
// row at its sorted place `cap`), 2 shaft_exact (apex, d and r2 read).
// `active` is [R] bool or null.  Scratch it writes: rows [tiles, width]
// (width >= every count: L2, or min(cap, L2)), bounds [tiles, 12], counts
// [tiles], sync [2] (zeroed here; sync[1] gets the hull's pairs in mode 2),
// and, where `gkeys` is not null, its [tiles, L2] keys in place of shared
// memory.  Output: tile_start [tiles + 1].
extern "C" int crt_stream_bin(
    const float* o, const float* d, const float* r2,
    const unsigned char* active, const float* apex, const float* sc_min,
    const float* sc_max, int mode, int num_sc, int tiles, int tile_rays,
    int width, int cap, float slack, unsigned long long* gkeys, int* rows,
    float* bounds, int* counts, int* tile_start, unsigned int* sync,
    void* stream) {
  if (tiles <= 0) return 0;
  if (tile_rays <= 0 || num_sc < 0 || width < 0 || !o || !sc_min ||
      !sc_max || !bounds || !counts || !tile_start || !sync ||
      (mode != MODE_SHAFT && !d) || (mode != MODE_RAYS && !apex) ||
      (mode == MODE_EXACT && !r2) || (width > 0 && !rows))
    return (int)cudaErrorInvalidValue;
  const int words = (num_sc + kBlock - 1) / kBlock * kWarps;
  const size_t bits = sizeof(unsigned int) * (size_t)words *
                      (mode == MODE_EXACT ? 2 : 1);
  const size_t keys = mode != MODE_RAYS && !gkeys
                          ? sizeof(unsigned long long) * (size_t)num_sc
                          : 0;
  const StreamBinArgs a{o, d, r2, active, apex, sc_min, sc_max,
                        (long long)tiles * tile_rays, num_sc, tile_rays,
                        words, width, cap, slack, gkeys, rows, bounds,
                        counts, tile_start, sync};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(sync, 0, 2 * sizeof(unsigned int), st);
  if (e != cudaSuccess) return (int)e;
  switch (mode) {
    case MODE_RAYS: return launch_bin<MODE_RAYS>(a, tiles, keys + bits, st);
    case MODE_SHAFT: return launch_bin<MODE_SHAFT>(a, tiles, keys + bits, st);
    case MODE_EXACT: return launch_bin<MODE_EXACT>(a, tiles, keys + bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// crt_stream_pack: the list of crt_stream_bin's rows, pair_sc and
// pair_bits [tile_start[tiles]], each pair's member word by the mode's test
// (shaft != 0: the shaft from apex; else the frustum).
extern "C" int crt_stream_pack(const int* rows, const float* bounds,
                               const int* counts, const int* tile_start,
                               const float* apex, const float* cl_min,
                               const float* cl_max, int shaft, int sc,
                               int tiles, int width, float slack,
                               int* pair_sc, int* pair_bits, void* stream) {
  if (tiles <= 0) return 0;
  if (sc < 1 || sc > 32 || (shaft && !apex) || !pair_sc || !pair_bits)
    return (int)cudaErrorInvalidValue;
  const PackArgs a{rows, bounds, counts, tile_start, apex, cl_min, cl_max,
                   sc, width, slack, pair_sc, pair_bits};
  cudaStream_t st = (cudaStream_t)stream;
  if (shaft)
    stream_pack_kernel<true><<<(unsigned)tiles, kBlock, 0, st>>>(a);
  else
    stream_pack_kernel<false><<<(unsigned)tiles, kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}
