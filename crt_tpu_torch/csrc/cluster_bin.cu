// Phase A of the cluster trace: each tile's frustum or light-side shaft
// tested against every cluster box, and the admitted clusters compacted to
// the front of the tile's list.
//
// Replaces no pallas_call: crt_tpu computes Phase A of the cluster path in
// XLA (crt_tpu/ops/pallas_trace.py `bin_rays` :400 with its `apex` mode and
// `bin_apex_shared` :516, through `_frustum_box_mask`, `_apex_cone_mask`,
// `_apex_wedge_mask`).  Its plain PyTorch version (ops/binning.py
// `bin_rays_plain`, `bin_apex_shared_plain`) is a chain of small ops over
// [tiles, L] arrays: 45 launches a `bin_rays` call and over 300 a
// `bin_apex_shared` call, about half of the host-bound GI and glass frames'
// launches.  This kernel does a call in one launch.
//
// What it computes, per row (a tile of `tile_rays` consecutive lanes; in the
// shared mode a tile and a light, light-major): the tile's bounds over its
// active lanes (+-3.4e38 in place of an inactive lane, as `tile_bounds`),
// then for every cluster c the conservative test of the mode:
//   MODE_RAYS   the interval slab of the origin box x direction box against
//               the box, t >= 0 (`_frustum_box_mask`);
//   MODE_APEX   `bin_rays(apex=)`: from the tile's apex P, direction box =
//               slack-inflated origin box - P, t in [0, 1 + 1e-4], against
//               the box inflated by 2 * slack, refined by the bounding cone
//               and the six 2-D wedges (`apex_shaft_mask`);
//   MODE_SHARED `bin_apex_shared`: the same shaft with P = each light, the
//               origin box reduced once over the union of the lights' masks;
//               `capped = 0` takes the four-corner slab with no lower clamp
//               and no cone or wedge; the glass boxes, when given, add the
//               clusters whose uncapped four-corner slab against them passes.
// A row with no active lane admits nothing.  The row's list is the stable
// partition of the clusters, admitted first, each group in cluster order
// (what `_compact`'s stable argsort gives), and its count the admitted.
//
// Arithmetic: every float32 operation of the plain version, in its order
// (sums of three left to right, IEEE division and sqrtf, which is the
// correctly rounded square root the plain version takes through float64),
// its constants rounded as PyTorch rounds a Python float (1e-12, 1.0001,
// 1 + 1e-4, 3.4e38), and min / max that keep a NaN as torch.amin / amax
// do.  The library is built with -fmad=false and without fast math, so the
// lists and counts are the plain version's bit for bit.  Terms whose value
// cannot change the mask are skipped (a wedge pair whose direction box or
// cluster is not sign-definite in its denominator axis, the cone and
// wedges of a cluster the slab refused): every test that is made is made
// with the plain version's operations.
//
// What bounds it on an H100: the reads of the wavefront, 24 bytes a lane
// (origins, and directions in MODE_RAYS) and one byte a lane and mask
// (active), and the [rows, L] list written; the tests are a few hundred
// FP32 operations per (row, cluster), which at L = 5 is nothing.  At the
// scenes the cluster path serves the launch is short, and what the kernel
// removes is the host's time to launch the plain version's chain.
//
// The design (the tests and the fold are bin_common.cuh's, shared with the
// streaming Phase A, stream_bin.cu):
//   - One 256-thread block per tile.  Each thread folds 4 lanes (1,024-lane
//     tiles) into its bounds: it loads the 4 lanes' mask bytes at once,
//     then the origins (and directions) of the active ones at once, so a
//     block waits on memory twice, not eight times; then warp shuffles and
//     one shared-memory pass, after which every thread holds the tile's
//     bounds.  The union of the masks and each mask's "any lane active"
//     are found in the same pass.
//   - Each thread that tests a cluster (thread t < L) computes the row's
//     own terms (the shaft, its cone and wedge ratios) from the bounds: a
//     few dozen operations, no barrier; a row with no active lane (most
//     rows of a bounce pool whose banks are mostly dead) computes none.
//   - The threads test the clusters in chunks of 256; each warp's ballot of
//     its 32 answers goes to a bitset in shared memory (L / 8 bytes), and
//     __syncthreads_count gives the chunk's admitted.  A second pass ranks
//     each cluster by popcounts of the bitset (its admitted before it) and
//     stores it at its place in the row: rank, or count + rank among the
//     refused.  Cluster boxes are read through the read-only path: each
//     (row, cluster) reads its box once, and a second light or box set
//     finds it in L1.

#include "bin_common.cuh"

namespace {

enum { MODE_RAYS = 0, MODE_APEX = 1, MODE_SHARED = 2 };

struct BinArgs {
  const float* o;                // [R, 3] (biased shadow origins: shared)
  const float* d;                // [R, 3], MODE_RAYS only
  const unsigned char* active;   // [masks, R] bool, or null
  const float* apex;             // [tiles, 3] (apex) or lights [Ll, 3]
  const float* bmin;             // [L, 3] cluster boxes
  const float* bmax;
  const float* gmin;             // [L, 3] glass boxes, or null
  const float* gmax;
  long long lanes;               // R: one mask's stride
  int num_clusters, tile_rays, rows_per_tile, masks, words, capped;
  float slack;
  int* cluster_list;             // [tiles * rows_per_tile, L]
  int* counts;                   // [tiles * rows_per_tile]
};

// The uncapped four-corner slab from the light against the box inflated by
// 2 * slack (s2).
__device__ __forceinline__ bool open_admits(const Shaft& sh, const float* bmin,
                                           const float* bmax, float s2) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = bmin[k] - s2;
    hi[k] = bmax[k] + s2;
  }
  return slab_open(sh.p, sh.w_lo, sh.w_hi, lo, hi);
}

template <int MODE>
__device__ __forceinline__ bool admit(const BinArgs& a, int c,
                                      const float* bounds, const Shaft& sh) {
  float bmin[3], bmax[3];
  load_box(a.bmin, c, bmin);
  load_box(a.bmax, c, bmax);
  if (MODE == MODE_RAYS)
    return slab_clamped<false>(bounds, bounds + 3, bounds + 6, bounds + 9,
                               bmin, bmax);
  const float s2 = 2.f * a.slack;
  bool ok = MODE == MODE_APEX || a.capped ? shaft_admits(sh, bmin, bmax, s2)
                                          : open_admits(sh, bmin, bmax, s2);
  if (MODE == MODE_SHARED && a.gmin != nullptr && !ok) {
    load_box(a.gmin, c, bmin);
    load_box(a.gmax, c, bmax);
    ok = open_admits(sh, bmin, bmax, s2);
  }
  return ok;
}

template <int MODE>
__global__ void __launch_bounds__(kBlock) cluster_bin_kernel(BinArgs a) {
  extern __shared__ unsigned int s_dyn[];  // [words] bits, [masks] any
  __shared__ float s_part[kWarps][kBounds];
  unsigned int* s_bits = s_dyn;
  int* s_any = (int*)(s_dyn + a.words);
  constexpr int NB = MODE == MODE_RAYS ? 12 : 6;
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const long long tile = blockIdx.x;
  for (int m = tid; m < a.masks; m += kBlock) s_any[m] = 0;
  __syncthreads();

  // The tile's bounds over its active lanes (`tile_bounds`).
  float b[kBounds];
  fold_tile_bounds<NB>(a.o, a.d, a.active, a.lanes, a.masks, tile,
                       a.tile_rays, s_any, s_part, b);

  const int L = a.num_clusters;
  for (int row_l = 0; row_l < a.rows_per_tile; ++row_l) {
    const long long row = (long long)row_l * gridDim.x + tile;
    const bool tile_any =
        a.masks == 0 || s_any[MODE == MODE_SHARED ? row_l : 0] != 0;
    Shaft sh;
    if (MODE != MODE_RAYS && tile_any && tid < L) {  // those that test
      const float* p = MODE == MODE_APEX ? a.apex + 3 * tile
                                         : a.apex + 3 * row_l;
      float pv[3] = {p[0], p[1], p[2]};
      make_shaft(sh, pv, b, b + 3, a.slack,
                 MODE == MODE_APEX || a.capped);
    }
    // Pass 1: the admitted bits, a ballot word per warp and chunk.
    int count = 0;
    for (int base = 0; base < L; base += kBlock) {
      const int c = base + tid;
      const bool bit = tile_any && c < L && admit<MODE>(a, c, b, sh);
      const unsigned int word = __ballot_sync(0xffffffffu, bit);
      if (lane_id == 0) s_bits[(base >> 5) + warp] = word;
      count += __syncthreads_count(bit);
    }
    // Pass 2: each cluster at its place in the stable partition.
    int* out = a.cluster_list + row * L;
    int before = 0;  // admitted in earlier chunks
    for (int base = 0; base < L; base += kBlock) {
      const int w0 = base >> 5;
      const int c = base + tid;
      if (c < L) {
        const int w = c >> 5;
        int rank = before;
        for (int i = w0; i < w; ++i) rank += __popc(s_bits[i]);
        const unsigned int word = s_bits[w];
        rank += __popc(word & ((1u << (c & 31)) - 1u));
        out[(word >> (c & 31)) & 1u ? rank : count + (c - rank)] = c;
      }
      for (int i = w0; i < w0 + kWarps; ++i) before += __popc(s_bits[i]);
    }
    if (tid == 0) a.counts[row] = count;
    __syncthreads();  // the next row rewrites the bits
  }
}

template <int MODE>
int launch(const BinArgs& a, int tiles, cudaStream_t st) {
  const size_t smem = sizeof(unsigned int) * (size_t)(a.words + a.masks);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_bin_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cluster_bin_kernel<MODE><<<(unsigned)tiles, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers on the
// device that owns `stream`.  mode: 0 `bin_rays`, 1 `bin_rays(apex=)`, 2
// `bin_apex_shared` (`lights` rows a tile, light-major, `capped`, glass
// boxes optional).  `active` is [masks, lanes] bool (masks 0: every lane
// active; 1 in modes 0 / 1; `lights` in mode 2).  `apex` is [tiles, 3] in
// mode 1 and the lights [lights, 3] in mode 2.  Writes cluster_list
// [lights * tiles, L] and counts [lights * tiles].  Returns
// cudaGetLastError() after the launch.
extern "C" int crt_cluster_bin(
    const float* o, const float* d, const unsigned char* active,
    const float* apex, const float* bmin, const float* bmax,
    const float* gmin, const float* gmax, int mode, int num_clusters,
    int tiles, int tile_rays, int lights, int masks, int capped, float slack,
    int* cluster_list, int* counts, void* stream) {
  if (tiles <= 0 || lights <= 0) return 0;
  if (tile_rays <= 0 || num_clusters < 0 || masks < 0 ||
      (masks > 0 && active == nullptr) || (mode == MODE_RAYS && !d) ||
      (mode != MODE_RAYS && !apex) || ((gmin == nullptr) != (gmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int chunks = (num_clusters + kBlock - 1) / kBlock;
  const BinArgs a{o, d, active, apex, bmin, bmax, gmin, gmax,
                  (long long)tiles * tile_rays, num_clusters, tile_rays,
                  mode == MODE_SHARED ? lights : 1, masks, chunks * kWarps,
                  capped, slack, cluster_list, counts};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_RAYS: return launch<MODE_RAYS>(a, tiles, st);
    case MODE_APEX: return launch<MODE_APEX>(a, tiles, st);
    case MODE_SHARED: return launch<MODE_SHARED>(a, tiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
