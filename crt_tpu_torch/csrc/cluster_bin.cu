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
// The design:
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

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kBounds = 12;  // o_lo, o_hi, d_lo, d_hi
constexpr int kLanes = 4;    // lanes a thread folds a step (1,024-lane tiles)

enum { MODE_RAYS = 0, MODE_APEX = 1, MODE_SHARED = 2 };

// The constants of ops/binning.py, rounded from the Python float as
// PyTorch rounds them.
constexpr float kInf = (float)3.4e38;  // the finite "infinity", _INF
constexpr float kTiny = (float)1e-12;
constexpr float kDegenerate = (float)1.0001;
constexpr float kCap = (float)(1.0 + 1e-4);

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

// torch.minimum / maximum / amin / amax: a NaN in either operand wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// torch.clamp(x, min=0) and clamp(x, 0, 1): a NaN stays.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// Slab test with the entry clamped at t >= 0 (`_frustum_box_mask`,
// t_lo_clamp=True), optionally capped at t <= kCap.
template <bool CAP>
__device__ __forceinline__ bool slab_clamped(const float* o_lo,
                                             const float* o_hi,
                                             const float* d_lo,
                                             const float* d_hi,
                                             const float* lo,
                                             const float* hi) {
  float ent_max = 0.f, ext_min = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool pos = d_lo[k] > 0.f, neg = d_hi[k] < 0.f;
    float ent = pos ? (lo[k] - o_hi[k]) / d_hi[k]
                    : (neg ? (hi[k] - o_lo[k]) / d_lo[k] : -kInf);
    const float ext = pos ? (hi[k] - o_lo[k]) / d_lo[k]
                          : (neg ? (lo[k] - o_hi[k]) / d_hi[k] : kInf);
    ent = clamp0(ent);
    ent_max = k ? max_nan(ent_max, ent) : ent;
    ext_min = k ? min_nan(ext_min, ext) : ext;
  }
  return ent_max <= ext_min && (!CAP || ent_max <= kCap);
}

// Slab test on the full line, by four-corner interval division
// (`_frustum_box_mask`, t_lo_clamp=False), capped at t <= kCap.
__device__ __forceinline__ bool slab_open(const float* o, const float* d_lo,
                                          const float* d_hi, const float* lo,
                                          const float* hi) {
  float ent_max = 0.f, ext_min = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool definite = d_lo[k] > 0.f || d_hi[k] < 0.f;
    float ent = -kInf, ext = kInf;
    if (definite) {
      const float n_lo = lo[k] - o[k], n_hi = hi[k] - o[k];
      const float c1 = n_lo / d_lo[k], c2 = n_lo / d_hi[k];
      const float c3 = n_hi / d_lo[k], c4 = n_hi / d_hi[k];
      ent = min_nan(min_nan(c1, c2), min_nan(c3, c4));
      ext = max_nan(max_nan(c1, c2), max_nan(c3, c4));
    }
    ent_max = k ? max_nan(ent_max, ent) : ent;
    ext_min = k ? min_nan(ext_min, ext) : ext;
  }
  return ent_max <= ext_min && ent_max <= kCap;
}

// A row's light-side shaft: apex P, direction box [w_lo, w_hi], and the
// terms of its bounding cone and 2-D wedges, which depend on the row alone.
struct Shaft {
  float p[3], w_lo[3], w_hi[3];
  float axis[3], sin_a, cos_a;
  bool degenerate;
  // per (num, den) axis pair: sign of the direction box in den, and the
  // box's ratio interval of w_num / w_den
  bool pos[6], definite[6];
  float r_lo[6], r_hi[6];
};

// The (num, den) axis pairs of `_apex_wedge_mask`, in its order:
// (0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1).  Called with q known at
// compile time, so the shaft's arrays stay in registers.
__device__ __forceinline__ int pair_num(int q) {
  return q == 0 || q == 2 ? 0 : (q == 1 || q == 4 ? 1 : 2);
}
__device__ __forceinline__ int pair_den(int q) {
  return q == 1 || q == 3 ? 0 : (q == 0 || q == 5 ? 1 : 2);
}

__device__ __forceinline__ void make_shaft(Shaft& sh, const float* p,
                                           const float* o_lo,
                                           const float* o_hi, float s,
                                           bool capped) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sh.p[k] = p[k];
    sh.w_lo[k] = (o_lo[k] - s) - p[k];
    sh.w_hi[k] = (o_hi[k] + s) - p[k];
  }
  if (!capped) return;
  // `_apex_cone_mask`'s row terms
  float c[3], dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = 0.5f * (sh.w_lo[k] + sh.w_hi[k]);
    dw[k] = sh.w_hi[k] - sh.w_lo[k];
  }
  const float r_w =
      0.5f * sqrtf(((dw[0] * dw[0] + dw[1] * dw[1]) + dw[2] * dw[2]) + kTiny);
  const float len_w =
      sqrtf(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + kTiny);
  sh.sin_a = clamp01(r_w / len_w);
  sh.cos_a = sqrtf(clamp0(1.f - sh.sin_a * sh.sin_a));
#pragma unroll
  for (int k = 0; k < 3; ++k) sh.axis[k] = c[k] / len_w;
  sh.degenerate = len_w <= r_w * kDegenerate;
  // `_apex_wedge_mask`'s row terms
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int num = pair_num(q), den = pair_den(q);
    const float d_lo = sh.w_lo[den], d_hi = sh.w_hi[den];
    const float n_lo = sh.w_lo[num], n_hi = sh.w_hi[num];
    sh.pos[q] = d_lo > 0.f;
    sh.definite[q] = sh.pos[q] || d_hi < 0.f;
    sh.r_lo[q] = sh.r_hi[q] = 0.f;
    if (sh.definite[q]) {
      const float r1 = n_lo / d_lo, r2 = n_lo / d_hi;
      const float r3 = n_hi / d_lo, r4 = n_hi / d_hi;
      sh.r_lo[q] = min_nan(min_nan(r1, r2), min_nan(r3, r4));
      sh.r_hi[q] = max_nan(max_nan(r1, r2), max_nan(r3, r4));
    }
  }
}

// `_apex_cone_mask` and `_apex_wedge_mask` of one cluster box.
__device__ __forceinline__ bool cone_and_wedges(const Shaft& sh,
                                                const float* bmin,
                                                const float* bmax, float s2) {
  float bc[3], db[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bc[k] = 0.5f * (bmin[k] + bmax[k]) - sh.p[k];
    db[k] = bmax[k] - bmin[k];
  }
  const float r_b =
      0.5f * sqrtf((db[0] * db[0] + db[1] * db[1]) + db[2] * db[2]) + s2;
  const float vproj =
      (bc[0] * sh.axis[0] + bc[1] * sh.axis[1]) + bc[2] * sh.axis[2];
  const float bb = (bc[0] * bc[0] + bc[1] * bc[1]) + bc[2] * bc[2];
  const float d_ax = sqrtf(clamp0(bb - vproj * vproj));
  const float e = sh.cos_a * d_ax - sh.sin_a * vproj;
  if (!(e <= r_b || sh.degenerate)) return false;
  float b_lo[3], b_hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b_lo[k] = (bmin[k] - s2) - sh.p[k];
    b_hi[k] = (bmax[k] + s2) - sh.p[k];
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    if (!sh.definite[q]) continue;
    const int num = pair_num(q), den = pair_den(q);
    const float c_dlo = b_lo[den], c_dhi = b_hi[den];
    if (!(sh.pos[q] ? c_dlo > 0.f : c_dhi < 0.f)) continue;
    const float c_nlo = b_lo[num], c_nhi = b_hi[num];
    const float r1 = c_nlo / c_dlo, r2 = c_nlo / c_dhi;
    const float r3 = c_nhi / c_dlo, r4 = c_nhi / c_dhi;
    const float c_rlo = min_nan(min_nan(r1, r2), min_nan(r3, r4));
    const float c_rhi = max_nan(max_nan(r1, r2), max_nan(r3, r4));
    if (!(c_rhi >= sh.r_lo[q] && c_rlo <= sh.r_hi[q])) return false;
  }
  return true;
}

__device__ __forceinline__ void load_box(const float* b, int c, float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = __ldg(b + 3 * c + k);
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
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = bmin[k] - s2;
    hi[k] = bmax[k] + s2;
  }
  bool ok;
  if (MODE == MODE_APEX || a.capped)
    ok = slab_clamped<true>(sh.p, sh.p, sh.w_lo, sh.w_hi, lo, hi) &&
         cone_and_wedges(sh, bmin, bmax, s2);
  else
    ok = slab_open(sh.p, sh.w_lo, sh.w_hi, lo, hi);
  if (MODE == MODE_SHARED && a.gmin != nullptr && !ok) {
    load_box(a.gmin, c, bmin);
    load_box(a.gmax, c, bmax);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = bmin[k] - s2;
      hi[k] = bmax[k] + s2;
    }
    ok = slab_open(sh.p, sh.w_lo, sh.w_hi, lo, hi);
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

  // The tile's bounds over its active lanes (`tile_bounds`): lo in
  // b[0..2] (and b[6..8]), hi in b[3..5] (and b[9..11]).
  float b[kBounds];
#pragma unroll
  for (int k = 0; k < kBounds; ++k)
    b[k] = (k % 6) < 3 ? CUDART_INF_F : -CUDART_INF_F;
  // kLanes lanes a step, their loads in flight together: the masks of
  // all of them, then the rays of the active ones.
  for (int first = tid; first < a.tile_rays; first += kLanes * kBlock) {
    bool in[kLanes], act[kLanes];
    long long r[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      in[j] = first + j * kBlock < a.tile_rays;
      r[j] = tile * a.tile_rays + (in[j] ? first + j * kBlock : 0);
      act[j] = in[j] && a.masks == 0;
    }
    for (int m = 0; m < a.masks; ++m) {
      unsigned char v[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        v[j] = in[j] ? __ldg(a.active + m * a.lanes + r[j]) : 0;
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        if (v[j]) {
          act[j] = true;
          s_any[m] = 1;  // every writer stores the same value
        }
    }
    float x[kLanes][6];
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[j][k] = act[j] ? __ldg(a.o + 3 * r[j] + k) : kInf;
        if (MODE == MODE_RAYS)
          x[j][3 + k] = act[j] ? __ldg(a.d + 3 * r[j] + k) : kInf;
      }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (!in[j]) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        b[k] = min_nan(b[k], x[j][k]);
        b[3 + k] = max_nan(b[3 + k], act[j] ? x[j][k] : -kInf);
        if (MODE == MODE_RAYS) {
          b[6 + k] = min_nan(b[6 + k], x[j][3 + k]);
          b[9 + k] = max_nan(b[9 + k], act[j] ? x[j][3 + k] : -kInf);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool lo = (k % 6) < 3;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, b[k], off);
      b[k] = lo ? min_nan(b[k], other) : max_nan(b[k], other);
    }
    if (lane_id == 0) s_part[warp][k] = b[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool lo = (k % 6) < 3;
    float v = s_part[0][k];
    for (int w = 1; w < kWarps; ++w)
      v = lo ? min_nan(v, s_part[w][k]) : max_nan(v, s_part[w][k]);
    b[k] = v;
  }

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
