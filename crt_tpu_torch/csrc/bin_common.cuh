// Shared pieces of the Phase A kernels (cluster_bin.cu, stream_bin.cu): the
// plain versions' constants, NaN-keeping min / max, the frustum slab, the
// light-side shaft with its cone and wedges (ops/binning.py
// `_frustum_box_mask`, `_apex_cone_mask`, `_apex_wedge_mask`,
// `apex_shaft_mask`), and the fold of a tile's bounds (`tile_bounds`), each
// with the plain version's float32 operations in their order (see
// cluster_bin.cu's note on the arithmetic).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kBounds = 12;  // o_lo, o_hi, d_lo, d_hi
constexpr int kLanes = 4;    // lanes a thread folds a step (1,024-lane tiles)

// The constants of ops/binning.py, rounded from the Python float as
// PyTorch rounds them.
constexpr float kInf = (float)3.4e38;  // the finite "infinity", _INF
constexpr float kTiny = (float)1e-12;
constexpr float kDegenerate = (float)1.0001;
constexpr float kCap = (float)(1.0 + 1e-4);

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

// `apex_shaft_mask` of one box: the capped slab from the apex against the
// box inflated by 2 * slack (s2), then the cone and the wedges.
__device__ __forceinline__ bool shaft_admits(const Shaft& sh,
                                             const float* bmin,
                                             const float* bmax, float s2) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = bmin[k] - s2;
    hi[k] = bmax[k] + s2;
  }
  return slab_clamped<true>(sh.p, sh.p, sh.w_lo, sh.w_hi, lo, hi) &&
         cone_and_wedges(sh, bmin, bmax, s2);
}

// A tile's bounds over its active lanes (`tile_bounds`): lo in b[0..2]
// (and, with NB = 12, the directions' in b[6..8]), hi in b[3..5] (and
// b[9..11]); +-3.4e38 in place of an inactive lane.  `active` is [masks,
// lanes] bool (masks 0: every lane active); a lane is active when any mask
// holds it, and s_any[m] (zeroed by the caller before a barrier) is set
// when mask m holds a lane of the tile.  kLanes lanes a step, their loads in
// flight together: the masks of all of them, then the rays of the active
// ones, so a block waits on memory twice, not eight times; then warp
// shuffles and one shared-memory pass, after which every thread holds the
// tile's bounds.  Called by the whole block.
template <int NB>
__device__ __forceinline__ void fold_tile_bounds(
    const float* o, const float* d, const unsigned char* active,
    long long lanes, int masks, long long tile, int tile_rays, int* s_any,
    float (*s_part)[kBounds], float* b) {
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
#pragma unroll
  for (int k = 0; k < kBounds; ++k)
    b[k] = (k % 6) < 3 ? CUDART_INF_F : -CUDART_INF_F;
  for (int first = tid; first < tile_rays; first += kLanes * kBlock) {
    bool in[kLanes], act[kLanes];
    long long r[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      in[j] = first + j * kBlock < tile_rays;
      r[j] = tile * tile_rays + (in[j] ? first + j * kBlock : 0);
      act[j] = in[j] && masks == 0;
    }
    for (int m = 0; m < masks; ++m) {
      unsigned char v[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        v[j] = in[j] ? __ldg(active + m * lanes + r[j]) : 0;
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
        x[j][k] = act[j] ? __ldg(o + 3 * r[j] + k) : kInf;
        if (NB == 12) x[j][3 + k] = act[j] ? __ldg(d + 3 * r[j] + k) : kInf;
      }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (!in[j]) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        b[k] = min_nan(b[k], x[j][k]);
        b[3 + k] = max_nan(b[3 + k], act[j] ? x[j][k] : -kInf);
        if (NB == 12) {
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
}

}  // namespace
