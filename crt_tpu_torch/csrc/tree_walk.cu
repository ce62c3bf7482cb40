// The KD walk of the tree backend: the closest hit of each ray through the
// scene's midpoint-split tree, one thread a ray.
//
// Replaces no pallas_call: crt_tpu walks the tree in one `lax.while_loop`
// (crt_tpu/ops/traverse.py:181 `closest_hit_tree`), which XLA compiles.
// Its plain PyTorch version (ops/traverse.py `_walk`) walks a wavefront in
// lock step: about 75 small ops an iteration, a host read of the lanes at
// a hit leaf each iteration and one of the loop condition every few, ~40
// iterations a walk.  This kernel does a walk in one launch with no host
// read.
//
// What it computes, for each ray (o, d) with active[r] != 0 (every ray
// where active is null): the reference's per-ray stack walk
// (crt_intersection.cpp:109-136).  The stack starts with the root; each
// step pops a node and tests its box (the slab test of `_ray_aabb`, with
// `_inverse`'s 1 / d, a component of size at most 1e-30 taken as +-1e-30
// by its sign, -0.0 as +); an inner node whose box is hit pushes child0
// then child1 (those that exist), so child1 is walked first; a leaf whose
// box is hit tests the triangles of its row in slot order (`_leaf_intersect`:
// the plane and three half-space test on the [17, T + 1] planes of
// `build_triangle_gather`).  The closest hit is kept with a strict <, in
// walk order: the first slot among equal t in a leaf, the first leaf walked
// across leaves.  An inactive ray walks nothing and writes t = inf, tri =
// -1.
//
// Arithmetic: every float32 operation of the plain version, in its order
// (dot products summed x, y, z left to right, IEEE division), min and max
// written as comparisons that keep a NaN as torch.minimum / amax do (a NaN
// in any slab misses the box), and the inclusive tfar >= max(tnear, 0).
// The library is built with -fmad=false and without fast math, so t and
// tri are the plain walk's bit for bit.  A member test stops at the first
// gate it fails, and one whose t is not below the best so far tests no
// edge: neither can change the answer.  A pad id -1 is skipped; the plain
// version reads the pad column there, whose zero normal is never a hit.
//
// What bounds it on an H100: operations.  An exact walk needs 24 FP32
// operations a box it enters and 51 a member test of the leaves among them
// (benchmark/harness/tree_bound.py's count); the bytes are the rays' 24 in
// and 8 out, and the tree's tables, which are small (62 nodes, 29 leaves
// of 16 slots and 67 plane columns, ~8 KB, on the quads scene; ~4.5 MB of
// planes at 65,536 triangles).  The no-FMA floor is 59 FP32 issue slots a
// member test.  The walk here is the reference's, so it tests every box a
// ray meets and every member of the leaves among them, hit found or not.
//
// The design: one thread a ray, with its own stack of STACK node ids in
// local memory (the builder's depth bound MAX_ACCELERATION_TREE_DEPTH = 39
// keeps a walk's stack at 41 at most), and no barrier in the walk.  The
// tables are read through the read-only path (const __restrict__, __ldg):
// a small tree stays in L1, a large one in L2.  Neighbouring threads take
// neighbouring rays, which are neighbouring pixels of the renderer's tiles,
// so a warp's rays mostly walk the same nodes.  While tracing is on the
// wrapper hands a one-word buffer, and each block adds its rays' hit
// leaves to it with one atomic: the (ray, leaf) pairs the plain walk
// counts as `crt.tree.leaf_lanes`.

#include <cuda_runtime.h>
#include <math_constants.h>

#define TREE_BLOCK 256
#define TREE_STACK 48
#define TREE_PARALLEL_EPS 1e-6f

namespace {

struct TreeArgs {
  const float* __restrict__ o;           // [R, 3]
  const float* __restrict__ d;           // [R, 3]
  const unsigned char* __restrict__ active;  // [R] bool, or null
  const float* __restrict__ node_min;    // [N, 3]
  const float* __restrict__ node_max;    // [N, 3]
  const int* __restrict__ children;      // [N, 2], -1 = absent
  const int* __restrict__ leaf_id;       // [N], -1 = inner node
  const int* __restrict__ leaf_tris;     // [leaves, leaf_size], -1 pads
  const float* __restrict__ tri;         // [17, cols]
  long long rays;
  int num_nodes;
  int leaf_size;
  long long cols;
  float* __restrict__ out_t;             // [R]
  int* __restrict__ out_tri;             // [R]
  unsigned long long* stats;             // [1] hit leaves, or null
};

// torch.minimum / torch.maximum: a NaN on either side wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// `_inverse`: 1 / d, a component with |d| <= 1e-30 (or NaN) taken as
// +1e-30 where d >= 0 (so -0.0 too), else -1e-30.
__device__ __forceinline__ float slab_inverse(float d) {
  const float tiny = d >= 0.0f ? 1e-30f : -1e-30f;
  return 1.0f / (fabsf(d) > 1e-30f ? d : tiny);
}

// `_ray_aabb`: does the ray segment [0, inf) hit node n's closed box?
__device__ __forceinline__ bool box_hit(const TreeArgs& a, int n, float ox,
                                        float oy, float oz, float ix,
                                        float iy, float iz) {
  const float* lo = a.node_min + 3 * n;
  const float* hi = a.node_max + 3 * n;
  const float x1 = (__ldg(lo + 0) - ox) * ix, x2 = (__ldg(hi + 0) - ox) * ix;
  const float y1 = (__ldg(lo + 1) - oy) * iy, y2 = (__ldg(hi + 1) - oy) * iy;
  const float z1 = (__ldg(lo + 2) - oz) * iz, z2 = (__ldg(hi + 2) - oz) * iz;
  const float tnear =
      nan_max(nan_max(nan_min(x1, x2), nan_min(y1, y2)), nan_min(z1, z2));
  const float tfar =
      nan_min(nan_min(nan_max(x1, x2), nan_max(y1, y2)), nan_max(z1, z2));
  return tfar >= nan_max(tnear, 0.0f);
}

__global__ void __launch_bounds__(TREE_BLOCK)
    tree_walk_kernel(TreeArgs a) {
  const long long r = (long long)blockIdx.x * TREE_BLOCK + threadIdx.x;
  unsigned leaves = 0;
  if (r < a.rays) {
    float best_t = CUDART_INF_F;
    int best_tri = -1;
    if ((a.active == nullptr || a.active[r] != 0) && a.num_nodes > 0) {
      const float ox = a.o[3 * r], oy = a.o[3 * r + 1], oz = a.o[3 * r + 2];
      const float dx = a.d[3 * r], dy = a.d[3 * r + 1], dz = a.d[3 * r + 2];
      const float ix = slab_inverse(dx), iy = slab_inverse(dy),
                  iz = slab_inverse(dz);
      int stack[TREE_STACK];
      int sp = 0;
      stack[sp++] = 0;
      while (sp > 0) {
        const int n = stack[--sp];
        if (!box_hit(a, n, ox, oy, oz, ix, iy, iz)) continue;
        const int leaf = __ldg(a.leaf_id + n);
        if (leaf < 0) {
          // child0 then child1: child1 is popped first
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int c = __ldg(a.children + 2 * n + k);
            if (c >= 0 && sp < TREE_STACK) stack[sp++] = c;
          }
          continue;
        }
        ++leaves;
        const int* row = a.leaf_tris + (long long)leaf * a.leaf_size;
        for (int s = 0; s < a.leaf_size; ++s) {
          const int id = __ldg(row + s);
          if (id < 0) continue;
          const float* g = a.tri + id;
          const long long C = a.cols;
          const float n0 = __ldg(g), n1 = __ldg(g + C), n2 = __ldg(g + 2 * C);
          const float nd = (n0 * dx + n1 * dy) + n2 * dz;
          const float opd = __ldg(g + 3 * C) - ((n0 * ox + n1 * oy) + n2 * oz);
          if (!(fabsf(nd) >= TREE_PARALLEL_EPS)) continue;
          if (!(opd < 0.0f || __ldg(g + 16 * C) > 0.0f)) continue;
          const float t = opd / nd;
          if (!(t >= 0.0f) || !(t < best_t)) continue;
          bool inside = true;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float mx = __ldg(g + (4 + 3 * e) * C);
            const float my = __ldg(g + (5 + 3 * e) * C);
            const float mz = __ldg(g + (6 + 3 * e) * C);
            const float md = (mx * dx + my * dy) + mz * dz;
            const float mo = (mx * ox + my * oy) + mz * oz;
            inside = inside && ((mo - __ldg(g + (13 + e) * C)) + t * md) >= 0.0f;
          }
          if (inside) {
            best_t = t;
            best_tri = id;
          }
        }
      }
    }
    a.out_t[r] = best_t;
    a.out_tri[r] = best_tri;
  }
  if (a.stats != nullptr) {  // uniform over the launch
    __shared__ unsigned block_leaves;
    if (threadIdx.x == 0) block_leaves = 0u;
    __syncthreads();
    const unsigned warp = __reduce_add_sync(0xffffffffu, leaves);
    if ((threadIdx.x & 31) == 0 && warp != 0u) atomicAdd(&block_leaves, warp);
    __syncthreads();
    if (threadIdx.x == 0 && block_leaves != 0u)
      atomicAdd(a.stats, (unsigned long long)block_leaves);
  }
}

}  // namespace

// The walk of `rays` rays over a tree of `num_nodes` nodes (root 0) into
// out_t / out_tri; `active` (bool bytes) and `stats` (one 64-bit word the
// launch adds its hit leaves to) may be null.  `cols` is the planes' row
// length, T + 1.
extern "C" int crt_tree_walk(const float* o, const float* d,
                             const unsigned char* active,
                             const float* node_min, const float* node_max,
                             const int* children, const int* leaf_id,
                             const int* leaf_tris, const float* tri,
                             long long rays, int num_nodes, int leaf_size,
                             long long cols, float* out_t, int* out_tri,
                             void* stream, unsigned long long* stats) {
  if (rays <= 0) return 0;
  if (num_nodes < 0 || leaf_size < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rays + TREE_BLOCK - 1) / TREE_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  TreeArgs a{o,        d,         active, node_min, node_max,
             children, leaf_id,   leaf_tris, tri,   rays,
             num_nodes, leaf_size, cols,   out_t,   out_tri,
             stats};
  tree_walk_kernel<<<(unsigned)blocks, TREE_BLOCK, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
