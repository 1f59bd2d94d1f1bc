// The grouped kernels: kernel B (kernel_extra_grouped) and kernel A
// (kernel_base_grouped, with the variance and budget epilogue), templated
// on the gates and the traversal like pipeline.cuh's kernel_extra and
// kernel_base, and the chunked kernel A (kernel_base_chunked_grouped) at
// the reference gate set over the table sweep, redesigned for the H100
// (kernel_extra.cu, kernel_accel.cu and kernel_base.cu instantiate them
// and say what they replace). Kernel B comes at the reference, EXT and XT
// gates over the table sweep (GroupSweep), over the block-culled sweep of
// `--accel grid` (GroupCulled) and over the grid walk of `--accel
// gathered` (GroupWalk, which splits each cell's bucket over the group);
// kernel A at the reference gates over GroupSweep and over GroupCulled.
//
// What bound the thread-per-entry kernels (pipeline.cuh kernel_extra and
// kernel_base_chunked, the case K = 1 below): the critical chain of one
// path. A pixel's samples are one chain (each sample reseeds from the end
// state of the one before, trace.cuh run_samples), so a thread runs every
// bounce of every sample one after another: each bounce a closest-hit
// sweep over the whole table, one shadow sweep per light and the shading,
// each instruction waiting on the one before. At the north star the
// budgeted entries of kernel B fill 62 blocks, about one warp per
// scheduler on under half of the card, and each warp waits out the
// latency of every dependent instruction of its longest lane; at
// stress1024 each sweep tests 1025 primitives in one thread (the culled
// sweep: 129 box tests and the entered blocks), with too few warps to hide
// the latency and lanes idle behind divergent paths.
//
// The design here:
//  - A path group: K lanes of one warp (K a power of two dividing 32, a
//    compile-time constant of each instantiation) carry one stream entry.
//    Every lane of the group makes the same RNG draws, ray generation,
//    shading and roulette on the same values (trace.cuh's path functions
//    run unchanged with the traversal GroupSweep<K> or GroupCulled<K>), so
//    the group never diverges internally and the pixel's chain is
//    untouched. The XT gates (fog distance and scatter, the phase, one-light
//    NEE's pick, MIS, the lens and the stratified sampler) are uniform
//    launch arguments and every value they branch on is the group's, so
//    they keep the group in step too. The group's lead lane (j = 0) alone
//    writes the entry's outputs.
//  - The sweeps split across the group (GroupSweep below): lane j tests
//    primitives j, j + K, j + 2K, ... of each kind; a closest hit is
//    reduced by (t, then primitive index) with __shfl_xor_sync over the
//    group's lanes, a shadow sweep joined with __any_sync. A bounce's
//    critical chain shrinks by about the sweeps' share times (1 - 1/K),
//    and the card holds K times as many working warps. GroupCulled splits
//    the block-culled sweep so that it makes the serial cull decisions.
//  - The scene's geometry rows live in shared memory, staged once per
//    block with cp.async before its first path: triangles first (three
//    float4 a row, 16-byte aligned), then spheres, then planes (then, for
//    GroupCulled, the group table). The lanes
//    of a group read consecutive rows: the odd strides 5 (spheres) and 9
//    (planes) put 32 consecutive rows' words in 32 different banks, and a
//    triangle row of 12 words read as three 16-byte loads puts the 8
//    consecutive rows of each quarter-warp phase in 8 disjoint groups of 4
//    banks (word offsets 12 r mod 32 = 0, 12, 24, 4, 16, 28, 8, 20). The
//    materials, the extension and light rows and the winner's normal stay
//    __ldg reads from the global buffer, one address for the whole group.
//  - Kernel B takes the budget-sorted stream in plain blocks of
//    GROUP_THREADS lanes; a block none of whose entries owes a sample
//    writes its zeros and leaves before it stages anything, so the
//    zero-budget tail holds no SM, and the budgeted prefix spreads over
//    every SM. The chunked kernel A keeps its chunk-major stream.
//
//  - A table whose rows exceed the 96 KB budget takes the same kernels over
//    GroupSpill (below): the first rows of each kind that fit a stage cap
//    (triangles as their nine intersection words) live in shared memory,
//    the rest are read from the scene buffer through the read-only path
//    (__ldg: L1, then the 50 MB L2). Its blocks are wider (one a SM at the
//    cap), and the rest of the SM's pool goes to L1. GroupCulledSpill does
//    the same for the culled sweep, its group table staged first.
//
// Neither tensor cores nor TMA tiles have a place here: each ray test is
// a handful of dependent f32 operations that must round exactly as the
// plain version's do (--fmad=false); a TF32 or bf16 product would change
// the hits, and the table is small and read whole by every block, so a
// tiled matrix copy has nothing to tile.

#pragma once

#include <climits>

#include "pipeline.cuh"
#include "traverse.cuh"

namespace trt {

// Kernel launch width of the grouped kernels, and the shared-memory budget
// of the staged rows (bytes; mirrored by ops/kernels.py GROUP_SMEM_BYTES):
// a table above it takes the thread-per-entry kernels.
constexpr int GROUP_THREADS = 128;
constexpr int GROUP_SMEM_BYTES = 96 * 1024;
// The most dynamic shared memory a block may take on the H100 (the 227 KB
// opt-in limit), the bound of GroupSpill's stage cap.
constexpr int GROUP_SMEM_MAX = 232448;
// The words of a triangle row that a sweep reads: v0, e1, e2. The unit
// normal (words 9-11) is read by hit_at, for the winner alone, from the
// global buffer.
constexpr int TRI_SWEEP_W = 9;

__host__ __device__ __forceinline__ int group_rows_floats(const Frame& f) {
  return TRI_W * f.n_tri + SPH_W * f.n_sph + PLN_W * f.n_pln;
}

// Copy the geometry rows of the packed buffer (spheres, planes, triangles)
// into shared memory as triangles, spheres, planes, one 4-byte cp.async a
// word, every thread of the block taking every blockDim.x-th word; then
// wait for them and for the block.
__device__ __forceinline__ void stage_rows(float* smem, const float* buf, const Frame& f) {
  const int n_front = SPH_W * f.n_sph + PLN_W * f.n_pln;
  const int n_tri = TRI_W * f.n_tri;
  for (int w = threadIdx.x; w < n_front + n_tri; w += blockDim.x) {
    const int dst = w < n_front ? n_tri + w : w - n_front;
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem + dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(buf + w) : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Triangle row i of the staged rows: three 16-byte loads.
__device__ __forceinline__ void tri_row(const float* tri, int i, V3& v0, V3& e1, V3& e2) {
  const float4* q = reinterpret_cast<const float4*>(tri) + 3 * i;
  const float4 a = q[0], b = q[1], c = q[2];
  v0 = {a.x, a.y, a.z};
  e1 = {a.w, b.x, b.y};
  e2 = {b.z, b.w, c.x};
}

// The intersection tests of trace.cuh (sphere_t, plane_t, triangle_t) on
// values loaded from shared memory, operation for operation.
__device__ __forceinline__ bool sphere_tv(V3 o, V3 d, V3 center, float rr, float t_min,
                                          float t_max, float& root) {
  V3 oc = center - o;
  float h = dot(d, oc);
  float c = dot(oc, oc) - rr;
  float disc = h * h - c;
  float sqrtd = sqrtf(disc > 0.0f ? disc : 0.0f);
  float near = h - sqrtd;
  float far = h + sqrtd;
  bool near_ok = (near > t_min) && (near < t_max);
  bool far_ok = (far > t_min) && (far < t_max);
  root = near_ok ? near : far;
  return (disc >= 0.0f) && (near_ok || far_ok);
}

__device__ __forceinline__ bool plane_tv(V3 o, V3 d, V3 point, V3 n, float t_min, float t_max,
                                         bool strict, float& t) {
  float denom = dot(n, d);
  bool parallel = fabsf(denom) < PLANE_PARALLEL_EPS;
  t = dot(point - o, n) / (parallel ? 1.0f : denom);
  return !parallel && (t >= t_min) && (strict ? t < t_max : t <= t_max);
}

__device__ __forceinline__ bool triangle_tv(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float t_min,
                                            float t_max, float& t) {
  V3 h = cross(d, e2);
  float a = dot(e1, h);
  bool parallel = (a > -TRI_PARALLEL_EPS) && (a < TRI_PARALLEL_EPS);
  float f = 1.0f / (parallel ? 1.0f : a);
  V3 s = o - v0;
  float u = f * dot(s, h);
  V3 qq = cross(s, e1);
  float v = f * dot(d, qq);
  t = f * dot(e2, qq);
  return !parallel && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > t_min) && (t < t_max);
}

// The lanes' (closest, idx) reduced over a group of K lanes by (t, then
// index), every lane ending with the group's.
template <int K>
__device__ __forceinline__ void reduce_closest(unsigned mask, float& closest, int& idx) {
#pragma unroll
  for (int off = K / 2; off > 0; off >>= 1) {
    const float t_o = __shfl_xor_sync(mask, closest, off);
    const int i_o = __shfl_xor_sync(mask, idx, off);
    if (t_o < closest || (t_o == closest && i_o < idx)) {
      closest = t_o;
      idx = i_o;
    }
  }
}

// The table sweep split across a path group of K lanes, over the rows
// staged in shared memory (a traversal of trace.cuh's path functions, like
// Sweep). Every lane of the group calls each sweep with the same ray.
//
// Why the split closest hit is the serial one. The serial sweep
// (trace.cuh closest_hit) feeds its running `closest` forward as each
// test's t_max and takes a primitive when t > 0 && t < closest. For each
// primitive i let f_i be the t it yields at t_max = T_FAR when that t is
// taken (t > 0 and t < T_FAR), else none. Then at any running closest
// T <= T_FAR the test takes i exactly when f_i exists and f_i < T, with t
// = f_i:
//  - triangle: t does not depend on t_max; the test is t > t_min && t <
//    t_max, then t < closest;
//  - plane: t does not depend on t_max; t >= t_min && t <= t_max, then t <
//    closest, which is stricter;
//  - sphere: near and far do not depend on t_max, only the root choice
//    root = near_ok ? near : far does. If t_min < near < T the test takes
//    near = f_i. If near >= T (and near > t_min) the near root fails and so
//    does the far one: far = fl(h + sqrtd) >= fl(h - sqrtd) = near >= T,
//    rounding being monotonic, so nothing is taken, and f_i (near, or none
//    when near >= T_FAR) is not below T.
//    If near <= t_min (the ray starts inside, or the sphere lies behind)
//    only far can be taken, at any T, exactly when t_min < far < T.
//  - NaN (the pads at 1e30 overflow the sphere test): every comparison
//    with NaN is false at every T, so a NaN root is never taken, and the
//    `disc > 0 ? disc : 0` of sqrtd maps a NaN disc to 0 as before.
// So the serial sweep ends at the smallest f_i, at its lowest index (a
// tie keeps the earlier primitive: strictly closer wins): the
// lexicographic minimum of (f_i, i). Lane j's serial run over its own
// share ends at the minimum over that share by the same argument, and the
// minimum of the lanes' minima, reduced here by (t, then index), is the
// minimum over the table. A lane that took nothing holds (T_FAR, INT_MAX),
// which loses to every taken primitive (f_i < T_FAR). Every lane ends
// with the winner, so hit_at runs identically on each.
//
// The shadow sweep is an OR of tests with fixed bounds: order-free, and a
// lane may stop at its own first blocker.
//
// The interface of a grouped kernel's traversal (kernel_extra_grouped's TR):
// K, its launch argument Launch, the floats it stages (smem_floats) and
// their staging (stage), a constructor from the staged rows, the frame and
// the launch argument, the sweeps and flush.
template <int K_>
struct GroupSweep {
  static constexpr int K = K_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two dividing 32");
  static constexpr int THREADS = GROUP_THREADS;     // a block's lanes
  static constexpr int SMEM_CAP = GROUP_SMEM_BYTES;  // the most it stages
  static constexpr bool PREFER_L1 = false;           // the launcher's carveout
  struct Launch {};  // its launch argument: none
  const float* tri;  // shared memory: [n_tri][TRI_W], then spheres, planes
  const float* sph;
  const float* pln;
  int j;          // the lane's place in its group
  unsigned mask;  // the group's lanes

  static __host__ __device__ __forceinline__ int smem_floats(const Frame& f, const Launch&) {
    return group_rows_floats(f);
  }

  static __device__ __forceinline__ void stage(float* smem, const float* buf, const Frame& f,
                                               const Launch&) {
    stage_rows(smem, buf, f);
  }

  __device__ __forceinline__ GroupSweep(const float* smem, const Frame& f, const Launch& = {}) {
    const unsigned lane = threadIdx.x & 31u;
    j = (int)(lane & (unsigned)(K - 1));
    mask = K == 32 ? 0xffffffffu : (((1u << K) - 1u) << (lane & ~(unsigned)(K - 1)));
    tri = smem;
    sph = tri + TRI_W * f.n_tri;
    pln = sph + SPH_W * f.n_sph;
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    float closest = T_FAR;
    int idx = INT_MAX;
    float t;
    for (int i = j; i < sc.n_sph; i += K) {
      const float* s = sph + SPH_W * i;
      bool hit = sphere_tv(o, d, V3{s[0], s[1], s[2]}, s[3], RAY_EPS, closest, t);
      t = hit ? t : -1.0f;
      if (t > 0.0f && t < closest) { closest = t; idx = i; }
    }
    for (int i = j; i < sc.n_pln; i += K) {
      const float* q = pln + PLN_W * i;
      bool hit = plane_tv(o, d, V3{q[0], q[1], q[2]}, V3{q[3], q[4], q[5]}, RAY_EPS, closest,
                          false, t);
      t = hit ? t : -1.0f;
      if (t > 0.0f && t < closest) { closest = t; idx = sc.n_sph + i; }
    }
    for (int i = j; i < sc.n_tri; i += K) {
      V3 v0, e1, e2;
      tri_row(tri, i, v0, e1, e2);
      bool hit = triangle_tv(o, d, v0, e1, e2, RAY_EPS, closest, t);
      t = hit ? t : -1.0f;
      if (t > 0.0f && t < closest) { closest = t; idx = sc.n_sph + sc.n_pln + i; }
    }
    reduce_closest<K>(mask, closest, idx);
    return hit_at<EXT, XT>(sc, o, d, closest, idx);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min,
                                           float t_max) {
    bool blocked = false;
    float t;
    for (int i = j; !blocked && i < sc.n_sph; i += K) {
      const float* s = sph + SPH_W * i;
      blocked = sphere_tv(o, d, V3{s[0], s[1], s[2]}, s[3], t_min, t_max, t);
    }
    for (int i = j; !blocked && i < sc.n_pln; i += K) {
      const float* q = pln + PLN_W * i;
      blocked = plane_tv(o, d, V3{q[0], q[1], q[2]}, V3{q[3], q[4], q[5]}, t_min, t_max, true, t);
    }
    for (int i = j; !blocked && i < sc.n_tri; i += K) {
      V3 v0, e1, e2;
      tri_row(tri, i, v0, e1, e2);
      blocked = triangle_tv(o, d, v0, e1, e2, t_min, t_max, t);
    }
    return __any_sync(mask, blocked);
  }

  __device__ __forceinline__ void flush() {}
};

// The staged part of a table under a stage cap of `cap` bytes
// (ops/kernels.py group_stage mirrors it): as many rows of each kind as
// fit, triangles first (TRI_SWEEP_W words a row), then spheres, then
// planes; the rest of each kind is spilled.
struct Stage {
  int n_tri, n_sph, n_pln;
};

__host__ __device__ __forceinline__ Stage group_stage(const Frame& f, int cap) {
  int left = cap / 4;
  Stage s;
  s.n_tri = f.n_tri < left / TRI_SWEEP_W ? f.n_tri : left / TRI_SWEEP_W;
  left -= TRI_SWEEP_W * s.n_tri;
  s.n_sph = f.n_sph < left / SPH_W ? f.n_sph : left / SPH_W;
  left -= SPH_W * s.n_sph;
  s.n_pln = f.n_pln < left / PLN_W ? f.n_pln : left / PLN_W;
  return s;
}

__host__ __device__ __forceinline__ int stage_floats(const Stage& s) {
  return TRI_SWEEP_W * s.n_tri + SPH_W * s.n_sph + PLN_W * s.n_pln;
}

// A load from shared memory, or (G) through the read-only path.
template <bool G>
__device__ __forceinline__ float ld(const float* p) {
  return G ? __ldg(p) : *p;
}

// GroupSweep for tables of any size: the same split sweep, its rows from
// two sources. group_stage(f, CAP) rows of each kind are staged in shared
// memory: the triangles plane-major (word w of staged triangle i at w *
// n_staged + i, 32 consecutive rows' words in 32 banks), then the spheres
// and planes as rows. The other rows are read from the scene buffer's rows
// through the read-only path. Lane j's rows of a kind, j, j + K, ..., run
// the staged ones, then the spilled ones: the same rows in the same order
// as GroupSweep, the same operations on the same values, so the lemma
// there holds as it stands. THREADS lanes a block, CAP bytes at most
// staged; the launcher leaves the rest of the SM's pool to L1. Tables
// within the budget keep GroupSweep: at its shape (the shipped K, 128
// lanes, a 96 KB cap) this traversal took 2-35% longer on each of the five
// rows that tools/group_k.py --only budget times (PERF.md).
template <int K_, int THREADS_, int CAP_>
struct GroupSpill {
  static constexpr int K = K_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two dividing 32");
  static constexpr int THREADS = THREADS_;
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS: whole warps, at most 1024");
  static constexpr int SMEM_CAP = CAP_;
  static_assert(CAP_ >= 0 && CAP_ <= GROUP_SMEM_MAX, "CAP: at most the opt-in limit");
  static constexpr bool PREFER_L1 = true;
  struct Launch {};  // its launch argument: none
  const float* tri;  // shared memory: [TRI_SWEEP_W][st.n_tri], then spheres, planes
  const float* sph;
  const float* pln;
  Stage st;
  int j;          // the lane's place in its group
  unsigned mask;  // the group's lanes

  static __host__ __device__ __forceinline__ int smem_floats(const Frame& f, const Launch&) {
    return stage_floats(group_stage(f, CAP_));
  }

  // Copy the staged rows, one 4-byte cp.async a word; then wait for them
  // and for the block.
  static __device__ __forceinline__ void stage(float* smem, const float* buf, const Frame& f,
                                               const Launch&) {
    const Stage s = group_stage(f, CAP_);
    const int n_tri = TRI_SWEEP_W * s.n_tri;
    const int n_front = n_tri + SPH_W * s.n_sph;
    const float* rows = buf + SPH_W * f.n_sph + PLN_W * f.n_pln;
    for (int w = threadIdx.x; w < stage_floats(s); w += blockDim.x) {
      const float* src;
      if (w < n_tri) {
        const int word = w / s.n_tri;
        const int i = w - word * s.n_tri;
        src = rows + TRI_W * i + word;
      } else if (w < n_front) {
        src = buf + (w - n_tri);
      } else {
        src = buf + SPH_W * f.n_sph + (w - n_front);
      }
      const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  __device__ __forceinline__ GroupSpill(const float* smem, const Frame& f, const Launch& = {})
      : st(group_stage(f, CAP_)) {
    const unsigned lane = threadIdx.x & 31u;
    j = (int)(lane & (unsigned)(K - 1));
    mask = K == 32 ? 0xffffffffu : (((1u << K) - 1u) << (lane & ~(unsigned)(K - 1)));
    tri = smem;
    sph = tri + TRI_SWEEP_W * st.n_tri;
    pln = sph + SPH_W * st.n_sph;
  }

  template <bool G>
  static __device__ __forceinline__ bool sphere_at(const float* s, V3 o, V3 d, float t_min,
                                                   float t_max, float& t) {
    return sphere_tv(o, d, V3{ld<G>(s), ld<G>(s + 1), ld<G>(s + 2)}, ld<G>(s + 3), t_min, t_max,
                     t);
  }

  template <bool G>
  static __device__ __forceinline__ bool plane_at(const float* q, V3 o, V3 d, float t_min,
                                                  float t_max, bool strict, float& t) {
    return plane_tv(o, d, V3{ld<G>(q), ld<G>(q + 1), ld<G>(q + 2)},
                    V3{ld<G>(q + 3), ld<G>(q + 4), ld<G>(q + 5)}, t_min, t_max, strict, t);
  }

  // The triangle whose word w lies at p[w * ws].
  template <bool G>
  static __device__ __forceinline__ bool tri_at(const float* p, int ws, V3 o, V3 d, float t_min,
                                                float t_max, float& t) {
    const V3 v0{ld<G>(p), ld<G>(p + ws), ld<G>(p + 2 * ws)};
    const V3 e1{ld<G>(p + 3 * ws), ld<G>(p + 4 * ws), ld<G>(p + 5 * ws)};
    const V3 e2{ld<G>(p + 6 * ws), ld<G>(p + 7 * ws), ld<G>(p + 8 * ws)};
    return triangle_tv(o, d, v0, e1, e2, t_min, t_max, t);
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    float closest = T_FAR;
    int idx = INT_MAX;
    float t;
    const auto take = [&](bool hit, int k) {
      t = hit ? t : -1.0f;
      if (t > 0.0f && t < closest) {
        closest = t;
        idx = k;
      }
    };
    int i = j;
    for (; i < st.n_sph; i += K)
      take(sphere_at<false>(sph + SPH_W * i, o, d, RAY_EPS, closest, t), i);
    for (; i < sc.n_sph; i += K)
      take(sphere_at<true>(sc.sph + SPH_W * i, o, d, RAY_EPS, closest, t), i);
    for (i = j; i < st.n_pln; i += K)
      take(plane_at<false>(pln + PLN_W * i, o, d, RAY_EPS, closest, false, t), sc.n_sph + i);
    for (; i < sc.n_pln; i += K)
      take(plane_at<true>(sc.pln + PLN_W * i, o, d, RAY_EPS, closest, false, t), sc.n_sph + i);
    const int k0 = sc.n_sph + sc.n_pln;
    for (i = j; i < st.n_tri; i += K)
      take(tri_at<false>(tri + i, st.n_tri, o, d, RAY_EPS, closest, t), k0 + i);
    for (; i < sc.n_tri; i += K)
      take(tri_at<true>(sc.tri + TRI_W * i, 1, o, d, RAY_EPS, closest, t), k0 + i);
    reduce_closest<K>(mask, closest, idx);
    return hit_at<EXT, XT>(sc, o, d, closest, idx);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min,
                                           float t_max) {
    bool blocked = false;
    float t;
    int i = j;
    for (; !blocked && i < st.n_sph; i += K)
      blocked = sphere_at<false>(sph + SPH_W * i, o, d, t_min, t_max, t);
    for (; !blocked && i < sc.n_sph; i += K)
      blocked = sphere_at<true>(sc.sph + SPH_W * i, o, d, t_min, t_max, t);
    for (i = j; !blocked && i < st.n_pln; i += K)
      blocked = plane_at<false>(pln + PLN_W * i, o, d, t_min, t_max, true, t);
    for (; !blocked && i < sc.n_pln; i += K)
      blocked = plane_at<true>(sc.pln + PLN_W * i, o, d, t_min, t_max, true, t);
    for (i = j; !blocked && i < st.n_tri; i += K)
      blocked = tri_at<false>(tri + i, st.n_tri, o, d, t_min, t_max, t);
    for (; !blocked && i < sc.n_tri; i += K)
      blocked = tri_at<true>(sc.tri + TRI_W * i, 1, o, d, t_min, t_max, t);
    return __any_sync(mask, blocked);
  }

  __device__ __forceinline__ void flush() {}
};

// The lanes of a guarded block in the wide design of GroupCulled: the
// blocked scene's block of 8 (ops/accel.py BLOCK).
constexpr int CULL_BLOCK = 8;

// The block-culled sweep (traverse.cuh Culled, `--accel grid`) split across
// a path group of K lanes, over the blocked scene's rows and its group
// table staged in shared memory (GroupCulled) or, for tables of any size,
// the part of them that fits a stage cap (GroupCulledSpill). It makes
// exactly the serial sweep's cull
// decisions, which depend on the running closest hit, so its hits and its
// four counters are Culled's (and the plain version's, ops/accel.py
// CulledPrims); ops/group.py split_culled_closest / split_culled_occluded
// are its plain model.
//
// A window of K consecutive groups at a time: lane j tests group g0 + j's
// box once, for the part of the slab predicate that does not depend on the
// closest hit C (tn <= tf && tf > RAY_EPS; an unguarded group: always,
// tn = -BIG), and keeps tn. A group is a candidate under C when its
// predicate holds and tn < C; __ballot_sync hands every lane the window's
// candidates. Then, step by step, the group sweeps the next P candidate
// groups at once (P = K / L): L lanes a group, lane l testing members l,
// l + L, ... with its own running closest from C0, the group's closest at
// the step's start, reduced over the L lanes by (t, then index) to the
// group's (t_b, i_b). Then every lane replays the serial decisions in
// group order from the broadcast (tn_b, t_b, i_b): group b is entered iff
// it is unguarded or tn_b < C (its predicate holds), and C, idx take
// (t_b, i_b) iff b is entered and t_b < C. The next step starts after the
// step's last group, with the candidates under the new C.
//
// Why this is the serial sweep. C only falls, so a group that is no
// candidate under C0 is none under any later C: the groups between
// candidates, skipped here, are skipped serially. At a group b that the
// serial sweep enters with closest C_b <= C0, it ends at the lexicographic
// minimum of (f_i, i) over the members with f_i < C_b, else at C_b (the
// lemma of GroupSweep: a member's taken t does not depend on t_max whenever
// it can win); (t_b, i_b), the minimum over f_i < C0, is that minimum when
// t_b < C_b, and no member has f_i < C_b otherwise. So the replay ends
// each group at the serial closest, and the slab decisions, made with that
// closest, are the serial ones. A tie across groups keeps the earlier
// (strictly closer wins), as the serial sweep does. The 1e30 pads stay
// pads: their NaN compares false on both sides.
//
// Two designs, by L. WIDE = false: L = K, P = 1, one candidate group a
// step with the whole group on it (a block of 8 idles K - 8 lanes when K >
// 8). WIDE = true (K >= 16): L = CULL_BLOCK, P = K / 8 candidate blocks a
// step, one member a lane, at the cost of the replay's broadcasts; the
// groups of a warp no longer split on different decisions at K = 32. Both
// are exact. kernel_accel.cu ships WIDE = true for kernel B and WIDE =
// false for kernel A (on the refill schedule, where a group's pixels follow
// one another and the replay's broadcasts cost more than the idle lanes;
// tools/group_k.py measures both designs at every K > 8): whether the
// replay gains depends on how many blocks a ray enters, which differs by
// scene, so the sweep re-measures the choice where that changes.
//
// The shadow sweep: its decisions use the fixed bounds [t_min, t_max), so
// the window's candidates are its entered groups, and the sweep visits
// them P at a time; a lane stops at its own first blocker, the group's
// first blocker is the least over its L lanes, and the first group of the
// step in order with a blocker (__ballot_sync over the groups' first
// lanes) ends the sweep.
//
// The counters (sweeps, guarded blocks swept, guarded blocks skipped,
// primitive tests: CulledPrims.STATS) count the serial sweep's owed work
// from the replayed decisions, once a group: a guarded group of the window
// up to the sweep's end is swept if entered, else skipped; an entered group
// adds its members, the blocking group those up to its first blocker. The
// lead lanes flush them.
template <int K_, bool WIDE = (K_ > CULL_BLOCK)>
struct GroupCulled {
  static constexpr int K = K_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two dividing 32");
  static constexpr int L = WIDE && K > CULL_BLOCK ? CULL_BLOCK : K;  // lanes a group
  static constexpr int P = K / L;                                    // groups a step
  static constexpr int THREADS = GROUP_THREADS;
  static constexpr int SMEM_CAP = GROUP_SMEM_BYTES;
  static constexpr bool PREFER_L1 = false;
  using Launch = Accel;
  const float* tri;  // shared memory: the rows as GroupSweep, then the group table
  const float* sph;
  const float* pln;
  const float* groups;
  int n_groups, n_sph, n_pln;
  int j;                // the lane's place in its group
  unsigned mask, base;  // the group's lanes, its first lane
  unsigned long long* stats;
  unsigned sweeps = 0, swept = 0, skipped = 0, tests = 0;

  static __host__ __device__ __forceinline__ int smem_floats(const Frame& f, const Accel& a) {
    return group_rows_floats(f) + GROUP_W * a.n_groups;
  }

  // The group table after the rows, then the rows (stage_rows waits for
  // every copy of the thread and for the block).
  static __device__ __forceinline__ void stage(float* smem, const float* buf, const Frame& f,
                                               const Accel& a) {
    float* table = smem + group_rows_floats(f);
    for (int w = threadIdx.x; w < GROUP_W * a.n_groups; w += blockDim.x) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(table + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(buf + a.section + w)
                   : "memory");
    }
    stage_rows(smem, buf, f);
  }

  __device__ __forceinline__ GroupCulled(const float* smem, const Frame& f, const Accel& a)
      : n_groups(a.n_groups), n_sph(f.n_sph), n_pln(f.n_pln), stats(a.stats) {
    const unsigned lane = threadIdx.x & 31u;
    j = (int)(lane & (unsigned)(K - 1));
    base = lane & ~(unsigned)(K - 1);
    mask = K == 32 ? 0xffffffffu : (((1u << K) - 1u) << base);
    tri = smem;
    sph = tri + TRI_W * f.n_tri;
    pln = sph + SPH_W * f.n_sph;
    groups = pln + PLN_W * f.n_pln;
  }

  // The window's bits of a ballot over the group.
  __device__ __forceinline__ unsigned ballot(bool v) const {
    const unsigned b = __ballot_sync(mask, v) >> base;
    return K == 32 ? b : b & ((1u << K) - 1u);
  }

  // Group g's kind, first row within its kind, first index in the flatten
  // order, and count.
  __device__ __forceinline__ void group_at(int g, int& kind, int& r0, int& k0, int& cnt) const {
    const float* G = groups + GROUP_W * g;
    kind = (int)G[0];
    r0 = (int)G[1];
    k0 = r0 + (kind == SPHERE ? 0 : kind == PLANE ? n_sph : n_sph + n_pln);
    cnt = (int)G[2];
  }

  // The test of row r of `kind` in (t_min, t_max), its t in t; a plane
  // takes t >= t_min, and t <= t_max unless `strict`, as plane_t does.
  __device__ __forceinline__ bool test(int kind, int r, V3 o, V3 d, float t_min, float t_max,
                                       bool strict, float& t) const {
    if (kind == SPHERE) {
      const float* s = sph + SPH_W * r;
      return sphere_tv(o, d, V3{s[0], s[1], s[2]}, s[3], t_min, t_max, t);
    }
    if (kind == PLANE) {
      const float* q = pln + PLN_W * r;
      return plane_tv(o, d, V3{q[0], q[1], q[2]}, V3{q[3], q[4], q[5]}, t_min, t_max, strict, t);
    }
    V3 v0, e1, e2;
    tri_row(tri, r, v0, e1, e2);
    return triangle_tv(o, d, v0, e1, e2, t_min, t_max, t);
  }

  // The window position of this lane's group in the step taking the first
  // P candidates of `cand`, or -1; the step's group count and last
  // position.
  __device__ __forceinline__ int slot_of(unsigned cand, int& nb, int& last) const {
    const int s = j / L;
    int mine = -1;
    nb = 0;
    for (unsigned rest = cand; rest != 0u && nb < P; rest &= rest - 1u, ++nb) {
      last = __ffs(rest) - 1;
      if (nb == s) mine = last;
    }
    return mine;
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    ++sweeps;
    const V3 inv = Culled::inverse(d);
    const int l = j % L;
    float closest = T_FAR;
    int idx = INT_MAX;
    for (int g0 = 0; g0 < n_groups; g0 += K) {
      bool guarded = false, pred = false;
      float tn = -BIG;
      if (g0 + j < n_groups) {
        const float* G = groups + GROUP_W * (g0 + j);
        guarded = G[3] != 0.0f;
        pred = true;
        if (guarded) {
          float tf;
          slab_interval(o, d, inv, G + 4, G + 7, tn, tf);
          pred = tn <= tf && tf > RAY_EPS;
        }
      }
      const unsigned gbits = ballot(guarded);
      unsigned entered = 0u;
      for (int from = 0; from < K;) {
        const unsigned cand = ballot(pred && tn < closest) & (~0u << from);
        if (cand == 0u) break;
        int nb, last = 0;
        const int pos = slot_of(cand, nb, last);
        float c = closest;  // C0
        int ci = INT_MAX;
        if (pos >= 0) {
          int kind, r0, k0, cnt;
          group_at(g0 + pos, kind, r0, k0, cnt);
          float t;
          for (int m = l; m < cnt; m += L) {
            bool hit = test(kind, r0 + m, o, d, RAY_EPS, c, false, t);
            t = hit ? t : -1.0f;
            if (t > 0.0f && t < c) { c = t; ci = k0 + m; }
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
          const float t_o = __shfl_xor_sync(mask, c, off);
          const int i_o = __shfl_xor_sync(mask, ci, off);
          if (t_o < c || (t_o == c && i_o < ci)) {
            c = t_o;
            ci = i_o;
          }
        }
        unsigned rest = cand;
        for (int b = 0; b < nb; ++b, rest &= rest - 1u) {
          const int p = __ffs(rest) - 1;
          const float tn_b = __shfl_sync(mask, tn, p, K);
          const float t_b = __shfl_sync(mask, c, b * L, K);
          const int i_b = __shfl_sync(mask, ci, b * L, K);
          if (((gbits >> p) & 1u) == 0u || tn_b < closest) {
            entered |= 1u << p;
            tests += (unsigned)groups[GROUP_W * (g0 + p) + 2];
            if (t_b < closest) {
              closest = t_b;
              idx = i_b;
            }
          }
        }
        from = last + 1;
      }
      swept += __popc(gbits & entered);
      skipped += __popc(gbits & ~entered);
    }
    return hit_at<EXT, XT>(sc, o, d, closest, idx);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min,
                                           float t_max) {
    ++sweeps;
    const V3 inv = Culled::inverse(d);
    const int l = j % L;
    for (int g0 = 0; g0 < n_groups; g0 += K) {
      bool guarded = false, entered = false;
      if (g0 + j < n_groups) {
        const float* G = groups + GROUP_W * (g0 + j);
        guarded = G[3] != 0.0f;
        entered = true;
        if (guarded) {
          float tn, tf;
          slab_interval(o, d, inv, G + 4, G + 7, tn, tf);
          entered = tn <= tf && tn < t_max && tf > t_min;
        }
      }
      const unsigned gbits = ballot(guarded);
      const unsigned cand = ballot(entered);
      for (int from = 0; from < K;) {
        const unsigned step = cand & (~0u << from);
        if (step == 0u) break;
        int nb, last = 0;
        const int pos = slot_of(step, nb, last);
        int first = INT_MAX;
        if (pos >= 0) {
          int kind, r0, k0, cnt;
          group_at(g0 + pos, kind, r0, k0, cnt);
          float t;
          for (int m = l; m < cnt; m += L) {
            if (test(kind, r0 + m, o, d, t_min, t_max, true, t)) {
              first = m;
              break;
            }
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) first = min(first, __shfl_xor_sync(mask, first, off));
        const unsigned blocked = ballot(l == 0 && first != INT_MAX);
        unsigned rest = step;
        for (int b = 0; b < nb; ++b, rest &= rest - 1u) {
          const int p = __ffs(rest) - 1;
          swept += (gbits >> p) & 1u;
          if ((blocked >> (b * L)) & 1u) {
            tests += (unsigned)__shfl_sync(mask, first, b * L, K) + 1u;
            skipped += __popc(gbits & ~cand & ((1u << p) - 1u));
            return true;
          }
          tests += (unsigned)groups[GROUP_W * (g0 + p) + 2];
        }
        from = last + 1;
      }
      skipped += __popc(gbits & ~cand);
    }
    return false;
  }

  // Every thread of the warp calls this; the lead lanes hold their group's
  // counts.
  __device__ __forceinline__ void flush() {
    const bool lead = j == 0;
    flush_counts(stats, lead ? sweeps : 0u, lead ? swept : 0u, lead ? skipped : 0u,
                 lead ? tests : 0u);
  }
};

// The staged part of a culled sweep under a stage cap of `cap` bytes
// (ops/kernels.py culled_stage mirrors it): the group table first, as many
// groups as fit (every sweep reads every window's boxes), then group_stage's
// rows under the rest of the cap: triangles, spheres, planes.
struct CulledStage {
  int n_groups;
  Stage rows;
};

__host__ __device__ __forceinline__ CulledStage culled_stage(const Frame& f, int n_groups,
                                                            int cap) {
  CulledStage s;
  s.n_groups = n_groups < cap / 4 / GROUP_W ? n_groups : cap / 4 / GROUP_W;
  s.rows = group_stage(f, cap - 4 * GROUP_W * s.n_groups);
  return s;
}

// GroupCulled for tables of any size: the same split sweep, line for line,
// each word read from one of two sources. culled_stage(f, n_groups, CAP)
// stages in shared memory the first groups of the table, then the first
// triangles plane-major (as GroupSpill stages them), spheres and planes; a
// group or row past its kind's staged count is read from the scene buffer,
// where the table lies at Accel::section. One pointer says where (group(),
// test()), so a window's box tests, the replay's counts and a member's test
// read the group's and the row's own source, and the sweep makes Culled's
// decisions on the same values in the same order: the lemma above holds as
// it stands, the 1e30 pads included. (GroupCulled keeps its own copy of the
// sweep: a template shared by the two changed the registers and spills
// ptxas gives GroupCulled's kernel B.) THREADS lanes a block, CAP bytes at most staged; the
// launcher leaves the rest of the SM's pool to L1. Tables within the budget
// keep GroupCulled: everything staged, this traversal took 23-28% longer
// for kernel B and 3-6% for kernel A at stress1024 and mesh1280
// (tools/group_k.py --only grid, PERF.md).
template <int K_, bool WIDE, int THREADS_, int CAP_>
struct GroupCulledSpill {
  static constexpr int K = K_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two dividing 32");
  static constexpr int L = WIDE && K > CULL_BLOCK ? CULL_BLOCK : K;  // lanes a group
  static constexpr int P = K / L;                                    // groups a step
  static constexpr int THREADS = THREADS_;
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS: whole warps, at most 1024");
  static constexpr int SMEM_CAP = CAP_;
  static_assert(CAP_ >= 0 && CAP_ <= GROUP_SMEM_MAX, "CAP: at most the opt-in limit");
  static constexpr bool PREFER_L1 = true;
  using Launch = Accel;
  const float* groups;  // shared memory: [st.n_groups][GROUP_W], then the rows as GroupSpill
  const float* tri;
  const float* sph;
  const float* pln;
  CulledStage st;
  int section;  // the group table's offset in the scene buffer
  int n_groups, n_sph, n_pln;
  int j;                // the lane's place in its group
  unsigned mask, base;  // the group's lanes, its first lane
  unsigned long long* stats;
  unsigned sweeps = 0, swept = 0, skipped = 0, tests = 0;

  static __host__ __device__ __forceinline__ int smem_floats(const Frame& f, const Accel& a) {
    const CulledStage s = culled_stage(f, a.n_groups, CAP_);
    return GROUP_W * s.n_groups + stage_floats(s.rows);
  }

  // Copy the staged groups and rows, one 4-byte cp.async a word; then wait
  // for them and for the block.
  static __device__ __forceinline__ void stage(float* smem, const float* buf, const Frame& f,
                                               const Accel& a) {
    const CulledStage s = culled_stage(f, a.n_groups, CAP_);
    const int n_tab = GROUP_W * s.n_groups;
    const int n_tri = n_tab + TRI_SWEEP_W * s.rows.n_tri;
    const int n_front = n_tri + SPH_W * s.rows.n_sph;
    const float* rows = buf + SPH_W * f.n_sph + PLN_W * f.n_pln;
    for (int w = threadIdx.x; w < n_tab + stage_floats(s.rows); w += blockDim.x) {
      const float* src;
      if (w < n_tab) {
        src = buf + a.section + w;
      } else if (w < n_tri) {
        const int word = (w - n_tab) / s.rows.n_tri;
        const int i = w - n_tab - word * s.rows.n_tri;
        src = rows + TRI_W * i + word;
      } else if (w < n_front) {
        src = buf + (w - n_tri);
      } else {
        src = buf + SPH_W * f.n_sph + (w - n_front);
      }
      const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  __device__ __forceinline__ GroupCulledSpill(const float* smem, const Frame& f, const Accel& a)
      : st(culled_stage(f, a.n_groups, CAP_)), section(a.section), n_groups(a.n_groups),
        n_sph(f.n_sph), n_pln(f.n_pln), stats(a.stats) {
    const unsigned lane = threadIdx.x & 31u;
    j = (int)(lane & (unsigned)(K - 1));
    base = lane & ~(unsigned)(K - 1);
    mask = K == 32 ? 0xffffffffu : (((1u << K) - 1u) << base);
    groups = smem;
    tri = groups + GROUP_W * st.n_groups;
    sph = tri + TRI_SWEEP_W * st.rows.n_tri;
    pln = sph + SPH_W * st.rows.n_sph;
  }

  // Group g's words, staged or in the scene buffer (which starts at the
  // sphere rows).
  __device__ __forceinline__ const float* group(const Scene& sc, int g) const {
    return g < st.n_groups ? groups + GROUP_W * g : sc.sph + section + GROUP_W * g;
  }

  // The window's bits of a ballot over the group.
  __device__ __forceinline__ unsigned ballot(bool v) const {
    const unsigned b = __ballot_sync(mask, v) >> base;
    return K == 32 ? b : b & ((1u << K) - 1u);
  }

  // Group g's kind, first row within its kind, first index in the flatten
  // order, and count.
  __device__ __forceinline__ void group_at(const Scene& sc, int g, int& kind, int& r0, int& k0,
                                           int& cnt) const {
    const float* G = group(sc, g);
    kind = (int)G[0];
    r0 = (int)G[1];
    k0 = r0 + (kind == SPHERE ? 0 : kind == PLANE ? n_sph : n_sph + n_pln);
    cnt = (int)G[2];
  }

  // The test of row r of `kind` in (t_min, t_max) on the row's own source,
  // its t in t; a plane takes t >= t_min, and t <= t_max unless `strict`,
  // as plane_t does; a triangle's word w lies at q[w * ws].
  __device__ __forceinline__ bool test(const Scene& sc, int kind, int r, V3 o, V3 d, float t_min,
                                       float t_max, bool strict, float& t) const {
    if (kind == SPHERE) {
      const float* s = r < st.rows.n_sph ? sph + SPH_W * r : sc.sph + SPH_W * r;
      return sphere_tv(o, d, V3{s[0], s[1], s[2]}, s[3], t_min, t_max, t);
    }
    if (kind == PLANE) {
      const float* q = r < st.rows.n_pln ? pln + PLN_W * r : sc.pln + PLN_W * r;
      return plane_tv(o, d, V3{q[0], q[1], q[2]}, V3{q[3], q[4], q[5]}, t_min, t_max, strict, t);
    }
    const bool staged = r < st.rows.n_tri;
    const float* q = staged ? tri + r : sc.tri + TRI_W * r;
    const int ws = staged ? st.rows.n_tri : 1;
    const V3 v0{q[0], q[ws], q[2 * ws]};
    const V3 e1{q[3 * ws], q[4 * ws], q[5 * ws]};
    const V3 e2{q[6 * ws], q[7 * ws], q[8 * ws]};
    return triangle_tv(o, d, v0, e1, e2, t_min, t_max, t);
  }

  // The window position of this lane's group in the step taking the first
  // P candidates of `cand`, or -1; the step's group count and last
  // position.
  __device__ __forceinline__ int slot_of(unsigned cand, int& nb, int& last) const {
    const int s = j / L;
    int mine = -1;
    nb = 0;
    for (unsigned rest = cand; rest != 0u && nb < P; rest &= rest - 1u, ++nb) {
      last = __ffs(rest) - 1;
      if (nb == s) mine = last;
    }
    return mine;
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    ++sweeps;
    const V3 inv = Culled::inverse(d);
    const int l = j % L;
    float closest = T_FAR;
    int idx = INT_MAX;
    for (int g0 = 0; g0 < n_groups; g0 += K) {
      bool guarded = false, pred = false;
      float tn = -BIG;
      if (g0 + j < n_groups) {
        const float* G = group(sc, g0 + j);
        guarded = G[3] != 0.0f;
        pred = true;
        if (guarded) {
          float tf;
          slab_interval(o, d, inv, G + 4, G + 7, tn, tf);
          pred = tn <= tf && tf > RAY_EPS;
        }
      }
      const unsigned gbits = ballot(guarded);
      unsigned entered = 0u;
      for (int from = 0; from < K;) {
        const unsigned cand = ballot(pred && tn < closest) & (~0u << from);
        if (cand == 0u) break;
        int nb, last = 0;
        const int pos = slot_of(cand, nb, last);
        float c = closest;  // C0
        int ci = INT_MAX;
        if (pos >= 0) {
          int kind, r0, k0, cnt;
          group_at(sc, g0 + pos, kind, r0, k0, cnt);
          float t;
          for (int m = l; m < cnt; m += L) {
            bool hit = test(sc, kind, r0 + m, o, d, RAY_EPS, c, false, t);
            t = hit ? t : -1.0f;
            if (t > 0.0f && t < c) { c = t; ci = k0 + m; }
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
          const float t_o = __shfl_xor_sync(mask, c, off);
          const int i_o = __shfl_xor_sync(mask, ci, off);
          if (t_o < c || (t_o == c && i_o < ci)) {
            c = t_o;
            ci = i_o;
          }
        }
        unsigned rest = cand;
        for (int b = 0; b < nb; ++b, rest &= rest - 1u) {
          const int p = __ffs(rest) - 1;
          const float tn_b = __shfl_sync(mask, tn, p, K);
          const float t_b = __shfl_sync(mask, c, b * L, K);
          const int i_b = __shfl_sync(mask, ci, b * L, K);
          if (((gbits >> p) & 1u) == 0u || tn_b < closest) {
            entered |= 1u << p;
            tests += (unsigned)group(sc, g0 + p)[2];
            if (t_b < closest) {
              closest = t_b;
              idx = i_b;
            }
          }
        }
        from = last + 1;
      }
      swept += __popc(gbits & entered);
      skipped += __popc(gbits & ~entered);
    }
    return hit_at<EXT, XT>(sc, o, d, closest, idx);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min,
                                           float t_max) {
    ++sweeps;
    const V3 inv = Culled::inverse(d);
    const int l = j % L;
    for (int g0 = 0; g0 < n_groups; g0 += K) {
      bool guarded = false, entered = false;
      if (g0 + j < n_groups) {
        const float* G = group(sc, g0 + j);
        guarded = G[3] != 0.0f;
        entered = true;
        if (guarded) {
          float tn, tf;
          slab_interval(o, d, inv, G + 4, G + 7, tn, tf);
          entered = tn <= tf && tn < t_max && tf > t_min;
        }
      }
      const unsigned gbits = ballot(guarded);
      const unsigned cand = ballot(entered);
      for (int from = 0; from < K;) {
        const unsigned step = cand & (~0u << from);
        if (step == 0u) break;
        int nb, last = 0;
        const int pos = slot_of(step, nb, last);
        int first = INT_MAX;
        if (pos >= 0) {
          int kind, r0, k0, cnt;
          group_at(sc, g0 + pos, kind, r0, k0, cnt);
          float t;
          for (int m = l; m < cnt; m += L) {
            if (test(sc, kind, r0 + m, o, d, t_min, t_max, true, t)) {
              first = m;
              break;
            }
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) first = min(first, __shfl_xor_sync(mask, first, off));
        const unsigned blocked = ballot(l == 0 && first != INT_MAX);
        unsigned rest = step;
        for (int b = 0; b < nb; ++b, rest &= rest - 1u) {
          const int p = __ffs(rest) - 1;
          swept += (gbits >> p) & 1u;
          if ((blocked >> (b * L)) & 1u) {
            tests += (unsigned)__shfl_sync(mask, first, b * L, K) + 1u;
            skipped += __popc(gbits & ~cand & ((1u << p) - 1u));
            return true;
          }
          tests += (unsigned)group(sc, g0 + p)[2];
        }
        from = last + 1;
      }
      skipped += __popc(gbits & ~cand);
    }
    return false;
  }

  // Every thread of the warp calls this; the lead lanes hold their group's
  // counts.
  __device__ __forceinline__ void flush() {
    const bool lead = j == 0;
    flush_counts(stats, lead ? sweeps : 0u, lead ? swept : 0u, lead ? skipped : 0u,
                 lead ? tests : 0u);
  }
};

// The row sources of GroupWalk: rows and CSR read through L1 (__ldg, nothing
// staged); the rows that fit the stage cap staged, the CSR through L1; the
// CSR staged where it fits the cap, then the rows that fit the rest.
constexpr int WALK_L1 = 0, WALK_ROWS = 1, WALK_CSR = 2;

// The rows GroupWalk stages under a cap of `cap` bytes: group_stage's
// triangles (TRI_SWEEP_W words a row), then spheres, and no planes (every
// lane tests those from the scene buffer). ops/kernels.py group_stage(n_sph,
// 0, n_tri, cap) mirrors it.
__host__ __device__ __forceinline__ Stage walk_stage(const Frame& f, int cap) {
  int left = cap / 4;
  Stage s;
  s.n_tri = f.n_tri < left / TRI_SWEEP_W ? f.n_tri : left / TRI_SWEEP_W;
  left -= TRI_SWEEP_W * s.n_tri;
  s.n_sph = f.n_sph < left / SPH_W ? f.n_sph : left / SPH_W;
  s.n_pln = 0;
  return s;
}

// The grid walk of `--accel gathered` (traverse.cuh Walk) split across a
// path group of K lanes: every lane makes Walk's decisions on the same
// values, and the group splits each cell's bucket. Its hits and its four
// counters are Walk's (and the plain version's, ops/gathered.py
// GatheredPrims); ops/group.py split_walk_closest / split_walk_occluded are
// its plain model.
//  - The planes sweep first in every lane, as in Walk, and cap the walk.
//  - Every lane computes the slab entry, the first cell and the DDA from the
//    same ray, so each advance decision is the group's.
//  - A cell's bucket [cur, end) is tested in windows of w = min(end - cur,
//    K, max_trips - trips) entries: lane j < w tests entry cur + j with the
//    running t_best at the window's start as t_max; the window is reduced by
//    (t, then position in the bucket) over the group's lanes, and its
//    winner, taken only when strictly below t_best, becomes the walk's.
//    Why that is the serial walk: by the lemma of GroupSweep a test's taken
//    t does not depend on t_max whenever it can win, so the serial walk,
//    feeding t_best forward through the window, ends it at the first entry
//    in bucket order of the least t below the window's starting t_best: the
//    lexicographic minimum of (t, position). A primitive that spans cells
//    is tested again in a later cell, as serially; the reduction is by
//    position within one window, never by primitive index across cells (a
//    tie across cells keeps the earlier cell's hit, strictly closer wins).
//  - A shadow walk ballots each window; the first hit's position ends the
//    walk and fixes its test count.
//  - The trip cap is replayed: a window takes at most max_trips - trips
//    tests and an advance one trip, so the group stops where Walk would.
// The counters (walks, tests, advances, capped walks) are counted from the
// replayed decisions, once a group, and flushed by the lead lanes.
//
// The row sources (SRC): WALK_L1 reads rows and CSR as Walk does; the
// others stage in shared memory the CSR (WALK_CSR, where the offsets and
// indices fit CAP) and the rows of walk_stage under the rest of CAP
// (triangles plane-major as GroupSpill stages them), the rest through L1.
// Every form serves any table size. THREADS lanes a block.
template <int K_, int SRC_, int THREADS_ = GROUP_THREADS, int CAP_ = GROUP_SMEM_MAX>
struct GroupWalk {
  static constexpr int K = K_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two dividing 32");
  static_assert(SRC_ >= WALK_L1 && SRC_ <= WALK_CSR, "SRC: a row source");
  static constexpr int THREADS = THREADS_;
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS: whole warps, at most 1024");
  static constexpr int SMEM_CAP = SRC_ == WALK_L1 ? 0 : CAP_;
  static_assert(CAP_ >= 0 && CAP_ <= GROUP_SMEM_MAX, "CAP: at most the opt-in limit");
  static constexpr bool PREFER_L1 = true;
  using Launch = Accel;
  const Accel& p;
  const int* csr;    // shared memory: the CSR offsets, then indices; or null
  const float* tri;  // shared memory: [TRI_SWEEP_W][st.n_tri], then spheres
  const float* sph;
  Stage st;
  int j;                // the lane's place in its group
  unsigned mask, base;  // the group's lanes, its first lane
  unsigned walks = 0, tests = 0, advances = 0, capped = 0;

  // The CSR's words: n_cells + 1 offsets and the indices (Accel::n_groups
  // holds their count under the walk).
  static __host__ __device__ __forceinline__ int csr_words(const Accel& a) {
    return a.dims[0] * a.dims[1] * a.dims[2] + 1 + a.n_groups;
  }

  static __host__ __device__ __forceinline__ bool csr_staged(const Accel& a) {
    return SRC_ == WALK_CSR && 4 * csr_words(a) <= CAP_;
  }

  static __host__ __device__ __forceinline__ Stage rows_stage(const Frame& f, const Accel& a) {
    if (SRC_ == WALK_L1) return Stage{0, 0, 0};
    return walk_stage(f, CAP_ - (csr_staged(a) ? 4 * csr_words(a) : 0));
  }

  static __host__ __device__ __forceinline__ int smem_floats(const Frame& f, const Accel& a) {
    return (csr_staged(a) ? csr_words(a) : 0) + stage_floats(rows_stage(f, a));
  }

  // Copy the staged CSR (its offsets and indices lie together at a.off) and
  // rows, one 4-byte cp.async a word; then wait for them and for the block.
  static __device__ __forceinline__ void stage(float* smem, const float* buf, const Frame& f,
                                               const Accel& a) {
    if (SRC_ == WALK_L1) return;
    const int nc = csr_staged(a) ? csr_words(a) : 0;
    const Stage s = rows_stage(f, a);
    const int n_tri = TRI_SWEEP_W * s.n_tri;
    const float* rows = buf + SPH_W * f.n_sph + PLN_W * f.n_pln;
    for (int w = threadIdx.x; w < nc + stage_floats(s); w += blockDim.x) {
      const float* src;
      if (w < nc) {
        src = buf + a.off + w;
      } else if (w - nc < n_tri) {
        const int word = (w - nc) / s.n_tri;
        src = rows + TRI_W * (w - nc - word * s.n_tri) + word;
      } else {
        src = buf + (w - nc - n_tri);
      }
      const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  __device__ __forceinline__ GroupWalk(const float* smem, const Frame& f, const Accel& a)
      : p(a), st(rows_stage(f, a)) {
    const unsigned lane = threadIdx.x & 31u;
    j = (int)(lane & (unsigned)(K - 1));
    base = lane & ~(unsigned)(K - 1);
    mask = K == 32 ? 0xffffffffu : (((1u << K) - 1u) << base);
    const bool cs = csr_staged(a);
    csr = cs ? reinterpret_cast<const int*>(smem) : nullptr;
    tri = smem + (cs ? csr_words(a) : 0);
    sph = tri + TRI_SWEEP_W * st.n_tri;
  }

  // The window's bits of a ballot over the group.
  __device__ __forceinline__ unsigned ballot(bool v) const {
    const unsigned b = __ballot_sync(mask, v) >> base;
    return K == 32 ? b : b & ((1u << K) - 1u);
  }

  // Word w of the CSR (offsets from 0, indices from p.idx - p.off), staged
  // or from g, the CSR in the scene buffer.
  __device__ __forceinline__ int csr_at(const int* g, int w) const {
    return SRC_ == WALK_CSR && csr != nullptr ? csr[w] : __ldg(g + w);
  }

  // The test of walk id `pid` (spheres, then triangles) in (t_min, t_max),
  // its t in t: Walk's, on the staged rows where the primitive is staged.
  __device__ __forceinline__ bool test(const Scene& sc, int pid, V3 o, V3 d, float t_min,
                                       float t_max, float& t) const {
    if (pid < sc.n_sph) {
      if (SRC_ != WALK_L1 && pid < st.n_sph) {
        const float* s = sph + SPH_W * pid;
        return sphere_tv(o, d, V3{s[0], s[1], s[2]}, s[3], t_min, t_max, t);
      }
      return sphere_t(o, d, sc.sph + SPH_W * pid, t_min, t_max, t);
    }
    const int r = pid - sc.n_sph;
    if (SRC_ != WALK_L1 && r < st.n_tri) {
      const float* q = tri + r;
      const int ws = st.n_tri;
      const V3 v0{q[0], q[ws], q[2 * ws]};
      const V3 e1{q[3 * ws], q[4 * ws], q[5 * ws]};
      const V3 e2{q[6 * ws], q[7 * ws], q[8 * ws]};
      return triangle_tv(o, d, v0, e1, e2, t_min, t_max, t);
    }
    return triangle_t(o, d, sc.tri + TRI_W * r, t_min, t_max, t);
  }

  // Walk::walk split across the group (see above): every lane ends with
  // the walk's t_best and best.
  template <bool ANY>
  __device__ __forceinline__ void walk(const Scene& sc, V3 o, V3 d, float t_min, float& t_best,
                                       int& best) {
    ++walks;
    const float oc[3] = {o.x, o.y, o.z}, dc[3] = {d.x, d.y, d.z};
    float inv[3], t0 = 0.0f, t1 = BIG;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      bool par = fabsf(dc[ax]) < PAR_EPS;
      inv[ax] = 1.0f / (par ? 1.0f : dc[ax]);
      float a = (p.lo[ax] - oc[ax]) * inv[ax];
      float b = (p.hi[ax] - oc[ax]) * inv[ax];
      float a_min = fminf(a, b), a_max = fmaxf(a, b);
      if (par) {
        bool inside = oc[ax] >= p.lo[ax] && oc[ax] <= p.hi[ax];
        a_min = inside ? 0.0f : BIG;
        a_max = inside ? BIG : 0.0f;
      }
      t0 = fmaxf(t0, a_min);
      t1 = fminf(t1, a_max);
    }
    if (!(t0 <= t1 && t0 < t_best)) return;
    const float t_entry = fmaxf(t0, 0.0f) + ENTRY_EPS;
    int ic[3];
    float tm[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      float pos = oc[ax] + dc[ax] * t_entry;
      float c = fminf(fmaxf(floorf((pos - p.lo[ax]) * p.inv_cell[ax]), 0.0f),
                      (float)(p.dims[ax] - 1));
      float pos_next = p.lo[ax] + (c + (dc[ax] >= 0.0f ? 1.0f : 0.0f)) * p.cell[ax];
      ic[ax] = (int)c;
      tm[ax] = fabsf(dc[ax]) < PAR_EPS ? BIG : fabsf((pos_next - oc[ax]) * inv[ax]);
    }
    // The scene buffer starts at the sphere rows.
    const int* g = reinterpret_cast<const int*>(sc.sph + p.off);
    const int ib = p.idx - p.off;
    int ci = ic[0] + ic[1] * p.dims[0] + ic[2] * (p.dims[0] * p.dims[1]);
    int cur = csr_at(g, ci), end = csr_at(g, ci + 1);
    for (int trips = 0;;) {
      if (trips == p.max_trips) {
        ++capped;
        return;
      }
      if (cur < end) {  // a window of the cell's next entries
        const int w = min(min(end - cur, K), p.max_trips - trips);
        int pid = -1;
        bool ok = false;
        float t = -1.0f;
        if (j < w) {
          pid = csr_at(g, ib + cur + j);
          bool hit = test(sc, pid, o, d, t_min, t_best, t);
          t = hit ? t : -1.0f;
          ok = t > 0.0f && t < t_best;
        }
        if (ANY) {
          const unsigned hits = ballot(ok);
          if (hits != 0u) {
            const int first = __ffs(hits) - 1;
            tests += (unsigned)first + 1u;
            best = __shfl_sync(mask, pid, first, K);
            return;
          }
        } else {
          float c = ok ? t : t_best;
          int at = ok ? j : K;
          reduce_closest<K>(mask, c, at);
          if (at < K) {
            best = __shfl_sync(mask, pid, at, K);
            t_best = c;
          }
        }
        tests += (unsigned)w;
        cur += w;
        trips += w;
      } else {  // advance one cell along the axis of the nearest boundary
        ++advances;
        const int ax = tm[0] <= tm[1] && tm[0] <= tm[2] ? 0 : tm[1] <= tm[2] ? 1 : 2;
        if (tm[ax] > t_best) return;
        const int c2 = ic[ax] + (dc[ax] >= 0.0f ? 1 : -1);
        if (c2 < 0 || c2 >= p.dims[ax]) return;
        ic[ax] = c2;
        tm[ax] = tm[ax] + fabsf(p.cell[ax] / (fabsf(dc[ax]) < PAR_EPS ? 1.0f : dc[ax]));
        ci = ic[0] + ic[1] * p.dims[0] + ic[2] * (p.dims[0] * p.dims[1]);
        cur = csr_at(g, ci);
        end = csr_at(g, ci + 1);
        ++trips;
      }
    }
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    float t_best = T_FAR, t;
    int plane = -1, best = -1;
    for (int i = 0; i < sc.n_pln; ++i) {
      bool hit = plane_t(o, d, sc.pln + PLN_W * i, RAY_EPS, t_best, false, t);
      t = hit ? t : -1.0f;
      if (t > 0.0f && t < t_best) { t_best = t; plane = i; }
    }
    walk<false>(sc, o, d, RAY_EPS, t_best, best);
    const int k = best >= 0 ? (best < sc.n_sph ? best : best + sc.n_pln)
                            : (plane >= 0 ? sc.n_sph + plane : -1);
    return hit_at<EXT, XT>(sc, o, d, t_best, k);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min, float t_max) {
    float t;
    for (int i = 0; i < sc.n_pln; ++i)
      if (plane_t(o, d, sc.pln + PLN_W * i, t_min, t_max, true, t)) return true;
    int best = -1;
    walk<true>(sc, o, d, t_min, t_max, best);
    return best >= 0;
  }

  // Every thread of the warp calls this; the lead lanes hold their group's
  // counts.
  __device__ __forceinline__ void flush() {
    const bool lead = j == 0;
    flush_counts(p.stats, lead ? walks : 0u, lead ? tests : 0u, lead ? advances : 0u,
                 lead ? capped : 0u);
  }
};

}  // namespace trt

namespace {

// Kernel B, grouped: the entry of group g = global thread / K, its K lanes
// rendering the entry's `add` extra samples together (see the top), with
// the gates EXT, XT and the traversal TR (GroupSweep<K>, GroupCulled<K>, ...)
// built from the staged rows and its launch argument.
template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(TR::THREADS)
    kernel_extra_grouped(ExtraArgs a, const float* __restrict__ scene_buf,
                         const int* __restrict__ xs, const int* __restrict__ ys,
                         const long long* __restrict__ state_in, const float* __restrict__ add,
                         const int* __restrict__ samp0, float* __restrict__ out,
                         unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                         typename TR::Launch tl) {
  constexpr int K = TR::K;
  extern __shared__ float4 group_smem[];
  float* rows = reinterpret_cast<float*>(group_smem);
  const int n = a.n_entries;
  const int i = (int)(((long long)blockIdx.x * TR::THREADS + threadIdx.x) / K);
  const bool lead = (threadIdx.x & (unsigned)(K - 1)) == 0u;
  const float budget = i < n ? add[i] : 0.0f;
  trt::V3 esum = {0.0f, 0.0f, 0.0f};
  float rays = 0.0f;
  unsigned my_iters = 0;
  if (__syncthreads_or(budget > 0.0f)) {
    TR::stage(rows, scene_buf, a.f, tl);
    TR tr(rows, a.f, tl);
    if (budget > 0.0f) {
      const trt::Scene sc = trt::make_scene(scene_buf, a.f);
      uint32_t state = (uint32_t)state_in[i];
      const int s0 = samp0[i];
      my_iters = trt::run_samples<EXT, XT>(a.f, sc, tx, xt, state, s0, budget + (float)s0,
                                           (float)xs[i], (float)ys[i], esum, nullptr, rays, tr);
    }
    trt::count_slot_iters<K>(my_iters, iters);
    tr.flush();
  }
  if (lead && i < n) {
    out[0 * n + i] = esum.x;
    out[1 * n + i] = esum.y;
    out[2 * n + i] = esum.z;
    out[3 * n + i] = rays;
  }
}

// The chunked kernel A, grouped: the chunk-major entry of group g = global
// thread / K (kernel_base_chunked's body, its sweeps split over the group),
// with the gates EXT, XT and the traversal TR (GroupSweep<K>, GroupSpill,
// GroupCulled, GroupCulledSpill) built from the staged rows and its launch
// argument. Every lane builds TR and flushes its counters after the slot
// count, as base_grouped does: GroupCulled's and GroupCulledSpill's flush
// reduces over the whole warp, whose groups past the last entry count 0.
template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(TR::THREADS)
    kernel_base_chunked_grouped(ChunkArgs a, const float* __restrict__ scene_buf,
                                float* __restrict__ out, long long* __restrict__ state_out,
                                unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                                typename TR::Launch tl) {
  constexpr int K = TR::K;
  extern __shared__ float4 group_smem[];
  float* rows = reinterpret_cast<float*>(group_smem);
  const int n_pix = a.h_out * a.f.width;
  const int n = a.n_chunks * n_pix;
  const int i = (int)(((long long)blockIdx.x * TR::THREADS + threadIdx.x) / K);
  const bool lead = (threadIdx.x & (unsigned)(K - 1)) == 0u;
  TR::stage(rows, scene_buf, a.f, tl);
  TR tr(rows, a.f, tl);
  unsigned my_iters = 0;
  if (i < n) {
    const trt::Scene sc = trt::make_scene(scene_buf, a.f);
    const int c = i / n_pix;
    const int p = i - c * n_pix;
    const int x = p % a.f.width;
    const int y = a.y0 + p / a.f.width;
    uint32_t state = trt::seed_pixel((uint32_t)y * (uint32_t)a.f.width + (uint32_t)x, a.seed,
                                     a.frame) +
                     (uint32_t)c * trt::CHUNK_GOLDEN;
    const int s0 = c * a.cb;
    const int quota = min(s0 + a.cb, a.base);
    trt::V3 csum = {0.0f, 0.0f, 0.0f}, csumsq = {0.0f, 0.0f, 0.0f};
    float rays = 0.0f;
    my_iters = trt::run_samples<EXT, XT>(a.f, sc, tx, xt, state, s0, (float)quota, (float)x,
                                         (float)y, csum, &csumsq, rays, tr);
    if (lead) {
      out[0 * n + i] = csum.x;
      out[1 * n + i] = csum.y;
      out[2 * n + i] = csum.z;
      out[3 * n + i] = csumsq.x;
      out[4 * n + i] = csumsq.y;
      out[5 * n + i] = csumsq.z;
      out[6 * n + i] = rays;
      state_out[i] = (long long)state;
    }
  }
  trt::count_slot_iters<K>(my_iters, iters);
  tr.flush();
}

// Kernel A, grouped: a path group of K = TR::K lanes carries one pixel p =
// y * w + x (y = y0 + row) through pipeline.cuh's base_pixel, every lane
// making the same draws over [0, base) with the traversal TR built from the
// staged rows; the lead lane writes the nine planes and the end state, the
// epilogue operation for operation kernel_base's. Two schedules:
//  - REFILL = false: group g = global thread / K takes pixel g.
//  - REFILL = true: a grid of the resident blocks (launch_base_grouped);
//    each group takes its next pixel from the zeroed counter `next` until
//    the pixels run out: the lead lane alone adds to it and broadcasts the
//    pixel over the group, so the group's lanes always hold one pixel, and
//    the groups of a warp stay busy until the frame's pixels are gone. The
//    rows are staged once a resident block; nothing in the pixel loop waits
//    for the block (its groups finish at different times).
// A pixel's chain does not depend on which group renders it, so both
// schedules give the thread-per-pixel kernel's outputs bit for bit. The
// slot count (count_slot_iters) and the traversal's counters (flush) are
// taken once a group after its last pixel: static, 32 / K x the warp's
// longest pixel; refill, 32 / K x the warp's busiest group's summed
// iterations, at least the sum over its pixels.
// kernel_base_grouped and kernel_base_grouped_resident share this body.
template <bool EXT, bool XT, class TR, bool REFILL>
__device__ __forceinline__ void base_grouped(const BaseArgs& a,
                                             const float* __restrict__ scene_buf,
                                             float* __restrict__ out,
                                             long long* __restrict__ state_out,
                                             unsigned long long* __restrict__ iters,
                                             unsigned* __restrict__ next, const trt::Tex& tx,
                                             const trt::Xt& xt, const typename TR::Launch& tl) {
  constexpr int K = TR::K;
  extern __shared__ float4 group_smem[];
  float* rows = reinterpret_cast<float*>(group_smem);
  const int n = a.h_out * a.f.width;
  const unsigned lane = threadIdx.x & 31u;
  const bool lead = (lane & (unsigned)(K - 1)) == 0u;
  const unsigned mask =
      K == 32 ? 0xffffffffu : (((1u << K) - 1u) << (lane & ~(unsigned)(K - 1)));
  TR::stage(rows, scene_buf, a.f, tl);
  TR tr(rows, a.f, tl);
  const trt::Scene sc = trt::make_scene(scene_buf, a.f);
  // The group's next pixel on the refill schedule.
  const auto take = [&]() {
    unsigned p = 0u;
    if (lead) p = atomicAdd(next, 1u);
    return (int)__shfl_sync(mask, p, 0, K);
  };
  unsigned my_iters = 0;
  int i = REFILL ? take()
                 : (int)(((long long)blockIdx.x * TR::THREADS + threadIdx.x) / K);
  while (i < n) {
    my_iters += base_pixel<EXT, XT>(a, sc, tx, xt, tr, i, n, lead, out, state_out);
    if (!REFILL) break;
    i = take();
  }
  trt::count_slot_iters<K>(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR, bool REFILL>
__global__ void __launch_bounds__(TR::THREADS)
    kernel_base_grouped(BaseArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                        long long* __restrict__ state_out, unsigned long long* __restrict__ iters,
                        unsigned* __restrict__ next, trt::Tex tx, trt::Xt xt,
                        typename TR::Launch tl) {
  base_grouped<EXT, XT, TR, REFILL>(a, scene_buf, out, state_out, iters, next, tx, xt, tl);
}

// kernel_base_grouped held to MIN_BLOCKS resident blocks an SM (ptxas fits
// its registers to 65,536 / (TR::THREADS x MIN_BLOCKS)).
template <bool EXT, bool XT, class TR, bool REFILL, int MIN_BLOCKS>
__global__ void __launch_bounds__(TR::THREADS, MIN_BLOCKS)
    kernel_base_grouped_resident(BaseArgs a, const float* __restrict__ scene_buf,
                                 float* __restrict__ out, long long* __restrict__ state_out,
                                 unsigned long long* __restrict__ iters,
                                 unsigned* __restrict__ next, trt::Tex tx, trt::Xt xt,
                                 typename TR::Launch tl) {
  base_grouped<EXT, XT, TR, REFILL>(a, scene_buf, out, state_out, iters, next, tx, xt, tl);
}

// The stage (bytes) whose attributes a kernel holds on a device, for a
// few (kernel, device) pairs: a launch of a GroupSpill kernel with the
// stage it holds makes no CUDA call but cudaGetDevice. nullptr when the
// table is full (the attributes are then set on every launch).
struct StageHeld {
  const void* kernel;
  int dev, bytes;
};

inline StageHeld* stage_held(const void* kernel, int dev) {
  constexpr int N = 64;
  static StageHeld held[N];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (held[i].kernel == kernel && held[i].dev == dev) return &held[i];
  if (n == N) return nullptr;
  held[n] = {kernel, dev, -1};
  return &held[n++];
}

// Launch a grouped kernel of traversal TR over n entries: K lanes an
// entry, TR::THREADS a block, `bytes` of dynamic shared memory (the staged
// rows); over TR::SMEM_CAP it is refused. TR::PREFER_L1 (GroupSpill,
// GroupCulledSpill, GroupWalk) asks
// for the smallest shared-memory carveout that holds the resident blocks'
// stages, leaving the rest of the SM's pool to L1, once for each stage
// size (stage_held).
template <class TR>
int grouped_grid(long long n, int bytes, const void* kernel, int& blocks) {
  if (bytes > TR::SMEM_CAP) return (int)cudaErrorInvalidValue;
  blocks = (int)((n * TR::K + TR::THREADS - 1) / TR::THREADS);
  if (!TR::PREFER_L1)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     TR::SMEM_CAP);
  int err, dev, pool, reserved, per_sm;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  StageHeld* held = stage_held(kernel, dev);
  if (held != nullptr && held->bytes == bytes) return 0;
  if ((err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TR::SMEM_CAP)) != 0 ||
      (err = (int)cudaDeviceGetAttribute(&pool, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                         dev)) != 0 ||
      (err = (int)cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                         dev)) != 0 ||
      (err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       100)) != 0 ||
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TR::THREADS,
                                                                bytes)) != 0)
    return err;
  const long long pct = (100LL * per_sm * (bytes + reserved) + pool - 1) / pool;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  pct < 100 ? (int)pct : 100);
  if (err == 0 && held != nullptr) held->bytes = bytes;
  return err;
}

template <bool EXT, bool XT, class TR>
int launch_extra_grouped(const ExtraArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                         const float* scene_buf, const int* xs, const int* ys,
                         const long long* state_in, const float* add, const int* samp0,
                         float* out, unsigned long long* iters, void* stream,
                         const typename TR::Launch& tl = {}) {
  const int n = a->n_entries;
  if (n > 0) {
    const int bytes = 4 * TR::smem_floats(a->f, tl);
    int blocks;
    const int err =
        grouped_grid<TR>(n, bytes, (const void*)kernel_extra_grouped<EXT, XT, TR>, blocks);
    if (err != 0) return err;
    kernel_extra_grouped<EXT, XT, TR><<<blocks, TR::THREADS, bytes, (cudaStream_t)stream>>>(
        *a, scene_buf, xs, ys, state_in, add, samp0, out, iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

// Kernel A grouped over the h_out * w pixels of `a` (kernel_base_grouped,
// or with MIN_BLOCKS > 0 kernel_base_grouped_resident). Static: K lanes a
// pixel, every pixel its group. Refill: as many blocks as stay resident at
// once (the occupancy at `bytes` of staged rows, times the SMs), at most
// one group a pixel; `next` is a zeroed counter.
template <bool EXT, bool XT, class TR, bool REFILL, int MIN_BLOCKS = 0>
int launch_base_grouped(const BaseArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                        const float* scene_buf, float* out, long long* state_out,
                        unsigned long long* iters, unsigned* next, void* stream,
                        const typename TR::Launch& tl = {}) {
  const int n = a->h_out * a->f.width;
  if (n > 0) {
    const int bytes = 4 * TR::smem_floats(a->f, tl);
    const void* kernel;
    if constexpr (MIN_BLOCKS > 0)
      kernel = (const void*)kernel_base_grouped_resident<EXT, XT, TR, REFILL, MIN_BLOCKS>;
    else
      kernel = (const void*)kernel_base_grouped<EXT, XT, TR, REFILL>;
    int blocks;
    int err = grouped_grid<TR>(n, bytes, kernel, blocks);
    if (err != 0) return err;
    if (REFILL) {
      int dev, n_sm, per_sm;
      if ((err = (int)cudaGetDevice(&dev)) != 0 ||
          (err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != 0 ||
          (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, TR::THREADS, bytes)) != 0)
        return err;
      blocks = min(blocks, max(per_sm, 1) * n_sm);
    }
    if constexpr (MIN_BLOCKS > 0)
      kernel_base_grouped_resident<EXT, XT, TR, REFILL, MIN_BLOCKS>
          <<<blocks, TR::THREADS, bytes, (cudaStream_t)stream>>>(
              *a, scene_buf, out, state_out, iters, next, tx, xt, tl);
    else
      kernel_base_grouped<EXT, XT, TR, REFILL>
          <<<blocks, TR::THREADS, bytes, (cudaStream_t)stream>>>(
              *a, scene_buf, out, state_out, iters, next, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

template <bool EXT, bool XT, class TR>
int launch_chunked_grouped(const ChunkArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                           const float* scene_buf, float* out, long long* state_out,
                           unsigned long long* iters, void* stream,
                           const typename TR::Launch& tl = {}) {
  const long long n = (long long)a->n_chunks * a->h_out * a->f.width;
  if (n > 0) {
    const int bytes = 4 * TR::smem_floats(a->f, tl);
    int blocks;
    const int err = grouped_grid<TR>(
        n, bytes, (const void*)kernel_base_chunked_grouped<EXT, XT, TR>, blocks);
    if (err != 0) return err;
    kernel_base_chunked_grouped<EXT, XT, TR>
        <<<blocks, TR::THREADS, bytes, (cudaStream_t)stream>>>(*a, scene_buf, out, state_out,
                                                               iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

}  // namespace
