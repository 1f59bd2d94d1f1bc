// The opt-in traversals of the device path (trace.cuh's TR parameter):
// Culled, the block-culled sweep of `--accel grid`, and Walk, the grid walk
// of `--accel gathered`. Each follows its plain version
// (ops/accel.py CulledPrims, ops/gathered.py GatheredPrims) operation by
// operation, so a kernel and its plain version round alike (--fmad=false).
//
// Culled replaces the JAX package's CulledPrims.closest_hit / occluded
// (terminal_raytracer_tpu/ops/accel.py:312-432, with the VMEM scratch and
// pl.when binding of pallas_kernel.py:71-88,129-141). The scene buffer
// holds the blocked scene and, at Accel::section, the group table
// (GROUP_W floats a group: kind, first index within the kind, count,
// guarded, box lo xyz, box hi xyz). The sweep visits the groups in order
// with the running closest hit; a guarded block whose box the segment
// [RAY_EPS, closest) misses (for a shadow ray [t_min, t_max)) is skipped.
// The TPU decides each skip for a (16, 128) tile with one any() over its
// lanes; here every thread decides for itself, as the plain version does.
// The boxes are padded, so skipping leaves the dense sweep's result but
// for far rays, where f32 rounding moves a test's hit outside the padded
// box (ops/accel.py CulledPrims).
//
// Walk replaces GatheredPrims.closest_hit / occluded with walk_start and
// walk_step (terminal_raytracer_tpu/ops/gathered.py:299-594) and the
// scratch-resident walk loop of pallas_kernel.py:91-126 (its table
// operands :144-180). The TPU fetches each CSR entry and primitive
// channel with a lane-axis gather that sweeps the table's rows; here each
// is one load (__ldg), and the walk state (ix, iy, iz, tm xyz, cur, end,
// t_best, best) lives in registers. The planes sweep first (their closest
// hit caps the walk); one step tests the next primitive of the cell or
// advances the DDA one cell; a thread stops at max_trips steps, as the
// JAX loop stops a lane, and counts it (no walk should reach it). The
// grid's constants arrive in Accel, its CSR offsets and indices (int32)
// in the scene buffer.
//
// What bounds them on an H100 is what bounds the table sweep (FP32 and
// divergent control flow), with fewer tests per ray and, for the walk,
// dependent loads of the CSR and the primitive rows (L1/L2-resident).
// Both count per thread (sweeps, blocks or tests, advances, capped walks)
// and flush the counts into Accel::stats when it is set.

#pragma once

#include "trace.cuh"

namespace trt {

// The opt-in traversals' launch argument (mirrored by ops/kernels.py
// _Accel). Culled reads `section` (the group table's offset in the scene
// buffer, in floats) and n_groups; Walk the CSR offsets' and indices'
// offsets and the grid's constants: dims, max_trips, and as f32 the box,
// the cell size and its reciprocal. Under the walk n_groups holds the CSR's
// index count (group.cuh GroupWalk sizes its stage by it).
struct Accel {
  int section, n_groups, off, idx;
  int dims[3];
  int max_trips;
  float lo[3], hi[3], cell[3], inv_cell[3];
  unsigned long long* stats;  // 4 counters, or null
};

constexpr int GROUP_W = 10;
constexpr int PLANE = 1;
constexpr float BIG = 3.0e38f;       // the slab tests' sentinel (< f32 inf)
constexpr float PAR_EPS = 1e-12f;    // the walk's parallel-axis bound
constexpr float ENTRY_EPS = 1e-5f;   // the walk enters this far past the box

// Add four per-thread counters to stats[0..3]; every thread of the warp
// calls this.
__device__ __forceinline__ void flush_counts(unsigned long long* stats, unsigned c0, unsigned c1,
                                             unsigned c2, unsigned c3) {
  if (stats == nullptr) return;
  const unsigned c[4] = {c0, c1, c2, c3};
  for (int k = 0; k < 4; ++k) {
    unsigned s = __reduce_add_sync(0xffffffffu, c[k]);
    if ((threadIdx.x & 31u) == 0u) atomicAdd(stats + k, (unsigned long long)s);
  }
}

// Where the ray's line enters (tn) and leaves (tf) the box lo, hi; inv is
// 1 / d where d != 0 (a zero component is parallel: inside the slab always,
// outside never). The segment [t_min, t_max) meets the box iff tn <= tf &&
// tn < t_max && tf > t_min.
__device__ __forceinline__ void slab_interval(V3 o, V3 d, V3 inv, const float lo[3],
                                              const float hi[3], float& tn, float& tf) {
  tn = -BIG;
  tf = BIG;
  const float oc[3] = {o.x, o.y, o.z}, dc[3] = {d.x, d.y, d.z}, ic[3] = {inv.x, inv.y, inv.z};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float a_min, a_max;
    if (dc[ax] == 0.0f) {
      bool inside = oc[ax] >= lo[ax] && oc[ax] <= hi[ax];
      a_min = inside ? -BIG : BIG;
      a_max = inside ? BIG : -BIG;
    } else {
      float t0 = (lo[ax] - oc[ax]) * ic[ax];
      float t1 = (hi[ax] - oc[ax]) * ic[ax];
      a_min = fminf(t0, t1);
      a_max = fmaxf(t0, t1);
    }
    tn = fmaxf(tn, a_min);
    tf = fminf(tf, a_max);
  }
}

// Whether the segment [t_min, t_max) meets the box lo = b[0..2], hi =
// b[3..5] of the global buffer.
__device__ __forceinline__ bool slab_hit(V3 o, V3 d, V3 inv, const float* b, float t_min,
                                         float t_max) {
  const float lo[3] = {__ldg(b), __ldg(b + 1), __ldg(b + 2)};
  const float hi[3] = {__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)};
  float tn, tf;
  slab_interval(o, d, inv, lo, hi, tn, tf);
  return tn <= tf && tn < t_max && tf > t_min;
}

struct Culled {
  using Launch = Accel;
  const Accel& p;
  const float* groups;
  unsigned sweeps = 0, swept = 0, skipped = 0, tests = 0;

  __device__ __forceinline__ Culled(const Accel& a, const float* buf)
      : p(a), groups(buf + a.section) {}

  static __device__ __forceinline__ V3 inverse(V3 d) {
    return {1.0f / (d.x == 0.0f ? 1.0f : d.x), 1.0f / (d.y == 0.0f ? 1.0f : d.y),
            1.0f / (d.z == 0.0f ? 1.0f : d.z)};
  }

  // Group g's kind, first index in the scene's flatten order and count,
  // or false when its box is tested and the segment misses it.
  __device__ __forceinline__ bool enter(const Scene& sc, int g, V3 o, V3 d, V3 inv, float t_min,
                                        float t_max, int& kind, int& k0, int& cnt) {
    const float* G = groups + GROUP_W * g;
    kind = (int)__ldg(G);
    k0 = (int)__ldg(G + 1) + (kind == SPHERE ? 0 : kind == PLANE ? sc.n_sph : sc.n_sph + sc.n_pln);
    cnt = (int)__ldg(G + 2);
    if (__ldg(G + 3) != 0.0f) {
      if (!slab_hit(o, d, inv, G + 4, t_min, t_max)) {
        ++skipped;
        return false;
      }
      ++swept;
    }
    tests += cnt;
    return true;
  }

  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    ++sweeps;
    const V3 inv = inverse(d);
    float closest = T_FAR, t;
    int idx = -1, kind, k0, cnt;
    for (int g = 0; g < p.n_groups; ++g) {
      if (!enter(sc, g, o, d, inv, RAY_EPS, closest, kind, k0, cnt)) continue;
      for (int k = k0; k < k0 + cnt; ++k) {
        bool hit;
        if (kind == SPHERE)
          hit = sphere_t(o, d, sc.sph + SPH_W * k, RAY_EPS, closest, t);
        else if (kind == PLANE)
          hit = plane_t(o, d, sc.pln + PLN_W * (k - sc.n_sph), RAY_EPS, closest, false, t);
        else
          hit = triangle_t(o, d, sc.tri + TRI_W * (k - sc.n_sph - sc.n_pln), RAY_EPS, closest, t);
        t = hit ? t : -1.0f;
        if (t > 0.0f && t < closest) { closest = t; idx = k; }
      }
    }
    return hit_at<EXT, XT>(sc, o, d, closest, idx);
  }

  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min, float t_max) {
    ++sweeps;
    const V3 inv = inverse(d);
    float t;
    int kind, k0, cnt;
    for (int g = 0; g < p.n_groups; ++g) {
      if (!enter(sc, g, o, d, inv, t_min, t_max, kind, k0, cnt)) continue;
      for (int k = k0; k < k0 + cnt; ++k) {
        bool hit;
        if (kind == SPHERE)
          hit = sphere_t(o, d, sc.sph + SPH_W * k, t_min, t_max, t);
        else if (kind == PLANE)
          hit = plane_t(o, d, sc.pln + PLN_W * (k - sc.n_sph), t_min, t_max, true, t);
        else
          hit = triangle_t(o, d, sc.tri + TRI_W * (k - sc.n_sph - sc.n_pln), t_min, t_max, t);
        if (hit) {
          tests -= k0 + cnt - 1 - k;  // the tests not made after the blocker
          return true;
        }
      }
    }
    return false;
  }

  __device__ __forceinline__ void flush() { flush_counts(p.stats, sweeps, swept, skipped, tests); }
};

struct Walk {
  using Launch = Accel;
  const Accel& p;
  const int* off;
  const int* idx;
  unsigned walks = 0, tests = 0, advances = 0, capped = 0;

  __device__ __forceinline__ Walk(const Accel& a, const float* buf)
      : p(a), off(reinterpret_cast<const int*>(buf + a.off)),
        idx(reinterpret_cast<const int*>(buf + a.idx)) {}

  // The walk of ray (o, d) over the grid, tests in (t_min, t_best): best
  // and t_best take each strictly closer hit (ANY: best takes the first
  // hit and the walk stops). t_best starts as the walk's cap.
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
    int ci = ic[0] + ic[1] * p.dims[0] + ic[2] * (p.dims[0] * p.dims[1]);
    int cur = __ldg(off + ci), end = __ldg(off + ci + 1);
    for (int trips = 0;; ++trips) {
      if (trips == p.max_trips) {
        ++capped;
        return;
      }
      if (cur < end) {  // test the cell's next primitive
        ++tests;
        const int pid = __ldg(idx + cur);
        ++cur;
        float t;
        bool hit = pid < sc.n_sph
                       ? sphere_t(o, d, sc.sph + SPH_W * pid, t_min, t_best, t)
                       : triangle_t(o, d, sc.tri + TRI_W * (pid - sc.n_sph), t_min, t_best, t);
        t = hit ? t : -1.0f;
        if (t > 0.0f && t < t_best) {
          best = pid;
          if (ANY) return;
          t_best = t;
        }
      } else {  // advance one cell along the axis of the nearest boundary
        ++advances;
        const int ax = tm[0] <= tm[1] && tm[0] <= tm[2] ? 0 : tm[1] <= tm[2] ? 1 : 2;
        if (tm[ax] > t_best) return;
        const int c2 = ic[ax] + (dc[ax] >= 0.0f ? 1 : -1);
        if (c2 < 0 || c2 >= p.dims[ax]) return;
        ic[ax] = c2;
        tm[ax] = tm[ax] + fabsf(p.cell[ax] / (fabsf(dc[ax]) < PAR_EPS ? 1.0f : dc[ax]));
        ci = ic[0] + ic[1] * p.dims[0] + ic[2] * (p.dims[0] * p.dims[1]);
        cur = __ldg(off + ci);
        end = __ldg(off + ci + 1);
      }
    }
  }

  // The planes' closest hit caps the walk; the walk's winner (ids count
  // spheres, then triangles), else the plane's.
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

  __device__ __forceinline__ void flush() { flush_counts(p.stats, walks, tests, advances, capped); }
};

}  // namespace trt
