// Shared device math of the kernels (csrc/*.cu): the reference
// transport of terminal_raytracer_tpu/ops/tracer.py for ONE path per
// thread, with the RNG state, ray and throughput in registers.
//
// Every expression follows the plain PyTorch version
// (terminal_raytracer_tpu_torch/ops/*.py) operation by operation, and the
// files are built with --fmad=false, so a kernel and its plain version on
// the card round alike. A draw the vectorised code gates off is simply not
// made here: the branch is real control flow.
//
// The scene arrives as the packed f32 buffer of ops/geometry.py
// scene_tables (row widths SPH_W .. LIGHT_W below must match it), or its
// per-frame counterpart ops/dynamic.py tables_from_packed in animated mode.
// Every sweep loops over that runtime table, so one build serves any
// primitive count: the JAX package's baked and array traversals are the
// same code here. At the largest configuration run (icosphere:3, 1280
// triangles + a sphere + a plane) the buffer holds 1280 x (12 + 7) + 1 x
// (5 + 7) + 1 x (9 + 7) + 17 + 1 floats, about 97 KB. Offsets into it are
// int (fine far beyond that). In the kernels that run one path a thread,
// every thread of a warp reads the same primitive at the same time through
// __ldg, so the table is served from L1 and L2 as a broadcast. The grouped
// kernels (group.cuh: kernel B and the chunked kernel A at the reference
// gates) split each sweep across the lanes of a path group, whose lanes
// read different primitives at once: they stage the geometry rows in
// shared memory, once a block, where those reads hit different banks, and
// keep __ldg for the materials, lights and the winner's normal.
//
// The device path is templated on EXT. EXT = false is the reference
// transport. EXT = true adds the material and texture extensions of
// ops/tracer.py (dielectrics, rough metals, checker, image textures,
// normal maps, sky map): it reads the winner's row of the extension table
// (packed after the light rows, EXT_W floats per primitive) and texels
// from the scene's atlas of packed 8-bit RGB (Tex.atlas, int32, through
// __ldg). That atlas replaces the JAX package's texel-atlas kernel operand
// (pallas_kernel.py _tex_ops / _tex_bind_front, tracer.py gather_texels):
// Mosaic can gather only along the lane axis, so each TPU fetch sweeps the
// atlas rows [lo, hi) one by one; here a fetch is one load, and an index
// outside [lo, hi) reads 0 as the sweep does. Each extension draw and
// recolor is gated per thread on its channel, so zero channels give the
// reference path's values and draws exactly. Texture filtering is the
// JAX integer index math and lerp, not the hardware's texture units
// (whose bilinear weights are 9-bit fixed point).
//
// XT, the path's second template flag (it implies EXT), adds the transport
// and camera extensions of ops/tracer.py: the unbiased and MIS transports
// (a per-path emit channel, balance weights against the light-inverse-area
// channel that widens each extension row to XT_W), fog (distance draw,
// phase-sampled scatter, transmittance), thin-lens depth of field, the
// stratified sampler and one-light NEE (the picked light's row is indexed;
// the pick table follows the extension table). The JAX package compiles
// each of these in or out by a static gate; here the gates and their f32
// constants are uniform launch arguments (Xt), read by every thread alike,
// so a branch on them never diverges. Each sits behind `if (XT && ...)`,
// so the reference and EXT instantiations compile as if it were absent.
//
// The path functions take the traversal as a third template parameter TR:
// Sweep, the table sweep above, for every kernel but the opt-in traversals
// of traverse.cuh (the culled sweep and the grid walk). Sweep is an empty
// object, so the kernels that take it compile as if it were absent.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace trt {

constexpr int SPH_W = 5;     // cx, cy, cz, r*r, 1/r
constexpr int PLN_W = 9;     // point xyz, raw normal xyz, unit normal xyz
constexpr int TRI_W = 12;    // v0 xyz, edge1 xyz, edge2 xyz, unit normal xyz
constexpr int MAT_W = 7;     // color rgb, emission rgb, reflectivity
constexpr int LIGHT_W = 17;  // kind, emission rgb, area, a, b, c, normal
constexpr int SPHERE = 0;

constexpr float RAY_EPS = 1e-3f;
constexpr float T_FAR = 1e10f;
constexpr float PLANE_PARALLEL_EPS = 1e-4f;
constexpr float TRI_PARALLEL_EPS = 1e-5f;
constexpr float TWO_PI = (float)(2.0 * 3.14159265359);
constexpr float INV_PI = (float)(1.0 / 3.14159265359);
constexpr float INV_U32_MAX = (float)(1.0 / 4294967295.0);
constexpr float NEE_CLAMP = 10.0f;
constexpr int RR_START_BOUNCE = 3;
constexpr float RR_MAX_SURVIVAL = 0.95f;
constexpr float SKY_INTENSITY = 0.8f;
constexpr float SKY_TOP_X = 0.5f, SKY_TOP_Y = 0.7f, SKY_TOP_Z = 1.0f;

// Extension table columns (ops/geometry.py EXT_KEYS).
constexpr int EXT_W = 12;
constexpr int X_TRANSP = 0, X_IOR = 1, X_ROUGH = 2, X_CK = 3, X_CKS = 6, X_TXI = 7, X_TXS = 8,
              X_NMI = 9, X_NMX = 10, X_NMS = 11;
constexpr int ATLAS_LANES = 128;  // texels per atlas row
// The plain versions' Python constants, each rounded to f32 once as
// PyTorch and JAX round a Python float against an f32 tensor.
constexpr float PI_F = (float)3.14159265359;
constexpr float HALF_PI = (float)(0.5 * 3.14159265359);
constexpr float HALF_INV_PI = (float)(0.5 / 3.14159265359);
constexpr float INV_PI_UV = (float)(2.0 * (0.5 / 3.14159265359));
constexpr float INV_255 = (float)(1.0 / 255.0);
constexpr float TINY_LEN2 = (float)1e-12;
constexpr float MIN_NZ = (float)1e-3;

// Frame constants shared by both kernels (mirrored by ops/kernels.py).
struct Frame {
  int width, height, max_depth;
  int n_sph, n_pln, n_tri, n_lights;
  float pose[12];  // pos, forward, right, up
  float half_w, half_h, inv_char_aspect, w1, h1;  // w1, h1 = f32(w-1), f32(h-1)
};

// Scene-level texture constants of the EXT kernels (mirrored by
// ops/kernels.py): the flat atlas, texels per side S (a power of two),
// atlas rows per texture, the filter, the atlas rows [lo, hi) of the
// primitives' textures and normal maps, and the sky map's first row (-1:
// the gradient sky) with its intensity.
struct Tex {
  const int32_t* atlas;
  int size, rows, bilinear;
  int tex_lo, tex_hi, nm_lo, nm_hi;
  int sky_lo;
  float sky_intensity;
};

// ---------------------------------------------------------------- vectors

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// a * (1 / sqrt(|a|^2)), both steps IEEE-rounded like the plain version.
__device__ __forceinline__ V3 normalize(V3 a) { return a * (1.0f / sqrtf(dot(a, a))); }

__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return v - n * (2.0f * dot(v, n)); }

__device__ __forceinline__ V3 load3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }

// -------------------------------------------------------------------- RNG

constexpr uint32_t CHUNK_GOLDEN = 0x9E3779B9u;

// The pixel's seed (y*w + x)*1973 + seed*9277 + frame*12345, wrapping.
__device__ __forceinline__ uint32_t seed_pixel(uint32_t pix, uint32_t seed, uint32_t frame) {
  return pix * 1973u + seed * 9277u + frame * 12345u;
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// The JAX package's conversion: int32 wrap, cast, +2^32 where negative.
__device__ __forceinline__ float u32_to_f32(uint32_t v) {
  int32_t i = (int32_t)v;
  float f = (float)i;
  return i < 0 ? f + 4294967296.0f : f;
}

__device__ __forceinline__ float next_f32(uint32_t& state) {
  state = pcg_hash(state);
  return u32_to_f32(state) * INV_U32_MAX;
}

// ------------------------------------------------------------------ scene

struct Scene {
  const float* sph;
  const float* pln;
  const float* tri;
  const float* mat;
  const float* lights;
  const float* ext;  // EXT kernels only
  int n_sph, n_pln, n_tri, n_lights;
};

__device__ __forceinline__ Scene make_scene(const float* buf, const Frame& f) {
  Scene s;
  s.sph = buf;
  s.pln = s.sph + SPH_W * f.n_sph;
  s.tri = s.pln + PLN_W * f.n_pln;
  s.mat = s.tri + TRI_W * f.n_tri;
  s.lights = s.mat + MAT_W * (f.n_sph + f.n_pln + f.n_tri);
  s.ext = s.lights + LIGHT_W * f.n_lights;
  s.n_sph = f.n_sph;
  s.n_pln = f.n_pln;
  s.n_tri = f.n_tri;
  s.n_lights = f.n_lights;
  return s;
}

__device__ __forceinline__ bool sphere_t(V3 o, V3 d, const float* s, float t_min, float t_max,
                                         float& root) {
  V3 oc = load3(s) - o;
  float h = dot(d, oc);
  float c = dot(oc, oc) - __ldg(s + 3);
  float disc = h * h - c;
  float sqrtd = sqrtf(disc > 0.0f ? disc : 0.0f);
  float near = h - sqrtd;
  float far = h + sqrtd;
  bool near_ok = (near > t_min) && (near < t_max);
  bool far_ok = (far > t_min) && (far < t_max);
  root = near_ok ? near : far;
  return (disc >= 0.0f) && (near_ok || far_ok);
}

// Closest-hit tests take t <= t_max; the shadow sweep takes t < t_max.
__device__ __forceinline__ bool plane_t(V3 o, V3 d, const float* q, float t_min, float t_max,
                                        bool strict, float& t) {
  V3 n = load3(q + 3);
  float denom = dot(n, d);
  bool parallel = fabsf(denom) < PLANE_PARALLEL_EPS;
  t = dot(load3(q) - o, n) / (parallel ? 1.0f : denom);
  return !parallel && (t >= t_min) && (strict ? t < t_max : t <= t_max);
}

__device__ __forceinline__ bool triangle_t(V3 o, V3 d, const float* q, float t_min, float t_max,
                                           float& t) {
  V3 e1 = load3(q + 3), e2 = load3(q + 6);
  V3 h = cross(d, e2);
  float a = dot(e1, h);
  bool parallel = (a > -TRI_PARALLEL_EPS) && (a < TRI_PARALLEL_EPS);
  float f = 1.0f / (parallel ? 1.0f : a);
  V3 s = o - load3(q);
  float u = f * dot(s, h);
  V3 qq = cross(s, e1);
  float v = f * dot(d, qq);
  t = f * dot(e2, qq);
  return !parallel && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > t_min) && (t < t_max);
}

struct Hit {
  bool found;
  V3 p, normal, color, emission;
  float refl;
  // EXT: `front` (the normal was not flipped) and the winner's row of the
  // extension table, whose channels are read where a branch needs them.
  bool front;
  const float* ext;
  // XT: the hit distance (T_FAR on a miss) and the light-inverse-area
  // channel, 0 on a back face.
  float t, lia;
};

// XT rows: the extension row plus the light-inverse-area channel.
constexpr int XT_W = EXT_W + 1;
constexpr int X_LIA = EXT_W;

// The hit record of primitive idx (-1: none) at distance `closest` (T_FAR:
// a miss) along the ray: the winner's index picks the material and normal;
// the normal is flipped to face the ray.
template <bool EXT, bool XT = false>
__device__ __forceinline__ Hit hit_at(const Scene& sc, V3 o, V3 d, float closest, int idx) {
  Hit h;
  h.found = closest < T_FAR;
  if (XT) h.t = closest;
  if (!h.found) return h;
  h.p = o + d * closest;
  const float* m = sc.mat + MAT_W * idx;
  h.color = load3(m);
  h.emission = load3(m + 3);
  h.refl = __ldg(m + 6);
  V3 n;
  if (idx < sc.n_sph) {
    const float* s = sc.sph + SPH_W * idx;
    n = normalize((h.p - load3(s)) * __ldg(s + 4));
  } else if (idx < sc.n_sph + sc.n_pln) {
    n = load3(sc.pln + PLN_W * (idx - sc.n_sph) + 6);
  } else {
    n = load3(sc.tri + TRI_W * (idx - sc.n_sph - sc.n_pln) + 9);
  }
  h.normal = dot(d, n) < 0.0f ? n : -n;
  if (EXT) {
    h.front = dot(d, n) < 0.0f;
    h.ext = sc.ext + (XT ? XT_W : EXT_W) * idx;
  }
  if (XT) h.lia = h.front ? __ldg(h.ext + X_LIA) : 0.0f;
  return h;
}

// Sweep spheres, planes, triangles; strictly closer wins, with the running
// closest fed forward as each test's t_max.
template <bool EXT, bool XT = false>
__device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
  float closest = T_FAR;
  int idx = -1, k = 0;
  float t;
  for (int i = 0; i < sc.n_sph; ++i, ++k) {
    bool hit = sphere_t(o, d, sc.sph + SPH_W * i, RAY_EPS, closest, t);
    t = hit ? t : -1.0f;
    if (t > 0.0f && t < closest) { closest = t; idx = k; }
  }
  for (int i = 0; i < sc.n_pln; ++i, ++k) {
    bool hit = plane_t(o, d, sc.pln + PLN_W * i, RAY_EPS, closest, false, t);
    t = hit ? t : -1.0f;
    if (t > 0.0f && t < closest) { closest = t; idx = k; }
  }
  for (int i = 0; i < sc.n_tri; ++i, ++k) {
    bool hit = triangle_t(o, d, sc.tri + TRI_W * i, RAY_EPS, closest, t);
    t = hit ? t : -1.0f;
    if (t > 0.0f && t < closest) { closest = t; idx = k; }
  }
  return hit_at<EXT, XT>(sc, o, d, closest, idx);
}

__device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min, float t_max) {
  float t;
  for (int i = 0; i < sc.n_sph; ++i)
    if (sphere_t(o, d, sc.sph + SPH_W * i, t_min, t_max, t)) return true;
  for (int i = 0; i < sc.n_pln; ++i)
    if (plane_t(o, d, sc.pln + PLN_W * i, t_min, t_max, true, t)) return true;
  for (int i = 0; i < sc.n_tri; ++i)
    if (triangle_t(o, d, sc.tri + TRI_W * i, t_min, t_max, t)) return true;
  return false;
}

// The traversal of the path functions below (their TR parameter): the
// table sweep above. A traversal offers closest_hit<EXT, XT>, occluded and
// flush (adds its per-thread counters to a launch's counter buffer; every
// thread of the warp calls it). traverse.cuh holds the opt-in ones.
struct Sweep {
  struct Launch {};  // its launch argument: none
  __device__ __forceinline__ Sweep(const Launch&, const float*) {}
  template <bool EXT, bool XT>
  __device__ __forceinline__ Hit closest_hit(const Scene& sc, V3 o, V3 d) {
    return trt::closest_hit<EXT, XT>(sc, o, d);
  }
  __device__ __forceinline__ bool occluded(const Scene& sc, V3 o, V3 d, float t_min,
                                           float t_max) {
    return trt::occluded(sc, o, d, t_min, t_max);
  }
  __device__ __forceinline__ void flush() {}
};

// -------------------------------------------------------------- transport

__device__ __forceinline__ V3 min_components(V3 a, float cap) {
  return {fminf(a.x, cap), fminf(a.y, cap), fminf(a.z, cap)};
}

// (u, v) completing the unit w: u from the y axis when |w.x| > 0.1, else
// from the x axis (sampling.orthonormal_basis).
__device__ __forceinline__ void orthonormal_basis(V3 w, V3& u, V3& v) {
  u = fabsf(w.x) > 0.1f ? normalize(V3{w.z, 0.0f, -w.x}) : normalize(V3{0.0f, -w.z, w.y});
  v = cross(w, u);
}

__device__ __forceinline__ V3 cosine_hemisphere(uint32_t& state, V3 normal) {
  float r1 = next_f32(state);
  float r2 = next_f32(state);
  float cos_theta = sqrtf(r1);
  float sin_theta = sqrtf(1.0f - r1);
  float phi = TWO_PI * r2;
  float x = sin_theta * cosf(phi);
  float y = sin_theta * sinf(phi);
  float z = cos_theta;
  V3 w = normalize(normal), u, v;
  orthonormal_basis(w, u, v);
  return normalize(u * x + v * y + w * z);
}

__device__ __forceinline__ V3 sky_color(V3 d) {
  float t = 0.5f * (d.y + 1.0f);
  float one = 1.0f - t;
  return {(one + t * SKY_TOP_X) * SKY_INTENSITY, (one + t * SKY_TOP_Y) * SKY_INTENSITY,
          (one + t * SKY_TOP_Z) * SKY_INTENSITY};
}

// ------------------------------------------------------- extensions (EXT)

// The JAX package's polynomial atan2 (sampling.atan2), term for term.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(ax, ay);
  float a = fminf(ax, ay) / (hi > 0.0f ? hi : 1.0f);
  float s = a * a;
  float r = a * ((float)0.99997726 +
                 s * ((float)-0.33262347 +
                      s * ((float)0.19354346 +
                           s * ((float)-0.11643287 +
                                s * ((float)0.05265332 - s * (float)0.01172120)))));
  r = ay > ax ? HALF_PI - r : r;
  r = x < 0.0f ? PI_F - r : r;
  return y < 0.0f ? -r : r;
}

// Longitude/latitude uv of a unit vector.
__device__ __forceinline__ void spherical_uv(V3 n, float& u, float& v) {
  u = 0.5f + atan2_poly(n.z, n.x) * HALF_INV_PI;
  float ny = fminf(fmaxf(n.y, -1.0f), 1.0f);
  v = 0.5f + atan2_poly(ny, sqrtf(fmaxf(1.0f - ny * ny, 0.0f))) * INV_PI_UV;
}

// models/texture.py packing r<<16 | g<<8 | b. Texels are below 2^24, so
// the arithmetic >> of int32 equals the JAX package's logical shift.
__device__ __forceinline__ V3 unpack_texel(int32_t p) {
  return {(float)(p >> 16) * INV_255, (float)((p >> 8) & 255) * INV_255,
          (float)(p & 255) * INV_255};
}

// The texel at flat atlas index idx, or 0 outside atlas rows [lo, hi).
__device__ __forceinline__ V3 fetch_texel(const Tex& tx, int idx, int lo, int hi) {
  bool ok = idx >= lo * ATLAS_LANES && idx < hi * ATLAS_LANES;
  return unpack_texel(ok ? __ldg(tx.atlas + idx) : 0);
}

// The 2x2 blend around wrapped uv of the texture whose texel 0 is at flat
// index `base`: texel centers at (i + 0.5) / S, neighbours wrapped with
// & (S - 1) in two's complement, lerped along u, then v.
__device__ __forceinline__ V3 fetch_bilinear(const Tex& tx, int base, float u, float v, int lo,
                                             int hi) {
  float s = (float)tx.size;
  int m = tx.size - 1;
  float x = u * s - 0.5f;
  float y = v * s - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int iu0 = (int)x0 & m, iv0 = (int)y0 & m;
  int iu1 = (iu0 + 1) & m, iv1 = (iv0 + 1) & m;
  int r0 = base + iv0 * tx.size, r1 = base + iv1 * tx.size;
  V3 t00 = fetch_texel(tx, max(r0 + iu0, 0), lo, hi);
  V3 t01 = fetch_texel(tx, max(r0 + iu1, 0), lo, hi);
  V3 t10 = fetch_texel(tx, max(r1 + iu0, 0), lo, hi);
  V3 t11 = fetch_texel(tx, max(r1 + iu1, 0), lo, hi);
  V3 top = t00 + (t01 - t00) * fx;
  V3 bot = t10 + (t11 - t10) * fx;
  return top + (bot - top) * fy;
}

// The nearest texel of uv in [0, 1] (clamped at 1) on the S x S grid.
__device__ __forceinline__ int nearest_index(const Tex& tx, float u, float v) {
  float s = (float)tx.size;
  int smax = tx.size - 1;
  int iu = min((int)floorf(u * s), smax);
  int iv = min((int)floorf(v * s), smax);
  return iv * tx.size + iu;
}

__device__ V3 sky_radiance(const Tex& tx, V3 d) {
  float u, v;
  spherical_uv(d, u, v);
  int lo = tx.sky_lo, hi = tx.sky_lo + tx.rows;
  V3 t = tx.bilinear ? fetch_bilinear(tx, lo * ATLAS_LANES, u, v, lo, hi)
                     : fetch_texel(tx, lo * ATLAS_LANES + nearest_index(tx, u, v), lo, hi);
  return t * tx.sky_intensity;
}

// (x-dominant, y-dominant) of |n|, ties to the earlier axis.
__device__ __forceinline__ void dominant_axes(V3 n, bool& xdom, bool& ydom) {
  float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  xdom = ax >= ay && ax >= az;
  ydom = !xdom && ay >= az;
}

// Texel of texture |id| at hit point p with front normal n: +id planar
// along n's dominant axis (x -> (z, y), y -> (x, z), z -> (x, y)), -id the
// longitude/latitude of n; `scale` tiles the uv.
__device__ V3 mapped_texel(const Tex& tx, V3 p, V3 n, float id, float scale, int lo, int hi) {
  float u, v;
  if (id < 0.0f) {
    spherical_uv(n, u, v);
  } else {
    bool xdom, ydom;
    dominant_axes(n, xdom, ydom);
    u = xdom ? p.z : p.x;
    v = xdom ? p.y : (ydom ? p.z : p.y);
  }
  u = u * scale;
  v = v * scale;
  u = u - floorf(u);
  v = v - floorf(v);
  int base = ((int)fabsf(id) - 1) * (tx.rows * ATLAS_LANES);
  if (tx.bilinear) return fetch_bilinear(tx, base, u, v, lo, hi);
  return fetch_texel(tx, max(base + nearest_index(tx, u, v), 0), lo, hi);
}

// The normal-mapped shading normal (ops/tracer.py apply_normal_map): the
// tangent frame of the uv mapping, the texel's xy deflection times the
// strength, z kept above 1e-3, renormalized.
__device__ V3 normal_mapped(const Tex& tx, const Hit& h) {
  float nmi = __ldg(h.ext + X_NMI), nms = __ldg(h.ext + X_NMS);
  V3 texel = mapped_texel(tx, h.p, h.normal, nmi, __ldg(h.ext + X_NMX), tx.nm_lo, tx.nm_hi);
  V3 tn = {texel.x * 2.0f - 1.0f, texel.y * 2.0f - 1.0f, texel.z * 2.0f - 1.0f};
  V3 n = h.normal, t, b;
  if (nmi < 0.0f) {
    float len2 = n.x * n.x + n.z * n.z;
    float inv = 1.0f / sqrtf(fmaxf(len2, TINY_LEN2));
    bool pole = len2 < TINY_LEN2;
    t = {pole ? 1.0f : -n.z * inv, 0.0f, pole ? 0.0f : n.x * inv};
    b = cross(n, t);
  } else {
    bool xdom, ydom;
    dominant_axes(n, xdom, ydom);
    t = xdom ? V3{0.0f, 0.0f, 1.0f} : V3{1.0f, 0.0f, 0.0f};
    b = (xdom || !ydom) ? V3{0.0f, 1.0f, 0.0f} : V3{0.0f, 0.0f, 1.0f};
  }
  V3 raw = t * (tn.x * nms) + b * (tn.y * nms) + n * fmaxf(tn.z, MIN_NZ);
  return normalize(raw);
}

// Checker, then image texture, then normal map (ops/tracer.py shade_hit).
__device__ __forceinline__ void shade_hit(const Tex& tx, Hit& h) {
  float k = __ldg(h.ext + X_CKS);
  if (k > 0.0f) {
    float cells = floorf(h.p.x * k + 0.5f) + floorf(h.p.y * k + 0.5f) + floorf(h.p.z * k + 0.5f);
    if (cells - 2.0f * floorf(cells * 0.5f) > 0.5f) h.color = load3(h.ext + X_CK);
  }
  float txi = __ldg(h.ext + X_TXI);
  if (txi != 0.0f)
    h.color = mapped_texel(tx, h.p, h.normal, txi, __ldg(h.ext + X_TXS), tx.tex_lo, tx.tex_hi);
  if (__ldg(h.ext + X_NMI) != 0.0f) h.normal = normal_mapped(tx, h);
}

__device__ __forceinline__ V3 uniform_sphere_dir(uint32_t& state) {
  float r1 = next_f32(state);
  float r2 = next_f32(state);
  float cos_theta = 1.0f - 2.0f * r1;
  float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  float phi = TWO_PI * r2;
  return {sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta};
}

__device__ __forceinline__ float fresnel_schlick(float cos_i, float eta) {
  float r = (1.0f - eta) / (1.0f + eta);
  float r0 = r * r;
  float m = 1.0f - cos_i;
  float m2 = m * m;
  return r0 + (1.0f - r0) * (m2 * m2 * m);
}

// The glass branch: Fresnel-weighted perfect mirror or refraction (one
// draw), with eta = 1/ior entering and ior leaving.
__device__ __forceinline__ V3 glass_scatter(uint32_t& state, const Hit& h, V3 d) {
  float ior = __ldg(h.ext + X_TRANSP) > 0.0f ? __ldg(h.ext + X_IOR) : 1.0f;
  float eta = h.front ? 1.0f / ior : ior;
  float cos_i = fminf(-dot(d, h.normal), 1.0f);
  float sin2_t = eta * eta * fmaxf(1.0f - cos_i * cos_i, 0.0f);
  bool tir = sin2_t > 1.0f;
  float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
  float fres = fresnel_schlick(eta > 1.0f ? cos_t : cos_i, eta);
  float r_fr = next_f32(state);
  if (tir || fres > r_fr) return reflect(d, h.normal);
  return d * eta + h.normal * (eta * cos_i - cos_t);
}

// ------------------------------------------- transport and camera (XT)

enum { T_REFERENCE = 0, T_UNBIASED = 1, T_MIS = 2 };
enum { L_ALL = 0, L_UNIFORM = 1, L_POWER = 2 };
constexpr float FOUR_PI_F = (float)(4.0 * 3.14159265359);
constexpr float LUM_R = (float)0.2126, LUM_G = (float)0.7152, LUM_B = (float)0.0722;
constexpr float PDF_FLOOR = (float)1e-8;   // the cos_l / cos_s floors of the MIS weights
constexpr float FUZZ_DISC = (float)1e-9;   // fuzz_pdf's edge floor
constexpr float DENOM_FLOOR = (float)1e-20;
constexpr float PSEL_FLOOR = (float)1e-12;

// The gates and the f32 roundings of their Python-float constants
// (mirrored by ops/kernels.py xt_args): transport, fog (-sigma, -1/sigma,
// albedo, the isotropic phase albedo / 4 pi, and Henyey-Greenstein's
// 1 - g^2, 1 + g^2, 1 - g, 2 g when hg), the lens, the stratified grid
// side g = 1 << strat_shift over the base samples, the light mode with
// f32(1 / n_lights), and the emit channel of a fresh camera ray.
struct Xt {
  int transport, fog, hg, dof, light_mode, strat_g, strat_shift, base;
  float emit_fresh, neg_sigma, neg_inv_sigma;
  float albedo[3], iso_phase[3];
  float hg_1mg2, hg_1pg2, hg_1mg, hg_2g;
  float aperture, focus, inv_n_lights;
};

// Henyey-Greenstein direction about the incoming d (two draws), g != 0.
__device__ __forceinline__ V3 henyey_greenstein_dir(const Xt& xt, uint32_t& state, V3 d) {
  float r1 = next_f32(state);
  float r2 = next_f32(state);
  float sq = xt.hg_1mg2 / (xt.hg_1mg + xt.hg_2g * r1);
  float cos_t = fminf(fmaxf((xt.hg_1pg2 - sq * sq) / xt.hg_2g, -1.0f), 1.0f);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = TWO_PI * r2;
  V3 w = normalize(d), u, v;
  orthonormal_basis(w, u, v);
  return u * (sin_t * cosf(phi)) + v * (sin_t * sinf(phi)) + w * cos_t;
}

// The Henyey-Greenstein phase value at cos_t (1 / 4 pi at g = 0).
__device__ __forceinline__ float hg_phase(const Xt& xt, float cos_t) {
  float denom = xt.hg_1pg2 - xt.hg_2g * cos_t;
  return xt.hg_1mg2 / (FOUR_PI_F * denom * sqrtf(fmaxf(denom, TINY_LEN2)));
}

// The fuzz lobe's solid-angle pdf about the mirror axis (sampling.fuzz_pdf).
__device__ __forceinline__ float fuzz_pdf(float cos_r, float rough) {
  float c = 1.0f - rough * rough;
  float disc = cos_r * cos_r - c;
  bool inside = cos_r > 0.0f && disc > FUZZ_DISC && rough > 0.0f;
  float denom = TWO_PI * rough * sqrtf(fmaxf(disc, FUZZ_DISC));
  return inside ? (2.0f * cos_r * cos_r - c) / fmaxf(denom, DENOM_FLOOR) : 0.0f;
}

// One-light NEE's pick table (probabilities, thresholds, 1 / total power),
// after the xt rows.
__device__ __forceinline__ const float* pick_table(const Scene& sc) {
  return sc.ext + XT_W * (sc.n_sph + sc.n_pln + sc.n_tri);
}

// The hit's emission weight (ops/tracer.py _emission): 1 under
// 'reference'; under 'unbiased' 1 where NEE could not have sampled the
// emitter (a delta history or lia == 0), else 0; under 'mis' the balance
// weight of the previous scatter's pdf against NEE's density here.
__device__ __forceinline__ bool emission_weight(const Scene& sc, const Xt& xt, const Hit& hit,
                                                V3 d, float emit, float& w) {
  w = 1.0f;
  if (xt.transport == T_UNBIASED) return emit != 0.0f || hit.lia == 0.0f;
  if (xt.transport != T_MIS) return true;
  float cos_l = fmaxf(dot(hit.normal, -d), 0.0f);
  float t2 = hit.t * hit.t;
  float p_nee = t2 * hit.lia / fmaxf(cos_l, PDF_FLOOR);
  if (xt.light_mode == L_UNIFORM) {
    p_nee = p_nee * xt.inv_n_lights;
  } else if (xt.light_mode == L_POWER) {
    V3 e = hit.emission;
    float lum = LUM_R * e.x + LUM_G * e.y + LUM_B * e.z;
    p_nee = hit.lia > 0.0f
                ? t2 * lum * __ldg(pick_table(sc) + 2 * sc.n_lights) / fmaxf(cos_l, PDF_FLOOR)
                : 0.0f;
  }
  float p_prev = fmaxf(emit, 0.0f);
  if (xt.fog) p_prev = p_prev * expf(xt.neg_sigma * hit.t);
  float denom = p_prev + p_nee;
  if (!(emit < 0.0f)) w = p_prev / (denom > 0.0f ? denom : 1.0f);
  return true;
}

// ------------------------------------------------------------------- path

// What NEE at one vertex needs besides the light: the point, its normal
// and albedo / pi; XT: whether it is a volume scatter point (NEE then
// takes the phase), and the MIS inputs (delta-branch probability, the fuzz
// lobe, the incoming direction for the phase).
struct NeeAt {
  V3 p, normal, brdf;
  bool scatter;
  V3 d_in;
  float refl, rough, m_refl;
  V3 m_dir;
};

// NEE at one vertex: one estimate per light, in light order (two draws
// per light), or XT's one-light NEE: a selection draw, one pair, and the
// picked light's row, indexed by the count of selection thresholds at or
// below the draw, its estimate weighed by 1 / the pick probability. XT adds
// the fog's transmittance, the MIS weight (the shadow ray then runs from
// the offset origin itself) and the phase at a scatter point
// (ops/tracer.py _nee_sample).
template <bool XT, class TR>
__device__ __forceinline__ V3 direct_light(const Scene& sc, const Xt& xt, uint32_t& state,
                                           const NeeAt& at, V3 att, TR& tr) {
  const bool one = XT && xt.light_mode != L_ALL;
  const bool scatter = XT && at.scatter;
  const bool mis = XT && xt.transport == T_MIS;
  V3 direct = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < (one ? 1 : sc.n_lights); ++l) {
    const float* L = sc.lights + LIGHT_W * l;
    float u_sel = 0.0f, psel = 0.0f;
    if (one) u_sel = next_f32(state);
    float r1 = next_f32(state);
    float r2 = next_f32(state);
    if (one) {  // the picked light's row
      const float* pick = pick_table(sc);
      int idx = 0;
      for (int i = 0; i < sc.n_lights - 1; ++i) idx += u_sel >= __ldg(pick + sc.n_lights + i) ? 1 : 0;
      psel = fmaxf(__ldg(pick + idx), PSEL_FLOOR);
      L = sc.lights + LIGHT_W * idx;
    }
    V3 lp, ln;
    if ((int)__ldg(L) == SPHERE) {
      float cos_theta = 1.0f - 2.0f * r1;
      float sin_theta = sqrtf(1.0f - cos_theta * cos_theta);
      float phi = TWO_PI * r2;
      ln = {sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta};
      lp = load3(L + 5) + ln * __ldg(L + 8);
    } else {
      float sqrt_r1 = sqrtf(r1);
      float u = 1.0f - sqrt_r1;
      float v = r2 * sqrt_r1;
      lp = load3(L + 5) * (1.0f - u - v) + load3(L + 8) * u + load3(L + 11) * v;
      ln = load3(L + 14);
    }
    V3 lvec = lp - at.p;
    float ldist = sqrtf(dot(lvec, lvec));
    V3 ldir = {lvec.x / ldist, lvec.y / ldist, lvec.z / ldist};
    V3 shadow_o = scatter ? at.p : at.p + at.normal * RAY_EPS;
    V3 sh_dir = ldir;
    float sh_tmax = ldist - RAY_EPS;
    if (mis) {
      V3 lvec_s = lp - shadow_o;
      float ldist_s = sqrtf(dot(lvec_s, lvec_s));
      sh_dir = {lvec_s.x / ldist_s, lvec_s.y / ldist_s, lvec_s.z / ldist_s};
      sh_tmax = ldist_s - RAY_EPS;
    }
    bool blocked = tr.occluded(sc, shadow_o, sh_dir, RAY_EPS, sh_tmax);
    float cos_s = scatter ? 1.0f : fmaxf(dot(at.normal, ldir), 0.0f);
    float cos_l = fmaxf(dot(ln, -ldir), 0.0f);
    if (!blocked && cos_s > 0.0f && cos_l > 0.0f) {
      float geom_term = (cos_s * cos_l) / (ldist * ldist);
      float weight = geom_term * __ldg(L + 4);
      V3 brdf = at.brdf;
      if (XT) {
        if (one) weight = weight * (1.0f / psel);
        float trans = 1.0f;
        if (xt.fog) {
          trans = expf(xt.neg_sigma * ldist);
          weight = weight * trans;
        }
        if (mis) {
          float l2 = ldist * ldist;
          if (one) l2 = psel * l2;
          float p_l = l2 / (fmaxf(cos_l, PDF_FLOOR) * __ldg(L + 4));
          float p_b, mix;
          if (scatter) {
            p_b = hg_phase(xt, dot(at.d_in, ldir));
            mix = 1.0f;
          } else {
            p_b = (1.0f - at.refl) * cos_s * INV_PI;
            mix = 1.0f - at.refl;
            float metal = at.m_refl * fuzz_pdf(dot(at.m_dir, ldir), at.rough);
            p_b = p_b + metal;
            mix = mix + metal * PI_F / fmaxf(cos_s, PDF_FLOOR);
          }
          if (xt.fog) p_b = p_b * trans;
          weight = weight * (mix * p_l / fmaxf(p_l + p_b, DENOM_FLOOR));
        }
        if (scatter && xt.hg)
          brdf = V3{xt.albedo[0], xt.albedo[1], xt.albedo[2]} * hg_phase(xt, dot(at.d_in, ldir));
      }
      V3 contrib = (brdf * load3(L + 1)) * (att * weight);
      direct = direct + min_components(contrib, NEE_CLAMP);
    }
  }
  return direct;
}

// One bounce of a live path. Returns false when the path ends here (a miss
// adds the sky; Russian roulette kills; EXT: a fuzzed mirror direction at
// or below the surface absorbs). `rays` counts owed sweeps: one
// closest-hit plus one shadow sweep per light (XT: one under one-light
// NEE). XT opens with the fog's distance draw, which may put a volume
// scatter event before the surface (NEE from the scatter point with the
// phase, a phase-sampled direction, the albedo), weighs the hit's emission
// by the transport, and ends with the next emit channel.
template <bool EXT, bool XT, class TR>
__device__ __forceinline__ bool bounce_step(const Scene& sc, const Tex& tx, const Xt& xt,
                                            uint32_t& state, V3& o, V3& d, V3& att, V3& acc,
                                            float& emit, int bounce_idx, float& rays, TR& tr) {
  static_assert(EXT || !XT, "XT implies EXT");
  Hit hit = tr.template closest_hit<EXT, XT>(sc, o, d);
  rays += 1.0f;
  bool scatter = false;
  V3 sp;
  if (XT && xt.fog) {
    float u_d = next_f32(state);
    float t_scat = logf(fmaxf(1.0f - u_d, TINY_LEN2)) * xt.neg_inv_sigma;
    scatter = t_scat < (hit.found ? hit.t : T_FAR);
    sp = o + d * t_scat;
  }
  if (!hit.found && !scatter) {
    acc = acc + (EXT && tx.sky_lo >= 0 ? sky_radiance(tx, d) : sky_color(d)) * att;
    return false;
  }
  const bool mis = XT && xt.transport == T_MIS;
  NeeAt at;
  at.scatter = scatter;
  at.d_in = d;
  if (scatter) {  // (the surface inputs are not read at a scatter point)
    at.p = sp;
    at.normal = at.m_dir = d;
    at.brdf = V3{xt.iso_phase[0], xt.iso_phase[1], xt.iso_phase[2]};
    at.refl = at.rough = at.m_refl = 0.0f;
  } else {
    if (EXT) shade_hit(tx, hit);
    float w = 1.0f;
    if (!XT || emission_weight(sc, xt, hit, d, emit, w))
      acc = acc + (mis ? hit.emission * (att * w) : hit.emission * att);
    at.p = hit.p;
    at.normal = hit.normal;
    at.brdf = hit.color * INV_PI;
    if (XT) {
      at.refl = hit.refl + __ldg(hit.ext + X_TRANSP);
      at.rough = __ldg(hit.ext + X_ROUGH);
      at.m_refl = hit.refl;
      at.m_dir = reflect(d, hit.normal);
    }
  }
  V3 direct = direct_light<XT>(sc, xt, state, at, att, tr);
  // EXT: no matte NEE ghost on glass (scaled by the non-glass share), but
  // under 'mis', which weighs it in.
  if (EXT && !mis && !scatter) direct = direct * (1.0f - __ldg(hit.ext + X_TRANSP));
  acc = acc + direct;
  rays += XT && xt.light_mode != L_ALL ? 1.0f : (float)sc.n_lights;

  V3 new_d, new_o;
  bool absorbed = false, delta = false, fuzzed = false;
  if (scatter) {
    new_d = xt.hg ? henyey_greenstein_dir(xt, state, d) : uniform_sphere_dir(state);
    new_o = sp + new_d * RAY_EPS;
    att = att * V3{xt.albedo[0], xt.albedo[1], xt.albedo[2]};
  } else {
    float r_spec = next_f32(state);
    if (hit.refl > r_spec) {
      new_d = reflect(d, hit.normal);
      delta = true;
      float rough = EXT ? __ldg(hit.ext + X_ROUGH) : 0.0f;
      if (rough > 0.0f) {  // fuzzy mirror (EXT): two more draws
        V3 raw = new_d + uniform_sphere_dir(state) * rough;
        float len2 = dot(raw, raw);
        new_d = raw * (1.0f / sqrtf(fmaxf(len2, TINY_LEN2)));
        absorbed = dot(new_d, hit.normal) <= 0.0f || len2 < TINY_LEN2;
        fuzzed = true;
      }
    } else if (EXT && hit.refl + __ldg(hit.ext + X_TRANSP) > r_spec) {
      new_d = glass_scatter(state, hit, d);
      delta = true;
    } else {
      new_d = cosine_hemisphere(state, hit.normal);
    }
    att = att * hit.color;
    new_o = hit.p + new_d * RAY_EPS;
  }

  if (bounce_idx > RR_START_BOUNCE) {
    float r_rr = next_f32(state);
    float m = fmaxf(att.x, fmaxf(att.y, att.z));
    float p_surv = fminf(m, RR_MAX_SURVIVAL);
    if (p_surv < r_rr || p_surv <= 0.0f) return false;
    att = {att.x / p_surv, att.y / p_surv, att.z / p_surv};
  }
  if (absorbed) return false;
  if (XT) {  // the next emit channel (ops/tracer.py _next_emit)
    if (!mis) {
      emit = !scatter && delta ? 1.0f : 0.0f;
    } else if (scatter) {
      emit = hg_phase(xt, dot(d, new_d));
    } else {
      float cos_new = fmaxf(dot(hit.normal, new_d), 0.0f);
      float p_cont = (1.0f - at.refl) * cos_new * INV_PI;
      p_cont = p_cont + at.m_refl * fuzz_pdf(dot(at.m_dir, new_d), at.rough);
      emit = delta && !fuzzed ? -1.0f : p_cont;
    }
  }
  o = new_o;
  d = new_d;
  return true;
}

// The camera ray through pixel (xf, yf), jittered by two draws. XT adds
// the stratified jitter (base samples s < base land in cell s mod g^2 of
// the g x g sub-pixel grid) and the thin lens (two more draws: a point on
// the lens disk aiming at the pinhole ray's focus-plane point).
template <bool XT>
__device__ __forceinline__ void gen_ray(const Frame& f, const Xt& xt, uint32_t& state, int s,
                                        float xf, float yf, V3& o, V3& d) {
  float rx = next_f32(state);
  float ry = next_f32(state);
  if (XT && xt.strat_g > 1 && s < xt.base) {
    const int m = xt.strat_g - 1;
    const float inv_g = 1.0f / (float)xt.strat_g;  // a power of two: exact
    rx = ((float)(s & m) + rx) * inv_g;
    ry = ((float)((s >> xt.strat_shift) & m) + ry) * inv_g;
  }
  float u = (xf + rx) / f.w1;
  float v = (f.h1 - yf + ry) / f.h1;
  float ndc_x = 2.0f * u - 1.0f;
  float ndc_y = (2.0f * v - 1.0f) * f.inv_char_aspect;
  float vx = f.half_w * ndc_x;
  float vy = f.half_h * ndc_y;
  V3 fwd = {f.pose[3], f.pose[4], f.pose[5]};
  V3 right = {f.pose[6], f.pose[7], f.pose[8]};
  V3 up = {f.pose[9], f.pose[10], f.pose[11]};
  d = normalize(right * vx + up * vy + fwd);
  o = {f.pose[0], f.pose[1], f.pose[2]};
  if (XT && xt.dof) {
    float r1 = next_f32(state);
    float r2 = next_f32(state);
    float lr = xt.aperture * sqrtf(r1);
    float phi = TWO_PI * r2;
    float t_focus = xt.focus / dot(d, fwd);
    V3 p_focus = o + d * t_focus;
    o = o + right * (lr * cosf(phi)) + up * (lr * sinf(phi));
    d = normalize(p_focus - o);
  }
}

// Samples [s0, quota) of one pixel continuing `state` (quota is the f32
// absolute sample quota, as in the plain regeneration scheduler), each
// path's sweeps through the traversal `tr`. Adds each finished sample's
// radiance to csum (and its square to csumsq when non-null) and returns the
// executed bounce iterations. XT starts each path's emit channel at the
// transport's fresh value.
//
// FIXED is the fixed-trip schedule of the lockstep kernel (the JAX
// package's render_lanes with loop_mode='fori'): the slots [s0, s_end)
// each spend max_depth iterations, a path's bounce guarded by its alive
// flag instead of ending the loop, and a slot at or past the quota makes
// no draw and traces nothing. The samples taken and their chains are the
// same; only the count of iterations differs.
template <bool EXT, bool XT, class TR, bool FIXED = false>
__device__ __forceinline__ unsigned run_samples(const Frame& f, const Scene& sc, const Tex& tx,
                                                const Xt& xt, uint32_t& state, int s0,
                                                float quota, float xf, float yf, V3& csum,
                                                V3* csumsq, float& rays, TR& tr, int s_end = 0) {
  unsigned iters = 0;
  for (int s = s0; FIXED ? s < s_end : (float)s < quota; ++s) {
    if (FIXED && !((float)s < quota)) {  // an idle slot
      iters += (unsigned)f.max_depth;
      continue;
    }
    state = pcg_hash(state + (uint32_t)s * 5096u);
    V3 o, d;
    gen_ray<XT>(f, xt, state, s, xf, yf, o, d);
    V3 att = {1.0f, 1.0f, 1.0f}, acc = {0.0f, 0.0f, 0.0f};
    float emit = XT ? xt.emit_fresh : 0.0f;
    bool alive = true;
    for (int b = 0; b < f.max_depth; ++b) {
      ++iters;
      if (!FIXED) {
        if (!bounce_step<EXT, XT>(sc, tx, xt, state, o, d, att, acc, emit, b, rays, tr)) break;
      } else if (alive) {
        alive = bounce_step<EXT, XT>(sc, tx, xt, state, o, d, att, acc, emit, b, rays, tr);
      }
    }
    csum = csum + acc;
    if (csumsq) *csumsq = *csumsq + acc * acc;
  }
  return iters;
}

// One trip of the regeneration schedule (ops/tracer.py regen_step; the JAX
// package's tracer.stream_step, which the TPU kernel A drives) for a lane
// at sample s whose current path has bounced b times (b = 0: the sample
// starts here): start the sample where b = 0, bounce its path once, and
// where the path ends (bounce_step returns false, or b reaches max_depth)
// add acc to csum and acc * acc to csumsq and advance s, so that the
// lane's next trip starts its next sample. As in the plain scheduler, a
// path is bounced once before its depth is checked: at max_depth 0 it
// bounces once, where run_samples bounces none.
template <bool EXT, bool XT, class TR>
__device__ __forceinline__ void regen_trip(const Frame& f, const Scene& sc, const Tex& tx,
                                           const Xt& xt, uint32_t& state, int& s, int& b,
                                           float xf, float yf, V3& o, V3& d, V3& att, V3& acc,
                                           float& emit, V3& csum, V3& csumsq, float& rays,
                                           TR& tr) {
  if (b == 0) {
    state = pcg_hash(state + (uint32_t)s * 5096u);
    gen_ray<XT>(f, xt, state, s, xf, yf, o, d);
    att = {1.0f, 1.0f, 1.0f};
    acc = {0.0f, 0.0f, 0.0f};
    emit = XT ? xt.emit_fresh : 0.0f;
  }
  if (bounce_step<EXT, XT>(sc, tx, xt, state, o, d, att, acc, emit, b, rays, tr) &&
      ++b < f.max_depth)
    return;
  csum = csum + acc;
  csumsq = csumsq + acc * acc;
  ++s;
  b = 0;
}

// Samples [0, quota) of one pixel continuing `state`, as run_samples, on
// the regeneration schedule: one trip of the loop is one bounce of the
// lane's current path (regen_trip), and a lane whose path ends starts its
// next sample on its next trip, without waiting for the other lanes' paths
// of the same sample. A warp thus runs as many trips as its lane with the
// most bounces over all its samples, where run_samples' nested loops run,
// sample by sample, as many as the warp's longest path of that sample. The
// draws, their order and the f32 order of the additions to csum, csumsq and
// rays are run_samples', so every output is equal bit for bit (at
// max_depth >= 1; regen_trip). Returns the executed bounce iterations.
template <bool EXT, bool XT, class TR>
__device__ __forceinline__ unsigned run_samples_regen(const Frame& f, const Scene& sc,
                                                      const Tex& tx, const Xt& xt,
                                                      uint32_t& state, float quota, float xf,
                                                      float yf, V3& csum, V3& csumsq, float& rays,
                                                      TR& tr) {
  unsigned iters = 0;
  V3 o, d, att, acc;
  float emit = 0.0f;
  int s = 0, b = 0;
  while ((float)s < quota) {
    ++iters;
    regen_trip<EXT, XT>(f, sc, tx, xt, state, s, b, xf, yf, o, d, att, acc, emit, csum, csumsq,
                        rays, tr);
  }
  return iters;
}

// Executed lane-iterations: 32 x the warp's largest iteration count, summed
// over warps (every lane of a warp waits for its slowest lane): the SIMT
// counterpart of the TPU kernels' per-tile iteration plane. With a lane's
// count its summed bounces over all its samples, this is the executed count
// of a loop that starts each lane's next sample at once (run_samples_regen).
// Under run_samples' nested loops, where each sample waits for the warp's
// longest path of that sample, it is a lower bound: their executed count
// is 32 x the sum over samples of the warp's longest path
// (ops/kernels.py nested_iters). Every thread of the warp must call this.
__device__ __forceinline__ void count_warp_iters(unsigned iters, unsigned long long* total) {
  unsigned m = __reduce_max_sync(0xffffffffu, iters);
  if ((threadIdx.x & 31u) == 0u) atomicAdd(total, 32ull * m);
}

// The same count for kernels whose path groups of K lanes carry one path
// each (group.cuh): executed lane-iterations are the path slots a warp
// spends, so a warp adds (32 / K) x its longest path's iterations (every
// lane of a group holds its path's count). K = 1 is count_warp_iters.
// ops/kernels.py warp_iters(lane_iters, k) is the plain model of both.
// Every thread of the warp must call this.
template <int K>
__device__ __forceinline__ void count_slot_iters(unsigned iters, unsigned long long* total) {
  unsigned m = __reduce_max_sync(0xffffffffu, iters);
  if ((threadIdx.x & 31u) == 0u) atomicAdd(total, (unsigned long long)(32 / K) * m);
}

}  // namespace trt
