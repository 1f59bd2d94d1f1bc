// Shared device math of kernel_base.cu and kernel_extra.cu: the reference
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
// int (fine far beyond that), and every thread of a warp reads the same
// primitive at the same time through __ldg, so the table is served from
// L1 and L2 as a broadcast; staging it in shared memory is later work.

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

// Frame constants shared by both kernels (mirrored by ops/kernels.py).
struct Frame {
  int width, height, max_depth;
  int n_sph, n_pln, n_tri, n_lights;
  float pose[12];  // pos, forward, right, up
  float half_w, half_h, inv_char_aspect, w1, h1;  // w1, h1 = f32(w-1), f32(h-1)
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
  int n_sph, n_pln, n_tri, n_lights;
};

__device__ __forceinline__ Scene make_scene(const float* buf, const Frame& f) {
  Scene s;
  s.sph = buf;
  s.pln = s.sph + SPH_W * f.n_sph;
  s.tri = s.pln + PLN_W * f.n_pln;
  s.mat = s.tri + TRI_W * f.n_tri;
  s.lights = s.mat + MAT_W * (f.n_sph + f.n_pln + f.n_tri);
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
};

// Sweep spheres, planes, triangles; strictly closer wins, with the running
// closest fed forward as each test's t_max; the winner's index picks the
// material and normal; the normal is flipped to face the ray.
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
  Hit h;
  h.found = closest < T_FAR;
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
  return h;
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

// -------------------------------------------------------------- transport

__device__ __forceinline__ V3 min_components(V3 a, float cap) {
  return {fminf(a.x, cap), fminf(a.y, cap), fminf(a.z, cap)};
}

// One NEE estimate per light, in light order (two draws per light).
__device__ __forceinline__ V3 direct_light(const Scene& sc, uint32_t& state, V3 p, V3 normal,
                                           V3 color, V3 att) {
  V3 direct = {0.0f, 0.0f, 0.0f};
  V3 brdf = color * INV_PI;
  for (int l = 0; l < sc.n_lights; ++l) {
    const float* L = sc.lights + LIGHT_W * l;
    float r1 = next_f32(state);
    float r2 = next_f32(state);
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
    V3 lvec = lp - p;
    float ldist = sqrtf(dot(lvec, lvec));
    V3 ldir = {lvec.x / ldist, lvec.y / ldist, lvec.z / ldist};
    V3 shadow_o = p + normal * RAY_EPS;
    bool blocked = occluded(sc, shadow_o, ldir, RAY_EPS, ldist - RAY_EPS);
    float cos_s = fmaxf(dot(normal, ldir), 0.0f);
    float cos_l = fmaxf(dot(ln, -ldir), 0.0f);
    if (!blocked && cos_s > 0.0f && cos_l > 0.0f) {
      float geom_term = (cos_s * cos_l) / (ldist * ldist);
      float weight = geom_term * __ldg(L + 4);
      V3 contrib = (brdf * load3(L + 1)) * (att * weight);
      direct = direct + min_components(contrib, NEE_CLAMP);
    }
  }
  return direct;
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
  V3 w = normalize(normal);
  V3 u = fabsf(w.x) > 0.1f ? normalize(V3{w.z, 0.0f, -w.x}) : normalize(V3{0.0f, -w.z, w.y});
  V3 v = cross(w, u);
  return normalize(u * x + v * y + w * z);
}

__device__ __forceinline__ V3 sky_color(V3 d) {
  float t = 0.5f * (d.y + 1.0f);
  float one = 1.0f - t;
  return {(one + t * SKY_TOP_X) * SKY_INTENSITY, (one + t * SKY_TOP_Y) * SKY_INTENSITY,
          (one + t * SKY_TOP_Z) * SKY_INTENSITY};
}

// One bounce of a live path. Returns false when the path ends here (a miss
// adds the sky; Russian roulette kills). `rays` counts owed sweeps: one
// closest-hit plus n_lights shadow sweeps per hit.
__device__ __forceinline__ bool bounce_step(const Scene& sc, uint32_t& state, V3& o, V3& d, V3& att,
                                            V3& acc, int bounce_idx, float& rays) {
  Hit hit = closest_hit(sc, o, d);
  rays += 1.0f;
  if (!hit.found) {
    acc = acc + sky_color(d) * att;
    return false;
  }
  acc = acc + hit.emission * att;
  acc = acc + direct_light(sc, state, hit.p, hit.normal, hit.color, att);
  rays += (float)sc.n_lights;

  float r_spec = next_f32(state);
  V3 new_d = hit.refl > r_spec ? reflect(d, hit.normal) : cosine_hemisphere(state, hit.normal);
  att = att * hit.color;
  V3 new_o = hit.p + new_d * RAY_EPS;

  if (bounce_idx > RR_START_BOUNCE) {
    float r_rr = next_f32(state);
    float m = fmaxf(att.x, fmaxf(att.y, att.z));
    float p_surv = fminf(m, RR_MAX_SURVIVAL);
    if (p_surv < r_rr || p_surv <= 0.0f) return false;
    att = {att.x / p_surv, att.y / p_surv, att.z / p_surv};
  }
  o = new_o;
  d = new_d;
  return true;
}

__device__ __forceinline__ void gen_ray(const Frame& f, uint32_t& state, float xf, float yf, V3& o,
                                        V3& d) {
  float rx = next_f32(state);
  float ry = next_f32(state);
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
}

// Samples [s0, quota) of one pixel continuing `state` (quota is the f32
// absolute sample quota, as in the plain regeneration scheduler). Adds each
// finished sample's radiance to csum (and its square to csumsq when
// non-null) and returns the executed bounce iterations.
__device__ __forceinline__ unsigned run_samples(const Frame& f, const Scene& sc, uint32_t& state,
                                                int s0, float quota, float xf, float yf, V3& csum,
                                                V3* csumsq, float& rays) {
  unsigned iters = 0;
  for (int s = s0; (float)s < quota; ++s) {
    state = pcg_hash(state + (uint32_t)s * 5096u);
    V3 o, d;
    gen_ray(f, state, xf, yf, o, d);
    V3 att = {1.0f, 1.0f, 1.0f}, acc = {0.0f, 0.0f, 0.0f};
    for (int b = 0; b < f.max_depth; ++b) {
      ++iters;
      if (!bounce_step(sc, state, o, d, att, acc, b, rays)) break;
    }
    csum = csum + acc;
    if (csumsq) *csumsq = *csumsq + acc * acc;
  }
  return iters;
}

// Executed lane-iterations: 32 x the warp's largest iteration count, summed
// over warps — the SIMT counterpart of the TPU kernels' per-tile iteration
// plane (every lane of a warp waits for its slowest lane). Every thread of
// the warp must call this.
__device__ __forceinline__ void count_warp_iters(unsigned iters, unsigned long long* total) {
  unsigned m = __reduce_max_sync(0xffffffffu, iters);
  if ((threadIdx.x & 31u) == 0u) atomicAdd(total, 32ull * m);
}

}  // namespace trt
