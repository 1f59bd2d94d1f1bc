// Kernels A and B of the sorted render pipeline, templated on the device
// path's gates (EXT, XT) and its traversal (TR, trace.cuh Sweep or a
// traverse.cuh one), with their launch arguments and launchers: one
// definition for kernel_base.cu, kernel_extra.cu and kernel_accel.cu, which
// instantiate them. The traversal's launch argument (TR::Launch, empty for
// Sweep) is the kernels' last parameter; each thread builds its traversal
// from it and the scene buffer, and flushes the traversal's counters at
// the end, where every thread of the warp arrives.
//
// kernel_base: one thread owns one pixel p = y*w + x (global y = y0 +
// local row): it seeds the pixel's PCG chain, renders `base` samples, and
// writes the pixel's csum[3], csumsq[3], owed rays, variance and adaptive
// extra budget, and its end RNG state (kernel_base.cu says what it
// replaces). kernel_extra: one thread owns one entry of the budget-sorted
// stream and renders its `add` extra samples, then writes esum[3] and the
// owed rays; a thread with add == 0 writes zeros and exits
// (kernel_extra.cu).

#pragma once

#include "trace.cuh"

// Launch arguments, passed by value (mirrored by ctypes in ops/kernels.py).
struct BaseArgs {
  trt::Frame f;
  int h_out, y0, base, spp;
  uint32_t seed, frame;
  float inv_base;   // f32(1 / base)
  float max_extra;  // f32(spp - base) when base < spp, else 0
};

struct ExtraArgs {
  trt::Frame f;
  int n_entries;
};

namespace {

template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_base(BaseArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                long long* __restrict__ state_out, unsigned long long* __restrict__ iters,
                trt::Tex tx, trt::Xt xt, typename TR::Launch tl) {
  const int n = a.h_out * a.f.width;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned my_iters = 0;
  TR tr(tl, scene_buf);
  if (i < n) {
    const trt::Scene sc = trt::make_scene(scene_buf, a.f);
    const int x = i % a.f.width;
    const int y = a.y0 + i / a.f.width;
    uint32_t state = trt::seed_pixel((uint32_t)y * (uint32_t)a.f.width + (uint32_t)x, a.seed,
                                     a.frame);
    trt::V3 csum = {0.0f, 0.0f, 0.0f}, csumsq = {0.0f, 0.0f, 0.0f};
    float rays = 0.0f;
    my_iters = trt::run_samples<EXT, XT>(a.f, sc, tx, xt, state, 0, (float)a.base, (float)x,
                                         (float)y, csum, &csumsq, rays, tr);
    // Variance of the base samples and the adaptive budget (the
    // fold_budget epilogue: tracer.variance_of + tracer.extra_quota).
    trt::V3 mean = csum * a.inv_base;
    trt::V3 dv = csumsq * a.inv_base - mean * mean;
    float var = dv.x + dv.y + dv.z;
    float additional = 0.0f;
    if (a.base < a.spp && var > 10.0f) additional = fminf(floorf(var * 50.0f), a.max_extra);
    out[0 * n + i] = csum.x;
    out[1 * n + i] = csum.y;
    out[2 * n + i] = csum.z;
    out[3 * n + i] = csumsq.x;
    out[4 * n + i] = csumsq.y;
    out[5 * n + i] = csumsq.z;
    out[6 * n + i] = rays;
    out[7 * n + i] = var;
    out[8 * n + i] = additional;
    state_out[i] = (long long)state;
  }
  trt::count_warp_iters(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_extra(ExtraArgs a, const float* __restrict__ scene_buf, const int* __restrict__ xs,
                 const int* __restrict__ ys, const long long* __restrict__ state_in,
                 const float* __restrict__ add, const int* __restrict__ samp0,
                 float* __restrict__ out, unsigned long long* __restrict__ iters, trt::Tex tx,
                 trt::Xt xt, typename TR::Launch tl) {
  const int n = a.n_entries;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned my_iters = 0;
  TR tr(tl, scene_buf);
  if (i < n) {
    trt::V3 esum = {0.0f, 0.0f, 0.0f};
    float rays = 0.0f;
    const float budget = add[i];
    if (budget > 0.0f) {
      const trt::Scene sc = trt::make_scene(scene_buf, a.f);
      uint32_t state = (uint32_t)state_in[i];
      const int s0 = samp0[i];
      my_iters = trt::run_samples<EXT, XT>(a.f, sc, tx, xt, state, s0, budget + (float)s0,
                                           (float)xs[i], (float)ys[i], esum, nullptr, rays, tr);
    }
    out[0 * n + i] = esum.x;
    out[1 * n + i] = esum.y;
    out[2 * n + i] = esum.z;
    out[3 * n + i] = rays;
  }
  trt::count_warp_iters(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR = trt::Sweep>
int launch_base(const BaseArgs* a, const trt::Tex& tx, const trt::Xt& xt, const float* scene_buf,
                float* out, long long* state_out, unsigned long long* iters, void* stream,
                const typename TR::Launch& tl = {}) {
  const int n = a->h_out * a->f.width;
  if (n > 0) {
    const int threads = 128;
    kernel_base<EXT, XT, TR><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        *a, scene_buf, out, state_out, iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

template <bool EXT, bool XT, class TR = trt::Sweep>
int launch_extra(const ExtraArgs* a, const trt::Tex& tx, const trt::Xt& xt, const float* scene_buf,
                 const int* xs, const int* ys, const long long* state_in, const float* add,
                 const int* samp0, float* out, unsigned long long* iters, void* stream,
                 const typename TR::Launch& tl = {}) {
  const int n = a->n_entries;
  if (n > 0) {
    const int threads = 128;
    kernel_extra<EXT, XT, TR><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        *a, scene_buf, xs, ys, state_in, add, samp0, out, iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

}  // namespace
