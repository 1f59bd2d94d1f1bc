// The kernels of the render pipelines, templated on the device path's
// gates (EXT, XT) and its traversal (TR, trace.cuh Sweep or a traverse.cuh
// one), with their launch arguments and launchers: one definition for
// kernel_base.cu, kernel_extra.cu, kernel_accel.cu and kernel_frame.cu,
// which instantiate them. The traversal's launch argument (TR::Launch,
// empty for Sweep) is the kernels' last parameter; each thread builds its
// traversal from it and the scene buffer, and flushes the traversal's
// counters at the end, where every thread of the warp arrives.
//
// The sorted pipeline's kernels A and B. kernel_base: one thread owns one
// pixel p = y*w + x (global y = y0 + local row): it seeds the pixel's PCG
// chain, renders `base` samples, and writes the pixel's csum[3],
// csumsq[3], owed rays, variance and adaptive extra budget, and its end
// RNG state (kernel_base.cu says what it replaces); kernel_base_regen does
// the same on the regeneration schedule (trace.cuh run_samples_regen), and
// kernel_base_refill, its form for a grid of resident lanes that take
// pixels from a counter, serves the sweep of tools/group_k.py.
// kernel_base_chunked: one thread owns one entry of the chunk-major stream,
// chunk c = i / n_pix of pixel i % n_pix, and renders the chunk's share of
// the base samples on the chunk's sub-chain (kernel_base.cu). kernel_extra:
// one thread owns one entry of the budget-sorted stream and renders its
// `add` extra samples, then writes esum[3] and the owed rays; a thread with
// add == 0 writes zeros and exits (kernel_extra.cu).
//
// The single-kernel schedulers, kernels C and D (kernel_frame.cu):
// kernel_frame renders one pixel's whole frame in one thread, kernel A's
// body, then kernel B's loop in place, then combine_phases; LOCKSTEP runs
// it on the fixed-trip schedule (trace.cuh run_samples FIXED).

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

struct ChunkArgs {
  trt::Frame f;
  int h_out, y0, base, cb, n_chunks;
  uint32_t seed, frame;
};

struct FrameArgs {
  trt::Frame f;
  int h_out, y0, base, spp;
  int cb, n_base_chunks;   // base chunk size and count (unsplit: base, 1)
  int ce, n_extra_chunks;  // extra chunk size and count (unsplit: spp - base, 1)
  uint32_t seed, frame;
  float inv_base;   // f32(1 / base)
  float max_extra;  // f32(spp - base) when base < spp, else 0
  float inv_spp;    // f32(1 / spp)
};

namespace {

// Kernel A's epilogue for pixel i of the launch (of n), the fold_budget
// epilogue (tracer.variance_of + tracer.extra_quota): the variance of the
// base samples and the adaptive budget, stored with the pixel's sums and
// owed rays in the nine planes, and its end state.
__device__ __forceinline__ void base_write(const BaseArgs& a, int i, int n, const trt::V3& csum,
                                           const trt::V3& csumsq, float rays, uint32_t state,
                                           float* out, long long* state_out) {
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

// Kernel A's body for pixel i of the launch (of n): seed the pixel's chain,
// render its `base` samples with the traversal tr, and, where `write`, store
// base_write's planes and end state. Returns the bounce iterations it ran.
// REGEN: the samples on the regeneration schedule (trace.cuh
// run_samples_regen: one bounce a trip, a lane's next sample started as
// soon as its path ends), else nested, a sample at a time (run_samples).
// kernel_base (nested), kernel_base_regen and group.cuh's
// kernel_base_grouped (nested; its lead lane writes) share it.
template <bool EXT, bool XT, class TR, bool REGEN = false>
__device__ __forceinline__ unsigned base_pixel(const BaseArgs& a, const trt::Scene& sc,
                                               const trt::Tex& tx, const trt::Xt& xt, TR& tr,
                                               int i, int n, bool write, float* out,
                                               long long* state_out) {
  const int x = i % a.f.width;
  const int y = a.y0 + i / a.f.width;
  uint32_t state =
      trt::seed_pixel((uint32_t)y * (uint32_t)a.f.width + (uint32_t)x, a.seed, a.frame);
  trt::V3 csum = {0.0f, 0.0f, 0.0f}, csumsq = {0.0f, 0.0f, 0.0f};
  float rays = 0.0f;
  unsigned iters;
  if constexpr (REGEN)
    iters = trt::run_samples_regen<EXT, XT>(a.f, sc, tx, xt, state, (float)a.base, (float)x,
                                            (float)y, csum, csumsq, rays, tr);
  else
    iters = trt::run_samples<EXT, XT>(a.f, sc, tx, xt, state, 0, (float)a.base, (float)x,
                                      (float)y, csum, &csumsq, rays, tr);
  if (write) base_write(a, i, n, csum, csumsq, rays, state, out, state_out);
  return iters;
}

// Kernel A, one thread a pixel: the body of kernel_base and
// kernel_base_resident (nested), and of kernel_base_regen and
// kernel_base_regen_resident (REGEN).
template <bool EXT, bool XT, class TR, bool REGEN = false>
__device__ __forceinline__ void base_thread(const BaseArgs& a, const float* __restrict__ scene_buf,
                                            float* __restrict__ out,
                                            long long* __restrict__ state_out,
                                            unsigned long long* __restrict__ iters,
                                            const trt::Tex& tx, const trt::Xt& xt,
                                            const typename TR::Launch& tl) {
  const int n = a.h_out * a.f.width;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned my_iters = 0;
  TR tr(tl, scene_buf);
  if (i < n) {
    const trt::Scene sc = trt::make_scene(scene_buf, a.f);
    my_iters = base_pixel<EXT, XT, TR, REGEN>(a, sc, tx, xt, tr, i, n, true, out, state_out);
  }
  trt::count_warp_iters(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_base(BaseArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                long long* __restrict__ state_out, unsigned long long* __restrict__ iters,
                trt::Tex tx, trt::Xt xt, typename TR::Launch tl) {
  base_thread<EXT, XT, TR>(a, scene_buf, out, state_out, iters, tx, xt, tl);
}

// kernel_base held to MIN_BLOCKS resident blocks an SM: ptxas fits its
// registers to 65,536 / (128 x MIN_BLOCKS), spilling what does not fit.
template <bool EXT, bool XT, class TR, int MIN_BLOCKS>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
    kernel_base_resident(BaseArgs a, const float* __restrict__ scene_buf,
                         float* __restrict__ out, long long* __restrict__ state_out,
                         unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                         typename TR::Launch tl) {
  base_thread<EXT, XT, TR>(a, scene_buf, out, state_out, iters, tx, xt, tl);
}

// Kernel A on the regeneration schedule, one thread a pixel
// (base_thread<..., REGEN>), and held to MIN_BLOCKS resident blocks an SM.
template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_base_regen(BaseArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                      long long* __restrict__ state_out, unsigned long long* __restrict__ iters,
                      trt::Tex tx, trt::Xt xt, typename TR::Launch tl) {
  base_thread<EXT, XT, TR, true>(a, scene_buf, out, state_out, iters, tx, xt, tl);
}

template <bool EXT, bool XT, class TR, int MIN_BLOCKS>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
    kernel_base_regen_resident(BaseArgs a, const float* __restrict__ scene_buf,
                               float* __restrict__ out, long long* __restrict__ state_out,
                               unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                               typename TR::Launch tl) {
  base_thread<EXT, XT, TR, true>(a, scene_buf, out, state_out, iters, tx, xt, tl);
}

// Kernel A's refill form: each lane of a grid of the resident blocks
// renders pixels taken from the zeroed counter `next`, each on the
// regeneration schedule (trace.cuh regen_trip, one bounce a trip). Where a
// lane's pixel has its `base` samples, the lane writes it (base_write) and
// takes its next pixel on its next trip. The lanes of a warp that need a
// pixel take theirs at once: __ballot_sync of those lanes, one atomicAdd of
// their count by the least of them, __shfl_sync of the first index. So a
// lane waits neither for its warp's other paths nor for their pixels, only,
// once the pixels are gone, for the warp's last path. A pixel's chain does
// not depend on which lane renders it: the outputs are the thread per
// pixel's bit for bit. The count (count_warp_iters) is 32 x the warp's
// busiest lane's summed bounces, at least the pixels' sum. Every lane of
// the grid runs the loop, so the warp-wide votes see all 32 lanes.
template <bool EXT, bool XT, class TR>
__device__ __forceinline__ void base_refill(const BaseArgs& a, const float* __restrict__ scene_buf,
                                            float* __restrict__ out,
                                            long long* __restrict__ state_out,
                                            unsigned long long* __restrict__ iters,
                                            unsigned* __restrict__ next, const trt::Tex& tx,
                                            const trt::Xt& xt, const typename TR::Launch& tl) {
  const int n = a.h_out * a.f.width;
  const unsigned lane = threadIdx.x & 31u;
  const float quota = (float)a.base;
  TR tr(tl, scene_buf);
  const trt::Scene sc = trt::make_scene(scene_buf, a.f);
  unsigned my_iters = 0;
  int i = -1;            // the lane's pixel; -1: none
  bool drained = false;  // the counter has passed the last pixel
  uint32_t state = 0u;
  trt::V3 o, d, att, acc, csum, csumsq;
  float emit = 0.0f, rays = 0.0f, xf = 0.0f, yf = 0.0f;
  int s = 0, b = 0;
  while (true) {
    const bool need = i < 0 && !drained;
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (m != 0u) {
      const int leader = __ffs(m) - 1;
      unsigned first = 0u;
      if ((int)lane == leader) first = atomicAdd(next, (unsigned)__popc(m));
      first = __shfl_sync(0xffffffffu, first, leader);
      if (need) {
        const unsigned k = first + (unsigned)__popc(m & ((1u << lane) - 1u));
        if (k < (unsigned)n) {
          i = (int)k;
          const int x = i % a.f.width;
          const int y = a.y0 + i / a.f.width;
          xf = (float)x;
          yf = (float)y;
          state = trt::seed_pixel((uint32_t)y * (uint32_t)a.f.width + (uint32_t)x, a.seed,
                                  a.frame);
          csum = csumsq = {0.0f, 0.0f, 0.0f};
          rays = 0.0f;
          s = b = 0;
        } else {
          drained = true;
        }
      }
    }
    if (__all_sync(0xffffffffu, i < 0)) break;
    if (i < 0) continue;
    if ((float)s < quota) {
      ++my_iters;
      trt::regen_trip<EXT, XT>(a.f, sc, tx, xt, state, s, b, xf, yf, o, d, att, acc, emit, csum,
                               csumsq, rays, tr);
    }
    if (!((float)s < quota)) {
      base_write(a, i, n, csum, csumsq, rays, state, out, state_out);
      i = -1;
    }
  }
  trt::count_warp_iters(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_base_refill(BaseArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                       long long* __restrict__ state_out, unsigned long long* __restrict__ iters,
                       unsigned* __restrict__ next, trt::Tex tx, trt::Xt xt,
                       typename TR::Launch tl) {
  base_refill<EXT, XT, TR>(a, scene_buf, out, state_out, iters, next, tx, xt, tl);
}

template <bool EXT, bool XT, class TR, int MIN_BLOCKS>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
    kernel_base_refill_resident(BaseArgs a, const float* __restrict__ scene_buf,
                                float* __restrict__ out, long long* __restrict__ state_out,
                                unsigned long long* __restrict__ iters,
                                unsigned* __restrict__ next, trt::Tex tx, trt::Xt xt,
                                typename TR::Launch tl) {
  base_refill<EXT, XT, TR>(a, scene_buf, out, state_out, iters, next, tx, xt, tl);
}

template <bool EXT, bool XT, class TR>
__global__ void __launch_bounds__(128)
    kernel_base_chunked(ChunkArgs a, const float* __restrict__ scene_buf,
                        float* __restrict__ out, long long* __restrict__ state_out,
                        unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                        typename TR::Launch tl) {
  const int n_pix = a.h_out * a.f.width;
  const int n = a.n_chunks * n_pix;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned my_iters = 0;
  TR tr(tl, scene_buf);
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
    out[0 * n + i] = csum.x;
    out[1 * n + i] = csum.y;
    out[2 * n + i] = csum.z;
    out[3 * n + i] = csumsq.x;
    out[4 * n + i] = csumsq.y;
    out[5 * n + i] = csumsq.z;
    out[6 * n + i] = rays;
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

// Kernel A over the h_out * w pixels of `a`: kernel_base, or with
// MIN_BLOCKS > 0 kernel_base_resident<..., MIN_BLOCKS>.
template <bool EXT, bool XT, class TR = trt::Sweep, int MIN_BLOCKS = 0>
int launch_base(const BaseArgs* a, const trt::Tex& tx, const trt::Xt& xt, const float* scene_buf,
                float* out, long long* state_out, unsigned long long* iters, void* stream,
                const typename TR::Launch& tl = {}) {
  const int n = a->h_out * a->f.width;
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    if constexpr (MIN_BLOCKS > 0)
      kernel_base_resident<EXT, XT, TR, MIN_BLOCKS><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          *a, scene_buf, out, state_out, iters, tx, xt, tl);
    else
      kernel_base<EXT, XT, TR><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          *a, scene_buf, out, state_out, iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

// The kernel of kernel A on the regeneration schedule that
// launch_base_regen launches.
template <bool EXT, bool XT, class TR, bool REFILL, int MIN_BLOCKS>
const void* base_regen_kernel() {
  if constexpr (REFILL && MIN_BLOCKS > 0)
    return (const void*)kernel_base_refill_resident<EXT, XT, TR, MIN_BLOCKS>;
  else if constexpr (REFILL)
    return (const void*)kernel_base_refill<EXT, XT, TR>;
  else if constexpr (MIN_BLOCKS > 0)
    return (const void*)kernel_base_regen_resident<EXT, XT, TR, MIN_BLOCKS>;
  else
    return (const void*)kernel_base_regen<EXT, XT, TR>;
}

// Kernel A on the regeneration schedule over the h_out * w pixels of `a`,
// 128 lanes a block, with MIN_BLOCKS > 0 held to MIN_BLOCKS resident blocks
// an SM. REFILL = false: one thread a pixel (kernel_base_regen[_resident]).
// REFILL = true: as many blocks as stay resident at once (the occupancy
// calculator's blocks an SM times the SMs), at most one lane a pixel, the
// lanes taking pixels from the zeroed counter `next`
// (kernel_base_refill[_resident]); `next` is unused otherwise.
template <bool EXT, bool XT, class TR = trt::Sweep, bool REFILL = false, int MIN_BLOCKS = 0>
int launch_base_regen(const BaseArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                      const float* scene_buf, float* out, long long* state_out,
                      unsigned long long* iters, unsigned* next, void* stream,
                      const typename TR::Launch& tl = {}) {
  const int n = a->h_out * a->f.width;
  if (n > 0) {
    const int threads = 128;
    int blocks = (n + threads - 1) / threads;
    if constexpr (REFILL) {
      int err, dev, n_sm, per_sm;
      if ((err = (int)cudaGetDevice(&dev)) != 0 ||
          (err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != 0 ||
          (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, base_regen_kernel<EXT, XT, TR, REFILL, MIN_BLOCKS>(), threads, 0)) != 0)
        return err;
      blocks = min(blocks, max(per_sm, 1) * n_sm);
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if constexpr (REFILL && MIN_BLOCKS > 0)
      kernel_base_refill_resident<EXT, XT, TR, MIN_BLOCKS>
          <<<blocks, threads, 0, st>>>(*a, scene_buf, out, state_out, iters, next, tx, xt, tl);
    else if constexpr (REFILL)
      kernel_base_refill<EXT, XT, TR>
          <<<blocks, threads, 0, st>>>(*a, scene_buf, out, state_out, iters, next, tx, xt, tl);
    else if constexpr (MIN_BLOCKS > 0)
      kernel_base_regen_resident<EXT, XT, TR, MIN_BLOCKS>
          <<<blocks, threads, 0, st>>>(*a, scene_buf, out, state_out, iters, tx, xt, tl);
    else
      kernel_base_regen<EXT, XT, TR>
          <<<blocks, threads, 0, st>>>(*a, scene_buf, out, state_out, iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

template <bool EXT, bool XT, class TR = trt::Sweep>
int launch_chunked(const ChunkArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                   const float* scene_buf, float* out, long long* state_out,
                   unsigned long long* iters, void* stream, const typename TR::Launch& tl = {}) {
  const int n = a->n_chunks * a->h_out * a->f.width;
  if (n > 0) {
    const int threads = 128;
    kernel_base_chunked<EXT, XT, TR>
        <<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
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

// Kernels C (regen) and D (LOCKSTEP): one thread owns one pixel p = y*w + x
// (global y = y0 + local row) and renders its whole frame.
//  1. seed the pixel's chain;
//  2. the base samples, chunk by chunk: chunk c re-seeds state0 + c *
//     CHUNK_GOLDEN (chunk 0 is state0), renders the absolute samples
//     [c * cb, min((c + 1) * cb, base)) from zero sums, and its sums are
//     added in chunk order; the extra phase continues chunk 0's end state;
//  3. the variance and the budget, as kernel A's epilogue;
//  4. the extra samples, chunk by chunk: chunk c owes clip(additional -
//     c * ce, 0, ce) samples from sample index base + c * ce on the
//     sub-chain state + c * CHUNK_GOLDEN, its sums added in chunk order;
//  5. combine_phases: an adaptive pixel averages (csum + esum) over base +
//     additional samples, by the f32 reciprocal of that total; the others
//     divide csum by spp.
// LOCKSTEP spends max_depth iterations on every slot: base samples, then
// ce slots a chunk of the extra phase, taken or not.
// out: f32 [6, n] (r, g, b, variance, total samples, owed rays).
template <bool EXT, bool XT, class TR, bool LOCKSTEP>
__global__ void __launch_bounds__(128)
    kernel_frame(FrameArgs a, const float* __restrict__ scene_buf, float* __restrict__ out,
                 unsigned long long* __restrict__ iters, trt::Tex tx, trt::Xt xt,
                 typename TR::Launch tl) {
  const int n = a.h_out * a.f.width;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned my_iters = 0;
  TR tr(tl, scene_buf);
  if (i < n) {
    const trt::Scene sc = trt::make_scene(scene_buf, a.f);
    const int x = i % a.f.width;
    const int y = a.y0 + i / a.f.width;
    const float xf = (float)x, yf = (float)y;
    const uint32_t state0 =
        trt::seed_pixel((uint32_t)y * (uint32_t)a.f.width + (uint32_t)x, a.seed, a.frame);
    trt::V3 csum = {0.0f, 0.0f, 0.0f}, csumsq = {0.0f, 0.0f, 0.0f};
    float rays = 0.0f;
    uint32_t state = state0;
    for (int c = 0; c < a.n_base_chunks; ++c) {
      uint32_t st = state0 + (uint32_t)c * trt::CHUNK_GOLDEN;
      const int s0 = c * a.cb;
      const int s1 = min(s0 + a.cb, a.base);
      trt::V3 cs = {0.0f, 0.0f, 0.0f}, cq = {0.0f, 0.0f, 0.0f};
      my_iters += trt::run_samples<EXT, XT, TR, LOCKSTEP>(a.f, sc, tx, xt, st, s0, (float)s1, xf,
                                                          yf, cs, &cq, rays, tr, s1);
      csum = csum + cs;
      csumsq = csumsq + cq;
      if (c == 0) state = st;
    }
    const trt::V3 mean = csum * a.inv_base;
    const trt::V3 dv = csumsq * a.inv_base - mean * mean;
    const float var = dv.x + dv.y + dv.z;
    const bool needs = a.base < a.spp && var > 10.0f;
    const float additional = needs ? fminf(floorf(var * 50.0f), a.max_extra) : 0.0f;
    trt::V3 esum = {0.0f, 0.0f, 0.0f};
    if (a.base < a.spp) {
      for (int c = 0; c < a.n_extra_chunks; ++c) {
        const float budget = fminf(fmaxf(additional - (float)(c * a.ce), 0.0f), (float)a.ce);
        if (!LOCKSTEP && !(budget > 0.0f)) continue;
        uint32_t st = state + (uint32_t)c * trt::CHUNK_GOLDEN;
        const int s0 = a.base + c * a.ce;
        trt::V3 es = {0.0f, 0.0f, 0.0f};
        my_iters += trt::run_samples<EXT, XT, TR, LOCKSTEP>(a.f, sc, tx, xt, st, s0,
                                                            budget + (float)s0, xf, yf, es,
                                                            nullptr, rays, tr, s0 + a.ce);
        esum = esum + es;
      }
    }
    trt::V3 cur;
    float total = (float)a.base;
    if (needs) {
      total = total + additional;
      cur = (csum + esum) * (1.0f / total);
    } else {
      cur = csum * a.inv_spp;
    }
    out[0 * n + i] = cur.x;
    out[1 * n + i] = cur.y;
    out[2 * n + i] = cur.z;
    out[3 * n + i] = var;
    out[4 * n + i] = total;
    out[5 * n + i] = rays;
  }
  trt::count_warp_iters(my_iters, iters);
  tr.flush();
}

template <bool EXT, bool XT, class TR, bool LOCKSTEP>
int launch_frame(const FrameArgs* a, const trt::Tex& tx, const trt::Xt& xt, const float* scene_buf,
                 float* out, unsigned long long* iters, void* stream,
                 const typename TR::Launch& tl = {}) {
  const int n = a->h_out * a->f.width;
  if (n > 0) {
    const int threads = 128;
    kernel_frame<EXT, XT, TR, LOCKSTEP>
        <<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(*a, scene_buf, out,
                                                                           iters, tx, xt, tl);
  }
  return (int)cudaGetLastError();
}

}  // namespace
