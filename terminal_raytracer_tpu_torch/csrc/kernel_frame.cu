// Kernels C and D: the single-kernel schedulers, one launch a frame.
//
// trt_kernel_regen* replaces terminal_raytracer_tpu/ops/pallas_kernel.py
// make_render_frame(mode='regen') / kernel_regen (:420-466, call
// :499-516): each lane of a (16, 128) tile runs its pixel's whole frame
// (tracer.render_lanes_regen: the base quota, variance_of, extra_quota and
// the extra samples that continue the chain) in a scalar-carry while loop
// over regen_step, the carry in typed VMEM scratch planes because Mosaic
// cannot carry vectors through a loop; a chunked tracer runs that loop
// once per chunk. trt_kernel_lockstep* replaces make_render_frame(
// mode='lockstep') / kernel_lockstep (:391-401, same call): the same frame
// on tracer.render_lanes with loop_mode='fori', every lane running every
// sample slot for max_depth masked bounce steps, and a static occupancy
// denominator (:518-545).
//
// None of the TPU machinery carries over. One thread owns one pixel and
// keeps the whole carry in registers: kernel A's body, then kernel B's
// loop in place, then combine_phases (pipeline.cuh kernel_frame). Per-pixel
// chains do not depend on scheduling, so both equal each other, the sorted
// pipeline and the plain whole frame (ops/kernels.py render_frame_plain).
// The regen kernel counts its executed iterations as kernels A and B do
// (32 x the warp's longest thread); the lockstep kernel spends max_depth
// iterations on every sample slot, so its count is the static formula.
// The JAX loop cap (spp + 1) * max_depth + 4 is dropped: a thread's
// phases need at most their quota x max_depth iterations.
//
// Five instantiations each, the gate sets and traversals of the sorted
// pipeline: the reference transport (trt_kernel_regen), EXT (_ext, the
// texel atlas and material channels), XT (_xt, the transport and camera
// gates), and XT over the opt-in traversals (_grid, the block-culled
// sweep; _gathered, the grid walk; their counters flush once a thread, at
// the end, over base and extra work alike).
//
// What bounds them on an H100: as kernels A and B (FP32 work behind
// divergent control flow, registers), with the whole frame's divergence in
// one warp: a warp runs until its pixel with the largest budget ends. A
// simple kernel that is right is the goal here. Built with --fmad=false
// like the others.

#include "pipeline.cuh"
#include "traverse.cuh"

// out: f32 [6, h_out*w] (r, g, b, variance, total samples, owed rays);
// iters: one zeroed u64. Returns cudaGetLastError().
extern "C" int trt_kernel_regen(const FrameArgs* a, const float* scene_buf, float* out,
                                unsigned long long* iters, void* stream) {
  return launch_frame<false, false, trt::Sweep, false>(a, trt::Tex{}, trt::Xt{}, scene_buf, out,
                                                       iters, stream);
}

// tx holds the atlas and texture constants.
extern "C" int trt_kernel_regen_ext(const FrameArgs* a, const trt::Tex* tx, const float* scene_buf,
                                    float* out, unsigned long long* iters, void* stream) {
  return launch_frame<true, false, trt::Sweep, false>(a, *tx, trt::Xt{}, scene_buf, out, iters,
                                                      stream);
}

// xt holds the gates.
extern "C" int trt_kernel_regen_xt(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                   const float* scene_buf, float* out, unsigned long long* iters,
                                   void* stream) {
  return launch_frame<true, true, trt::Sweep, false>(a, *tx, *xt, scene_buf, out, iters, stream);
}

// acc: the traversal's launch argument.
extern "C" int trt_kernel_regen_grid(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                     const trt::Accel* acc, const float* scene_buf, float* out,
                                     unsigned long long* iters, void* stream) {
  return launch_frame<true, true, trt::Culled, false>(a, *tx, *xt, scene_buf, out, iters, stream,
                                                      *acc);
}

extern "C" int trt_kernel_regen_gathered(const FrameArgs* a, const trt::Tex* tx,
                                         const trt::Xt* xt, const trt::Accel* acc,
                                         const float* scene_buf, float* out,
                                         unsigned long long* iters, void* stream) {
  return launch_frame<true, true, trt::Walk, false>(a, *tx, *xt, scene_buf, out, iters, stream,
                                                    *acc);
}

// The lockstep kernel: the same arguments and outputs.
extern "C" int trt_kernel_lockstep(const FrameArgs* a, const float* scene_buf, float* out,
                                   unsigned long long* iters, void* stream) {
  return launch_frame<false, false, trt::Sweep, true>(a, trt::Tex{}, trt::Xt{}, scene_buf, out,
                                                      iters, stream);
}

extern "C" int trt_kernel_lockstep_ext(const FrameArgs* a, const trt::Tex* tx,
                                       const float* scene_buf, float* out,
                                       unsigned long long* iters, void* stream) {
  return launch_frame<true, false, trt::Sweep, true>(a, *tx, trt::Xt{}, scene_buf, out, iters,
                                                     stream);
}

extern "C" int trt_kernel_lockstep_xt(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                      const float* scene_buf, float* out,
                                      unsigned long long* iters, void* stream) {
  return launch_frame<true, true, trt::Sweep, true>(a, *tx, *xt, scene_buf, out, iters, stream);
}

extern "C" int trt_kernel_lockstep_grid(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                        const trt::Accel* acc, const float* scene_buf, float* out,
                                        unsigned long long* iters, void* stream) {
  return launch_frame<true, true, trt::Culled, true>(a, *tx, *xt, scene_buf, out, iters, stream,
                                                     *acc);
}

extern "C" int trt_kernel_lockstep_gathered(const FrameArgs* a, const trt::Tex* tx,
                                            const trt::Xt* xt, const trt::Accel* acc,
                                            const float* scene_buf, float* out,
                                            unsigned long long* iters, void* stream) {
  return launch_frame<true, true, trt::Walk, true>(a, *tx, *xt, scene_buf, out, iters, stream,
                                                   *acc);
}
