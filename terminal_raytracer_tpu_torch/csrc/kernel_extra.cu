// Kernel B of the sorted render pipeline: the adaptive extra samples.
//
// Replaces terminal_raytracer_tpu/ops/pallas_kernel.py make_extra_kernel /
// kernel_extra (with its _regen_driver). Its input is the stream that the
// glue in ops/kernels.py sorts by descending budget: entry i names pixel
// (xs, ys), the pixel's RNG state after the base phase, its extra budget
// `add` and the sample index `samp0` its chain continues at. One thread
// owns one entry and renders `add` samples, each a plain bounce loop, then
// writes esum[3] and the owed rays. A thread with add == 0 writes zeros
// and exits: the counterpart of the Pallas kernel's pl.when tile skip. The
// sort puts such threads together in whole warps, so those warps finish at
// once.
//
// kernel_extra is defined in pipeline.cuh (with kernel A, for the opt-in
// traversals' instantiations in kernel_accel.cu); this file instantiates it
// with the table sweep. trt_kernel_extra_ext is the EXT instantiation (trace.cuh): the same
// kernel for extension scenes, replacing the Pallas kernel built with the
// texel-atlas operand (pallas_kernel.py _tex_ops/_tex_bind_front, bound at
// :1031, :1078, :1093). trt_kernel_extra_xt is the XT instantiation, for
// the transport and camera extensions: it replaces the Pallas kernel whose
// body is the PathTracer built with their gates (pallas_kernel.py
// :1013-1015).
//
// What bounds it on an H100: divergent control flow (per-entry budgets and
// path lengths differ; a warp runs until its longest entry ends),
// registers, and FP32 ALU and SFU work; a few hundred bytes of L1-resident
// scene table and 40 bytes per entry of DRAM traffic. A simple kernel that
// is right is the goal here; persistent threads and warp-level path
// regeneration are later work. Built with --fmad=false like kernel A.

#include "pipeline.cuh"

// xs, ys, samp0: int32 [n]; state_in: int64 [n]; add: f32 [n];
// out: f32 [4, n] (esum rgb, rays); iters: one zeroed u64.
// Returns cudaGetLastError().
extern "C" int trt_kernel_extra(const ExtraArgs* a, const float* scene_buf, const int* xs,
                                const int* ys, const long long* state_in, const float* add,
                                const int* samp0, float* out, unsigned long long* iters,
                                void* stream) {
  return launch_extra<false, false>(a, trt::Tex{}, trt::Xt{}, scene_buf, xs, ys, state_in, add,
                                    samp0, out, iters, stream);
}

// The EXT instantiation (trace.cuh): the same outputs, for a scene buffer
// that carries the extension table; tx holds the atlas and texture constants.
extern "C" int trt_kernel_extra_ext(const ExtraArgs* a, const trt::Tex* tx, const float* scene_buf,
                                    const int* xs, const int* ys, const long long* state_in,
                                    const float* add, const int* samp0, float* out,
                                    unsigned long long* iters, void* stream) {
  return launch_extra<true, false>(a, *tx, trt::Xt{}, scene_buf, xs, ys, state_in, add, samp0,
                                   out, iters, stream);
}

// The XT instantiation (trace.cuh): the same outputs, for a scene buffer
// with xt tables; tx holds the atlas and texture constants, xt the gates.
extern "C" int trt_kernel_extra_xt(const ExtraArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                   const float* scene_buf, const int* xs, const int* ys,
                                   const long long* state_in, const float* add, const int* samp0,
                                   float* out, unsigned long long* iters, void* stream) {
  return launch_extra<true, true>(a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0, out,
                                  iters, stream);
}
