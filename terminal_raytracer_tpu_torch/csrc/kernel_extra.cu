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
// trt_kernel_extra_grouped is kernel B at the reference gates redesigned
// for the H100 (group.cuh): a path group of GROUP_K_EXTRA lanes carries
// one entry, the closest-hit and shadow sweeps split across the group over
// the scene's rows staged in shared memory. ops/kernels.py takes it where
// the rows fit group.cuh's shared-memory budget. trt_kernel_extra_xt_grouped
// is the same design at the XT gates (GROUP_K_EXTRA_XT lanes an entry),
// which ops/kernels.py takes for an XT tracer whose rows fit; it replaces
// the same Pallas kernel as trt_kernel_extra_xt (pallas_kernel.py:1013-1015,
// :1028). trt_kernel_extra_grouped_spill and
// trt_kernel_extra_xt_grouped_spill are the two for tables of any size
// (group.cuh GroupSpill: the rows that fit a 227 KB stage staged, the rest
// read through L1), which ops/kernels.py takes where the rows exceed the
// 96 KB budget. trt_kernel_extra_ext_grouped and
// trt_kernel_extra_ext_grouped_spill are the same two at the EXT gates
// (the atlas fetches run in path groups as at the XT gates), replacing the
// Pallas kernel built with the texel-atlas operand (pallas_kernel.py
// _tex_ops/_tex_bind_front, bound at :1031). The thread-per-entry
// trt_kernel_extra, trt_kernel_extra_ext and trt_kernel_extra_xt stay,
// launched directly.
//
// What bounds it on an H100. Not its bytes (40 a entry and a table that
// fits in L1) nor its FP32 operations (hundreds of times below the card's
// rate): the critical chain of the longest entry's path. An entry's extra
// samples are one serial chain of bounces, and the thread-per-entry kernel
// ran each bounce's sweeps in one thread, a lone warp per scheduler on the
// few SMs that the sorted stream's budgeted prefix filled, waiting out the
// latency of each dependent instruction, its lanes diverging on sample
// ends, roulette and the scatter branch. The grouped kernel shortens each
// bounce by splitting its sweeps over K lanes, multiplies the working warps
// by K, and keeps the lanes of a group in step; zero-budget blocks leave
// before staging. Built with --fmad=false like kernel A.

#include "group.cuh"

// The group widths of the grouped kernel B at the reference and the XT
// gates: chosen by the sweep over K of tools/group_k.py (PERF.md, the
// grouped kernels).
constexpr int GROUP_K_EXTRA = 16;
constexpr int GROUP_K_EXTRA_XT = 4;
// Their forms for any table size (group.cuh GroupSpill<K, block width,
// stage cap>), which ops/kernels.py takes where the rows exceed the 96 KB
// budget: chosen by the sweep of tools/group_k.py --only spill at 200x100,
// 8 spp, depth 6 (PERF.md, the grouped kernels over the budget; ms at
// mesh5120 / icosphere:5, H100 80GB HBM3 at 700 W). B: K = 32, 256 lanes,
// 227 KB 0.640 / 3.644 (512 lanes 0.736 / 3.818; 128 lanes at 96 KB 0.828
// / 3.587; K = 16 at best 1.227 / 6.582; thread per entry 20.940 /
// 94.541): its few budgeted entries spread over more SMs in narrower
// blocks. XT B in fog: K = 16, 512 lanes, 227 KB 1.914 / 9.775 (at 96 KB
// 1.881 / 9.822, within 2%; K = 32 at best 1.961 / 11.103; thread per
// entry 30.199 / 136.373).
using ExtraSpill = trt::GroupSpill<32, 256, trt::GROUP_SMEM_MAX>;
using ExtraXtSpill = trt::GroupSpill<16, 512, trt::GROUP_SMEM_MAX>;
// The grouped kernel B at the EXT gates and its form for any table size:
// chosen by the sweep of tools/group_k.py --only ext (PERF.md, the grouped
// EXT kernel B; ms, H100 80GB HBM3 at 700 W). At cornell_glass, showcase,
// textured, envmap, bumpy (400x200) and the checker stress:1024 (200x100,
// 8 spp, depth 6), thread per entry 2.857, 0.799, 0.675, 0.074, 0.540,
// 3.238 (summed 8.18); K = 2 6.07 summed, K = 4 2.445, 0.696, 0.608,
// 0.076, 0.564, 0.781 (5.17), K = 8 4.97 but bumpy 0.748 and textured
// 0.693, over the thread per entry; K = 16 6.75. K = 4 is faster than or
// within 5% of the thread per entry on every shape. Over the budget at the
// checker icosphere:4: K = 32, 256 lanes, 227 KB 0.650 (512 lanes 0.739;
// K = 16 1.253 / 1.377; thread per entry 21.469).
constexpr int GROUP_K_EXTRA_EXT = 4;
using ExtraExtSpill = trt::GroupSpill<32, 256, trt::GROUP_SMEM_MAX>;

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

// The grouped kernel B (group.cuh): the same arguments and outputs as
// trt_kernel_extra; refused (cudaErrorInvalidValue) when the scene's rows
// exceed the shared-memory budget.
extern "C" int trt_kernel_extra_grouped(const ExtraArgs* a, const float* scene_buf, const int* xs,
                                        const int* ys, const long long* state_in,
                                        const float* add, const int* samp0, float* out,
                                        unsigned long long* iters, void* stream) {
  return launch_extra_grouped<false, false, trt::GroupSweep<GROUP_K_EXTRA>>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

// Its group width K (lanes an entry).
extern "C" int trt_kernel_extra_grouped_k() { return GROUP_K_EXTRA; }

// The grouped kernel B at the XT gates: the same arguments and outputs as
// trt_kernel_extra_xt; refused (cudaErrorInvalidValue) when the scene's
// rows exceed the shared-memory budget.
extern "C" int trt_kernel_extra_xt_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                           const trt::Xt* xt, const float* scene_buf,
                                           const int* xs, const int* ys,
                                           const long long* state_in, const float* add,
                                           const int* samp0, float* out,
                                           unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true, trt::GroupSweep<GROUP_K_EXTRA_XT>>(
      a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_xt_grouped_k() { return GROUP_K_EXTRA_XT; }

// The grouped kernel B for tables of any size (group.cuh GroupSpill): the
// arguments of trt_kernel_extra_grouped.
extern "C" int trt_kernel_extra_grouped_spill(const ExtraArgs* a, const float* scene_buf,
                                              const int* xs, const int* ys,
                                              const long long* state_in, const float* add,
                                              const int* samp0, float* out,
                                              unsigned long long* iters, void* stream) {
  return launch_extra_grouped<false, false, ExtraSpill>(a, trt::Tex{}, trt::Xt{}, scene_buf, xs,
                                                        ys, state_in, add, samp0, out, iters,
                                                        stream);
}

// Its group width K and stage cap (bytes).
extern "C" int trt_kernel_extra_grouped_spill_k() { return ExtraSpill::K; }
extern "C" int trt_kernel_extra_grouped_spill_cap() { return ExtraSpill::SMEM_CAP; }

// The grouped kernel B at the XT gates for tables of any size: the
// arguments of trt_kernel_extra_xt_grouped.
extern "C" int trt_kernel_extra_xt_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const float* scene_buf,
                                                 const int* xs, const int* ys,
                                                 const long long* state_in,
                                                 const float* add, const int* samp0,
                                                 float* out, unsigned long long* iters,
                                                 void* stream) {
  return launch_extra_grouped<true, true, ExtraXtSpill>(a, *tx, *xt, scene_buf, xs, ys, state_in,
                                                        add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_xt_grouped_spill_k() { return ExtraXtSpill::K; }
extern "C" int trt_kernel_extra_xt_grouped_spill_cap() { return ExtraXtSpill::SMEM_CAP; }

// The grouped kernel B at the EXT gates: the same arguments and outputs as
// trt_kernel_extra_ext; refused (cudaErrorInvalidValue) when the scene's
// rows exceed the shared-memory budget.
extern "C" int trt_kernel_extra_ext_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                            const float* scene_buf, const int* xs, const int* ys,
                                            const long long* state_in, const float* add,
                                            const int* samp0, float* out,
                                            unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, false, trt::GroupSweep<GROUP_K_EXTRA_EXT>>(
      a, *tx, trt::Xt{}, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_ext_grouped_k() { return GROUP_K_EXTRA_EXT; }

// The grouped kernel B at the EXT gates for tables of any size: the
// arguments of trt_kernel_extra_ext_grouped.
extern "C" int trt_kernel_extra_ext_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                  const float* scene_buf, const int* xs,
                                                  const int* ys, const long long* state_in,
                                                  const float* add, const int* samp0,
                                                  float* out, unsigned long long* iters,
                                                  void* stream) {
  return launch_extra_grouped<true, false, ExtraExtSpill>(a, *tx, trt::Xt{}, scene_buf, xs, ys,
                                                          state_in, add, samp0, out, iters,
                                                          stream);
}

extern "C" int trt_kernel_extra_ext_grouped_spill_k() { return ExtraExtSpill::K; }
extern "C" int trt_kernel_extra_ext_grouped_spill_cap() { return ExtraExtSpill::SMEM_CAP; }
