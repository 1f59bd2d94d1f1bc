// The sweep over the group width K of the grouped kernels (group.cuh),
// for terminal_raytracer_tpu_torch/tools/group_k.py: kernel B at the
// reference and XT gates, kernel B over the culled sweep (in the design
// TRT_TUNE_WIDE, GroupCulled's WIDE) and the chunked kernel A at K =
// TRT_TUNE_K, and kernel A and the grid kernel A (the latter in the design
// TRT_TUNE_WIDE) on the schedule TRT_TUNE_REFILL (1: refill, 0: static),
// which the tool gives nvcc (-D) for one library a width, design and
// schedule, under the same entry names as the render libraries' grouped
// entries. No render loads this library; the widths the render libraries
// ship are constants of kernel_extra.cu, kernel_accel.cu and kernel_base.cu.

#include "group.cuh"

#ifndef TRT_TUNE_K
#define TRT_TUNE_K 1
#endif
#ifndef TRT_TUNE_WIDE
#define TRT_TUNE_WIDE (TRT_TUNE_K > 8)
#endif
#ifndef TRT_TUNE_REFILL
#define TRT_TUNE_REFILL 0
#endif
// The forms for any table size (GroupSpill): block width and stage cap
// (bytes).
#ifndef TRT_TUNE_THREADS
#define TRT_TUNE_THREADS 512
#endif
#ifndef TRT_TUNE_STAGE_CAP
#define TRT_TUNE_STAGE_CAP trt::GROUP_SMEM_MAX
#endif

using TuneSpill = trt::GroupSpill<TRT_TUNE_K, TRT_TUNE_THREADS, TRT_TUNE_STAGE_CAP>;

extern "C" int trt_kernel_extra_grouped(const ExtraArgs* a, const float* scene_buf, const int* xs,
                                        const int* ys, const long long* state_in,
                                        const float* add, const int* samp0, float* out,
                                        unsigned long long* iters, void* stream) {
  return launch_extra_grouped<false, false, trt::GroupSweep<TRT_TUNE_K>>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_extra_xt_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                           const trt::Xt* xt, const float* scene_buf,
                                           const int* xs, const int* ys,
                                           const long long* state_in, const float* add,
                                           const int* samp0, float* out,
                                           unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true, trt::GroupSweep<TRT_TUNE_K>>(
      a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_xt_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_extra_grid_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                             const trt::Xt* xt, const trt::Accel* acc,
                                             const float* scene_buf, const int* xs,
                                             const int* ys, const long long* state_in,
                                             const float* add, const int* samp0, float* out,
                                             unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true, trt::GroupCulled<TRT_TUNE_K, (TRT_TUNE_WIDE != 0)>>(
      a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream, *acc);
}

extern "C" int trt_kernel_extra_grid_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_chunked_grouped(const ChunkArgs* a, const float* scene_buf,
                                               float* out, long long* state_out,
                                               unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<trt::GroupSweep<TRT_TUNE_K>>(a, scene_buf, out, state_out, iters,
                                                             stream);
}

extern "C" int trt_kernel_base_chunked_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_grouped(const BaseArgs* a, const float* scene_buf, float* out,
                                       long long* state_out, unsigned long long* iters,
                                       unsigned* next, void* stream) {
  return launch_base_grouped<false, false, trt::GroupSweep<TRT_TUNE_K>, (TRT_TUNE_REFILL != 0)>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters, next, stream);
}

extern "C" int trt_kernel_base_grouped_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_grouped_refill() { return TRT_TUNE_REFILL; }

extern "C" int trt_kernel_base_grid_grouped(const BaseArgs* a, const trt::Tex* tx,
                                            const trt::Xt* xt, const trt::Accel* acc,
                                            const float* scene_buf, float* out,
                                            long long* state_out, unsigned long long* iters,
                                            unsigned* next, void* stream) {
  return launch_base_grouped<true, true, trt::GroupCulled<TRT_TUNE_K, (TRT_TUNE_WIDE != 0)>,
                             (TRT_TUNE_REFILL != 0)>(a, *tx, *xt, scene_buf, out, state_out,
                                                     iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_grid_grouped_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_grid_grouped_refill() { return TRT_TUNE_REFILL; }

extern "C" int trt_kernel_extra_grouped_spill(const ExtraArgs* a, const float* scene_buf,
                                              const int* xs, const int* ys,
                                              const long long* state_in, const float* add,
                                              const int* samp0, float* out,
                                              unsigned long long* iters, void* stream) {
  return launch_extra_grouped<false, false, TuneSpill>(a, trt::Tex{}, trt::Xt{}, scene_buf, xs,
                                                       ys, state_in, add, samp0, out, iters,
                                                       stream);
}

extern "C" int trt_kernel_extra_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_extra_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_extra_xt_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const float* scene_buf,
                                                 const int* xs, const int* ys,
                                                 const long long* state_in,
                                                 const float* add, const int* samp0,
                                                 float* out, unsigned long long* iters,
                                                 void* stream) {
  return launch_extra_grouped<true, true, TuneSpill>(a, *tx, *xt, scene_buf, xs, ys, state_in,
                                                     add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_xt_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_extra_xt_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_base_chunked_grouped_spill(const ChunkArgs* a, const float* scene_buf,
                                                     float* out, long long* state_out,
                                                     unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<TuneSpill>(a, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_chunked_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }
