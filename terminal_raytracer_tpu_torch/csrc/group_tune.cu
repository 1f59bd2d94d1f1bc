// The sweep over the group width K of the grouped kernels (group.cuh),
// for terminal_raytracer_tpu_torch/tools/group_k.py: kernel B at the
// reference and XT gates, kernel B over the culled sweep (in the design
// TRT_TUNE_WIDE, GroupCulled's WIDE) and the chunked kernel A at the
// reference and XT gates at K = TRT_TUNE_K, and kernel A and the grid
// kernel A (the latter in the design TRT_TUNE_WIDE) on the schedule
// TRT_TUNE_REFILL (1: refill, 0: static), which the tool gives nvcc (-D)
// for one library a width, design and schedule, under the same entry names
// as the render libraries' grouped entries. No render loads this library;
// the widths the render libraries ship are constants of kernel_extra.cu,
// kernel_accel.cu and kernel_base.cu.
//
// The grouped kernels B and A over the culled sweep for tables of any size
// come over GroupCulledSpill<TRT_TUNE_K, TRT_TUNE_WIDE, TRT_TUNE_THREADS,
// TRT_TUNE_STAGE_CAP> (A on the schedule TRT_TUNE_REFILL).
//
// The grouped kernel B and the grouped chunked kernel A at the EXT gates
// over GroupSweep<TRT_TUNE_K> and over TuneSpill, and the grouped gathered
// kernels B, A (the latter on the schedule TRT_TUNE_REFILL) and chunked A
// over GroupWalk<TRT_TUNE_K, TRT_TUNE_WALK (the row source),
// TRT_TUNE_THREADS, TRT_TUNE_STAGE_CAP> come under the render libraries'
// names too.
//
// The grouped kernel A at the EXT gates comes over GroupSweep<TRT_TUNE_K> on
// the schedule TRT_TUNE_REFILL, held to TRT_TUNE_MIN_BLOCKS resident blocks
// an SM (0: none), and the grouped chunked kernel A over the culled sweep
// over GroupCulled<TRT_TUNE_K, TRT_TUNE_WIDE> and TuneCulledSpill.
//
// Beside them, the forms of kernel A at the XT and EXT gates and over the
// culled sweep that the sweep weighs against the shipped thread per pixel
// (ops/build.py TUNE_ONLY_ENTRY_POINTS): trt_kernel_base_xt,
// trt_kernel_base_ext and trt_kernel_base_grid, one thread a pixel held to
// TRT_TUNE_MIN_BLOCKS resident blocks an SM (0: as shipped; the EXT one on
// the regeneration schedule, kernel_base_regen), and
// trt_kernel_base_xt_grouped, kernel_base_grouped at the XT gates over
// GroupSweep<TRT_TUNE_K> on the schedule TRT_TUNE_REFILL, held to
// TRT_TUNE_MIN_BLOCKS too; each with its queries, and the resident blocks
// an SM that the occupancy calculator gives it (no staged rows; the
// grouped EXT kernel A's too, with its rows staged for a given scene).
// Last, kernel A's thread-per-pixel loops at the reference, EXT and XT
// gates and over the culled sweep and the grid walk (TRT_TUNE_LOOP, below).

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
// XT kernel A's residency bound (blocks an SM; 0: none).
#ifndef TRT_TUNE_MIN_BLOCKS
#define TRT_TUNE_MIN_BLOCKS 0
#endif

// The grouped gathered kernel B's row source (group.cuh WALK_L1, WALK_ROWS,
// WALK_CSR).
#ifndef TRT_TUNE_WALK
#define TRT_TUNE_WALK 0
#endif

using TuneSpill = trt::GroupSpill<TRT_TUNE_K, TRT_TUNE_THREADS, TRT_TUNE_STAGE_CAP>;
using TuneWalk = trt::GroupWalk<TRT_TUNE_K, TRT_TUNE_WALK, TRT_TUNE_THREADS, TRT_TUNE_STAGE_CAP>;
using TuneCulledSpill = trt::GroupCulledSpill<TRT_TUNE_K, (TRT_TUNE_WIDE != 0), TRT_TUNE_THREADS,
                                              TRT_TUNE_STAGE_CAP>;

// TRT_TUNE_LOOP_ONLY=1 builds the thread-per-pixel loops alone (the last
// section; tools/group_k.py --only regen, one library a loop and bound).
#ifndef TRT_TUNE_LOOP_ONLY
#define TRT_TUNE_LOOP_ONLY 0
#endif
#if !TRT_TUNE_LOOP_ONLY

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
  return launch_chunked_grouped<false, false, trt::GroupSweep<TRT_TUNE_K>>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_chunked_xt_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const float* scene_buf,
                                                  float* out, long long* state_out,
                                                  unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, true, trt::GroupSweep<TRT_TUNE_K>>(
      a, *tx, *xt, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_xt_grouped_k() { return TRT_TUNE_K; }

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
  return launch_chunked_grouped<false, false, TuneSpill>(a, trt::Tex{}, trt::Xt{}, scene_buf, out,
                                                         state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_chunked_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_base_chunked_xt_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                        const trt::Xt* xt,
                                                        const float* scene_buf, float* out,
                                                        long long* state_out,
                                                        unsigned long long* iters,
                                                        void* stream) {
  return launch_chunked_grouped<true, true, TuneSpill>(a, *tx, *xt, scene_buf, out, state_out,
                                                       iters, stream);
}

extern "C" int trt_kernel_base_chunked_xt_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_chunked_xt_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_extra_ext_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                            const float* scene_buf, const int* xs, const int* ys,
                                            const long long* state_in, const float* add,
                                            const int* samp0, float* out,
                                            unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, false, trt::GroupSweep<TRT_TUNE_K>>(
      a, *tx, trt::Xt{}, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_ext_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_extra_ext_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                  const float* scene_buf, const int* xs,
                                                  const int* ys, const long long* state_in,
                                                  const float* add, const int* samp0,
                                                  float* out, unsigned long long* iters,
                                                  void* stream) {
  return launch_extra_grouped<true, false, TuneSpill>(a, *tx, trt::Xt{}, scene_buf, xs, ys,
                                                      state_in, add, samp0, out, iters, stream);
}

extern "C" int trt_kernel_extra_ext_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_extra_ext_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_extra_grid_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                   const trt::Xt* xt, const trt::Accel* acc,
                                                   const float* scene_buf, const int* xs,
                                                   const int* ys, const long long* state_in,
                                                   const float* add, const int* samp0,
                                                   float* out, unsigned long long* iters,
                                                   void* stream) {
  return launch_extra_grouped<true, true, TuneCulledSpill>(a, *tx, *xt, scene_buf, xs, ys,
                                                           state_in, add, samp0, out, iters,
                                                           stream, *acc);
}

extern "C" int trt_kernel_extra_grid_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_extra_grid_grouped_spill_cap() { return TuneCulledSpill::SMEM_CAP; }

extern "C" int trt_kernel_base_grid_grouped_spill(const BaseArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const trt::Accel* acc,
                                                  const float* scene_buf, float* out,
                                                  long long* state_out,
                                                  unsigned long long* iters, unsigned* next,
                                                  void* stream) {
  return launch_base_grouped<true, true, TuneCulledSpill, (TRT_TUNE_REFILL != 0)>(
      a, *tx, *xt, scene_buf, out, state_out, iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_grid_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_grid_grouped_spill_cap() { return TuneCulledSpill::SMEM_CAP; }
extern "C" int trt_kernel_base_grid_grouped_spill_refill() { return TRT_TUNE_REFILL; }

extern "C" int trt_kernel_extra_gathered_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const trt::Accel* acc,
                                                 const float* scene_buf, const int* xs,
                                                 const int* ys, const long long* state_in,
                                                 const float* add, const int* samp0, float* out,
                                                 unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true, TuneWalk>(a, *tx, *xt, scene_buf, xs, ys, state_in,
                                                    add, samp0, out, iters, stream, *acc);
}

extern "C" int trt_kernel_extra_gathered_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_chunked_ext_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                   const float* scene_buf, float* out,
                                                   long long* state_out,
                                                   unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, false, trt::GroupSweep<TRT_TUNE_K>>(
      a, *tx, trt::Xt{}, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_ext_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_chunked_ext_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                         const float* scene_buf, float* out,
                                                         long long* state_out,
                                                         unsigned long long* iters,
                                                         void* stream) {
  return launch_chunked_grouped<true, false, TuneSpill>(a, *tx, trt::Xt{}, scene_buf, out,
                                                        state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_ext_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_chunked_ext_grouped_spill_cap() { return TuneSpill::SMEM_CAP; }

extern "C" int trt_kernel_base_gathered_grouped(const BaseArgs* a, const trt::Tex* tx,
                                                const trt::Xt* xt, const trt::Accel* acc,
                                                const float* scene_buf, float* out,
                                                long long* state_out,
                                                unsigned long long* iters, unsigned* next,
                                                void* stream) {
  return launch_base_grouped<true, true, TuneWalk, (TRT_TUNE_REFILL != 0)>(
      a, *tx, *xt, scene_buf, out, state_out, iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_gathered_grouped_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_gathered_grouped_refill() { return TRT_TUNE_REFILL; }

extern "C" int trt_kernel_base_ext_grouped(const BaseArgs* a, const trt::Tex* tx,
                                           const float* scene_buf, float* out,
                                           long long* state_out, unsigned long long* iters,
                                           unsigned* next, void* stream) {
  return launch_base_grouped<true, false, trt::GroupSweep<TRT_TUNE_K>, (TRT_TUNE_REFILL != 0),
                             TRT_TUNE_MIN_BLOCKS>(a, *tx, trt::Xt{}, scene_buf, out, state_out,
                                                  iters, next, stream);
}

extern "C" int trt_kernel_base_ext_grouped_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_ext_grouped_refill() { return TRT_TUNE_REFILL; }

extern "C" int trt_kernel_base_chunked_grid_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                    const trt::Xt* xt, const trt::Accel* acc,
                                                    const float* scene_buf, float* out,
                                                    long long* state_out,
                                                    unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, true, trt::GroupCulled<TRT_TUNE_K, (TRT_TUNE_WIDE != 0)>>(
      a, *tx, *xt, scene_buf, out, state_out, iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_grid_grouped_k() { return TRT_TUNE_K; }

extern "C" int trt_kernel_base_chunked_grid_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                          const trt::Xt* xt,
                                                          const trt::Accel* acc,
                                                          const float* scene_buf, float* out,
                                                          long long* state_out,
                                                          unsigned long long* iters,
                                                          void* stream) {
  return launch_chunked_grouped<true, true, TuneCulledSpill>(a, *tx, *xt, scene_buf, out,
                                                             state_out, iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_grid_grouped_spill_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_chunked_grid_grouped_spill_cap() {
  return TuneCulledSpill::SMEM_CAP;
}

extern "C" int trt_kernel_base_chunked_gathered_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                        const trt::Xt* xt,
                                                        const trt::Accel* acc,
                                                        const float* scene_buf, float* out,
                                                        long long* state_out,
                                                        unsigned long long* iters,
                                                        void* stream) {
  return launch_chunked_grouped<true, true, TuneWalk>(a, *tx, *xt, scene_buf, out, state_out,
                                                      iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_gathered_grouped_k() { return TRT_TUNE_K; }

// Kernel A at the EXT gates, one thread a pixel on the regeneration
// schedule as shipped (TRT_TUNE_MIN_BLOCKS > 0: kernel_base_regen_resident),
// the arguments of kernel_base.cu's entry.
extern "C" int trt_kernel_base_ext(const BaseArgs* a, const trt::Tex* tx, const float* scene_buf,
                                   float* out, long long* state_out, unsigned long long* iters,
                                   void* stream) {
  return launch_base_regen<true, false, trt::Sweep, false, TRT_TUNE_MIN_BLOCKS>(
      a, *tx, trt::Xt{}, scene_buf, out, state_out, iters, nullptr, stream);
}

extern "C" int trt_kernel_base_ext_min_blocks() { return TRT_TUNE_MIN_BLOCKS; }

// Kernel A at the XT gates, one thread a pixel on the nested loops
// (TRT_TUNE_MIN_BLOCKS > 0: kernel_base_resident), the arguments of
// kernel_base.cu's entry (the --only xt sweep's reference).
extern "C" int trt_kernel_base_xt(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                  const float* scene_buf, float* out, long long* state_out,
                                  unsigned long long* iters, void* stream) {
  return launch_base<true, true, trt::Sweep, TRT_TUNE_MIN_BLOCKS>(a, *tx, *xt, scene_buf, out,
                                                                  state_out, iters, stream);
}

extern "C" int trt_kernel_base_xt_min_blocks() { return TRT_TUNE_MIN_BLOCKS; }

// Kernel A over the culled sweep, one thread a pixel on the nested loops
// (TRT_TUNE_MIN_BLOCKS > 0: kernel_base_resident), the arguments of
// kernel_accel.cu's entry (the --only grid sweep's reference).
extern "C" int trt_kernel_base_grid(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                    const trt::Accel* acc, const float* scene_buf, float* out,
                                    long long* state_out, unsigned long long* iters,
                                    void* stream) {
  return launch_base<true, true, trt::Culled, TRT_TUNE_MIN_BLOCKS>(a, *tx, *xt, scene_buf, out,
                                                                   state_out, iters, stream, *acc);
}

extern "C" int trt_kernel_base_grid_min_blocks() { return TRT_TUNE_MIN_BLOCKS; }

// Kernel A at the XT gates grouped (kernel_base_grouped, or with
// TRT_TUNE_MIN_BLOCKS > 0 kernel_base_grouped_resident): the arguments of
// trt_kernel_base_xt and `next`, as trt_kernel_base_grouped.
extern "C" int trt_kernel_base_xt_grouped(const BaseArgs* a, const trt::Tex* tx,
                                          const trt::Xt* xt, const float* scene_buf, float* out,
                                          long long* state_out, unsigned long long* iters,
                                          unsigned* next, void* stream) {
  return launch_base_grouped<true, true, trt::GroupSweep<TRT_TUNE_K>, (TRT_TUNE_REFILL != 0),
                             TRT_TUNE_MIN_BLOCKS>(a, *tx, *xt, scene_buf, out, state_out, iters,
                                                  next, stream);
}

extern "C" int trt_kernel_base_xt_grouped_k() { return TRT_TUNE_K; }
extern "C" int trt_kernel_base_xt_grouped_refill() { return TRT_TUNE_REFILL; }

// The resident blocks an SM of the forms above (no staged rows), or a
// negative CUDA error.
template <class F>
static int per_sm(F* kernel, int threads) {
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  return err != 0 ? -err : n;
}

extern "C" int trt_kernel_base_xt_per_sm() {
#if TRT_TUNE_MIN_BLOCKS > 0
  return per_sm(kernel_base_resident<true, true, trt::Sweep, TRT_TUNE_MIN_BLOCKS>, 128);
#else
  return per_sm(kernel_base<true, true, trt::Sweep>, 128);
#endif
}

extern "C" int trt_kernel_base_grid_per_sm() {
#if TRT_TUNE_MIN_BLOCKS > 0
  return per_sm(kernel_base_resident<true, true, trt::Culled, TRT_TUNE_MIN_BLOCKS>, 128);
#else
  return per_sm(kernel_base<true, true, trt::Culled>, 128);
#endif
}

extern "C" int trt_kernel_base_xt_grouped_per_sm() {
  using TR = trt::GroupSweep<TRT_TUNE_K>;
#if TRT_TUNE_MIN_BLOCKS > 0
  return per_sm(
      kernel_base_grouped_resident<true, true, TR, (TRT_TUNE_REFILL != 0), TRT_TUNE_MIN_BLOCKS>,
      TR::THREADS);
#else
  return per_sm(kernel_base_grouped<true, true, TR, (TRT_TUNE_REFILL != 0)>, TR::THREADS);
#endif
}

extern "C" int trt_kernel_base_ext_per_sm() {
  return per_sm(base_regen_kernel<true, false, trt::Sweep, false, TRT_TUNE_MIN_BLOCKS>(), 128);
}

// The grouped EXT kernel A's resident blocks an SM with `bytes` of staged
// rows, or a negative CUDA error.
extern "C" int trt_kernel_base_ext_grouped_per_sm(const int* bytes) {
  using TR = trt::GroupSweep<TRT_TUNE_K>;
  int n = 0;
#if TRT_TUNE_MIN_BLOCKS > 0
  const void* kernel = (const void*)kernel_base_grouped_resident<true, false, TR,
                                                                 (TRT_TUNE_REFILL != 0),
                                                                 TRT_TUNE_MIN_BLOCKS>;
#else
  const void* kernel = (const void*)kernel_base_grouped<true, false, TR, (TRT_TUNE_REFILL != 0)>;
#endif
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      TR::SMEM_CAP);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TR::THREADS, *bytes);
  return err != 0 ? -err : n;
}
#endif  // !TRT_TUNE_LOOP_ONLY

// Kernel A's thread-per-pixel loops at the reference, EXT and XT gates and
// over the culled sweep and the grid walk (the XT gate set, as
// kernel_accel.cu's trt_kernel_base_grid and trt_kernel_base_gathered), for
// tools/group_k.py --only regen:
// TRT_TUNE_LOOP 0, the nested sample and bounce loops (kernel_base, as the
// *_nested entries); 1, the regeneration schedule one thread a pixel
// (kernel_base_regen, as shipped); 2, its refill form (kernel_base_refill: a
// grid of the resident blocks whose lanes take pixels from the zeroed
// counter `next`, unused by the others); each held to TRT_TUNE_MIN_BLOCKS
// resident blocks an SM (0: none). The arguments of the shipped entries,
// and `next`.
#ifndef TRT_TUNE_LOOP
#define TRT_TUNE_LOOP 1
#endif

template <bool EXT, bool XT, class TR>
static const void* loop_kernel() {
#if TRT_TUNE_LOOP == 0
#if TRT_TUNE_MIN_BLOCKS > 0
  return (const void*)kernel_base_resident<EXT, XT, TR, TRT_TUNE_MIN_BLOCKS>;
#else
  return (const void*)kernel_base<EXT, XT, TR>;
#endif
#else
  return base_regen_kernel<EXT, XT, TR, (TRT_TUNE_LOOP == 2), TRT_TUNE_MIN_BLOCKS>();
#endif
}

template <bool EXT, bool XT, class TR>
static int launch_loop(const BaseArgs* a, const trt::Tex& tx, const trt::Xt& xt,
                       const float* scene_buf, float* out, long long* state_out,
                       unsigned long long* iters, unsigned* next, void* stream,
                       const typename TR::Launch& tl = {}) {
#if TRT_TUNE_LOOP == 0
  (void)next;
  return launch_base<EXT, XT, TR, TRT_TUNE_MIN_BLOCKS>(a, tx, xt, scene_buf, out, state_out,
                                                       iters, stream, tl);
#else
  return launch_base_regen<EXT, XT, TR, (TRT_TUNE_LOOP == 2), TRT_TUNE_MIN_BLOCKS>(
      a, tx, xt, scene_buf, out, state_out, iters, next, stream, tl);
#endif
}

extern "C" int trt_kernel_base_loop(const BaseArgs* a, const float* scene_buf, float* out,
                                    long long* state_out, unsigned long long* iters,
                                    unsigned* next, void* stream) {
  return launch_loop<false, false, trt::Sweep>(a, trt::Tex{}, trt::Xt{}, scene_buf, out,
                                               state_out, iters, next, stream);
}

extern "C" int trt_kernel_base_ext_loop(const BaseArgs* a, const trt::Tex* tx,
                                        const float* scene_buf, float* out, long long* state_out,
                                        unsigned long long* iters, unsigned* next, void* stream) {
  return launch_loop<true, false, trt::Sweep>(a, *tx, trt::Xt{}, scene_buf, out, state_out,
                                              iters, next, stream);
}

extern "C" int trt_kernel_base_gathered_loop(const BaseArgs* a, const trt::Tex* tx,
                                             const trt::Xt* xt, const trt::Accel* acc,
                                             const float* scene_buf, float* out,
                                             long long* state_out, unsigned long long* iters,
                                             unsigned* next, void* stream) {
  return launch_loop<true, true, trt::Walk>(a, *tx, *xt, scene_buf, out, state_out, iters, next,
                                            stream, *acc);
}

extern "C" int trt_kernel_base_xt_loop(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                       const float* scene_buf, float* out, long long* state_out,
                                       unsigned long long* iters, unsigned* next, void* stream) {
  return launch_loop<true, true, trt::Sweep>(a, *tx, *xt, scene_buf, out, state_out, iters, next,
                                             stream);
}

extern "C" int trt_kernel_base_grid_loop(const BaseArgs* a, const trt::Tex* tx,
                                         const trt::Xt* xt, const trt::Accel* acc,
                                         const float* scene_buf, float* out,
                                         long long* state_out, unsigned long long* iters,
                                         unsigned* next, void* stream) {
  return launch_loop<true, true, trt::Culled>(a, *tx, *xt, scene_buf, out, state_out, iters, next,
                                              stream, *acc);
}

// The loop (TRT_TUNE_LOOP), its residency bound, and the resident blocks an
// SM that the occupancy calculator gives it at the gates `*gates` (0: the
// reference gates, 1: EXT, 2: over the grid walk, 3: XT, 4: over the culled
// sweep), or a negative CUDA error.
extern "C" int trt_kernel_base_loop_kind() { return TRT_TUNE_LOOP; }
extern "C" int trt_kernel_base_loop_min_blocks() { return TRT_TUNE_MIN_BLOCKS; }
extern "C" int trt_kernel_base_loop_per_sm(const int* gates) {
  const void* kernel = *gates == 4   ? loop_kernel<true, true, trt::Culled>()
                       : *gates == 3 ? loop_kernel<true, true, trt::Sweep>()
                       : *gates == 2 ? loop_kernel<true, true, trt::Walk>()
                       : *gates == 1 ? loop_kernel<true, false, trt::Sweep>()
                                     : loop_kernel<false, false, trt::Sweep>();
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 128, 0);
  return err != 0 ? -err : n;
}
