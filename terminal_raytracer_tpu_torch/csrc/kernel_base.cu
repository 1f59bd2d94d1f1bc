// Kernel A of the sorted render pipeline: the base phase, in two forms.
//
// kernel_base replaces terminal_raytracer_tpu/ops/pallas_kernel.py
// make_base_kernel / kernel_base (the packed-stream Pallas kernel with the
// fold_budget epilogue). The TPU kernel packs `pair` pixels per lane and
// drives a scalar-carry while loop over tracer.stream_step to keep (16, 128)
// vector tiles full under Mosaic's limits; none of that carries over. Here
// one thread owns one pixel p = y*w + x (global y = y0 + local row): it
// seeds the pixel's PCG chain, renders `base` samples, and writes the
// pixel's csum[3], csumsq[3], owed rays, variance and adaptive extra
// budget, and its end RNG state. What does carry over is stream_step's
// schedule, a lane's next sample started in the step where its path ends:
// the thread runs one bounce a loop trip and starts its next sample as soon
// as its path ends in a miss, a roulette kill or max_depth (pipeline.cuh
// kernel_base_regen over trace.cuh run_samples_regen), so it never waits
// for the warp's other paths of the same sample. Per-pixel chains do not
// depend on scheduling, so the results match every JAX scheduler and the
// plain PyTorch version (ops/kernels.py base_kernel_plain). The nested
// loops it replaced (kernel_base over run_samples: the sample loop around
// the bounce loop) stay as trt_kernel_base_nested and
// trt_kernel_base_ext_nested, launched by chip_smoke.py and
// tools/group_k.py --only regen alone.
//
// kernel_base_chunked replaces the same Pallas kernel built with a chunk
// size `cb` (pallas_kernel.py:749-754, 798-800, 901-908): the heavy-pixel
// chunk split of many-primitive scenes. One thread owns one entry of the
// chunk-major stream, entry i = chunk c = i / n_pix of pixel i % n_pix. It
// seeds the pixel's chain offset by c * CHUNK_GOLDEN and renders the
// absolute samples [c*cb, min((c+1)*cb, base)), so chunk 0 is the head of
// the sequential chain and a heavy pixel's samples spread over n_chunks
// threads instead of one. It writes the entry's csum[3], csumsq[3], rays
// and end state, and no budget: the variance needs the pixel's totals,
// which the glue adds in chunk order (ops/kernels.py).
//
// Both kernels are defined in pipeline.cuh (with kernel B, for the opt-in
// traversals' instantiations in kernel_accel.cu); this file instantiates
// them with the table sweep. Both come in three instantiations of
// trace.cuh's device path: the reference transport (trt_kernel_base,
// trt_kernel_base_chunked); EXT (trt_kernel_base_ext,
// trt_kernel_base_chunked_ext), which replaces the same Pallas kernel
// built with the texel-atlas operand
// (pallas_kernel.py _tex_ops/_tex_specs/_tex_bind_front, :190-220, bound
// at :807, :920, :949) and with the material-channel branches of its body
// (tracer.py bounce_step :1300-1344, :1457-1559); and XT
// (trt_kernel_base_xt, trt_kernel_base_chunked_xt), which replaces the
// Pallas kernel whose body is the PathTracer built with a transport, fog,
// an aperture, a stratified grid or one-light NEE (pallas_kernel.py
// :739-742; tracer.py :907-1268, :1346-1638, :1703-1758). One EXT build
// serves every extension scene, one XT build every gate setting: the
// texture constants arrive in trt::Tex, the gates in trt::Xt.
//
// trt_kernel_base_chunked_grouped is the chunked kernel A at the reference
// gates redesigned for the H100 (group.cuh): a path group of
// GROUP_K_CHUNKED lanes carries one chunk-major entry, each sweep split
// across the group over the scene's rows staged in shared memory.
// ops/kernels.py takes it where the rows fit group.cuh's shared-memory
// budget, and trt_kernel_base_chunked_grouped_spill, its form for tables of
// any size (group.cuh GroupSpill: the rows that fit a 227 KB stage staged,
// the rest read through L1), above it; the thread-per-entry
// trt_kernel_base_chunked stays, launched directly. At the XT gates the
// same pair is trt_kernel_base_chunked_xt_grouped (GROUP_K_CHUNKED_XT) and
// trt_kernel_base_chunked_xt_grouped_spill (ChunkedXtSpill), beside the
// thread-per-entry trt_kernel_base_chunked_xt. At the EXT gates it is
// trt_kernel_base_chunked_ext_grouped (GROUP_K_CHUNKED_EXT) and
// trt_kernel_base_chunked_ext_grouped_spill (ChunkedExtSpill), beside the
// thread-per-entry trt_kernel_base_chunked_ext; they replace the same Pallas
// kernel as trt_kernel_base_chunked_ext (the chunk-major stream with the
// atlas bound at :807).
// trt_kernel_base_grouped is kernel A at the reference gates redesigned
// the same way (group.cuh kernel_base_grouped over GroupSweep<GROUP_K_BASE>,
// the schedule GROUP_REFILL_BASE: static, group g takes pixel g, or refill,
// the resident groups taking pixels from a counter until they run out),
// with the same epilogue; it replaces the same Pallas kernel as
// trt_kernel_base. trt_kernel_base_ext_grouped is the same at the EXT gates
// (GroupSweep<GROUP_K_BASE_EXT>, the schedule GROUP_REFILL_BASE_EXT), which
// ops/kernels.py takes for an EXT scene of at least
// GROUP_BASE_MIN_PRIMS primitives whose rows fit the budget; it replaces
// the same Pallas kernel as trt_kernel_base_ext (the atlas bound at :807
// and the material-channel branches of its body). Kernel A at the XT gates
// stays one thread a pixel on the regeneration schedule, held to
// XT_MIN_BLOCKS resident blocks an SM (pipeline.cuh launch_base_regen); its
// nested twin trt_kernel_base_xt_nested keeps the sample and bounce loops
// that it replaced, held to XT_NESTED_MIN_BLOCKS, and is launched by
// chip_smoke.py and tools/group_k.py --only regen alone. The XT draws of a
// new sample (the transport's fresh emit value, the stratified cell, the
// two DOF draws, fog's gated distance) come in the nested loops' order, so
// the outputs are equal bit for bit (at max_depth >= 1; at max_depth 0 the
// regeneration schedule bounces each path once, as the plain version does,
// and the nested loops none).
//
// What bounds them on an H100. Not bytes: they read the scene table (L1 /
// L2 or shared memory) and write 44 (36 chunked) bytes an entry. Not FP32
// operations either: the thread-per-entry kernels run 50-100x above that
// bound. Their time is the critical chain of their longest paths: one
// thread runs each bounce's sweeps one test after another (1025 tests a
// closest hit at stress1024), with too few warps on the card to hide the
// latency of each dependent instruction, and a warp runs until its
// longest lane's work ends, its lanes diverging on path ends and scatter
// branches. For the thread per pixel on the regeneration schedule that is
// the lane with the most bounces over all its base samples (32 x which,
// warp by warp, is what count_warp_iters adds); the nested twins wait,
// sample by sample, for the warp's longest path of that sample (at the
// north star 1.57x the trips, ops/kernels.py nested_iters). The grouped
// form splits each sweep over K lanes, multiplies
// the working warps by K, and keeps a group's lanes in step; it serves
// the array-scale default, where the chunk split already spreads a heavy
// pixel over n_chunks entries. --fmad=false keeps their rounding equal to
// the plain version's (about 3% slower, PERF.md).

#include "group.cuh"

// The group width of the grouped chunked kernel A: chosen by the sweep over
// K of tools/group_k.py (PERF.md, the grouped kernels).
constexpr int GROUP_K_CHUNKED = 32;
// Its form for any table size (group.cuh GroupSpill<K, block width, stage
// cap>), which ops/kernels.py takes where the rows exceed the 96 KB
// budget: chosen by the sweep of tools/group_k.py --only spill at 200x100,
// 8 spp, depth 6 (PERF.md, the grouped kernels over the budget; ms at
// mesh5120 / icosphere:5, H100 80GB HBM3 at 700 W): K = 32, 512 lanes,
// 227 KB 2.701 / 14.410 (512 lanes at 96 KB 2.833 / 14.835; 256 lanes at
// 96 KB 3.395 / 15.164; 128 lanes at 96 KB, the shape below the budget,
// 5.546 / 22.096; K = 16 at best 3.156 / 15.563; thread per entry 23.310
// / 105.313).
using ChunkedSpill = trt::GroupSpill<32, 512, trt::GROUP_SMEM_MAX>;
// The same at the XT gates (the chunked XT kernel A), over GroupSweep within
// the budget and GroupSpill above it: chosen by tools/group_k.py --only xt
// (PERF.md, PR 13; H100 80GB HBM3 at 700 W, 200x100, 8 spp, depth 6, fog
// 0.15). Within the budget, at stress1024 fog --mis: K = 8 2.846 ms, 2.830
// in a second run (K = 2 3.762, 4 3.157, 16 3.117, 32 3.353; thread per
// entry 4.207, 4.172). Above it, ms at mesh5120 fog /
// icosphere:5 fog: K = 32, 512 lanes, 227 KB 18.330 / 105.428 (K = 16, 512
// lanes, 227 KB 19.410 / 90.859, at 96 KB 18.536 / 93.695; K = 16, 256
// lanes, 96 KB 21.351 / 92.139; 227 KB with 256 lanes 28.1-28.9 at
// mesh5120; thread per entry 35.076 / 155.112). In fog every path runs to
// its roulette or depth, so the card is full of long paths and the groups
// gain less than at the reference gates (chunked A 8.2x at mesh5120).
constexpr int GROUP_K_CHUNKED_XT = 8;
using ChunkedXtSpill = trt::GroupSpill<32, 512, trt::GROUP_SMEM_MAX>;
// The resident blocks an SM that the nested twin of kernel A at the XT gates
// (trt_kernel_base_xt_nested) is held to, as the parent shipped it
// (pipeline.cuh kernel_base_resident): chosen by tools/group_k.py --only xt
// at fog (Cornell_Box 400x200, 16 spp, depth 32, fog 0.15; PERF.md, PR 13).
// Unbound, ptxas gives it 128 registers: 4 blocks of 128 lanes an SM, 528
// resident for the 625 blocks of 80,000 pixels, 1.18 waves, 1.859 ms
// (1.878 in a second run). At 5 (96 registers, 244 bytes of spill stores)
// 0.95 waves, 1.448 ms (1.371); at 6 (80 registers) 1.486 (1.483); the
// grouped forms at best 1.599 (K = 1 refill, held to 5). At
// manylights_one and showcase --mis, whose grids take 0.30 and 1.18 waves
// unbound, the two forms are within 5% of each other, either way round
// between the runs (0.304 / 0.297 ms and 0.309 / 0.322; 0.598 / 0.590 and
// 0.626 / 0.611, bound / unbound).
constexpr int XT_NESTED_MIN_BLOCKS = 5;
// The loop and residency bound of kernel A at the XT gates (pipeline.cuh
// launch_base_regen): chosen by tools/group_k.py --only regen --gates xt
// over the configurations where it serves (fog, stratified, dof at
// Cornell_Box 400x200, 16 spp, depth 32; manylights_one; showcase --mis;
// fog's sp = 3 share 2; PERF.md, the XT and grid sweep; ms of device
// time, twice in turns, H100 80GB HBM3 at 700 W). Summed: the
// regeneration schedule held to 5
// blocks an SM 4.080 / 4.072 (96 registers, 224 B of spill stores, 0.95
// waves at 400x200), to 6 4.325 / 4.319, unbound 4.595 / 4.594 (128
// registers, 1.18 waves); the nested loops held to 5, as the parent shipped
// them (trt_kernel_base_xt_nested), 5.119 / 5.113, unbound 6.222 / 6.224.
// At fog 0.966 / 0.949 against the parent's 1.343 / 1.346. The refill form
// held to 4 summed 0.9-1.0% less (4.040 / 4.034): under the 5% a second
// form must gain, and its count is no longer warp_iters, so the plain
// per-warp model would not hold it. At manylights_one (157 blocks, under
// one wave at any bound) the bound of 5 costs 5.6% against 4 (0.263 /
// 0.262 against 0.249 / 0.248); a bound chosen by grid size would save
// 0.3% of the sum.
constexpr bool XT_REFILL = false;
constexpr int XT_MIN_BLOCKS = 5;
// The same at the EXT gates (the chunked EXT kernel A), over GroupSweep
// within the budget and GroupSpill above it: chosen by tools/group_k.py
// --only ext at 200x100, 8 spp, depth 6, a checker floor (PERF.md, the
// grouped chunked EXT kernel A; H100 80GB HBM3 at 700 W). Within the
// budget, at the checker stress1024 (cb = 2): K = 32 0.734 ms (K = 4
// 1.247, 8 0.978, 16 0.811; thread per entry 3.501). Above it, at the
// checker mesh5120: K = 32, 512 lanes, 227 KB 2.694 ms (K = 32, 256 lanes
// 4.466; K = 16, 512 lanes 3.264, 256 lanes 4.461; thread per entry
// 19.390).
constexpr int GROUP_K_CHUNKED_EXT = 32;
using ChunkedExtSpill = trt::GroupSpill<32, 512, trt::GROUP_SMEM_MAX>;
// The group width of the grouped kernel A and its schedule (true: refill):
// chosen by the sweep over K and the schedule of tools/group_k.py at
// stress256, the bench configuration where the main path takes it (PERF.md,
// the grouped kernels; at the north star the thread per pixel is faster,
// and ops/kernels.py GROUP_BASE_MIN_PRIMS keeps it there).
constexpr int GROUP_K_BASE = 32;
constexpr bool GROUP_REFILL_BASE = false;
// The same at the EXT gates: chosen by tools/group_k.py --only ext --a-only
// at the checker stress:256 and stress:64 (200x100, 8 spp, depth 6), where
// the main path takes it, the least summed time (PERF.md, the grouped EXT
// kernel A; ms, H100 80GB HBM3 at 700 W): K = 32 refill 0.186 / 0.097, static 0.197 / 0.097; K 8
// refill 0.259 / 0.111; K 4 0.458 / 0.151; thread per pixel 1.485 / 0.384;
// each bound to 6 blocks an SM slower. At the packaged extension scenes
// (4-12 primitives) no form beat the thread per pixel's summed time (2.64
// ms; the best, the thread per pixel held to 6, 2.71), so base_kernel_ext
// keeps it below GROUP_BASE_MIN_PRIMS.
constexpr int GROUP_K_BASE_EXT = 32;
constexpr bool GROUP_REFILL_BASE_EXT = true;
// The thread per pixel's loop and residency bound (pipeline.cuh
// launch_base_regen): chosen by tools/group_k.py --only regen, the least
// summed time per gate set over the configurations where it serves, twice
// in turns (PERF.md, the regeneration schedule; ms of device time, H100
// 80GB HBM3 at 700 W).
// Reference gates (north star, its sp = 3 share 2, shipped, ascii 80x40,
// demo, scene2): the regeneration schedule held to 4 blocks an SM 2.480 /
// 2.470 (unbound 2.509 / 2.499; at 5 and 6 2.512, 2.546; the refill form
// at best 2.535, held to 4; the nested loops at best 2.817, held to 4, and
// 2.855 / 2.843 unbound, as trt_kernel_base_nested). EXT gates (the five packaged
// scenes): the regeneration schedule unbound 2.397 / 2.407 (held to 4, 5, 6
// 2.404, 2.411, 2.455; the refill form at best 2.505; the nested loops
// 2.505 / 2.511).
constexpr int BASE_MIN_BLOCKS = 4;

// out: f32 [9, h_out*w] (csum rgb, csumsq rgb, rays, var, additional);
// state_out: int64 [h_out*w]; iters: one zeroed u64. Returns cudaGetLastError().
// Kernel A one thread a pixel on the regeneration schedule, held to
// BASE_MIN_BLOCKS resident blocks an SM (pipeline.cuh
// kernel_base_regen_resident).
extern "C" int trt_kernel_base(const BaseArgs* a, const float* scene_buf, float* out,
                               long long* state_out, unsigned long long* iters, void* stream) {
  return launch_base_regen<false, false, trt::Sweep, false, BASE_MIN_BLOCKS>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters, nullptr, stream);
}

// The same with the nested sample and bounce loops that it replaced
// (pipeline.cuh kernel_base over trace.cuh run_samples): the same
// arguments and outputs, bit for bit; launched by chip_smoke.py and the
// sweep alone.
extern "C" int trt_kernel_base_nested(const BaseArgs* a, const float* scene_buf, float* out,
                                      long long* state_out, unsigned long long* iters,
                                      void* stream) {
  return launch_base<false, false>(a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters,
                                   stream);
}

// out: f32 [7, n_chunks*h_out*w] (csum rgb, csumsq rgb, rays), chunk-major;
// state_out: int64 [n_chunks*h_out*w]; iters: one zeroed u64.
// Returns cudaGetLastError().
extern "C" int trt_kernel_base_chunked(const ChunkArgs* a, const float* scene_buf, float* out,
                                       long long* state_out, unsigned long long* iters,
                                       void* stream) {
  return launch_chunked<false, false>(a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters,
                                      stream);
}

// The EXT instantiations (trace.cuh): the same outputs, for a scene buffer
// that carries the extension table; tx holds the atlas and texture constants.
// Kernel A's thread per pixel on the regeneration schedule, unbound
// (pipeline.cuh kernel_base_regen).
extern "C" int trt_kernel_base_ext(const BaseArgs* a, const trt::Tex* tx, const float* scene_buf,
                                   float* out, long long* state_out, unsigned long long* iters,
                                   void* stream) {
  return launch_base_regen<true, false>(a, *tx, trt::Xt{}, scene_buf, out, state_out, iters,
                                        nullptr, stream);
}

// Its nested twin, as trt_kernel_base_nested.
extern "C" int trt_kernel_base_ext_nested(const BaseArgs* a, const trt::Tex* tx,
                                          const float* scene_buf, float* out,
                                          long long* state_out, unsigned long long* iters,
                                          void* stream) {
  return launch_base<true, false>(a, *tx, trt::Xt{}, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_ext(const ChunkArgs* a, const trt::Tex* tx,
                                           const float* scene_buf, float* out,
                                           long long* state_out, unsigned long long* iters,
                                           void* stream) {
  return launch_chunked<true, false>(a, *tx, trt::Xt{}, scene_buf, out, state_out, iters,
                                     stream);
}

// The XT instantiations (trace.cuh): the same outputs, for a scene buffer
// with xt tables; tx holds the atlas and texture constants, xt the gates.
// Kernel A at the XT gates, one thread a pixel on the regeneration schedule
// (pipeline.cuh kernel_base_regen[_resident]), held to XT_MIN_BLOCKS.
extern "C" int trt_kernel_base_xt(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                  const float* scene_buf, float* out, long long* state_out,
                                  unsigned long long* iters, void* stream) {
  return launch_base_regen<true, true, trt::Sweep, XT_REFILL, XT_MIN_BLOCKS>(
      a, *tx, *xt, scene_buf, out, state_out, iters, nullptr, stream);
}

// Its residency bound (blocks an SM; 0: none).
extern "C" int trt_kernel_base_xt_min_blocks() { return XT_MIN_BLOCKS; }

// Its nested twin (pipeline.cuh kernel_base_resident over trace.cuh
// run_samples), the loops it replaced, held to XT_NESTED_MIN_BLOCKS: the
// same arguments and outputs.
extern "C" int trt_kernel_base_xt_nested(const BaseArgs* a, const trt::Tex* tx,
                                         const trt::Xt* xt, const float* scene_buf, float* out,
                                         long long* state_out, unsigned long long* iters,
                                         void* stream) {
  return launch_base<true, true, trt::Sweep, XT_NESTED_MIN_BLOCKS>(a, *tx, *xt, scene_buf, out,
                                                                   state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_xt(const ChunkArgs* a, const trt::Tex* tx,
                                          const trt::Xt* xt, const float* scene_buf, float* out,
                                          long long* state_out, unsigned long long* iters,
                                          void* stream) {
  return launch_chunked<true, true>(a, *tx, *xt, scene_buf, out, state_out, iters, stream);
}

// The grouped chunked kernel A (group.cuh): the same arguments and outputs
// as trt_kernel_base_chunked; refused (cudaErrorInvalidValue) when the
// scene's rows exceed the shared-memory budget.
extern "C" int trt_kernel_base_chunked_grouped(const ChunkArgs* a, const float* scene_buf,
                                               float* out, long long* state_out,
                                               unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<false, false, trt::GroupSweep<GROUP_K_CHUNKED>>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters, stream);
}

// Its group width K (lanes an entry).
extern "C" int trt_kernel_base_chunked_grouped_k() { return GROUP_K_CHUNKED; }

// The grouped chunked kernel A for tables of any size (group.cuh
// GroupSpill): the arguments of trt_kernel_base_chunked_grouped.
extern "C" int trt_kernel_base_chunked_grouped_spill(const ChunkArgs* a, const float* scene_buf,
                                                     float* out, long long* state_out,
                                                     unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<false, false, ChunkedSpill>(a, trt::Tex{}, trt::Xt{}, scene_buf,
                                                            out, state_out, iters, stream);
}

// Its group width K and stage cap (bytes).
extern "C" int trt_kernel_base_chunked_grouped_spill_k() { return ChunkedSpill::K; }
extern "C" int trt_kernel_base_chunked_grouped_spill_cap() { return ChunkedSpill::SMEM_CAP; }

// The grouped chunked kernel A at the XT gates: the same arguments and
// outputs as trt_kernel_base_chunked_xt; refused (cudaErrorInvalidValue)
// when the scene's rows exceed the shared-memory budget.
extern "C" int trt_kernel_base_chunked_xt_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const float* scene_buf,
                                                  float* out, long long* state_out,
                                                  unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, true, trt::GroupSweep<GROUP_K_CHUNKED_XT>>(
      a, *tx, *xt, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_xt_grouped_k() { return GROUP_K_CHUNKED_XT; }

// The grouped chunked kernel A at the XT gates for tables of any size
// (group.cuh GroupSpill): the arguments of trt_kernel_base_chunked_xt_grouped.
extern "C" int trt_kernel_base_chunked_xt_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                        const trt::Xt* xt,
                                                        const float* scene_buf, float* out,
                                                        long long* state_out,
                                                        unsigned long long* iters,
                                                        void* stream) {
  return launch_chunked_grouped<true, true, ChunkedXtSpill>(a, *tx, *xt, scene_buf, out,
                                                            state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_xt_grouped_spill_k() { return ChunkedXtSpill::K; }
extern "C" int trt_kernel_base_chunked_xt_grouped_spill_cap() {
  return ChunkedXtSpill::SMEM_CAP;
}

// The grouped chunked kernel A at the EXT gates: the same arguments and
// outputs as trt_kernel_base_chunked_ext; refused (cudaErrorInvalidValue)
// when the scene's rows exceed the shared-memory budget.
extern "C" int trt_kernel_base_chunked_ext_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                   const float* scene_buf, float* out,
                                                   long long* state_out,
                                                   unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, false, trt::GroupSweep<GROUP_K_CHUNKED_EXT>>(
      a, *tx, trt::Xt{}, scene_buf, out, state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_ext_grouped_k() { return GROUP_K_CHUNKED_EXT; }

// The grouped chunked kernel A at the EXT gates for tables of any size
// (group.cuh GroupSpill): the arguments of trt_kernel_base_chunked_ext_grouped.
extern "C" int trt_kernel_base_chunked_ext_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                         const float* scene_buf, float* out,
                                                         long long* state_out,
                                                         unsigned long long* iters,
                                                         void* stream) {
  return launch_chunked_grouped<true, false, ChunkedExtSpill>(a, *tx, trt::Xt{}, scene_buf, out,
                                                              state_out, iters, stream);
}

extern "C" int trt_kernel_base_chunked_ext_grouped_spill_k() { return ChunkedExtSpill::K; }
extern "C" int trt_kernel_base_chunked_ext_grouped_spill_cap() {
  return ChunkedExtSpill::SMEM_CAP;
}

// The grouped kernel A (group.cuh): the same arguments and outputs as
// trt_kernel_base, and `next`, one zeroed u32 (the refill schedule's pixel
// counter); refused (cudaErrorInvalidValue) when the scene's rows exceed
// the shared-memory budget.
extern "C" int trt_kernel_base_grouped(const BaseArgs* a, const float* scene_buf, float* out,
                                       long long* state_out, unsigned long long* iters,
                                       unsigned* next, void* stream) {
  return launch_base_grouped<false, false, trt::GroupSweep<GROUP_K_BASE>, GROUP_REFILL_BASE>(
      a, trt::Tex{}, trt::Xt{}, scene_buf, out, state_out, iters, next, stream);
}

// Its group width K (lanes a pixel) and schedule (1: refill, 0: static).
extern "C" int trt_kernel_base_grouped_k() { return GROUP_K_BASE; }
extern "C" int trt_kernel_base_grouped_refill() { return GROUP_REFILL_BASE; }

// The grouped kernel A at the EXT gates: the same arguments and outputs as
// trt_kernel_base_ext, and `next`, as trt_kernel_base_grouped; refused
// (cudaErrorInvalidValue) when the scene's rows exceed the shared-memory
// budget.
extern "C" int trt_kernel_base_ext_grouped(const BaseArgs* a, const trt::Tex* tx,
                                           const float* scene_buf, float* out,
                                           long long* state_out, unsigned long long* iters,
                                           unsigned* next, void* stream) {
  return launch_base_grouped<true, false, trt::GroupSweep<GROUP_K_BASE_EXT>,
                             GROUP_REFILL_BASE_EXT>(a, *tx, trt::Xt{}, scene_buf, out,
                                                    state_out, iters, next, stream);
}

// Its group width K and schedule (1: refill, 0: static).
extern "C" int trt_kernel_base_ext_grouped_k() { return GROUP_K_BASE_EXT; }
extern "C" int trt_kernel_base_ext_grouped_refill() { return GROUP_REFILL_BASE_EXT; }
