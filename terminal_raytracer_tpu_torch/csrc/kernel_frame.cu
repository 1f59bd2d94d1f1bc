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
//
// The *_queue entries are kernels C and D redesigned for the H100 (group.cuh
// kernel_frame_queue; kernel D's queue entries are in kernel_frame_lockstep.cu
// and the forms of both in frame_queue.cuh, so that nvcc builds the two
// halves at once): one launch of resident path groups that take chunk
// items from a device queue, base items first, pixel-major, then the extra
// items that each folded pixel appends; the group that completes a pixel's
// items adds their planes in chunk order and writes combine_phases. They
// replace the same Pallas kernels as the entries above, which stay (one
// thread a pixel, launched directly by chip_smoke.py). Per instantiation
// three forms, by the sorted pipeline's dispatch for the same tracer:
// _solo below GROUP_BASE_MIN_PRIMS = 16 primitives, base items one a lane
// (KB = 1) as kernel A keeps its thread per pixel there; the group form
// over GroupSweep (reference, EXT, XT), GroupCulled (grid) or GroupWalk
// (gathered, WALK_L1) within the 96 KB budget (the walk at every size);
// _spill, over GroupSpill or GroupCulledSpill above it. Each form runs base
// items at KB lanes and extra items at KE lanes (kernels A and B's widths
// at first). Each entry has a _per_sm(args, accel) query (its resident
// blocks an SM at the tracer's staged rows). A tune
// build (-DTRT_TUNE_KB, -DTRT_TUNE_KE; tools/group_k.py --only frame) gives
// every form that base width (the thread per item keeps KB = 1) or extra
// width, and -DTRT_TUNE_FRAME_MIN_BLOCKS every form of 128-lane blocks that
// residency bound (the XT forms within the budget ship with 5);
// -DTRT_TUNE_QUEUE_ONLY leaves out the thread-per-pixel entries.
//
// What bounds the redesign: the longest item's chain (a chunk's samples,
// not a pixel's frame) and the sweeps inside it, split over the group; the
// fold adds a few global reads and atomics a pixel.

#include "frame_queue.cuh"

#ifndef TRT_TUNE_QUEUE_ONLY

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
#endif  // TRT_TUNE_QUEUE_ONLY

// The entries: out f32 [6, h_out*w] as above; ctl, scratch: the queue's
// zeroed u32 words and its f32 scratch (ops/kernels.py frame_queue_words);
// each with its _per_sm query (acc null for the table sweeps).
extern "C" int trt_kernel_regen_queue_solo(const FrameArgs* a, const float* scene_buf, float* out,
                                           unsigned* ctl, float* scratch, void* stream) {
  return queue<RefSolo, false>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefSolo, false>(a, acc);
}
extern "C" int trt_kernel_regen_queue(const FrameArgs* a, const float* scene_buf, float* out,
                                      unsigned* ctl, float* scratch, void* stream) {
  return queue<RefGroup, false>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefGroup, false>(a, acc);
}
extern "C" int trt_kernel_regen_queue_spill(const FrameArgs* a, const float* scene_buf, float* out,
                                            unsigned* ctl, float* scratch, void* stream) {
  return queue<RefSpill, false>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_queue_spill_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefSpill, false>(a, acc);
}

extern "C" int trt_kernel_regen_ext_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                               const float* scene_buf, float* out, unsigned* ctl,
                                               float* scratch, void* stream) {
  return queue<ExtSolo, false>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_ext_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<ExtSolo, false>(a, acc);
}
extern "C" int trt_kernel_regen_ext_queue(const FrameArgs* a, const trt::Tex* tx,
                                          const float* scene_buf, float* out, unsigned* ctl,
                                          float* scratch, void* stream) {
  return queue<ExtGroup, false>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_ext_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<ExtGroup, false>(a, acc);
}
extern "C" int trt_kernel_regen_ext_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                                const float* scene_buf, float* out, unsigned* ctl,
                                                float* scratch, void* stream) {
  return queue<ExtSpill, false>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_ext_queue_spill_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<ExtSpill, false>(a, acc);
}

extern "C" int trt_kernel_regen_xt_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                              const trt::Xt* xt, const float* scene_buf, float* out,
                                              unsigned* ctl, float* scratch, void* stream) {
  return queue<XtSolo, false>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_xt_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<XtSolo, false>(a, acc);
}
extern "C" int trt_kernel_regen_xt_queue(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                         const float* scene_buf, float* out, unsigned* ctl,
                                         float* scratch, void* stream) {
  return queue<XtGroup, false>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_xt_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<XtGroup, false>(a, acc);
}
extern "C" int trt_kernel_regen_xt_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                               const trt::Xt* xt, const float* scene_buf,
                                               float* out, unsigned* ctl, float* scratch,
                                               void* stream) {
  return queue<XtSpill, false>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_xt_queue_spill_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<XtSpill, false>(a, acc);
}

extern "C" int trt_kernel_regen_grid_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                const trt::Xt* xt, const trt::Accel* acc,
                                                const float* scene_buf, float* out, unsigned* ctl,
                                                float* scratch, void* stream) {
  return queue<GridSolo, false>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_grid_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<GridSolo, false>(a, acc);
}
extern "C" int trt_kernel_regen_grid_queue(const FrameArgs* a, const trt::Tex* tx,
                                           const trt::Xt* xt, const trt::Accel* acc,
                                           const float* scene_buf, float* out, unsigned* ctl,
                                           float* scratch, void* stream) {
  return queue<GridGroup, false>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_grid_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<GridGroup, false>(a, acc);
}
extern "C" int trt_kernel_regen_grid_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const trt::Accel* acc,
                                                 const float* scene_buf, float* out, unsigned* ctl,
                                                 float* scratch, void* stream) {
  return queue<GridSpill, false>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_grid_queue_spill_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<GridSpill, false>(a, acc);
}

extern "C" int trt_kernel_regen_gathered_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                    const trt::Xt* xt, const trt::Accel* acc,
                                                    const float* scene_buf, float* out,
                                                    unsigned* ctl, float* scratch, void* stream) {
  return queue<WalkSolo, false>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_gathered_queue_solo_per_sm(const FrameArgs* a,
                                                           const trt::Accel* acc) {
  return queue_per_sm<WalkSolo, false>(a, acc);
}
extern "C" int trt_kernel_regen_gathered_queue(const FrameArgs* a, const trt::Tex* tx,
                                               const trt::Xt* xt, const trt::Accel* acc,
                                               const float* scene_buf, float* out, unsigned* ctl,
                                               float* scratch, void* stream) {
  return queue<WalkGroup, false>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_regen_gathered_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<WalkGroup, false>(a, acc);
}
