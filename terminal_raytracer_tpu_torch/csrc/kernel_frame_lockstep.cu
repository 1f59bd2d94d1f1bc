// Kernel D on the queue schedule: the lockstep queue entries (kernel_frame.cu
// says what they replace and how they work; frame_queue.cuh holds the forms
// they share with kernel C's entries), a library of its own so that nvcc
// builds it beside kernel_frame.cu.

#include "frame_queue.cuh"

// The entries: out f32 [6, h_out*w] as kernel_frame.cu's; ctl, scratch: the queue's
// zeroed u32 words and its f32 scratch (ops/kernels.py frame_queue_words);
// each with its _per_sm query (acc null for the table sweeps).
extern "C" int trt_kernel_lockstep_queue_solo(const FrameArgs* a, const float* scene_buf,
                                              float* out, unsigned* ctl, float* scratch,
                                              void* stream) {
  return queue<RefSolo, true>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefSolo, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_queue(const FrameArgs* a, const float* scene_buf, float* out,
                                         unsigned* ctl, float* scratch, void* stream) {
  return queue<RefGroup, true>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefGroup, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_queue_spill(const FrameArgs* a, const float* scene_buf,
                                               float* out, unsigned* ctl, float* scratch,
                                               void* stream) {
  return queue<RefSpill, true>(a, nullptr, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_queue_spill_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<RefSpill, true>(a, acc);
}

extern "C" int trt_kernel_lockstep_ext_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                  const float* scene_buf, float* out, unsigned* ctl,
                                                  float* scratch, void* stream) {
  return queue<ExtSolo, true>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_ext_queue_solo_per_sm(const FrameArgs* a,
                                                         const trt::Accel* acc) {
  return queue_per_sm<ExtSolo, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_ext_queue(const FrameArgs* a, const trt::Tex* tx,
                                             const float* scene_buf, float* out, unsigned* ctl,
                                             float* scratch, void* stream) {
  return queue<ExtGroup, true>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_ext_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<ExtGroup, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_ext_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                                   const float* scene_buf, float* out,
                                                   unsigned* ctl, float* scratch, void* stream) {
  return queue<ExtSpill, true>(a, tx, nullptr, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_ext_queue_spill_per_sm(const FrameArgs* a,
                                                          const trt::Accel* acc) {
  return queue_per_sm<ExtSpill, true>(a, acc);
}

extern "C" int trt_kernel_lockstep_xt_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const float* scene_buf,
                                                 float* out, unsigned* ctl, float* scratch,
                                                 void* stream) {
  return queue<XtSolo, true>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_xt_queue_solo_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<XtSolo, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_xt_queue(const FrameArgs* a, const trt::Tex* tx,
                                            const trt::Xt* xt, const float* scene_buf, float* out,
                                            unsigned* ctl, float* scratch, void* stream) {
  return queue<XtGroup, true>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_xt_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<XtGroup, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_xt_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const float* scene_buf,
                                                  float* out, unsigned* ctl, float* scratch,
                                                  void* stream) {
  return queue<XtSpill, true>(a, tx, xt, nullptr, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_xt_queue_spill_per_sm(const FrameArgs* a,
                                                         const trt::Accel* acc) {
  return queue_per_sm<XtSpill, true>(a, acc);
}

extern "C" int trt_kernel_lockstep_grid_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                   const trt::Xt* xt, const trt::Accel* acc,
                                                   const float* scene_buf, float* out,
                                                   unsigned* ctl, float* scratch, void* stream) {
  return queue<GridSolo, true>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_grid_queue_solo_per_sm(const FrameArgs* a,
                                                          const trt::Accel* acc) {
  return queue_per_sm<GridSolo, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_grid_queue(const FrameArgs* a, const trt::Tex* tx,
                                              const trt::Xt* xt, const trt::Accel* acc,
                                              const float* scene_buf, float* out, unsigned* ctl,
                                              float* scratch, void* stream) {
  return queue<GridGroup, true>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_grid_queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  return queue_per_sm<GridGroup, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_grid_queue_spill(const FrameArgs* a, const trt::Tex* tx,
                                                    const trt::Xt* xt, const trt::Accel* acc,
                                                    const float* scene_buf, float* out,
                                                    unsigned* ctl, float* scratch, void* stream) {
  return queue<GridSpill, true>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_grid_queue_spill_per_sm(const FrameArgs* a,
                                                           const trt::Accel* acc) {
  return queue_per_sm<GridSpill, true>(a, acc);
}

extern "C" int trt_kernel_lockstep_gathered_queue_solo(const FrameArgs* a, const trt::Tex* tx,
                                                       const trt::Xt* xt, const trt::Accel* acc,
                                                       const float* scene_buf, float* out,
                                                       unsigned* ctl, float* scratch,
                                                       void* stream) {
  return queue<WalkSolo, true>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_gathered_queue_solo_per_sm(const FrameArgs* a,
                                                              const trt::Accel* acc) {
  return queue_per_sm<WalkSolo, true>(a, acc);
}
extern "C" int trt_kernel_lockstep_gathered_queue(const FrameArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const trt::Accel* acc,
                                                  const float* scene_buf, float* out, unsigned* ctl,
                                                  float* scratch, void* stream) {
  return queue<WalkGroup, true>(a, tx, xt, acc, scene_buf, out, ctl, scratch, stream);
}
extern "C" int trt_kernel_lockstep_gathered_queue_per_sm(const FrameArgs* a,
                                                         const trt::Accel* acc) {
  return queue_per_sm<WalkGroup, true>(a, acc);
}
