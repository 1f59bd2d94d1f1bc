// The forms of the queue entries of kernels C and D (kernel_frame.cu's
// regen entries, kernel_frame_lockstep.cu's lockstep entries): their group
// widths, traversals and residency bounds, and the launch helpers the
// entries call (group.cuh kernel_frame_queue; kernel_frame.cu says what the
// entries replace).

#pragma once

#include <type_traits>

#include "group.cuh"

// The group widths of the queue entries, base items then extra items, and
// their forms over the budget: the sorted pipeline's kernel A and B widths
// for the same tracer, then each width at the summed regen and lockstep
// ms of tools/group_k.py --only frame on the H100 at the [sched] config of
// each form (PERF.md §6; the EXT spill form shares the reference
// one's). The thread per item takes base items one a lane (KB = 1) and
// extra items at its own width.
#ifndef TRT_TUNE_KB
#define TRT_TUNE_KB 0
#endif
#ifndef TRT_TUNE_KE
#define TRT_TUNE_KE 0
#endif
#ifndef TRT_TUNE_FRAME_MIN_BLOCKS
#define TRT_TUNE_FRAME_MIN_BLOCKS -1
#endif
// A tuned width, or the shipped one.
constexpr int tuned(int tune, int shipped) { return tune > 0 ? tune : shipped; }
// A form's residency bound (resident blocks an SM; 0: none): a tune build's
// (-DTRT_TUNE_FRAME_MIN_BLOCKS) for the forms of 128-lane blocks, or the
// shipped one.
constexpr int bound(int shipped, int threads) {
  return TRT_TUNE_FRAME_MIN_BLOCKS >= 0 && threads == 128 ? TRT_TUNE_FRAME_MIN_BLOCKS : shipped;
}

constexpr int GROUP_KB_FRAME = tuned(TRT_TUNE_KB, 32);
constexpr int GROUP_KE_FRAME = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KB_FRAME_EXT = tuned(TRT_TUNE_KB, 16);
constexpr int GROUP_KE_FRAME_EXT = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KB_FRAME_XT = tuned(TRT_TUNE_KB, 8);
constexpr int GROUP_KE_FRAME_XT = tuned(TRT_TUNE_KE, 16);
constexpr int GROUP_KB_FRAME_GRID = tuned(TRT_TUNE_KB, 8);
constexpr int GROUP_KE_FRAME_GRID = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KB_FRAME_GATHERED = tuned(TRT_TUNE_KB, 4);
constexpr int GROUP_KE_FRAME_GATHERED = tuned(TRT_TUNE_KE, 16);
constexpr int GROUP_KE_FRAME_SOLO = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KE_FRAME_EXT_SOLO = tuned(TRT_TUNE_KE, 16);
constexpr int GROUP_KE_FRAME_XT_SOLO = tuned(TRT_TUNE_KE, 8);
constexpr int GROUP_KE_FRAME_GRID_SOLO = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KE_FRAME_GATHERED_SOLO = tuned(TRT_TUNE_KE, 8);
// The XT forms within the budget held to 5 resident blocks an SM, as the XT
// kernel A is (tools/group_k.py --only frame: -6 to -25% at fog and
// stress1024 fog mis on the H100, PERF.md §6).
constexpr int FRAME_MIN_BLOCKS_XT = 5;
constexpr int GROUP_KB_FRAME_SPILL = tuned(TRT_TUNE_KB, 32);
constexpr int GROUP_KE_FRAME_SPILL = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KB_FRAME_XT_SPILL = tuned(TRT_TUNE_KB, 32);
constexpr int GROUP_KE_FRAME_XT_SPILL = tuned(TRT_TUNE_KE, 32);
constexpr int GROUP_KB_FRAME_GRID_SPILL = tuned(TRT_TUNE_KB, 32);
constexpr int GROUP_KE_FRAME_GRID_SPILL = tuned(TRT_TUNE_KE, 32);

namespace {

template <int K>
using Sweep = trt::GroupSweep<K>;
template <int K>
using Spill = trt::GroupSpill<K, 256, trt::GROUP_SMEM_MAX>;
template <int K>
using SpillXt = trt::GroupSpill<K, 512, trt::GROUP_SMEM_MAX>;
template <int K>
using Culled = trt::GroupCulled<K, (K > trt::CULL_BLOCK)>;
template <int K>
using CulledSpill = trt::GroupCulledSpill<K, (K > trt::CULL_BLOCK), 256, trt::GROUP_SMEM_MAX>;
template <int K>
using Walk = trt::GroupWalk<K, trt::WALK_L1>;

// A form of the queue entries: its gates, its base and extra items'
// traversals (one staging of the rows serves both) and its residency bound.
template <bool EXT_, bool XT_, class TRB_, class TRE_, int MIN_BLOCKS_ = 0>
struct Form {
  static constexpr bool EXT = EXT_, XT = XT_;
  using TRB = TRB_;
  using TRE = TRE_;
  static constexpr int MIN_BLOCKS = bound(MIN_BLOCKS_, TRB::THREADS);
};
using RefSolo = Form<false, false, Sweep<1>, Sweep<GROUP_KE_FRAME_SOLO>>;
using RefGroup = Form<false, false, Sweep<GROUP_KB_FRAME>, Sweep<GROUP_KE_FRAME>>;
using RefSpill = Form<false, false, Spill<GROUP_KB_FRAME_SPILL>, Spill<GROUP_KE_FRAME_SPILL>>;
using ExtSolo = Form<true, false, Sweep<1>, Sweep<GROUP_KE_FRAME_EXT_SOLO>>;
using ExtGroup = Form<true, false, Sweep<GROUP_KB_FRAME_EXT>, Sweep<GROUP_KE_FRAME_EXT>>;
using ExtSpill = Form<true, false, Spill<GROUP_KB_FRAME_SPILL>, Spill<GROUP_KE_FRAME_SPILL>>;
using XtSolo = Form<true, true, Sweep<1>, Sweep<GROUP_KE_FRAME_XT_SOLO>, FRAME_MIN_BLOCKS_XT>;
using XtGroup =
    Form<true, true, Sweep<GROUP_KB_FRAME_XT>, Sweep<GROUP_KE_FRAME_XT>, FRAME_MIN_BLOCKS_XT>;
using XtSpill =
    Form<true, true, SpillXt<GROUP_KB_FRAME_XT_SPILL>, SpillXt<GROUP_KE_FRAME_XT_SPILL>>;
using GridSolo = Form<true, true, Culled<1>, Culled<GROUP_KE_FRAME_GRID_SOLO>>;
using GridGroup = Form<true, true, Culled<GROUP_KB_FRAME_GRID>, Culled<GROUP_KE_FRAME_GRID>>;
using GridSpill = Form<true, true, CulledSpill<GROUP_KB_FRAME_GRID_SPILL>,
                       CulledSpill<GROUP_KE_FRAME_GRID_SPILL>>;
using WalkSolo = Form<true, true, Walk<1>, Walk<GROUP_KE_FRAME_GATHERED_SOLO>>;
using WalkGroup = Form<true, true, Walk<GROUP_KB_FRAME_GATHERED>, Walk<GROUP_KE_FRAME_GATHERED>>;

// The traversal's launch argument: the Accel of the opt-in traversals (acc),
// none for the table sweeps.
template <class TR>
typename TR::Launch launch_arg(const trt::Accel* acc) {
  typename TR::Launch tl{};
  if constexpr (std::is_same_v<typename TR::Launch, trt::Accel>) tl = *acc;
  return tl;
}

// Kernel C (LS = false) or D (LS = true) on the queue schedule in form F;
// tx, xt, acc: null where the form takes none.
template <class F, bool LS>
int queue(const FrameArgs* a, const trt::Tex* tx, const trt::Xt* xt, const trt::Accel* acc,
          const float* scene_buf, float* out, unsigned* ctl, float* scratch, void* stream) {
  return launch_frame_queue<F::EXT, F::XT, typename F::TRB, typename F::TRE, LS, F::MIN_BLOCKS>(
      a, tx ? *tx : trt::Tex{}, xt ? *xt : trt::Xt{}, scene_buf, out, ctl, scratch, stream,
      launch_arg<typename F::TRB>(acc));
}

// Its resident blocks an SM at the staged rows of `a`.
template <class F, bool LS>
int queue_per_sm(const FrameArgs* a, const trt::Accel* acc) {
  using TRB = typename F::TRB;
  return frame_queue_per_sm<F::EXT, F::XT, TRB, typename F::TRE, LS, F::MIN_BLOCKS>(
      4 * TRB::smem_floats(a->f, launch_arg<TRB>(acc)));
}

}  // namespace
