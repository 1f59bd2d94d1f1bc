// Kernels A and B of the sorted render pipeline over the opt-in traversals
// (traverse.cuh): `--accel grid`, the block-culled sweep, and `--accel
// gathered`, the grid walk.
//
// Replaces terminal_raytracer_tpu/ops/pallas_kernel.py kernel A
// (make_base_kernel / kernel_base, :796) and kernel B (make_extra_kernel /
// kernel_extra, :1028) built over accel.CulledPrims (the pl.when-guarded
// block sweeps and their VMEM scratch, :71-88, :129-141) and over
// gathered.GatheredPrims (the scratch-resident walk loop and its table
// operands, :91-126, :144-180), and kernel A's chunk-major stream (`cb`,
// :749-754, 798-800, 951-970) built over either traversal: neither splits
// a pixel's chain by itself, but an explicit chunk_base does.
//
// One instantiation each, at the XT gate set of pipeline.cuh's kernels:
// XT with every gate off is the reference path bit for bit, so these six
// entry points serve reference, EXT and XT scenes alike (the port builds
// xt tables for both traversals). The culled sweep reads the blocked
// scene and its group table, the walk its grid; trt::Accel carries their
// offsets, the grid's constants and the optional counter buffer.
//
// What bounds them on an H100: as kernel_base.cu / kernel_extra.cu (FP32
// work behind divergent control flow, registers), with fewer primitive
// tests per ray; the walk's loads are dependent (CSR entry, then the
// primitive's row).
//
// trt_kernel_extra_grid_grouped is kernel B over the culled sweep
// redesigned for the H100 (group.cuh GroupCulled): a path group of
// GROUP_K_EXTRA_GRID lanes carries one entry; each window of K groups' box
// tests splits across the lanes, the entered blocks' members split across
// them, and the group replays the serial cull decisions, so its hits and
// traversal counters are Culled's. The blocked scene's rows and its group
// table are staged in shared memory; ops/kernels.py takes it where both
// fit group.cuh's budget. It replaces
// the same Pallas kernel as trt_kernel_extra_grid (:1028 over CulledPrims,
// bound at :1033).
//
// trt_kernel_base_grid and trt_kernel_base_gathered, one thread a pixel
// (they serve scenes below GROUP_BASE_MIN_PRIMS primitives under --accel
// grid and --accel gathered: Cornell_Box and the packaged extension
// scenes), run the regeneration schedule (pipeline.cuh launch_base_regen
// over trace.cuh run_samples_regen: one bounce a loop trip, a lane starting
// its next sample on the trip after its path ends, as the TPU kernel's
// stream_step), held to GRID_MIN_BLOCKS and GATHERED_MIN_BLOCKS resident
// blocks an SM. The nested sample and bounce loops that they replaced stay
// as trt_kernel_base_grid_nested (held to GRID_NESTED_MIN_BLOCKS, as the
// parent shipped it) and trt_kernel_base_gathered_nested, launched by
// chip_smoke.py and the sweep alone: the same arguments and outputs, and
// the same sweeps and walks, so the same traversal counters (flushed once a
// thread, after the loop), bit for bit (at max_depth >= 1: at max_depth 0
// the regeneration schedule bounces each path once, as the plain version
// does, and the nested loops none).
//
// trt_kernel_base_grid_grouped is kernel A over the culled sweep redesigned
// the same way (group.cuh kernel_base_grouped over GroupCulled<GROUP_K_BASE_GRID,
// GROUP_WIDE_BASE_GRID>, the schedule GROUP_REFILL_BASE_GRID): a path group
// carries one pixel, the serial cull decisions replayed, the counters
// Culled's. It replaces the same Pallas kernel as trt_kernel_base_grid
// (:796 over CulledPrims, bound at :809).
//
// trt_kernel_extra_grid_grouped_spill and trt_kernel_base_grid_grouped_spill
// are the two for tables of any size (group.cuh GroupCulledSpill: the group
// table, then the rows, as far as they fit a 227 KB stage, the rest read
// through L1; the same decisions, hits and counters); ops/kernels.py takes
// them where the rows and the group table exceed the budget (kernel A from
// GROUP_BASE_MIN_PRIMS primitives on), so trt_kernel_extra_grid serves no
// dispatch and trt_kernel_base_grid only scenes below that count.
//
// trt_kernel_base_chunked_grid_grouped is the chunked kernel A over the
// culled sweep redesigned the same way (group.cuh
// kernel_base_chunked_grouped over GroupCulled<GROUP_K_CHUNKED_GRID,
// GROUP_WIDE_CHUNKED_GRID>): a path group carries one chunk-major entry,
// the serial cull decisions replayed, the counters Culled's; and
// trt_kernel_base_chunked_grid_grouped_spill its form for tables of any
// size (ChunkedGridSpill, GroupCulledSpill). ops/kernels.py takes them for
// every `--accel grid` tracer with a chunk split (the spill form where the
// rows and group table exceed the budget), so trt_kernel_base_chunked_grid
// serves no dispatch. They replace the same Pallas kernel as
// trt_kernel_base_chunked_grid (the chunk-major stream, :749-754, 798-800,
// 951-970, over CulledPrims, bound at :809).
//
// trt_kernel_extra_gathered_grouped is kernel B over the grid walk
// redesigned for the H100 (group.cuh GroupWalk): a path group of
// GROUP_K_EXTRA_GATHERED lanes carries one entry; every lane makes the
// walk's DDA decisions, and each cell's bucket is tested a window of K
// entries at a time, reduced in bucket order, so its hits and traversal
// counters are Walk's. It serves every table size, and ops/kernels.py
// takes it for every `--accel gathered` tracer. It replaces the same
// Pallas kernel as trt_kernel_extra_gathered (:1028 over GatheredPrims,
// bound at :1032).
//
// trt_kernel_base_gathered_grouped is kernel A over the grid walk
// redesigned the same way (group.cuh kernel_base_grouped over
// GroupWalk<GROUP_K_BASE_GATHERED, GROUP_SRC_BASE_GATHERED>, the schedule
// GROUP_REFILL_BASE_GATHERED): a path group carries one pixel, the walk's
// hits and counters Walk's. It serves every table size; ops/kernels.py
// takes it for an `--accel gathered` scene of at least GROUP_BASE_MIN_PRIMS
// primitives. It replaces the same Pallas kernel as trt_kernel_base_gathered
// (:796 over GatheredPrims, the walk loop at :91-126, bound at :808).
//
// trt_kernel_base_chunked_gathered_grouped is the chunked kernel A over the
// grid walk redesigned the same way (group.cuh kernel_base_chunked_grouped
// over GroupWalk<GROUP_K_CHUNKED_GATHERED, GROUP_SRC_CHUNKED_GATHERED>): a
// path group carries one chunk-major entry, the walk's hits and counters
// Walk's. It serves every table size; ops/kernels.py takes it for every
// `--accel gathered` tracer with a chunk split, so
// trt_kernel_base_chunked_gathered serves no dispatch. It replaces the same
// Pallas kernel as trt_kernel_base_chunked_gathered (the chunk-major
// stream, :749-754, 798-800, 951-970, over GatheredPrims, the walk loop at
// :91-126, bound at :808).

#include "group.cuh"

// The resident blocks an SM that the nested twin of the grid kernel A's
// thread per pixel (trt_kernel_base_grid_nested) is held to, as the parent
// shipped it (pipeline.cuh kernel_base_resident): chosen by tools/group_k.py --only grid
// at the north star under --accel grid (Cornell_Box 400x200, 16 spp, depth
// 32; ms, H100 80GB HBM3 at 700 W, twice in turns): unbound 2.516 / 2.528
// (128 registers, 4 blocks an SM), 4 2.530 / 2.514, 5 2.199 / 2.199 (96
// registers, 360 B of spill stores, 0.95 waves), 6 2.308 / 2.311.
constexpr int GRID_NESTED_MIN_BLOCKS = 5;
// The loop and residency bound of the grid kernel A's thread per pixel
// (pipeline.cuh launch_base_regen): chosen by tools/group_k.py --only regen
// --gates grid, the least summed time over the configurations where it
// serves, each under --accel grid (the north star, shipped, ascii 80x40,
// fog, the five packaged extension scenes; PERF.md, the XT and grid sweep;
// ms of device time, twice in turns, H100 80GB HBM3 at 700 W). Summed: the
// regeneration
// schedule held to 5 blocks an SM 11.925 / 11.947 (96 registers, 336 B of
// spill stores, 0.95 waves at 400x200), to 6 13.065 / 12.939, unbound
// 14.834 / 14.832 (128 registers, 1.18 waves); the refill form at best
// 12.305 / 12.298 (held to 5); the nested loops held to 5, as the parent
// shipped them (trt_kernel_base_grid_nested), 13.907 / 13.885, unbound
// 17.300 / 17.313. At the north star 1.730 / 1.683 against the parent's
// 2.260 / 2.173. Unbound, the regeneration schedule is 10-12% faster at
// showcase and envmap (0.705 / 0.711 against 0.782 / 0.776; 0.242 / 0.242
// against 0.272 / 0.269), slower by more everywhere the paths run long.
constexpr bool GRID_REFILL = false;
constexpr int GRID_MIN_BLOCKS = 5;

// The resident blocks an SM that the gathered kernel A's thread per pixel
// is held to (pipeline.cuh launch_base_regen): chosen by tools/group_k.py
// --only regen --gates gathered, the least summed time over the
// configurations where it serves, each under --accel gathered (the north
// star, its sp = 3 share 2, shipped, ascii 80x40, scene2, fog, the five
// packaged extension scenes, Cornell_Box 100x50; ms of device time, twice
// in turns, H100 80GB HBM3 at 700 W). Summed: the regeneration schedule
// held to 6 blocks 17.287 / 17.336 (80 registers, 460 B of spill stores,
// 0.79 waves at 400x200), to 5 17.475 / 17.569, unbound 21.700 / 21.705
// (128 registers, 4 blocks an SM, 1.18 waves); the refill form at best
// 17.561 / 17.566 (held to 6); the nested loops at best 19.727 / 19.478
// (held to 6) and 24.200 / 24.224 unbound, as the parent shipped them.
// At the north star 1.991 / 1.979 against the parent's 2.929 / 2.933; at
// Cornell_Box 100x50 0.573 / 0.573 against 0.526 / 0.526 (the spills cost
// more than the trips save where 40 blocks leave the wave count at one).
constexpr int GATHERED_MIN_BLOCKS = 6;

// The group width of the grouped grid kernel B and its design (group.cuh
// GroupCulled: WIDE sweeps K / 8 candidate blocks a step): chosen by the
// sweep over K of tools/group_k.py (PERF.md, the grouped kernels).
constexpr int GROUP_K_EXTRA_GRID = 32;
constexpr bool GROUP_WIDE_EXTRA_GRID = true;
// The same for the grouped grid kernel A, with its schedule (true: refill):
// chosen by the sweep over K, the design and the schedule at stress1024 and
// mesh1280 under --accel grid (the least summed time; PERF.md).
constexpr int GROUP_K_BASE_GRID = 32;
constexpr bool GROUP_WIDE_BASE_GRID = false;
constexpr bool GROUP_REFILL_BASE_GRID = true;
// Their forms for tables over the budget (group.cuh GroupCulledSpill<K,
// WIDE, block width, stage cap>) and kernel A's schedule there: chosen by
// the sweep of tools/group_k.py --only grid at mesh5120 and icosphere:5
// under --accel grid, 200x100, 8 spp, depth 6, the least summed time
// (PERF.md; ms at mesh5120 / icosphere:5, H100 80GB HBM3 at 700 W). B:
// thread per entry 5.863 / 18.316; K 8 1.275 / 4.270; K 16 wide 0.602 /
// 1.693; K 32 wide at 256 lanes 0.272 / 0.609, at 512 0.279 / 0.669, K 32
// one block a step 0.288 / 0.636. A: thread per pixel 6.112 / 20.963; K 32
// wide at 512 lanes, refill 0.701 / 1.642, static 0.828 / 1.928; K 32 one
// block a step at 512, refill 0.721 / 1.673; every form at 256 lanes
// slower, and K 8 and 16 slower still. Within the budget (stress1024,
// mesh1280) every form is slower than GroupCulled (B by 23-28%, A by
// 3-6%), which keeps those tables.
using ExtraGridSpill = trt::GroupCulledSpill<32, true, 256, trt::GROUP_SMEM_MAX>;
using BaseGridSpill = trt::GroupCulledSpill<32, true, 512, trt::GROUP_SMEM_MAX>;
constexpr bool GROUP_REFILL_BASE_GRID_SPILL = true;
// The group width and design of the grouped chunked grid kernel A
// (GroupCulled, 128 lanes a block) within the budget, and its form over the
// budget (GroupCulledSpill<K, WIDE, block width, stage cap>): chosen by the
// sweep of tools/group_k.py --only grid --a-only at stress1024 and mesh1280
// grid (within) and mesh5120 and icosphere:5 grid (over), 200x100, 8 spp,
// depth 6, chunks of 2, the least summed time (PERF.md, the grouped chunked
// grid kernel A; ms, H100 80GB HBM3 at 700 W). Within: thread per entry 1.674 / 1.225; K 16 wide
// 0.715 / 0.394, K 8 0.673 / 0.447, K 16 narrow 0.731 / 0.417, K 32
// narrow 0.830 / 0.427, wide 0.862 / 0.455. Over: thread per entry 3.252
// / 11.374; K 32 narrow at 512 lanes 0.951 / 1.945, wide 1.040 / 2.135;
// K 16 at 512 lanes 1.001-1.030 / 2.771-2.779; K 8 1.377 / 4.504; every
// form at 256 lanes 1.77-2.10 / 3.66-6.44.
constexpr int GROUP_K_CHUNKED_GRID = 16;
constexpr bool GROUP_WIDE_CHUNKED_GRID = true;
using ChunkedGridSpill = trt::GroupCulledSpill<32, false, 512, trt::GROUP_SMEM_MAX>;
// The group width and row source of the grouped gathered kernel B (group.cuh
// GroupWalk, 128 lanes a block): chosen by the sweep of tools/group_k.py
// --only walk at 200x100, 8 spp, depth 6 (PERF.md, the grouped gathered
// kernel B; ms at stress1024 / mesh1280 / mesh5120, H100 80GB HBM3 at
// 700 W). Thread per entry 1.166 / 0.826 / 1.288; rows and CSR through
// L1 at K = 2 0.845 / 0.573 / 0.844, 4 0.519 / 0.384 / 0.551, 8 0.348 /
// 0.265 / 0.347, 16 0.258 / 0.185 / 0.245; the rows staged 1-23% slower
// at every K; the CSR and rows staged within 5% of L1 (K = 16 0.248 /
// 0.190 / 0.263) at 165 registers. A second run (--ks 16,32): K = 16 L1
// 0.260 / 0.184 / 0.248, K = 32 L1 0.221 / 0.159 / 0.195 (CSR and rows
// staged 0.213 / 0.155 / 0.228 at 157 registers): the working warps (231
// → 461 at stress1024) outweigh the lanes a short bucket leaves idle. L1
// stages nothing and serves every size.
constexpr int GROUP_K_EXTRA_GATHERED = 32;
using ExtraWalk = trt::GroupWalk<GROUP_K_EXTRA_GATHERED, trt::WALK_L1>;
// The same for the grouped gathered kernel A, with its schedule (true:
// refill): chosen by the sweep of tools/group_k.py --only walk at 200x100,
// 8 spp, depth 6, the least summed time (PERF.md, the grouped gathered
// kernel A; ms at stress1024 / mesh1280 / mesh5120, H100 80GB HBM3 at
// 700 W). Thread per pixel 1.186 / 0.984 / 1.629; rows and CSR through
// L1, static, K = 4 0.596 / 0.414 / 0.602 (a second run), K = 8 0.483 /
// 0.292 / 0.385, K = 16 0.597 / 0.297 / 0.331, K = 32 0.787 / 0.302 /
// 0.368; on the refill schedule 5-9% slower at K = 8 (0.525 / 0.307 /
// 0.413), within 7% either way at K = 16 and 32; the rows staged, or the
// CSR and rows, slower at every K and schedule (up to 7.6x at mesh5120,
// whose rows take the stage). At Cornell_Box (11 primitives) the thread
// per pixel 0.586 against 1.197 at best: ops/kernels.py
// GROUP_BASE_MIN_PRIMS keeps it there.
constexpr int GROUP_K_BASE_GATHERED = 8;
constexpr int GROUP_SRC_BASE_GATHERED = trt::WALK_L1;
constexpr bool GROUP_REFILL_BASE_GATHERED = false;
using BaseWalk = trt::GroupWalk<GROUP_K_BASE_GATHERED, GROUP_SRC_BASE_GATHERED>;
// The group width and row source of the grouped chunked gathered kernel A
// (group.cuh GroupWalk, 128 lanes a block): chosen by the sweep of
// tools/group_k.py --only walk --a-only at stress1024, mesh1280 and
// mesh5120 gathered, 200x100, 8 spp, depth 6, chunks of 2, the least
// summed time of two runs in turns (PERF.md, the grouped chunked gathered
// kernel A; ms at stress1024 / mesh1280 / mesh5120, run 1, H100 80GB HBM3
// at 700 W). Thread per entry 0.645 / 0.539 / 0.908; rows and CSR through
// L1 at K = 4 0.446 / 0.240 / 0.377, K = 8 0.454 / 0.214 / 0.277 (summed
// 0.945, 0.958 in run 2), K = 16 0.569 / 0.242 / 0.289, K = 32 0.790 /
// 0.297 / 0.371; the rows staged, or the CSR and rows, at K = 4 and 8
// 1.1-5.2x slower (mesh5120's rows take the stage). A form chosen by the
// table's size gained 0.8% and 2.3% over K = 8 alone: under the 5% rule.
constexpr int GROUP_K_CHUNKED_GATHERED = 8;
constexpr int GROUP_SRC_CHUNKED_GATHERED = trt::WALK_L1;
using ChunkedWalk = trt::GroupWalk<GROUP_K_CHUNKED_GATHERED, GROUP_SRC_CHUNKED_GATHERED>;

// out: f32 [9, h_out*w] (csum rgb, csumsq rgb, rays, var, additional);
// state_out: int64 [h_out*w]; iters: one zeroed u64; acc: the traversal's
// launch argument. Returns cudaGetLastError().
// Kernel A over the culled sweep, one thread a pixel on the regeneration
// schedule (pipeline.cuh kernel_base_regen[_resident]), held to
// GRID_MIN_BLOCKS.
extern "C" int trt_kernel_base_grid(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                    const trt::Accel* acc, const float* scene_buf, float* out,
                                    long long* state_out, unsigned long long* iters,
                                    void* stream) {
  return launch_base_regen<true, true, trt::Culled, GRID_REFILL, GRID_MIN_BLOCKS>(
      a, *tx, *xt, scene_buf, out, state_out, iters, nullptr, stream, *acc);
}

// Its residency bound (blocks an SM; 0: none).
extern "C" int trt_kernel_base_grid_min_blocks() { return GRID_MIN_BLOCKS; }

// Its nested twin (pipeline.cuh kernel_base_resident over trace.cuh
// run_samples), the loops it replaced, held to GRID_NESTED_MIN_BLOCKS: the
// same arguments and outputs.
extern "C" int trt_kernel_base_grid_nested(const BaseArgs* a, const trt::Tex* tx,
                                           const trt::Xt* xt, const trt::Accel* acc,
                                           const float* scene_buf, float* out,
                                           long long* state_out, unsigned long long* iters,
                                           void* stream) {
  return launch_base<true, true, trt::Culled, GRID_NESTED_MIN_BLOCKS>(
      a, *tx, *xt, scene_buf, out, state_out, iters, stream, *acc);
}

// Kernel A over the walk, one thread a pixel on the regeneration schedule
// (pipeline.cuh kernel_base_regen[_resident]), held to GATHERED_MIN_BLOCKS.
extern "C" int trt_kernel_base_gathered(const BaseArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                        const trt::Accel* acc, const float* scene_buf, float* out,
                                        long long* state_out, unsigned long long* iters,
                                        void* stream) {
  return launch_base_regen<true, true, trt::Walk, false, GATHERED_MIN_BLOCKS>(
      a, *tx, *xt, scene_buf, out, state_out, iters, nullptr, stream, *acc);
}

// Its residency bound (blocks an SM; 0: none).
extern "C" int trt_kernel_base_gathered_min_blocks() { return GATHERED_MIN_BLOCKS; }

// Its nested twin (pipeline.cuh kernel_base over trace.cuh run_samples),
// the loops it replaced: the same arguments and outputs.
extern "C" int trt_kernel_base_gathered_nested(const BaseArgs* a, const trt::Tex* tx,
                                               const trt::Xt* xt, const trt::Accel* acc,
                                               const float* scene_buf, float* out,
                                               long long* state_out,
                                               unsigned long long* iters, void* stream) {
  return launch_base<true, true, trt::Walk>(a, *tx, *xt, scene_buf, out, state_out, iters, stream,
                                            *acc);
}

// out: f32 [7, n_chunks*h_out*w] (csum rgb, csumsq rgb, rays), chunk-major;
// state_out: int64 [n_chunks*h_out*w]; iters: one zeroed u64; acc: the
// traversal's launch argument. Returns cudaGetLastError().
extern "C" int trt_kernel_base_chunked_grid(const ChunkArgs* a, const trt::Tex* tx,
                                            const trt::Xt* xt, const trt::Accel* acc,
                                            const float* scene_buf, float* out,
                                            long long* state_out, unsigned long long* iters,
                                            void* stream) {
  return launch_chunked<true, true, trt::Culled>(a, *tx, *xt, scene_buf, out, state_out, iters,
                                                 stream, *acc);
}

extern "C" int trt_kernel_base_chunked_gathered(const ChunkArgs* a, const trt::Tex* tx,
                                                const trt::Xt* xt, const trt::Accel* acc,
                                                const float* scene_buf, float* out,
                                                long long* state_out,
                                                unsigned long long* iters, void* stream) {
  return launch_chunked<true, true, trt::Walk>(a, *tx, *xt, scene_buf, out, state_out, iters,
                                               stream, *acc);
}

// xs, ys, samp0: int32 [n]; state_in: int64 [n]; add: f32 [n];
// out: f32 [4, n] (esum rgb, rays); iters: one zeroed u64; acc: the
// traversal's launch argument. Returns cudaGetLastError().
extern "C" int trt_kernel_extra_grid(const ExtraArgs* a, const trt::Tex* tx, const trt::Xt* xt,
                                     const trt::Accel* acc, const float* scene_buf, const int* xs,
                                     const int* ys, const long long* state_in, const float* add,
                                     const int* samp0, float* out, unsigned long long* iters,
                                     void* stream) {
  return launch_extra<true, true, trt::Culled>(a, *tx, *xt, scene_buf, xs, ys, state_in, add,
                                               samp0, out, iters, stream, *acc);
}

extern "C" int trt_kernel_extra_gathered(const ExtraArgs* a, const trt::Tex* tx,
                                         const trt::Xt* xt, const trt::Accel* acc,
                                         const float* scene_buf, const int* xs, const int* ys,
                                         const long long* state_in, const float* add,
                                         const int* samp0, float* out,
                                         unsigned long long* iters, void* stream) {
  return launch_extra<true, true, trt::Walk>(a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0,
                                             out, iters, stream, *acc);
}

// The grouped kernel B over the culled sweep: the same arguments and
// outputs as trt_kernel_extra_grid; refused (cudaErrorInvalidValue) when
// the rows and the group table exceed the shared-memory budget.
extern "C" int trt_kernel_extra_grid_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                             const trt::Xt* xt, const trt::Accel* acc,
                                             const float* scene_buf, const int* xs,
                                             const int* ys, const long long* state_in,
                                             const float* add, const int* samp0, float* out,
                                             unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true,
                              trt::GroupCulled<GROUP_K_EXTRA_GRID, GROUP_WIDE_EXTRA_GRID>>(
      a, *tx, *xt, scene_buf, xs, ys, state_in, add, samp0, out, iters, stream, *acc);
}

extern "C" int trt_kernel_extra_grid_grouped_k() { return GROUP_K_EXTRA_GRID; }

// The grouped kernel A over the culled sweep: the same arguments and
// outputs as trt_kernel_base_grid, and `next`, one zeroed u32 (the refill
// schedule's pixel counter); refused (cudaErrorInvalidValue) when the rows
// and the group table exceed the shared-memory budget.
extern "C" int trt_kernel_base_grid_grouped(const BaseArgs* a, const trt::Tex* tx,
                                            const trt::Xt* xt, const trt::Accel* acc,
                                            const float* scene_buf, float* out,
                                            long long* state_out, unsigned long long* iters,
                                            unsigned* next, void* stream) {
  return launch_base_grouped<true, true,
                             trt::GroupCulled<GROUP_K_BASE_GRID, GROUP_WIDE_BASE_GRID>,
                             GROUP_REFILL_BASE_GRID>(a, *tx, *xt, scene_buf, out, state_out,
                                                     iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_grid_grouped_k() { return GROUP_K_BASE_GRID; }
extern "C" int trt_kernel_base_grid_grouped_refill() { return GROUP_REFILL_BASE_GRID; }

// The grouped kernels B and A over the culled sweep for tables of any size
// (group.cuh GroupCulledSpill): the arguments of trt_kernel_extra_grid_grouped
// and trt_kernel_base_grid_grouped.
extern "C" int trt_kernel_extra_grid_grouped_spill(const ExtraArgs* a, const trt::Tex* tx,
                                                   const trt::Xt* xt, const trt::Accel* acc,
                                                   const float* scene_buf, const int* xs,
                                                   const int* ys, const long long* state_in,
                                                   const float* add, const int* samp0,
                                                   float* out, unsigned long long* iters,
                                                   void* stream) {
  return launch_extra_grouped<true, true, ExtraGridSpill>(a, *tx, *xt, scene_buf, xs, ys,
                                                          state_in, add, samp0, out, iters,
                                                          stream, *acc);
}

extern "C" int trt_kernel_extra_grid_grouped_spill_k() { return ExtraGridSpill::K; }
extern "C" int trt_kernel_extra_grid_grouped_spill_cap() { return ExtraGridSpill::SMEM_CAP; }

extern "C" int trt_kernel_base_grid_grouped_spill(const BaseArgs* a, const trt::Tex* tx,
                                                  const trt::Xt* xt, const trt::Accel* acc,
                                                  const float* scene_buf, float* out,
                                                  long long* state_out,
                                                  unsigned long long* iters, unsigned* next,
                                                  void* stream) {
  return launch_base_grouped<true, true, BaseGridSpill, GROUP_REFILL_BASE_GRID_SPILL>(
      a, *tx, *xt, scene_buf, out, state_out, iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_grid_grouped_spill_k() { return BaseGridSpill::K; }
extern "C" int trt_kernel_base_grid_grouped_spill_cap() { return BaseGridSpill::SMEM_CAP; }
extern "C" int trt_kernel_base_grid_grouped_spill_refill() {
  return GROUP_REFILL_BASE_GRID_SPILL;
}

// The grouped chunked kernel A over the culled sweep: the same arguments
// and outputs as trt_kernel_base_chunked_grid; refused
// (cudaErrorInvalidValue) when the rows and the group table exceed the
// shared-memory budget.
extern "C" int trt_kernel_base_chunked_grid_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                    const trt::Xt* xt, const trt::Accel* acc,
                                                    const float* scene_buf, float* out,
                                                    long long* state_out,
                                                    unsigned long long* iters, void* stream) {
  return launch_chunked_grouped<true, true,
                                trt::GroupCulled<GROUP_K_CHUNKED_GRID, GROUP_WIDE_CHUNKED_GRID>>(
      a, *tx, *xt, scene_buf, out, state_out, iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_grid_grouped_k() { return GROUP_K_CHUNKED_GRID; }

// The grouped chunked kernel A over the culled sweep for tables of any size
// (group.cuh GroupCulledSpill): the arguments of
// trt_kernel_base_chunked_grid_grouped.
extern "C" int trt_kernel_base_chunked_grid_grouped_spill(const ChunkArgs* a, const trt::Tex* tx,
                                                          const trt::Xt* xt,
                                                          const trt::Accel* acc,
                                                          const float* scene_buf, float* out,
                                                          long long* state_out,
                                                          unsigned long long* iters,
                                                          void* stream) {
  return launch_chunked_grouped<true, true, ChunkedGridSpill>(a, *tx, *xt, scene_buf, out,
                                                              state_out, iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_grid_grouped_spill_k() { return ChunkedGridSpill::K; }
extern "C" int trt_kernel_base_chunked_grid_grouped_spill_cap() {
  return ChunkedGridSpill::SMEM_CAP;
}

// The grouped chunked kernel A over the grid walk: the same arguments and
// outputs as trt_kernel_base_chunked_gathered, at any table size.
extern "C" int trt_kernel_base_chunked_gathered_grouped(const ChunkArgs* a, const trt::Tex* tx,
                                                        const trt::Xt* xt,
                                                        const trt::Accel* acc,
                                                        const float* scene_buf, float* out,
                                                        long long* state_out,
                                                        unsigned long long* iters,
                                                        void* stream) {
  return launch_chunked_grouped<true, true, ChunkedWalk>(a, *tx, *xt, scene_buf, out, state_out,
                                                         iters, stream, *acc);
}

extern "C" int trt_kernel_base_chunked_gathered_grouped_k() { return ChunkedWalk::K; }

// The grouped kernel B over the grid walk: the same arguments and outputs
// as trt_kernel_extra_gathered, at any table size.
extern "C" int trt_kernel_extra_gathered_grouped(const ExtraArgs* a, const trt::Tex* tx,
                                                 const trt::Xt* xt, const trt::Accel* acc,
                                                 const float* scene_buf, const int* xs,
                                                 const int* ys, const long long* state_in,
                                                 const float* add, const int* samp0, float* out,
                                                 unsigned long long* iters, void* stream) {
  return launch_extra_grouped<true, true, ExtraWalk>(a, *tx, *xt, scene_buf, xs, ys, state_in,
                                                     add, samp0, out, iters, stream, *acc);
}

extern "C" int trt_kernel_extra_gathered_grouped_k() { return ExtraWalk::K; }

// The grouped kernel A over the grid walk: the same arguments and outputs
// as trt_kernel_base_gathered, and `next`, one zeroed u32 (the refill
// schedule's pixel counter), at any table size.
extern "C" int trt_kernel_base_gathered_grouped(const BaseArgs* a, const trt::Tex* tx,
                                                const trt::Xt* xt, const trt::Accel* acc,
                                                const float* scene_buf, float* out,
                                                long long* state_out,
                                                unsigned long long* iters, unsigned* next,
                                                void* stream) {
  return launch_base_grouped<true, true, BaseWalk, GROUP_REFILL_BASE_GATHERED>(
      a, *tx, *xt, scene_buf, out, state_out, iters, next, stream, *acc);
}

extern "C" int trt_kernel_base_gathered_grouped_k() { return BaseWalk::K; }
extern "C" int trt_kernel_base_gathered_grouped_refill() { return GROUP_REFILL_BASE_GATHERED; }
