#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (terminal_raytracer_tpu_torch) on
one NVIDIA GPU. Run from the repository root:  python3 chip_smoke.py

Phases, each reported on lines starting with its tag:

  [device]  torch must see a CUDA GPU; nvidia-smi's name, power limit and
            maximum SM clock (the FP32 peak of the bounds below)
  [build]   every CUDA source built from csrc/ with nvcc, one process per
            source, all at once (seconds, ptxas registers and spills)
  [kernel_base]   kernel A against its plain PyTorch version on the card
            in both forms, the thread-per-pixel entry, which the wrapper
            takes for Cornell_Box's 11 primitives, and the grouped entry
            (csrc/group.cuh kernel_base_grouped): Cornell_Box 128x16, 16
            spp, seed 42, frame 0, depth 8 and 3. Owed rays, adaptive
            budgets, variance, end RNG states and the bits of csum and
            csumsq must be equal; both timed
  [kernel_extra]  kernel B against its plain version on the budget-sorted
            stream built from the depth-8 output, in both forms: the
            grouped entry (csrc/group.cuh), which the wrapper takes, and
            the thread-per-entry entry, each bit for bit (rays, esum bits,
            maxrel 0) with its executed lane-iterations equal to the plain
            model at its group width; then both forms of kernel A and of B
            held against and timed beside their plain versions at the
            north-star shapes, and both forms of A at stress256 (where the
            wrapper takes the grouped one), with K, the working warps, the
            longest
            entry's iterations and µs an iteration, the staged rows' bytes
            and the entry the wrapper takes; kernel A also with its
            schedule (static or refill), both forms' lane-iterations (the
            static one's equal to the plain model at K, the refill one's at
            least the pixels' summed iterations) and both forms' occupancy
  [kernel_base_chunked]  the same for the chunked kernel A on
            stress:120:7 at 64x16, 8 spp, depth 6, chunks of 2 (rays, end
            states, per-pixel totals and radiance bits equal) and at the
            stress1024 shapes, and one stress1024 frame with and without
            the chunk split
  [thread]  tables over the grouped kernels' shared-memory budget:
            at mesh5120 (icosphere:4, 5120 triangles, 240 KB of rows) the
            GroupSpill forms of kernel B and the chunked kernel A, which
            the wrappers take, and in fog those of the XT kernel B and the
            chunked XT kernel A, each beside the thread-per-entry entry,
            launched directly; the GroupCulledSpill forms of the grid
            kernels A and B at mesh5120 under grid, which the wrappers
            take, beside the thread per pixel / entry, launched directly:
            bit for bit against their plain versions (lane-iterations the
            plain model's; grid: traversal counters equal), timed, and the
            mesh5120 grid frame through either pair in turns; then the
            GroupSpill forms of the split-point libraries
            (csrc/group_tune.cu at stage caps of 0 and 168 bytes) on
            Cornell_Box, icosphere:1 and stress:64, plain and (B and the
            chunked A at the XT gates) in fog under --mis, and their
            GroupCulledSpill forms under grid, bit for bit
  [main]    the main path through Engine at Cornell_Box 400x200: 16 spp
            depth 32 (north star), 128 spp depth 3 (shipped), and 80x40
            1 spp depth 4 in ASCII (the base >= spp path), plus one
            cli.main run; the north-star frame must agree with the plain
            version (rays, samples, radiance within 5e-3)
  [scale]   the many-primitive and animated path through Engine at the
            JAX package's bench configurations stress1024, mesh1280,
            stress256, dynamic1024 and dynamic, and at mesh5120
            (icosphere:4, whose rows exceed the grouped kernels' shared-
            memory budget: the GroupSpill forms); the device busy share
            and device time by kernel of profiled north-star, stress1024,
            mesh1280 and mesh5120 frames, and their sorted frames through
            the grouped and the thread-per-entry kernels in turns
            (the north star and stress256 also with kernel A alone in
            either form); then one stress1024 frame
            and one animated frame at t > 0 (dynamic1024, and Cornell at
            128x32) against the plain pipeline on the card, on the same
            per-frame scene buffer: rays, samples and variance equal,
            radiance within 5e-3
  [ext]     the material and texture extensions (EXT kernels): each EXT
            kernel against its plain version on the five packaged
            extension scenes at 128x64 (their own spp and depth; envmap
            with a brighter sky so that kernel B has work), textured
            bilinear, and the chunked EXT kernel A (rays, budgets, states
            equal; radiance within 5e-3); the EXT kernels on Cornell_Box
            against the reference kernels, bit for bit; Engine at each
            extension scene's full size, at stress:1024 with a checker
            floor (chunked), at icosphere:4 with a checker floor (rows
            over the budget: the GroupSpill form of the EXT kernel B) and
            at showcase --animate orbit, and the device busy share of a
            profiled showcase and textured run; an animated showcase
            frame against the plain pipeline; cli.main on showcase; then
            each EXT kernel against its plain version at the main path's
            shapes (the five scenes at 400x200, the checker stress:1024
            at 200x100), kernel B and the chunked kernel A in both forms
            (the grouped entry, which the wrapper takes, and the thread
            per entry), bit for bit with their lane-iterations the plain
            model's, timed side by side at the showcase, textured (B) and
            checker stress:1024 shapes and, their GroupSpill forms, at the
            checker icosphere:4 shapes; the showcase sorted frame through
            both forms of B, and the checker icosphere:4 frame through
            both forms of every kernel, in turns; kernel A at the EXT
            gates in both forms (the grouped entry, which the wrapper
            takes from 16 primitives on, and the thread per pixel) at the
            checker stress:256 and stress:64 (200x100, 8 spp, depth 6),
            bit for bit with their lane-iterations, timed side by side,
            Engine through both scenes, and the checker stress:256 frame
            with kernel A in either form, in turns
  [xt]      the transport and camera extensions (XT kernels): each XT
            kernel against its plain version at the main path's shapes:
            the JAX bench's fog (Cornell_Box 400x200, 16 spp, depth 32,
            fog 0.15), stratified and manylights_one (lights:16, power)
            configurations, a depth-of-field Cornell (aperture 0.1, focus
            3), showcase --mis, and the chunked XT kernel A on stress:1024
            in fog under --mis (rays, budgets, states equal; radiance
            within 5e-3; the chunked XT kernel A and kernel B, on a stream
            with work, in both forms: the grouped entry, which the wrapper
            takes, and the thread-per-entry entry, each bit for bit, and
            at fog, manylights_one and stress:1024 fog --mis B's
            lane-iterations, at stress:1024 fog --mis the chunked A's,
            equal to the plain model at their group widths); the XT
            kernels on Cornell_Box with every gate off against the
            reference kernels, bit for bit; Engine through each of those,
            through manylights (every light, the reference kernels) and
            through mesh5120 in fog (rows over the grouped kernels'
            budget: the GroupSpill forms of the XT kernel B and chunked
            XT kernel A); the fog and mesh5120 fog frames through both
            forms of every kernel in turns, the latter profiled first;
            cli.main with --mis --fog; the XT kernels, both forms of B and
            of the chunked A, timed at the fog and stress:1024 shapes
  [accel]   the opt-in traversals (csrc/kernel_accel.cu): each grid and
            gathered kernel against its plain version at the JAX bench's
            stress1024 shapes (200x100, 8 spp, depth 6; gathered also at
            mesh1280, icosphere:3), bit for bit (rays, budgets, states,
            radiance; kernel B on a stream with budgeted entries), with the
            kernels' traversal counters (blocks swept and culled; walks,
            tests, advances, walks at the trip cap, which must be 0) equal
            to the plain version's count, timed there; the grid kernel B
            in both forms (the grouped entry, which the wrapper takes, and
            the thread-per-entry entry) bit for bit, both counters equal
            to the plain version's, both lane-iterations equal to the
            plain model, timed side by side; the gathered kernel B
            likewise (the grouped entry over csrc/group.cuh GroupWalk, at
            stress1024 and mesh1280); the grid and gathered kernel A
            likewise in both forms (grouped, which the wrapper takes, and
            thread per pixel; the grouped entry's counters also against
            the thread per pixel's), with its schedule and occupancy;
            Engine at stress256,
            stress1024 and mesh1280 under baked, auto (array), grid and
            gathered, at mesh5120 under grid (rows over the grouped
            kernels' budget: the GroupCulledSpill forms of kernels A and
            B), and at the north star under grid
            (too few primitives for the grouped kernel A, whose
            thread-per-pixel entry, held to 5 resident blocks an SM, is
            then held bit for bit and timed there beside its unbound
            form), with each traversal's counters over the warm-up frame;
            the
            stress1024 grid, stress1024 gathered and mesh1280 gathered
            frames through both forms of every kernel, and of kernel A
            alone, in turns;
            cli.main with --accel grid and
            --accel gathered; the chunked grid kernel A at chunks of 2 at
            stress1024 and mesh5120 (rows and group table over the
            budget: its GroupCulledSpill form) in both forms (the grouped
            entry, which the wrapper takes, and the thread per entry),
            bit for bit, both counters equal to the plain version's and
            to each other, timed in turns, and the sorted main path at
            both shapes; the chunked gathered kernel A in both forms at
            chunks of 2 at stress1024 and mesh1280 (its grouped entry over
            csrc/group.cuh GroupWalk, which the wrapper takes at every
            size, and the thread per entry), bit for bit, both counters
            equal, timed in turns (its main-path launches come from
            [sched]); and at the stress1024 shapes
            a frame through the grid kernels beside one through the XT
            kernels over the blocked scene's dense table sweep (the JAX
            oracle's traversal under accel 'grid'), three seeds: the
            pixels and owed rays that differ
  [sched]   the single-kernel schedulers (csrc/kernel_frame.cu) and the
            chunked kernel A over the traversals: at the SCHED_CONFIGS
            shapes (the north star, stress1024, showcase (EXT), fog (XT),
            stress1024 under grid and gathered with chunks of 2, then
            mesh5120 and one config for each other form of the queue
            entries), the regen (C) and lockstep (D) queue entry that the
            tracer takes (csrc/group.cuh kernel_frame_queue) and the
            thread-per-pixel entry of its instantiation (launched
            directly), each against the plain whole frame, bit for bit
            (planes; traversal counters; counts: lockstep's static
            formula, regen's between the items' sum and 32 / K times it on
            the queue and the warp count of the per-pixel iterations on
            the thread per pixel), both timed; the chunked grid and
            gathered kernel A's thread per entry, launched directly,
            against its plain version at the chunked configs, with
            counters (their grouped forms in [accel]); then this slice's
            main path: make_render_frame with 'sorted', 'regen' and
            'lockstep' on every config (launch counters reset before, read
            after; ms/frame side by side with the queue entry's widths,
            form and resident blocks an SM), where C, D and sorted must
            render one frame
  [denoise] the à-trous filter (ops/denoise.py): one north-star Engine
            run with --denoise 1.0 (finite, not flat, the filter changing
            the image, kernels A and B launched once a frame), the filter
            on the card within max relative error 1e-5 of the same filter
            on a CPU copy of its inputs, timed
  [offline] the display transforms, checkpoints and offline modes
            (runtime/offline.py, runtime/engine.py, cli.py) at Cornell_Box
            400x200, 16 spp, depth 32: cli.main --scan --frames 8 (aces,
            exposure 0.5) against the render step driven once a frame, the
            accumulation and the image bit for bit; each tonemap mode at
            exposures -1, 0, +1.5 (and the variance heat map) on the card
            against the same function on the CPU from that accumulation,
            every u8 within one level; run_headless (19 frames, one image)
            against the step with its image once a frame, bit for bit;
            --until-noise with --scan
            against the engine's explicit chunks of 8 at a threshold
            between two chunk boundaries (equal frames done), and without
            --scan; --turntable 3 --frames 4 with and without --scan;
            --animate orbit --scan --frames 4 against an animated Engine,
            bit for bit; a checkpoint after 4 frames, loaded, and 4 more
            against 8 straight, and a 64x32 checkpoint of the card resumed
            on the CPU (rays equal, radiance within 5e-3); --profile's
            trace holding kernels A and B; kernels A and B launched once a
            frame (the launch counters reset before); then the headless
            ms/frame at stress1024 with the noise scalar read every frame
            (--until-noise 0, chunk 1), every 8 frames (chunk 8) and never,
            in turns, with the nvidia-smi line (information, no claim)
  [examples] the five examples of examples_torch/: each main() on the
            card at its scene's own size (render_png 16 frames of scene2,
            custom_scene 8 of its 23-primitive stage, animate 8 of demo's
            orbit, glass 32, multichip 8 of scene2 in a process group of
            one rank over NCCL), the launch counters reset just before and
            read just after (every kernel of its path launched once a
            frame, nothing else); the PNGs of the scene's shape and not
            flat, animate's frames pairwise distinct, custom_scene's 30
            rows of 80 glyphs; each scene at its own size (multichip's
            scene2 is render_png's): the kernel pipeline against the plain
            pipeline on the card (rays, samples, variance equal, radiance
            maxrel < 5e-3); each scene cut to 64x32 at depth 4: the
            example's frame loop on the card against the CPU (rays and
            per-pixel samples equal; the knife-edge pixels, where an ulp
            of sin/cos between torch's CUDA and CPU flips a NEE sample,
            at most 2 a scene, their summed error at most 0.75);
            multichip.py as a process under torchrun --nproc-per-node 1
            and alone, its image digest that of the one-device step; each
            main()'s wall time a frame with the nvidia-smi line
            (information, no claim)
  [mesh]    the multi-GPU path (parallel/mesh.py) on one card: kernel A
            (through the entry the wrapper takes, thread per pixel at the
            north star) with each sample-split shard's runtime quota and
            seed at the north star (sp = 3: shares 2, 1, 1) on the whole
            image and on the px = 2 row block y0 = 100, against
            base_kernel_plain with
            the same arguments (rays, end states, budgets and variance
            equal, sums within 5e-3), timed per share; the sample-split
            composition (every shard's phases in one process, the sums
            over sp in rank order) for sp = 2 and 3 against the same
            phases on the plain versions (rays, totals, variance equal,
            radiance within 5e-3), ms/frame beside the unsharded sorted
            frame; then a process group of one rank over NCCL: Engine on
            a (1, 1) mesh against Engine without one, bit for bit, kernels
            A and B launched once a frame. Its launch counters run from
            the composition to the end, and kernel A must have taken a
            runtime quota on every sample-split launch
  [probes]  the Hopper probes (terminal_raytracer_tpu_torch/tools/,
            csrc/probes.cu): each probe's main() on the card at the JAX
            scripts' default sizes and loop counts (--reps 3), the launch
            counters reset before and read after (every form must have
            launched); then every form's output of that run against its
            plain version on the card: bit for bit, atan2f within rtol 1e-6
            of torch.atan2 (ulps printed), every copy of a branch probe's
            tile equal
  Each Engine run resets the launch counters, renders a warm-up frame
  and N frames, and must show every kernel of its path launched once per
  frame; the accumulation must be finite and the image not flat. The
  sorted frames in turns reset the counters too and add what both forms'
  wrappers launched. It prints
  ms/frame, Mray/s (owed traversal sweeps per second) and occupancy (owed
  sweeps over executed lane-iterations x (1 + the shadow sweeps a bounce
  owes: n_lights, or 1 under one-light NEE); a grouped kernel's
  lane-iterations are the path slots its warps spend, 32 / K a warp).

Then one JSON line with each kernel's result (its max abs error: the
largest over its comparisons, which include the main path's shapes; its
bound: the FP32 operations of the intersection tests its plain version
counts for the same inputs, over the card's FP32 peak, or its bytes over
3.35 TB/s, whichever is larger; the thread-per-pixel kernel_base and
kernel_extra_grouped at the north star, kernel_base_grouped at stress256,
kernel_base_chunked_grouped and kernel_base_grid_grouped at stress1024,
the thread-per-pixel kernel_base_grid and the thread-per-entry
kernel_extra, kernel_extra_xt, kernel_extra_grid, kernel_base_chunked and
kernel_base_chunked_xt at mesh5120 (in fog, under grid), all but
kernel_base_grid launched directly: no dispatch takes them (OFF_PATH), so
their launches are 0 and a main-path launch fails the run (kernel_base_grid
serves scenes below 16 primitives, the north star under grid); the
GroupSpill forms kernel_extra_grouped_spill, kernel_extra_xt_grouped_spill,
kernel_base_chunked_grouped_spill and kernel_base_chunked_xt_grouped_spill
at mesh5120 (in fog) and the GroupCulledSpill forms
kernel_base_grid_grouped_spill and kernel_extra_grid_grouped_spill at
mesh5120 under grid, their errors including the split-point libraries';
kernel_base_chunked_xt_grouped at the stress:1024 fog --mis shapes;
kernel_base_ext_grouped at the checker stress:256 shapes; the chunked
grid kernel A at the stress1024 grid cb 2 shapes (the thread-per-entry
kernel_base_chunked_grid launched directly, OFF_PATH; its grouped
entry) and its GroupCulledSpill form at mesh5120 grid cb 2; the chunked
gathered kernel A at the stress1024 gathered cb 2 shapes (the
thread-per-entry kernel_base_chunked_gathered launched directly,
OFF_PATH; its grouped entry), its errors including mesh1280 gathered cb
2's;
the other EXT rows at the showcase and
stress:1024-checker shapes (the thread-per-entry kernel_extra_ext and
kernel_base_chunked_ext launched directly, OFF_PATH; the GroupSpill
forms kernel_extra_ext_grouped_spill and
kernel_base_chunked_ext_grouped_spill at the checker icosphere:4 shapes);
the other XT rows at the fog and stress:1024 fog shapes; the other grid
and gathered rows at the stress1024 shapes (the thread-per-entry
kernel_extra_gathered launched directly, OFF_PATH; the thread-per-pixel
kernel_base_gathered, which the main path takes below 16 primitives),
their
operations the slab tests, walk steps and primitive tests that the plain
traversal counts; the regen and lockstep rows, thread per pixel
(launched directly, OFF_PATH) and each queue form, at their first
[sched] config, the plain version's operations over the whole frame, 24
bytes written a pixel; kernel_base_quota, kernel A with a runtime quota, at the
largest sp = 3 share of the north star, its launches those that took a
quota; the five probe rows at their default form, probe21 ldg at n =
1024, probe21b rowsel_ldg, probe21c packed, probe_when guarded at frac
0.5, probe_cond cond at frac 0.25, their bound the FP32 operations of the
loop over the FP32 peak or their bytes, their launches those of the
main() runs), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. A failed phase raises or exits non-zero and
prints no result; nothing falls back to the plain version or to the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

TOL = 5e-3
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
LANES_PER_SM = 128  # FP32 lanes of one Hopper SM
TILE = 16 * 128  # the probes' tile
SPIN_CYCLES = 2_000_000  # ~1 ms at 1980 MHz: the host's enqueue of a call


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def maxrel(k, p) -> float:
    k, p = k.double(), p.double()
    return float(((k - p).abs() / p.abs().clamp(min=1e-3)).max())


def maxabs(k, p) -> float:
    return float((k.double() - p.double()).abs().max())


def _smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"[device] nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    """Returns (nvidia-smi name/power line, FP32 peak in FLOP/s)."""
    import torch

    if not torch.cuda.is_available():
        fail("[device] torch.cuda.is_available() is False")
    smi_line = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peak = n_sm * LANES_PER_SM * 2 * clock_mhz * 1e6
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | {smi_line} | max SM clock "
          f"{clock_mhz:.0f} MHz, {n_sm} SMs: FP32 peak {peak / 1e12:.1f} "
          "TFLOP/s", flush=True)
    return smi_line, peak


def phase_build():
    """Every library, the split-point libraries of csrc/group_tune.cu
    (SPLIT_CAPS) and its library of the unbound XT and grid kernel A
    (_unbound_a_source), one nvcc each, all at once."""
    from terminal_raytracer_tpu_torch.ops import build

    t0 = time.perf_counter()
    paths = build.library_paths(tuple(build.ENTRY_POINTS)
                                + tuple(_split_sources().values())
                                + (_unbound_a_source(),))
    build.load_kernels()
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(p.name for p in paths.values())} in "
          f"{dt:.1f} s", flush=True)
    for src, so in paths.items():
        if not isinstance(src, str):
            continue  # csrc/group_tune.cu: the render kernels' code
        for line in so.with_suffix(".log").read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"[build] {line.strip()}", flush=True)


def _scene(name, w, h, spp, depth):
    from terminal_raytracer_tpu_torch.models import load_scene

    return load_scene(name).with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth)


def _cornell(w, h, spp, depth):
    return _scene("Cornell_Box", w, h, spp, depth)


def _pose():
    from terminal_raytracer_tpu_torch.models import Camera

    return Camera().pose()


def phase_kernel_base(peak):
    """Kernel A in both forms at Cornell_Box 128x16, 16 spp, depth 8 and 3
    (_base_both). Returns (max abs error of each form, the depth-8 tracer
    and the wrapper's output)."""
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    worst, keep = {"grouped": 0.0, "thread": 0.0}, None
    for depth in (8, 3):
        tr = PathTracer(_cornell(128, 16, 16, depth), "cuda")
        res, out = _base_both("kernel_base", f"depth {depth}", tr, peak)
        for form in worst:
            worst[form] = max(worst[form], res[form][0])
        if depth == 8:
            keep = (tr, out)
    return worst, keep


def _base_both(tag, label, tr, peak, timed_plain=True):
    """Kernel A of tracer `tr` (reference or EXT gates, `--accel grid` or
    `--accel gathered`) in both forms, the grouped entry and the
    thread-per-pixel entry, the one that ops/kernels.takes_grouped picks through the
    wrapper: each against the plain version bit for bit (rays, budgets,
    variance, end states, csum and csumsq bits; under a traversal its
    counters, the grouped entry's also against the thread per pixel's),
    the thread-per-pixel lane-iterations equal to the plain model, the
    grouped ones as _base_iters_model says; both timed beside each other,
    and the plain version too where `timed_plain`. Returns ({form: (max
    abs error, ms, plain ms or None, bound)}, the wrapper's output)."""
    from terminal_raytracer_tpu_torch.ops import kernels

    pose = _pose()
    kind = kernels._kind(tr)
    traversal = tr.traversal
    taken = "grouped" if kernels.takes_grouped(tr, "base") else "thread"
    # Over the budget the grid's grouped entry passes the tracer on to its
    # GroupCulledSpill form, which counts the launch.
    sfx = _spill(tr) if taken == "grouped" else ""
    name = ("base" if kind == "ref" else f"base_{kind}") + sfx
    wrapper = (getattr(kernels, kernels.GROUPED_BASE[kind].__name__ + sfx)
               if taken == "grouped" else getattr(kernels, "base_kernel" + (
                   f"_{kind}" if kind != "ref" else "")))

    def launch(form):
        k = ("grouped" if kind == "ref" else f"{kind}_grouped") + sfx \
            if form == "grouped" else kind
        return lambda: kernels._launch_base(tr, pose, SEED, 0, 0, None, None,
                                            k)

    n0 = wrapper.launches
    outs = {taken: _counted_launch(
        tr, lambda: kernels.base_kernel(tr, pose, SEED, 0))}
    if wrapper.launches != n0 + 1:
        fail(f"[{tag}] {label}: kernel A took no {wrapper.__name__}")
    other = "thread" if taken == "grouped" else "grouped"
    outs[other] = _counted_launch(tr, launch(other))
    pc = []
    plain, ops, p = (_time_plain if timed_plain else _plain_counted)(
        tr, lambda: kernels.base_kernel_plain(tr, pose, SEED, 0),
        pc if traversal else None)
    it = kernels.base_entry_iters(tr, pose, SEED, 0)
    atlas = 0 if tr.atlas is None else tr.atlas.numel()
    bound = _bound(ops, 4 * (tr.tables.buf.numel() + atlas)
                   + 44 * p.var.numel(), peak)
    res = {}
    for form in ("grouped", "thread"):
        out, counts = outs[form]
        err = _compare_base(tag, f"{label} kernel A {form}", out, p,
                            ("additional", "var"), exact=True)
        if traversal:
            _check_counts(f"{label} kernel A {form}", counts, pc[0])
        if form == "thread":
            _iters_model(tag, f"{label} kernel A thread", out.iters, it, 1)
        else:
            _base_iters_model(tag, f"{label} kernel A", out.iters, it, name)
        res[form] = (err, _time_cuda(launch(form), 5), plain, bound)
    if traversal:
        _check_counts(f"{label} grouped against thread-per-pixel kernel A",
                      outs["grouped"][1], outs["thread"][1])
        print(f"[{tag}] {label} kernel A: "
              f"{_traversal_counts(traversal, outs['grouped'][1])}",
              flush=True)
    _grouped_vs_thread(tag, f"{label} kernel A", name, tr,
                       res["grouped"][1], res["thread"][1], it,
                       (outs["grouped"][0], outs["thread"][0]))
    print(f"[{tag}] {label} kernel A: the wrapper takes {wrapper.__name__}; "
          f"plain {_fmt_ms(plain)}, bound {bound[0]:.4f} ms by {bound[1]}: "
          f"{ops:.4g} FP32 operations", flush=True)
    return res, outs[taken][0]


def _time_cuda(fn, reps, warm=True, queued=True):
    """ms a call of `fn` over `reps` calls between two CUDA events. Queued:
    behind a spin of SPIN_CYCLES a call, during which the host enqueues
    the calls, so that a kernel shorter than its wrapper's host time is
    timed on the device, not at the host's pace."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _plain_counted(tr, fn, stats=None):
    """One counted run of a plain version: the FP32 operations of the
    intersection tests it owes (ops/geometry.py ScenePrims.ops). Returns
    (None for the time, operations, its output); appends an opt-in
    traversal's counters to the list `stats`."""
    import torch

    tr.prims.ops = torch.zeros((), dtype=torch.float64, device=tr.device)
    out = fn()
    ops = float(tr.prims.ops)
    if stats is not None:
        stats.append(tr.prims.stats.cpu())
    tr.prims.ops = None
    return None, ops, out


def _time_plain(tr, fn, stats=None):
    """One counted run of a plain version (_plain_counted), which is also
    the warm-up, then one timed run. Returns (ms, operations, the timed
    run's output)."""
    _, ops, _ = _plain_counted(tr, fn, stats)
    out = []
    return (_time_cuda(lambda: out.append(fn()), 1, warm=False, queued=False),
            ops, out[0])


def _fmt_ms(ms) -> str:
    return "not timed" if ms is None else f"{ms:.1f} ms"


def _bound(ops, n_bytes, peak):
    """(bound ms, what bounds it): the larger of FP32 operations over the
    FP32 peak and bytes over the HBM rate."""
    t_ops, t_bytes = ops / peak, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _iters_model(tag, label, got, entry_iters, k):
    """A kernel's executed lane-iterations against the plain model at group
    width k (ops/kernels.py warp_iters)."""
    from terminal_raytracer_tpu_torch.ops import kernels

    want = float(kernels.warp_iters(entry_iters, k))
    if float(got) != want:
        fail(f"[{tag}] {label}: executed lane-iterations {float(got):.0f}, "
             f"the plain model at K = {k} {want:.0f}")


def _base_iters_model(tag, label, got, entry_iters, kind):
    """A grouped kernel A's executed lane-iterations (kind 'base',
    'base_grid' or 'base_gathered'): on the static schedule the plain
    model at its group width, on the refill schedule at least the pixels'
    summed iterations (every slot busy)."""
    from terminal_raytracer_tpu_torch.ops import kernels

    if not kernels.group_refill(kind):
        _iters_model(tag, label, got, entry_iters, kernels.group_k(kind))
    elif float(got) < float(entry_iters.sum()):
        fail(f"[{tag}] {label}: refill lane-iterations {float(got):.0f} "
             f"below the pixels' sum {int(entry_iters.sum())}")


def _grouped_vs_thread(tag, label, kind, tr, ms_g, ms_t, entry_iters,
                       base_outs=None):
    """Print the grouped entry's time beside the thread-per-entry entry's,
    with K (ops/kernels.group_k(kind)), the working warps, the longest
    entry's iterations and the µs an iteration on that chain, the staged
    bytes and the entry that the wrapper takes for `tr`. Kernel A ('base',
    'base_grid'; `base_outs` its grouped and thread-per-pixel outputs) adds
    its schedule, each form's lane-iterations beside the static model and
    the pixels' sum, and each form's occupancy: owed sweeps over
    lane-iterations x (1 + nee_sweeps)."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels

    k = kernels.group_k(kind)
    w_g, w_t = (kernels.working_warps(entry_iters, k),
                kernels.working_warps(entry_iters, 1))
    longest = int(entry_iters.max())
    took = ("grouped" if kernels.takes_grouped(tr, kind.split("_")[0])
            else "thread-per-entry")
    staged = (f"{kernels.group_smem_bytes(tr)} B of "
              f"{kernels.GROUP_SMEM_BYTES}")
    if kind.endswith("gathered"):
        staged = "nothing (GroupWalk reads rows and CSR through L1)"
    elif kind.endswith("grid_spill"):
        cap = kernels.group_cap(kind)
        counts = kernels.grid_counts(tr)
        rows = kernels.culled_stage(*counts, cap)
        staged = (f"{kernels.culled_stage_bytes(rows)} B of {cap} (groups, "
                  f"triangles, spheres, planes {rows} of {counts[0]}, "
                  f"{counts[3]}, {counts[1]}, {counts[2]})")
    elif kind.endswith("_spill"):
        cap = kernels.group_cap(kind)
        rows = kernels.group_stage(*tr.tables.counts[:3], cap)
        staged = (f"{kernels.stage_bytes(rows)} B of {cap} (triangles, "
                  f"spheres, planes {rows} of {tr.tables.counts[2]}, "
                  f"{tr.tables.counts[0]}, {tr.tables.counts[1]})")
    extra = ""
    if base_outs is not None:
        g, t = base_outs
        owed = float(t.rays.sum(dtype=torch.float64))
        per = 1.0 + tr.nee_sweeps
        sched = "refill" if kernels.group_refill(kind) else "static"
        extra = (f"; schedule {sched}, lane-iterations {float(g.iters):.0f} / "
                 f"{float(t.iters):.0f} (static model at K "
                 f"{float(kernels.warp_iters(entry_iters, k)):.0f}, pixels' "
                 f"sum {int(entry_iters.sum())}), occupancy "
                 f"{owed / (float(g.iters) * per):.3f} / "
                 f"{owed / (float(t.iters) * per):.3f}")
    print(f"[{tag}] {label}: grouped K {k} {ms_g:.4f} ms on {w_g} working "
          f"warps, thread-per-entry {ms_t:.4f} ms on {w_t} (x{ms_t / ms_g:.2f});"
          f" longest entry {longest} iterations: {1e3 * ms_g / longest:.3f} / "
          f"{1e3 * ms_t / longest:.3f} µs an iteration; staged {staged}; "
          f"the wrapper takes {took}{extra}", flush=True)


def phase_kernel_extra(tr, a, peak):
    """Kernel B vs plain on the stream of kernel A's output `a`: the grouped
    entry (which the wrapper takes) and the thread-per-entry entry, each
    bit for bit with its executed lane-iterations equal to the plain model;
    then both forms of kernel A (_base_both) and of kernel B held against
    and timed beside their plain versions at the north star, and both forms
    of A at stress256. Returns (kernel A's forms at the north star and at
    stress256, B's max abs error, B's ms, plain ms and bound)."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()

    def both(t, s, label):
        """Kernel B through its wrapper (the grouped entry) and the
        thread-per-entry entry on stream `s`, against the plain version."""
        args = (t, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        n0 = kernels.extra_kernel_grouped.launches
        g = kernels.extra_kernel(*args)
        if kernels.extra_kernel_grouped.launches != n0 + 1:
            fail(f"[kernel_extra] {label}: the wrapper took no grouped entry")
        th = kernels._launch_extra(*args, "ref")
        p = kernels.extra_kernel_plain(*args)
        it = kernels.extra_entry_iters(*args)
        err = _check_extra("kernel_extra", f"{label} grouped", s, g, p,
                           exact=True)
        err = max(err, _check_extra("kernel_extra",
                                    f"{label} thread-per-entry", s, th, p,
                                    exact=True))
        _iters_model("kernel_extra", label, g[2], it, kernels.group_k("extra"))
        _iters_model("kernel_extra", label, th[2], it, 1)
        return args, it, err

    s = kernels.sorted_stream(tr, a.state, a.additional)
    _, _, err = both(tr, s, "Cornell_Box 128x16 depth 8")

    # Both forms of A and both forms of B against their plain versions at
    # the north-star shapes, and timed there (outside the counted main
    # path); both forms of A also at stress256, where the wrapper takes the
    # grouped one.
    ns = PathTracer(_cornell(400, 200, 16, 32), "cuda")
    scene_bytes = 4 * ns.tables.buf.numel()
    res_a, a_ns = _base_both("kernel_extra", "north-star shapes", ns, peak)
    res_a256, _ = _base_both(
        "kernel_extra", "stress256 shapes",
        PathTracer(_scene("stress:256", 200, 100, 8, 6), "cuda"), peak)
    s_ns = kernels.sorted_stream(ns, a_ns.state, a_ns.additional)
    args, it, err_ns = both(ns, s_ns, "north-star shapes")
    err = max(err, err_ns)
    ms_b = _time_cuda(lambda: kernels.extra_kernel(*args), 5)
    ms_bt = _time_cuda(lambda: kernels._launch_extra(*args, "ref"), 5)
    plain_b, ops_b, _ = _time_plain(
        ns, lambda: kernels.extra_kernel_plain(*args))
    n_ent = s_ns.add.numel()
    bound_b = _bound(ops_b, scene_bytes + 40 * n_ent, peak)
    print(f"[kernel_extra] north-star shapes: kernel_extra "
          f"grouped {ms_b:.3f} ms on {int((s_ns.add > 0).sum())} budgeted of "
          f"{n_ent} entries (plain {plain_b:.1f} ms, bound {bound_b[0]:.4f} "
          f"ms by {bound_b[1]}: {ops_b:.4g} operations)", flush=True)
    _grouped_vs_thread("kernel_extra", "north-star shapes", "extra", ns, ms_b,
                       ms_bt, it)
    return res_a, res_a256, err, (ms_b, plain_b, bound_b)


def _chunk_totals(tr, out):
    return [tr.chunk_total(v) for v in (*out.csum, *out.csumsq)]


def phase_kernel_base_chunked(peak):
    """The chunked kernel A against its plain version, its grouped entry
    (which the wrapper takes) and its thread-per-entry entry, bit for bit
    with the executed lane-iterations equal to the plain model; then both
    timed at the stress1024 shapes; one stress1024 frame with and without
    the split."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()

    def both(t, label):
        n0 = kernels.base_kernel_chunked_grouped.launches
        g = kernels.base_kernel_chunked(t, pose, SEED, 0)
        if kernels.base_kernel_chunked_grouped.launches != n0 + 1:
            fail(f"[kernel_base_chunked] {label}: the wrapper took no "
                 "grouped entry")
        th = kernels._launch_chunked(t, pose, SEED, 0, 0, None, "ref")
        p = kernels.base_kernel_chunked_plain(t, pose, SEED, 0)
        it = kernels.chunked_entry_iters(t, pose, SEED, 0)
        err = max(_compare_base("kernel_base_chunked", f"{label} {form}", k,
                                p, (), t, exact=True)
                  for form, k in (("grouped", g), ("thread-per-entry", th)))
        _iters_model("kernel_base_chunked", label, g.iters, it,
                     kernels.group_k("chunked"))
        _iters_model("kernel_base_chunked", label, th.iters, it, 1)
        return it, err

    tr = PathTracer(_scene("stress:120:7", 64, 16, 8, 6), "cuda",
                    chunk_base=2, chunk_extra=2)
    _, err = both(tr, f"stress:120:7 64x16 spp 8 depth 6, "
                      f"{tr.n_base_chunks} chunks of {tr.chunk_base}")

    big = PathTracer(_scene("stress:1024", 200, 100, 8, 6), "cuda")
    if big.chunk_base != 2 or big.chunk_extra != 2:
        fail("[kernel_base_chunked] stress1024 does not resolve to cb = ce "
             "= 2")
    it, err_big = both(big, "stress1024 shapes")
    err = max(err, err_big)
    ms = _time_cuda(lambda: kernels.base_kernel_chunked(big, pose, SEED, 0), 5)
    ms_t = _time_cuda(lambda: kernels._launch_chunked(
        big, pose, SEED, 0, 0, None, "ref"), 5)
    plain_ms, ops, _ = _time_plain(
        big, lambda: kernels.base_kernel_chunked_plain(big, pose, SEED, 0))
    n_ent = big.n_base_chunks * big.width * big.height
    bound = _bound(ops, 4 * big.tables.buf.numel() + 36 * n_ent, peak)
    print(f"[kernel_base_chunked] stress1024 shapes ({n_ent} entries): "
          f"grouped {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]}: {ops:.4g} FP32 test "
          "operations)", flush=True)
    _grouped_vs_thread("kernel_base_chunked", "stress1024 shapes", "chunked",
                       big, ms, ms_t, it)

    # Occupancy and frame time with and without the chunk split.
    flat = PathTracer(big.scene, "cuda", chunk_base=None, chunk_extra=None)
    for label, t in (("unchunked", flat), ("chunked", big)):
        render = kernels.make_sorted_render_frame(t)
        render(pose, SEED, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(3):
            out = render(pose, SEED, f + 1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        print(f"[kernel_base_chunked] stress1024 {label}: {1e3 * dt:.2f} "
              f"ms/frame, {float(out[3]) / dt / 1e6:.1f} Mray/s, occupancy "
              f"{float(out[4]):.3f}", flush=True)
    return err, (ms, plain_ms, bound)


# The stage caps of the split-point libraries of csrc/group_tune.cu (K 8,
# 128 lanes a block): nothing staged, and 168 bytes (Cornell_Box: its planes
# split; icosphere:1: its triangles; stress:64: its spheres).
SPLIT_CAPS = (0, 168)
SPLIT_SCENES = ("Cornell_Box", "icosphere:1", "stress:64")


def _split_sources():
    from terminal_raytracer_tpu_torch.ops import build

    return {cap: (build.TUNE_SOURCE, ("TRT_TUNE_K=8", "TRT_TUNE_THREADS=128",
                                      f"TRT_TUNE_STAGE_CAP={cap}"))
            for cap in SPLIT_CAPS}


def _unbound_a_source():
    """csrc/group_tune.cu at its defaults (K = 1, no residency bound): its
    trt_kernel_base_xt and trt_kernel_base_grid are the XT and grid kernel A
    as they were before their bounds, kernel_base<true, true, Sweep |
    Culled>, timed beside the shipped entries."""
    from terminal_raytracer_tpu_torch.ops import build

    return (build.TUNE_SOURCE, ("TRT_TUNE_K=1", "TRT_TUNE_MIN_BLOCKS=0"))


def _frames_xt_a_in_turns(tag, label, scene, frames=8, **kw):
    """ms/frame of the sorted pipeline on one XT tracer with kernel A held
    to its residency bound (the render library's trt_kernel_base_xt) and
    unbound (_unbound_a_source's), in turns: unbound, bound, bound,
    unbound; the other kernels as the dispatch takes them. The forced form
    is no main path: its launches count nowhere."""
    from types import SimpleNamespace

    import torch

    from terminal_raytracer_tpu_torch.ops import build, kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    tr = PathTracer(scene, "cuda", **kw)
    render = kernels.make_sorted_render_frame(tr)
    pose = _pose()
    load = kernels.load_kernels
    unbound = SimpleNamespace(**{
        **vars(load()), "trt_kernel_base_xt": build.load_kernels(
            (_unbound_a_source(),)).trt_kernel_base_xt})
    times = {"unbound": [], "bound": []}
    try:
        for form in ("unbound", "bound", "bound", "unbound"):
            kernels.load_kernels = (load if form == "bound"
                                    else lambda *a: unbound)
            render(pose, SEED, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(frames):
                render(pose, SEED, f + 1)
            torch.cuda.synchronize()
            times[form].append(1e3 * (time.perf_counter() - t0) / frames)
    finally:
        kernels.load_kernels = load
    print(f"[{tag}] {label} sorted frame in turns, {frames} frames each, "
          f"XT kernel A unbound or held to "
          f"{load().trt_kernel_base_xt_min_blocks()} blocks an SM: unbound "
          f"{times['unbound'][0]:.3f} / {times['unbound'][1]:.3f} ms/frame, "
          f"bound {times['bound'][0]:.3f} / {times['bound'][1]:.3f}",
          flush=True)


def _spill_both(label, tr, kernel, peak, tag="thread", turns=False):
    """The grouped entry of the chunked kernel A (kernel 'chunked') or of
    kernel B ('extra') at the tracer's instantiation, which its wrapper
    takes (over the budget its GroupSpill or GroupCulledSpill form), and
    the thread-per-entry entry, launched directly: each against the plain
    version bit for bit (under `--accel grid` with the traversal counters,
    the grouped entry's also against the thread per entry's), with its
    lane-iterations equal to the plain model at its group width; both
    timed side by side (`turns`: thread, grouped, grouped, thread, each
    form's least). Returns {form: (max abs error, ms, plain ms, bound)}."""
    from terminal_raytracer_tpu_torch.ops import kernels

    pose = _pose()
    kind = kernels._kind(tr)
    atlas = 0 if tr.atlas is None else tr.atlas.numel()
    fixed = 4 * (tr.tables.buf.numel() + atlas)
    sfx = _spill(tr)

    def counted(fn):
        return _counted_launch(tr, fn) if tr.traversal else (fn(), None)

    if kernel == "chunked":
        name = ("chunked" if kind == "ref" else f"chunked_{kind}") + sfx
        spill = ("grouped" if kind == "ref" else f"{kind}_grouped") + sfx
        wrapper = getattr(kernels, f"base_kernel_chunked_{spill}")
        n0 = wrapper.launches
        g, gc = counted(lambda: kernels.base_kernel_chunked(tr, pose, SEED,
                                                            0))

        def launch(form):
            return lambda: kernels._launch_chunked(
                tr, pose, SEED, 0, 0, None,
                spill if form == "grouped" else kind)

        pc = []
        plain, ops, p = _time_plain(
            tr, lambda: kernels.base_kernel_chunked_plain(tr, pose, SEED, 0),
            pc if tr.traversal else None)
        it = kernels.chunked_entry_iters(tr, pose, SEED, 0)
        n_ent = tr.n_base_chunks * tr.width * tr.height
        bound = _bound(ops, fixed + 36 * n_ent, peak)
        t, tc = counted(launch("thread"))
        outs = {"grouped": g, "thread": t}
        errs = {form: _compare_base(tag, f"{label} chunked kernel A "
                                    f"{form}", o, p, (), tr, exact=True)
                for form, o in outs.items()}
        if tr.traversal:
            for form, c in (("grouped", gc), ("thread", tc)):
                _check_counts(f"{label} {form} chunked kernel A", c, pc[0])
            _check_counts(f"{label} grouped against thread-per-entry chunked "
                          "kernel A", gc, tc)
            print(f"[{tag}] {label} chunked kernel A: "
                  f"{_traversal_counts(tr.traversal, gc)}", flush=True)
        iters = {form: o.iters for form, o in outs.items()}
        what = f"{n_ent} entries"
    else:
        name = ("extra" if kind == "ref" else f"extra_{kind}") + sfx
        wrapper = (kernels.SPILL_EXTRA if sfx else kernels.GROUPED_EXTRA)[kind]
        a = kernels.base_phase(tr, pose, SEED, 0)
        s = kernels.sorted_stream(tr, a[2], a[7])
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        n0 = wrapper.launches
        spill = ("grouped" if kind == "ref" else f"{kind}_grouped") + sfx

        def launch(form):
            return lambda: kernels._launch_extra(
                *args, spill if form == "grouped" else kind)

        g, gc = counted(lambda: kernels.extra_kernel(*args))
        pc = []
        plain, ops, pb = _time_plain(
            tr, lambda: kernels.extra_kernel_plain(*args),
            pc if tr.traversal else None)
        it = kernels.extra_entry_iters(*args)
        bound = _bound(ops, fixed + 40 * s.add.numel(), peak)
        t, tc = counted(launch("thread"))
        outs = {"grouped": g, "thread": t}
        errs = {form: _check_extra(tag, f"{label} {form}", s, o, pb,
                                   exact=True) for form, o in outs.items()}
        if tr.traversal:
            for form, c in (("grouped", gc), ("thread", tc)):
                _check_counts(f"{label} {form} kernel B", c, pc[0])
        iters = {form: o[2] for form, o in outs.items()}
        what = f"{int((s.add > 0).sum())} budgeted of {s.add.numel()} entries"
    if wrapper.launches != n0 + 1:
        fail(f"[{tag}] {label}: the wrapper took no {wrapper.__name__}")
    _iters_model(tag, f"{label} {kernel} grouped", iters["grouped"], it,
                 kernels.group_k(name))
    _iters_model(tag, f"{label} {kernel} thread", iters["thread"], it, 1)
    if turns:
        ms = {"grouped": float("inf"), "thread": float("inf")}
        for form in ("thread", "grouped", "grouped", "thread"):
            ms[form] = min(ms[form], _time_cuda(launch(form), 3))
    else:
        ms = {form: _time_cuda(launch(form), 3)
              for form in ("grouped", "thread")}
    _grouped_vs_thread(tag, f"{label} shapes", name, tr, ms["grouped"],
                       ms["thread"], it)
    print(f"[{tag}] {label} shapes ({kernels.group_rows_bytes(tr)} B of "
          f"rows, {'over' if sfx else 'within'} the "
          f"{kernels.GROUP_SMEM_BYTES} B budget): "
          f"{wrapper.__name__} {ms['grouped']:.3f} ms, thread per entry "
          f"{ms['thread']:.3f} ms on {what} (plain {plain:.1f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]}: {ops:.4g} operations)",
          flush=True)
    return {form: (errs[form], ms[form], plain, bound) for form in ms}


def _split_points():
    """The GroupSpill forms of the split-point libraries (SPLIT_CAPS) on
    SPLIT_SCENES at 64x16, 16 spp, depth 8 (chunks of 2; kernel B and the
    chunked kernel A also at the XT gates in fog under --mis), and their
    GroupCulledSpill forms of kernels A and B under --accel grid (_grid_split:
    the group table cut at icosphere:1 and stress:64 at 168 bytes, the
    triangles at Cornell_Box): bit for bit against the plain versions, the
    lane-iterations the plain model's at K. Returns the max abs error."""
    from terminal_raytracer_tpu_torch.models.scene import Fog
    from terminal_raytracer_tpu_torch.ops import build, kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    err = 0.0
    for cap, src in _split_sources().items():
        lib = build.load_kernels((src,))
        for name in SPLIT_SCENES:
            scene = _scene(name, 64, 16, 16, 8)
            tr = PathTracer(scene, "cuda", chunk_base=2, chunk_extra=2)
            staged = kernels.group_stage(*tr.tables.counts[:3], cap)
            label = f"cap {cap} B, {name} (staged {staged})"
            k = kernels._launch_chunked(tr, pose, SEED, 0, 0, None,
                                        "grouped_spill", lib)
            p = kernels.base_kernel_chunked_plain(tr, pose, SEED, 0)
            err = max(err, _compare_base("thread", f"{label} chunked A", k, p,
                                         (), tr, exact=True))
            _iters_model("thread", label, k.iters, kernels.chunked_entry_iters(
                tr, pose, SEED, 0), kernels.group_k("chunked_spill", lib))
            fog = PathTracer(scene.with_overrides(fog=Fog(density=0.15)),
                             "cuda", transport="mis", chunk_base=2,
                             chunk_extra=2)
            k = kernels._launch_chunked(fog, pose, SEED, 0, 0, None,
                                        "xt_grouped_spill", lib)
            p = kernels.base_kernel_chunked_plain(fog, pose, SEED, 0)
            err = max(err, _compare_base("thread", f"{label} chunked XT A", k,
                                         p, (), fog, exact=True))
            _iters_model("thread", f"{label} chunked XT A", k.iters,
                         kernels.chunked_entry_iters(fog, pose, SEED, 0),
                         kernels.group_k("chunked_xt_spill", lib))
            for t, kind in ((tr, "grouped_spill"), (fog, "xt_grouped_spill")):
                a = kernels.base_phase(t, pose, SEED, 0)
                s = kernels.sorted_stream(t, a[2], a[7])
                args = (t, pose, s.xs, s.ys, s.state, s.add, s.samp0)
                b = kernels._launch_extra(*args, kind, lib)
                err = max(err, _check_extra("thread", f"{label} {kind}", s, b,
                                            kernels.extra_kernel_plain(*args),
                                            exact=True))
                _iters_model("thread", f"{label} {kind}", b[2],
                             kernels.extra_entry_iters(*args),
                             kernels.group_k(
                                 "extra_spill" if kind == "grouped_spill"
                                 else "extra_xt_spill", lib))
            err = max(err, _grid_split(cap, lib, name, scene))
    return err


def _grid_split(cap, lib, name, scene):
    """The GroupCulledSpill forms of kernels A and B of the split-point
    library `lib` (stage cap `cap`) on `scene` (named `name`) under --accel
    grid: each
    against its plain version bit for bit with the traversal counters, the
    lane-iterations the plain model's. Returns the max abs error."""
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    tr = PathTracer(scene, "cuda", accel="grid")
    staged = kernels.culled_stage(*kernels.grid_counts(tr), cap)
    label = f"cap {cap} B, {name} grid (staged {staged})"
    k, kc = _counted_launch(tr, lambda: kernels._launch_base(
        tr, pose, SEED, 0, 0, None, None, "grid_grouped_spill", lib))
    pc = []
    _, _, p = _plain_counted(
        tr, lambda: kernels.base_kernel_plain(tr, pose, SEED, 0), pc)
    err = _compare_base("thread", f"{label} A", k, p, ("additional", "var"),
                        exact=True)
    _check_counts(f"{label} kernel A", kc, pc[0])
    it = kernels.base_entry_iters(tr, pose, SEED, 0)
    if kernels.group_refill("base_grid_spill", lib):
        if float(k.iters) < float(it.sum()):
            fail(f"[thread] {label} A: refill lane-iterations below the "
                 "pixels' sum")
    else:
        _iters_model("thread", f"{label} A", k.iters, it,
                     kernels.group_k("base_grid_spill", lib))
    s = kernels.sorted_stream(tr, k.state, k.additional)
    args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
    b, bc = _counted_launch(tr, lambda: kernels._launch_extra(
        *args, "grid_grouped_spill", lib))
    pc = []
    _, _, pb = _plain_counted(tr, lambda: kernels.extra_kernel_plain(*args),
                              pc)
    err = max(err, _check_extra("thread", f"{label} B", s, b, pb,
                                exact=True))
    _check_counts(f"{label} kernel B", bc, pc[0])
    _iters_model("thread", f"{label} B", b[2],
                 kernels.extra_entry_iters(*args),
                 kernels.group_k("extra_grid_spill", lib))
    return err


def phase_thread_per_entry(peak):
    """Tables above the grouped kernels' shared-memory budget (mesh5120,
    icosphere:4 at the bench's 200x100, 8 spp, depth 6): the GroupSpill
    forms of kernel B and of the chunked kernel A, which their wrappers
    take, beside the thread-per-entry entries, launched directly
    (_spill_both): the reference entries, then kernel B's XT entries in fog
    (XT_OVER_BUDGET); then kernels A and B over the culled sweep under
    `--accel grid` (ACCEL_OVER_BUDGET), whose wrappers take their
    GroupCulledSpill forms there, beside the thread per pixel / entry
    (_base_both, _spill_both), against the plain versions bit for bit with
    the traversal counters, timed, and the frame in turns; then the
    split-point libraries (_split_points). Returns {row: (max abs error,
    ms, plain ms, bound)}."""
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    tr = PathTracer(_scene("icosphere:4", 200, 100, 8, 6), "cuda")
    if not kernels.takes_grouped(tr) or not tr.chunk_base:
        fail("[thread] mesh5120 takes no grouped kernel B or no chunks")
    out = {}
    both = _spill_both("mesh5120", tr, "chunked", peak)
    out["c"], out["cs"] = both["thread"], both["grouped"]
    both = _spill_both("mesh5120", tr, "extra", peak)
    out["b"], out["bs"] = both["thread"], both["grouped"]
    _, name, size, over, transport = XT_OVER_BUDGET
    fog = PathTracer(_xt_scene(name, size, over), "cuda", transport=transport)
    if not kernels.takes_grouped(fog, "chunked") or not fog.chunk_base:
        fail("[thread] mesh5120 fog takes no grouped chunked XT A or no "
             "chunks")
    both = _spill_both("mesh5120 fog", fog, "chunked", peak)
    out["cxt"], out["cxts"] = both["thread"], both["grouped"]
    both = _spill_both("mesh5120 fog", fog, "extra", peak)
    out["xt"], out["xts"] = both["thread"], both["grouped"]

    # The grid kernels A and B over the culled sweep (ACCEL_OVER_BUDGET):
    # their GroupCulledSpill forms, which the wrappers take, beside the
    # thread per pixel / entry, launched directly, each bit for bit with the
    # traversal counters; then the frame in turns.
    label, name = ACCEL_OVER_BUDGET
    grid = PathTracer(_scene(name, 200, 100, 8, 6), "cuda", accel="grid")
    if not (kernels._over_budget(grid) and kernels.takes_grouped(grid, "base")
            and kernels.takes_grouped(grid)):
        fail(f"[thread] {label} grid takes no grouped kernel A or B, or fits "
             "the budget")
    res, _ = _base_both("thread", f"{label} grid", grid, peak)
    out["ga"], out["gas"] = res["thread"], res["grouped"]
    both = _spill_both(f"{label} grid", grid, "extra", peak)
    out["grid"], out["gs"] = both["thread"], both["grouped"]
    _frames_grouped_vs_thread("thread", f"{label} grid",
                              _scene(name, 200, 100, 8, 6), accel="grid")
    split_err = _split_points()
    for key in ("cs", "bs", "xts", "cxts", "gas", "gs"):
        out[key] = (max(out[key][0], split_err), *out[key][1:])
    return out


# The thread-per-entry entries that no dispatch takes (the grouped entries
# serve their instantiations at every table size; the thread per pixel of
# the gathered and grid kernel A serves scenes below GROUP_BASE_MIN_PRIMS,
# which [sched] renders under both (Cornell grid and gathered), so both
# stay on the path; the queue entries serve kernels C and D): held bit for
# bit and timed beside their grouped forms, launched directly, so their
# main-path launches are 0, and a launch there fails the run.
OFF_PATH = ("kernel_extra", "kernel_extra_xt", "kernel_extra_ext",
            "kernel_extra_grid", "kernel_extra_gathered", "kernel_base_chunked",
            "kernel_base_chunked_xt", "kernel_base_chunked_ext",
            "kernel_base_chunked_grid", "kernel_base_chunked_gathered") + tuple(
    f"kernel_{mode}{sfx}" for mode in ("regen", "lockstep")
    for sfx in ("", "_ext", "_xt", "_grid", "_gathered"))
# Kernels C and D: the wrappers of the thread-per-pixel entries (counting
# nothing since the queue entries: OFF_PATH rows) and of the queue entries
# (ops/kernels.FRAME_QUEUE), by (mode, kind, form).
FRAME_NAMES = tuple(f"{mode}_kernel{sfx}" for mode in ("regen", "lockstep")
                    for sfx in ("", "_ext", "_xt", "_grid", "_gathered"))
QUEUE_KEYS = tuple((mode, kind, form) for mode in ("regen", "lockstep")
                   for kind in ("ref", "ext", "xt", "grid", "gathered")
                   for form in ("solo", "group", "spill")
                   if not (kind == "gathered" and form == "spill"))
QUEUE_NAMES = tuple(
    f"{mode}_kernel{'' if kind == 'ref' else '_' + kind}_queue"
    + {"solo": "_solo", "group": "", "spill": "_spill"}[form]
    for mode, kind, form in QUEUE_KEYS)
LAUNCH_NAMES = ("base_kernel", "base_kernel_chunked", "extra_kernel",
                "base_kernel_grouped", "base_kernel_grid_grouped",
                "base_kernel_chunked_grouped", "extra_kernel_grouped",
                "extra_kernel_xt_grouped", "extra_kernel_grid_grouped",
                "base_kernel_grid_grouped_spill",
                "extra_kernel_grid_grouped_spill",
                "base_kernel_chunked_grouped_spill",
                "base_kernel_chunked_xt_grouped",
                "base_kernel_chunked_xt_grouped_spill",
                "extra_kernel_grouped_spill", "extra_kernel_xt_grouped_spill",
                "extra_kernel_ext_grouped", "extra_kernel_ext_grouped_spill",
                "extra_kernel_gathered_grouped",
                "base_kernel_gathered_grouped",
                "base_kernel_chunked_ext_grouped",
                "base_kernel_chunked_ext_grouped_spill",
                "base_kernel_ext", "base_kernel_chunked_ext",
                "extra_kernel_ext", "base_kernel_xt", "base_kernel_chunked_xt",
                "extra_kernel_xt", "base_kernel_grid", "extra_kernel_grid",
                "base_kernel_gathered", "extra_kernel_gathered",
                "base_kernel_chunked_grid", "base_kernel_chunked_gathered",
                "base_kernel_ext_grouped", "base_kernel_chunked_grid_grouped",
                "base_kernel_chunked_grid_grouped_spill",
                "base_kernel_chunked_gathered_grouped")
LAUNCH_NAMES += FRAME_NAMES + QUEUE_NAMES


def _sfx(tr) -> str:
    """The suffix of the kernel wrappers that tracer `tr` takes."""
    return (f"_{tr.traversal}" if tr.traversal else "_xt" if tr.xt
            else "_ext" if tr.ext else "")


def _spill(tr) -> str:
    """The suffix of a grouped wrapper's GroupSpill (GroupCulledSpill under
    grid) form, which takes tracer `tr` where its rows exceed the grouped
    kernels' budget (the instantiations with one: the walk reads its rows
    through L1 at every size)."""
    from terminal_raytracer_tpu_torch.ops import kernels

    return ("_spill" if kernels._kind(tr) in kernels.SPILL_EXTRA
            and kernels.group_smem_bytes(tr) > kernels.GROUP_SMEM_BYTES
            else "")


def _a_name(tr) -> str:
    """The kernel A wrapper that counts the launches of tracer `tr`'s base
    phase: the grouped entry (chunked or not; over the budget the chunked
    one's GroupSpill form, the grid's GroupCulledSpill form) where
    ops/kernels.takes_grouped."""
    from terminal_raytracer_tpu_torch.ops import kernels

    if not tr.chunk_base:
        if kernels.takes_grouped(tr, "base"):
            return kernels.GROUPED_BASE[kernels._kind(tr)].__name__ + _spill(tr)
        return "base_kernel" + _sfx(tr)
    return (kernels.GROUPED_CHUNKED[kernels._kind(tr)].__name__ + _spill(tr)
            if kernels.takes_grouped(tr, "chunked")
            else "base_kernel_chunked" + _sfx(tr))


def _b_name(tr) -> str:
    """The kernel B wrapper that counts tracer `tr`'s launches: the grouped
    entry of its instantiation (its GroupSpill form over the budget) where
    ops/kernels.takes_grouped."""
    from terminal_raytracer_tpu_torch.ops import kernels

    if kernels.takes_grouped(tr):
        return kernels.GROUPED_EXTRA[kernels._kind(tr)].__name__ + _spill(tr)
    return "extra_kernel" + _sfx(tr)


def _nonzero(got) -> dict:
    """The launch counts of the kernels that were launched."""
    return {name: n for name, n in got.items() if n}


def _reset_launches():
    from terminal_raytracer_tpu_torch.ops import kernels

    for name in LAUNCH_NAMES:
        getattr(kernels, name).launches = 0


def _launches():
    from terminal_raytracer_tpu_torch.ops import kernels

    return {name: getattr(kernels, name).launches for name in LAUNCH_NAMES}


def _traversal_counts(accel, counts) -> str:
    """The kernels' traversal counters (CulledPrims.STATS,
    GatheredPrims.STATS) in words."""
    a, b, c, d = (float(v) for v in counts)
    if accel == "grid":
        return (f"{a:.0f} sweeps, {c / max(b + c, 1.0):.3f} of {b + c:.0f} "
                f"block tests culled, {d / max(a, 1.0):.2f} primitive tests "
                "a sweep")
    return (f"{a:.0f} walks, {b / max(a, 1.0):.2f} tests and "
            f"{c / max(a, 1.0):.2f} advances a walk, {d:.0f} at the trip cap")


def _counted_launch(tr, fn):
    """fn() with the kernels' traversal counters of tracer `tr` on:
    (output, counters)."""
    import torch

    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.double().cpu()
    finally:
        tr.accel_stats = None


def _run_engine(tag, label, scene, full_color, frames, animate=None,
                transport="reference", accel="auto"):
    """Drive `frames` frames (after one warm-up) through Engine with the
    launch counters reset first. Returns the launches by kernel. With an
    opt-in traversal the warm-up frame also reads its counters."""
    import torch

    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    eng = Engine(scene, full_color=full_color, device="cuda",
                 deterministic=SEED, animate=animate, transport=transport,
                 accel=accel)
    _reset_launches()
    traversal = eng.step.tracer.traversal
    if traversal:
        _, counts = _counted_launch(eng.step.tracer,
                                    lambda: eng.render_one(eng.frame_count))
        if traversal == "gathered" and float(counts[3]) != 0.0:
            fail(f"[{tag}] {label}: a walk reached the trip cap")
    else:
        eng.render_one(eng.frame_count)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = []
    for _ in range(frames):
        out = eng.render_one(eng.frame_count)
        rays.append(out.rays)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = _launches()
    tr = eng.step.tracer
    accel, chunked = tr.accel, tr.chunk_base is not None
    n = frames + 1
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    want[_a_name(tr)] = n
    if tr.base_samples < tr.spp:
        want[_b_name(tr)] = n
    total_rays = sum(float(r) for r in rays)
    rgb = out.rgb
    finite = bool(torch.isfinite(eng.state.acc).all())
    flat = bool(rgb.max() == rgb.min())
    print(f"[{tag}] {label}: {scene.width}x{scene.height} spp "
          f"{scene.samples_per_pixel} depth {scene.max_depth}, "
          f"{scene.primitive_count} primitives, accel {accel}"
          f"{', chunked' if chunked else ''}"
          f"{', animate ' + animate if animate else ''}"
          f"{', transport ' + transport if transport != 'reference' else ''}"
          f", {frames} frames: {1e3 * dt / frames:.2f} ms/frame, "
          f"{total_rays / dt / 1e6:.1f} Mray/s, occupancy "
          f"{float(out.occupancy):.3f} (1 + {tr.nee_sweeps} sweeps an "
          f"iteration), launches {_nonzero(got)}, finite {finite}, "
          f"rgb range [{int(rgb.min())}, {int(rgb.max())}]"
          + (f"; warm-up frame: {_traversal_counts(traversal, counts)}"
             if traversal else ""), flush=True)
    if got != want:
        fail(f"[{tag}] {label}: launch counts {got}, expected {want}")
    if not finite or flat:
        fail(f"[{tag}] {label}: accumulation not finite or image flat")
    return got


def _add(total, got):
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def _against_plain(tag, label, tr, render, pose, seed, arrays=None):
    """One frame of the kernel pipeline `render` against the plain whole
    frame of `tr` on the card (the same per-frame scene buffer)."""
    import torch

    cur_k, var_k, tot_k, rays_k, _ = render(pose, seed, 0, arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur_p, var_p, tot_p, rays_p, _ = tr.render_frame(pose, seed, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = max(maxrel(a, b) for a, b in zip(cur_k, cur_p))
    same = {"rays": float(rays_k) == float(rays_p),
            "samples": bool(torch.equal(tot_k, tot_p)),
            "variance": bool(torch.equal(var_k, var_p))}
    print(f"[{tag}] {label} against the plain pipeline: rays "
          f"{float(rays_k):.0f} vs {float(rays_p):.0f}, equal {same}, maxrel "
          f"{rel:.3e}, {int((tot_p > tr.base_samples).sum())} budgeted "
          f"pixels; plain {1e3 * dt:.1f} ms", flush=True)
    if not all(same.values()) or not rel < TOL:
        fail(f"[{tag}] {label} disagrees with the plain pipeline")


def phase_main():
    import torch

    from terminal_raytracer_tpu_torch import cli
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    launches = {}
    ns_scene = _cornell(400, 200, 16, 32)
    for label, scene, fc, frames in (
            ("north star", ns_scene, True, 8),
            ("shipped", _cornell(400, 200, 128, 3), True, 4),
            ("ascii 80x40", _cornell(80, 40, 1, 4), False, 4)):
        _add(launches, _run_engine("main", label, scene, fc, frames))

    _reset_launches()
    rc = cli.main(["--device", "cuda", "--full-color", "--scene",
                   "Cornell_Box", "--width", "128", "--height", "32",
                   "--spp", "16", "--depth", "8", "--frames", "2"])
    got = _launches()
    print(f"[main] cli.main rc {rc}, launches {_nonzero(got)}", flush=True)
    if rc != 0 or got != dict(dict.fromkeys(LAUNCH_NAMES, 0),
                              base_kernel=2, extra_kernel_grouped=2):
        fail("[main] cli.main run failed")
    _add(launches, got)

    # The north-star frame against the plain version on the card, and the
    # plain version's speed.
    pose = _pose()
    ns = PathTracer(ns_scene, "cuda")
    render = kernels.make_sorted_render_frame(ns)
    cur_k, _, tot_k, rays_k, _ = render(pose, 7, 0)
    times, plain = [], None
    for f in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ns.render_frame(pose, 7, f)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if f == 0:
            plain = out
    cur_p, _, tot_p, rays_p, _ = plain
    rel = max(maxrel(a, b) for a, b in zip(cur_k, cur_p))
    same = float(rays_k) == float(rays_p) and bool(torch.equal(tot_k, tot_p))
    dt = sum(times) / len(times)
    print(f"[main] north star, plain PyTorch on the card: {1e3 * dt:.1f} "
          f"ms/frame, {float(rays_p) / dt / 1e6:.2f} Mray/s; kernel path vs "
          f"plain: rays {float(rays_k):.0f} vs {float(rays_p):.0f}, samples "
          f"equal {bool(torch.equal(tot_k, tot_p))}, maxrel {rel:.3e}",
          flush=True)
    if not same or not rel < TOL:
        fail("[main] north-star frame disagrees with the plain version")
    return launches


# The JAX package's bench configurations of this path (bench.py CONFIGS):
# (label, scene, width, height, spp, depth, animate, frames).
SCALE_CONFIGS = (
    ("stress1024", "stress:1024", 200, 100, 8, 6, None, 8),
    ("mesh1280", "icosphere:3", 200, 100, 8, 6, None, 8),
    # The next icosphere: 5120 triangles, rows over the grouped kernels'
    # shared-memory budget (the thread-per-entry kernels B and chunked A).
    ("mesh5120", "icosphere:4", 200, 100, 8, 6, None, 4),
    ("stress256", "stress:256", 200, 100, 8, 6, None, 8),
    ("dynamic1024", "stress:1024", 200, 100, 8, 6, "orbit", 8),
    ("dynamic", "Cornell_Box", 400, 200, 16, 32, "orbit", 8),
)


def _frames_grouped_vs_thread(tag, label, scene, frames=8, base_only=False,
                              **kw):
    """ms/frame of the sorted pipeline on one tracer (PathTracer keywords
    `kw`) with the grouped kernels and with the thread-per-entry kernels
    (the dispatch by table size turned off), in turns: thread, grouped,
    grouped, thread. `base_only`: kernel A alone in either form (its
    grouped entry wherever it serves the tracer, also below
    GROUP_BASE_MIN_PRIMS), the other kernels as the dispatch takes them.
    The forced form is no main path: its launches count nowhere."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    tr = PathTracer(scene, "cuda", **kw)
    render = kernels.make_sorted_render_frame(tr)
    pose = _pose()
    grouped = kernels.takes_grouped
    times = {"thread": [], "grouped": []}
    try:
        for form in ("thread", "grouped", "grouped", "thread"):
            def forced(tracer, kernel="extra", form=form):
                if base_only and kernel != "base":
                    return grouped(tracer, kernel)
                if form == "thread":
                    return False
                if not base_only:
                    return grouped(tracer, kernel)
                kind = kernels._kind(tracer)
                return kind in kernels.GROUPED_BASE and (
                    kind in kernels.ANY_SIZE["base"]
                    or kernels.group_smem_bytes(tracer)
                    <= kernels.GROUP_SMEM_BYTES)

            kernels.takes_grouped = forced
            render(pose, SEED, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(frames):
                render(pose, SEED, f + 1)
            torch.cuda.synchronize()
            times[form].append(1e3 * (time.perf_counter() - t0) / frames)
    finally:
        kernels.takes_grouped = grouped
    which = "kernel A" if base_only else "every kernel"
    print(f"[{tag}] {label} sorted frame in turns, {frames} frames each, "
          f"{which} thread per entry or grouped: "
          f"thread per entry {times['thread'][0]:.3f} / "
          f"{times['thread'][1]:.3f} ms/frame, grouped "
          f"{times['grouped'][0]:.3f} / {times['grouped'][1]:.3f}",
          flush=True)


def phase_scale():
    from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
    from terminal_raytracer_tpu_torch.ops import dynamic as dyn
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    launches = {}
    for label, name, w, h, spp, depth, animate, frames in SCALE_CONFIGS:
        scene = _scene(name, w, h, spp, depth)
        _add(launches, _run_engine("scale", label, scene, True, frames,
                                   animate))
    # Where the time of a frame goes now that the grouped kernels carry it,
    # and the frame through them beside the thread-per-entry kernels.
    for label, scene in (("north star", _cornell(400, 200, 16, 32)),
                         ("stress1024", _scene("stress:1024", 200, 100, 8, 6)),
                         ("mesh1280", _scene("icosphere:3", 200, 100, 8, 6)),
                         ("mesh5120", _scene("icosphere:4", 200, 100, 8, 6))):
        _device_busy("scale", label, scene, 8)
        _frames_grouped_vs_thread("scale", label, scene)
        if label == "north star":
            _frames_grouped_vs_thread("scale", label, scene, base_only=True)
    # Kernel A in either form where the dispatch takes the grouped one.
    _frames_grouped_vs_thread("scale", "stress256",
                              _scene("stress:256", 200, 100, 8, 6),
                              base_only=True)

    pose = _pose()
    tr = PathTracer(_scene("stress:1024", 200, 100, 8, 6), "cuda")
    _against_plain("scale", "stress1024 frame", tr,
                   kernels.make_sorted_render_frame(tr), pose, 7)
    for label, name, w, h, spp, depth in (
            ("dynamic1024 frame t=5", "stress:1024", 200, 100, 8, 6),
            ("dynamic Cornell 128x32 frame t=5", "Cornell_Box", 128, 32, 16,
             8)):
        scene = _scene(name, w, h, spp, depth)
        tr = PathTracer(scene, "cuda", dynamic=True)
        arrays = ANIMATORS["orbit"](dyn.pack_scene(scene), 5)
        _against_plain("scale", label, tr,
                       kernels.make_sorted_render_frame(tr), pose, 9, arrays)
    return launches


# The packaged extension scenes, rendered at their own size, spp and depth.
EXT_SCENES = ("cornell_glass", "showcase", "textured", "envmap", "bumpy")
# The EXT scenes from GROUP_BASE_MIN_PRIMS primitives on where kernel A is
# not chunked (the grouped EXT kernel A): stress:256 and stress:64 with a
# checker floor at 200x100, 8 spp, depth 6 (_checker_stress); the row of
# the kernels line is the first's.
EXT_A_SCENES = (("stress256 checker floor", "stress:256"),
                ("stress64 checker floor", "stress:64"))


def _ext_scene(name, w=None, h=None, filt=None, spp=None, depth=None):
    from terminal_raytracer_tpu_torch.models import load_scene

    return load_scene(name).with_overrides(
        width=w, height=h, texture_filter=filt, samples_per_pixel=spp,
        max_depth=depth)


def _bright_sky(scene, intensity=8.0):
    """`scene` with its sky map brightened: at envmap's own 1.4 no pixel's
    variance reaches the adaptive threshold (10), so kernel B traces
    nothing there; at 8 it budgets pixels whose extra paths end in the
    sky map."""
    import dataclasses

    return dataclasses.replace(
        scene, sky=dataclasses.replace(scene.sky, intensity=intensity))


def _checker_stress(name="stress:1024", w=200, h=100):
    """stress:1024 (or `name`) with a checker floor, w x h, 8 spp, depth 6:
    an extension scene at array scale, where auto resolves the chunk split
    (the chunked EXT kernel); icosphere:4's rows exceed the grouped kernels'
    budget."""
    import dataclasses

    scene = _scene(name, w, h, 8, 6)
    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


def _compare_base(tag, label, k, p, extra_eq=("additional",), tr=None,
                  exact=False):
    """Kernel A (or its chunk planes) against the plain version: rays and
    end states (and `extra_eq`; with the chunked tracer `tr`, the
    per-pixel chunk totals) equal, radiance within TOL (`exact`: bit for
    bit). Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    eq = {name: bool(torch.equal(getattr(k, name), getattr(p, name)))
          for name in ("rays", "state") + tuple(extra_eq)}
    if tr is not None:
        eq["totals"] = all(bool(torch.equal(a, b)) for a, b in
                           zip(_chunk_totals(tr, k), _chunk_totals(tr, p)))
    pairs = list(zip(k.csum, p.csum)) + list(zip(k.csumsq, p.csumsq))
    eq["radiance bits"] = all(bool(torch.equal(a, b)) for a, b in pairs)
    rel = max(maxrel(a, b) for a, b in pairs)
    print(f"[{tag}] {label}: rays {float(k.rays.sum()):.0f}, equal {eq}, "
          f"maxrel {rel:.3e}", flush=True)
    if (not all(v for n, v in eq.items() if exact or n != "radiance bits")
            or not rel < TOL):
        fail(f"[{tag}] {label}: disagrees")
    return max(maxabs(a, b) for a, b in pairs)


def _check_extra(tag, label, s, k, p, allow_empty=False, exact=False):
    """Kernel B's outputs `k` against the plain version's `p` on the sorted
    stream `s`: rays equal, esum within TOL (`exact`: bit for bit), and
    (unless `allow_empty`) at least one budgeted entry. Returns the max abs
    error."""
    import torch

    torch.cuda.synchronize()
    (ek, rk, _), (ep, rp, _) = k, p
    n_work = int((s.add > 0).sum())
    rays_eq = bool(torch.equal(rk, rp))
    bits = all(bool(torch.equal(x, y)) for x, y in zip(ek, ep))
    rel = max(maxrel(x, y) for x, y in zip(ek, ep))
    print(f"[{tag}] {label} kernel B: {n_work} budgeted entries, rays "
          f"{float(rk.sum()):.0f} equal {rays_eq}, esum bits equal {bits}, "
          f"maxrel {rel:.3e}", flush=True)
    if n_work == 0 and not allow_empty:
        fail(f"[{tag}] {label}: the stream has no budgeted entry")
    if not rays_eq or not rel < TOL or (exact and not bits):
        fail(f"[{tag}] {label}: kernel B disagrees")
    return max(maxabs(x, y) for x, y in zip(ek, ep))


def _compare_extra(tag, label, tr, k_fn, p_fn, a, exact=False):
    """Kernel B on the sorted stream of kernel A's output `a`, `k_fn`
    against `p_fn` (_check_extra). Returns the max abs error."""
    from terminal_raytracer_tpu_torch.ops import kernels

    s = kernels.sorted_stream(tr, a.state, a.additional)
    args = (tr, _pose(), s.xs, s.ys, s.state, s.add, s.samp0)
    return _check_extra(tag, label, s, k_fn(*args), p_fn(*args),
                        exact=exact)


def _device_busy(tag, label, scene, frames):
    """`frames` Engine frames (after a warm-up) under torch.profiler: the
    share of their wall time in which the card ran work (the union of the
    device activity intervals), and the device time per frame by kernel.
    Prints "not measured" when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED)
    eng.render_one(eng.frame_count)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            eng.render_one(eng.frame_count)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    if not spans:
        print(f"[{tag}] {label} profiled: device busy share not measured "
              "(the profiler recorded no device activity)", flush=True)
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{tag}] {label} profiled, {frames} frames: "
          f"{1e3 * wall / frames:.3f} ms/frame under the profiler, device "
          f"busy {busy / 1e3 / frames:.3f} ms/frame = "
          f"{busy / 1e6 / wall:.3f} of the wall time, {len(spans)} device "
          "activities; device ms/frame by name: " + ", ".join(
              f"{name[:48]} {us / 1e3 / frames:.3f}" for name, us in top),
          flush=True)


def phase_ext(peak):
    """The material and texture extensions: (a) each EXT kernel against its
    plain version on the packaged extension scenes at 128x64 (their spp
    and depth; envmap with a brighter sky, _bright_sky), textured
    bilinear, and the chunked EXT kernel A with chunks of 2 in both forms;
    (b) the EXT kernels on Cornell_Box (zero channels, no atlas) against
    the reference kernels, bit for bit; (c) Engine at each extension
    scene's full size, at stress:1024 and icosphere:4 with a checker
    floor (the grouped chunked EXT kernel A and its GroupSpill form on the
    main path) and at EXT_A_SCENES (the grouped EXT kernel A), with the
    device busy share of a profiled showcase and textured run; (d)
    showcase --animate orbit through Engine, and an animated frame against
    the plain pipeline; (e) cli.main on showcase; (f) each EXT kernel
    against its plain version at the main path's shapes (the five scenes
    at 400x200, the checker stress:1024 and icosphere:4 at 200x100),
    timed at the showcase, textured and checker shapes, and kernel A in
    both forms at EXT_A_SCENES (_base_both), its frame in turns with
    kernel A in either form. Returns (launches, per-kernel results); each
    kernel's error is the largest of (a) and (f)."""
    import torch

    from terminal_raytracer_tpu_torch import cli
    from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
    from terminal_raytracer_tpu_torch.ops import dynamic as dyn
    from terminal_raytracer_tpu_torch.ops import geometry as geom
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    err = {"a": 0.0, "b": 0.0, "c": 0.0, "g": 0.0, "gs": 0.0, "cg": 0.0}
    # (a)
    for name, filt in [(n, None) for n in EXT_SCENES] + [("textured",
                                                          "bilinear")]:
        scene = _ext_scene(name, 128, 64, filt)
        if scene.sky is not None:
            scene = _bright_sky(scene)
        label = f"{name}{' ' + filt if filt else ''}" \
                f"{' sky x' + str(scene.sky.intensity) if scene.sky else ''}" \
                f" 128x64 spp {scene.samples_per_pixel} depth {scene.max_depth}"
        tr = PathTracer(scene, "cuda")
        k = kernels.base_kernel_ext(tr, pose, SEED, 0)
        p = kernels.base_kernel_plain(tr, pose, SEED, 0)
        err["a"] = max(err["a"], _compare_base("ext", label, k, p))
        err["b"] = max(err["b"], _compare_extra(
            "ext", label, tr, kernels.extra_kernel_ext,
            kernels.extra_kernel_plain, k))
        err["g"] = max(err["g"], _compare_extra(
            "ext", f"{label} grouped", tr, kernels.extra_kernel_ext_grouped,
            kernels.extra_kernel_plain, k, exact=True))
    tr = PathTracer(_ext_scene("showcase", 128, 64), "cuda", chunk_base=2,
                    chunk_extra=2)
    k = kernels.base_kernel_chunked_ext(tr, pose, SEED, 0)
    p = kernels.base_kernel_chunked_plain(tr, pose, SEED, 0)
    label = f"showcase 128x64 chunked EXT kernel A, {tr.n_base_chunks} chunks"
    err["cg"] = _compare_base("ext", f"{label} of 2 grouped", k, p, (), tr,
                              exact=True)
    err["c"] = _compare_base("ext", f"{label} of 2 thread per entry",
                             kernels._launch_chunked(tr, pose, SEED, 0, 0,
                                                     None, "ext"), p, (), tr,
                             exact=True)

    # (b) The reference scene through the EXT kernels: its tables with a
    # (zero) extension table bound.
    scene = _cornell(128, 16, 16, 8)

    def with_ext(**kw):
        t = PathTracer(scene, "cuda", **kw)
        t.bind_tables(geom.scene_tables(scene, "cuda", t.accel, ext=True))
        return t

    ref, ext = PathTracer(scene, "cuda"), with_ext()
    a_ref = kernels.base_kernel(ref, pose, SEED, 0)
    a_ext = kernels.base_kernel_ext(ext, pose, SEED, 0)
    _compare_base("ext", "Cornell_Box: EXT kernel A vs reference kernel A",
                  a_ext, a_ref, ("additional", "var"))
    s = kernels.sorted_stream(ref, a_ref.state, a_ref.additional)
    b_ref = kernels.extra_kernel(ref, pose, s.xs, s.ys, s.state, s.add,
                                 s.samp0)
    b_ext = kernels.extra_kernel_ext(ext, pose, s.xs, s.ys, s.state, s.add,
                                     s.samp0)
    g_ext = kernels.extra_kernel_ext_grouped(ext, pose, s.xs, s.ys, s.state,
                                             s.add, s.samp0)
    c_ref = kernels.base_kernel_chunked(
        PathTracer(scene, "cuda", chunk_base=2), pose, SEED, 0)
    c_ext = kernels.base_kernel_chunked_ext(with_ext(chunk_base=2), pose,
                                            SEED, 0)
    torch.cuda.synchronize()
    same = all(all(bool(torch.equal(x, y)) for x, y in zip(b[0], b_ref[0]))
               and bool(torch.equal(b[1], b_ref[1])) for b in (b_ext, g_ext))
    same_c = (all(bool(torch.equal(getattr(c_ext, f), getattr(c_ref, f)))
                  for f in ("rays", "state"))
              and all(bool(torch.equal(x, y)) for x, y in
                      zip((*c_ext.csum, *c_ext.csumsq),
                          (*c_ref.csum, *c_ref.csumsq))))
    bits_a = all(bool(torch.equal(x, y)) for x, y in
                 zip((*a_ext.csum, *a_ext.csumsq),
                     (*a_ref.csum, *a_ref.csumsq)))
    print(f"[ext] Cornell_Box: EXT kernels bit-equal to the reference "
          f"kernels: A {bits_a}, B (both forms) {same}, chunked A {same_c}",
          flush=True)
    if not (bits_a and same and same_c):
        fail("[ext] the EXT kernels change a reference scene")

    # (c), (d)
    launches = {}
    for name in EXT_SCENES:
        _add(launches, _run_engine("ext", name, _ext_scene(name), True, 8))
    _add(launches, _run_engine("ext", "stress1024 checker floor",
                               _checker_stress(), True, 8))
    # Rows over the budget: the GroupSpill form of the EXT kernel B.
    _add(launches, _run_engine("ext", "mesh5120 checker floor",
                               _checker_stress("icosphere:4"), True, 4))
    # The grouped EXT kernel A's scenes (EXT_A_SCENES).
    for label, name in EXT_A_SCENES:
        _add(launches, _run_engine("ext", label, _checker_stress(name), True,
                                   8))
    _add(launches, _run_engine("ext", "showcase", _ext_scene("showcase"),
                               True, 8, "orbit"))
    for name in ("showcase", "textured"):  # outside the counted runs
        _device_busy("ext", name, _ext_scene(name), 8)
    scene = _ext_scene("showcase", 128, 32)
    tr = PathTracer(scene, "cuda", dynamic=True)
    _against_plain("ext", "showcase --animate orbit 128x32 frame t=5", tr,
                   kernels.make_sorted_render_frame(tr), pose, 9,
                   ANIMATORS["orbit"](dyn.pack_scene(scene), 5))

    # (e)
    _reset_launches()
    rc = cli.main(["--device", "cuda", "--full-color", "--scene", "showcase",
                   "--frames", "2"])
    got = _launches()
    print(f"[ext] cli.main --scene showcase rc {rc}, launches "
          f"{_nonzero(got)}",
          flush=True)
    if rc != 0 or got != dict(dict.fromkeys(LAUNCH_NAMES, 0),
                              base_kernel_ext=2, extra_kernel_ext_grouped=2):
        fail("[ext] cli.main run failed")
    _add(launches, got)

    # (f) At the main path's shapes. envmap's own sky budgets no pixel
    # (see _bright_sky), so its kernel B stream is empty there. Kernel B in
    # both forms: the grouped entry, which the wrapper takes, and the
    # thread per entry, launched directly, each bit for bit with its
    # lane-iterations the plain model's.
    def both_b(label, tr, s, pb, timed):
        """The EXT kernel B's grouped entry (through extra_kernel) and thread
        per entry on the sorted stream `s` against the plain version's
        `pb`, bit for bit; timed side by side where `timed`. Returns
        (errors, ms) by form."""
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        name = "extra_ext" + _spill(tr)
        wrapper = getattr(kernels, "extra_kernel_ext_grouped" + _spill(tr))
        n0 = wrapper.launches
        g = kernels.extra_kernel(*args)
        if wrapper.launches != n0 + 1:
            fail(f"[ext] {label}: the wrapper took no grouped EXT kernel B")
        t = kernels.extra_kernel_ext(*args)
        allow = label.startswith("envmap")
        errs = {"grouped": _check_extra("ext", f"{label} grouped", s, g, pb,
                                        allow_empty=allow, exact=True),
                "thread": _check_extra("ext", f"{label} thread per entry", s,
                                       t, pb, allow_empty=allow, exact=True)}
        it = kernels.extra_entry_iters(*args)
        _iters_model("ext", f"{label} grouped", g[2], it,
                     kernels.group_k(name))
        _iters_model("ext", f"{label} thread per entry", t[2], it, 1)
        if not timed:
            return errs, None
        ms = {"grouped": _time_cuda(lambda: kernels.extra_kernel(*args), 5),
              "thread": _time_cuda(lambda: kernels.extra_kernel_ext(*args),
                                   5)}
        _grouped_vs_thread("ext", f"{label} shapes", name, tr,
                           ms["grouped"], ms["thread"], it)
        return errs, ms

    results = {}
    for name in EXT_SCENES:
        tr = PathTracer(_ext_scene(name), "cuda")
        label = f"{name} 400x200"
        timed = name in ("textured", "showcase")
        a = kernels.base_kernel_ext(tr, pose, SEED, 0)
        s = kernels.sorted_stream(tr, a.state, a.additional)
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        if timed:
            ms_a = _time_cuda(
                lambda: kernels.base_kernel_ext(tr, pose, SEED, 0), 5)
            plain_a, ops_a, pa = _time_plain(
                tr, lambda: kernels.base_kernel_plain(tr, pose, SEED, 0))
            plain_b, ops_b, pb = _time_plain(
                tr, lambda: kernels.extra_kernel_plain(*args))
        else:
            pa = kernels.base_kernel_plain(tr, pose, SEED, 0)
            pb = kernels.extra_kernel_plain(*args)
        err["a"] = max(err["a"], _compare_base("ext", label, a, pa))
        errs, ms = both_b(label, tr, s, pb, timed)
        err["b"] = max(err["b"], errs["thread"])
        err["g"] = max(err["g"], errs["grouped"])
        if not timed:
            continue
        fixed = 4 * (tr.tables.buf.numel() + tr.atlas.numel())
        bound_a = _bound(ops_a, fixed + 44 * a.var.numel(), peak)
        bound_b = _bound(ops_b, fixed + 40 * s.add.numel(), peak)
        results[name] = (ms_a, plain_a, bound_a, ms, plain_b, bound_b)
        print(f"[ext] {name} 400x200 shapes: kernel_base_ext {ms_a:.3f} ms "
              f"(plain {plain_a:.1f} ms, bound {bound_a[0]:.4f} ms by "
              f"{bound_a[1]}: {ops_a:.4g} FP32 test operations), "
              f"kernel_extra_ext_grouped {ms['grouped']:.3f} ms, "
              f"kernel_extra_ext {ms['thread']:.3f} ms on "
              f"{int((s.add > 0).sum())} budgeted of {s.add.numel()} entries "
              f"(plain {plain_b:.1f} ms, bound {bound_b[0]:.4f} ms by "
              f"{bound_b[1]}: {ops_b:.4g} operations)", flush=True)
    # The chunked EXT kernel A in both forms at the checker stress1024
    # shapes (its grouped entry over GroupSweep) and at the checker mesh5120
    # shapes, whose rows exceed the budget (the GroupSpill form): the
    # grouped entry, which the wrapper takes, and the thread per entry,
    # launched directly, each bit for bit with its lane-iterations the
    # plain model's, timed side by side (_spill_both).
    big = PathTracer(_checker_stress(), "cuda")
    mesh = PathTracer(_checker_stress("icosphere:4"), "cuda")
    chunked = {}
    for label, tr in (("stress1024 checker floor", big),
                      ("mesh5120 checker floor", mesh)):
        if not tr.chunk_base or not kernels.takes_grouped(tr, "chunked"):
            fail(f"[ext] {label}: no chunks, or no grouped chunked EXT "
                 "kernel A")
        chunked[label] = _spill_both(label, tr, "chunked", peak, tag="ext")
        err["c"] = max(err["c"], chunked[label]["thread"][0])
    # Kernel B in both forms at the checker stress1024 shapes (its grouped
    # entry over GroupSweep) and at the checker mesh5120 shapes, whose rows
    # exceed the budget (the GroupSpill form).
    spill_row = None
    for label, tr in (("stress1024 checker floor", big),
                      ("mesh5120 checker floor", mesh)):
        ph = kernels.base_phase(tr, pose, SEED, 0)
        s = kernels.sorted_stream(tr, ph[2], ph[7])
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        plain_b, ops_b, pb = _time_plain(
            tr, lambda: kernels.extra_kernel_plain(*args))
        errs, ms_b = both_b(label, tr, s, pb, True)
        key = "gs" if _spill(tr) else "g"
        err[key] = max(err[key], errs["grouped"])
        err["b"] = max(err["b"], errs["thread"])
        bound_b = _bound(ops_b, 4 * (tr.tables.buf.numel()
                                     + tr.atlas.numel())
                         + 40 * s.add.numel(), peak)
        print(f"[ext] {label} shapes: kernel_extra_ext_grouped"
              f"{_spill(tr)} {ms_b['grouped']:.3f} ms, kernel_extra_ext "
              f"{ms_b['thread']:.3f} ms on {int((s.add > 0).sum())} "
              f"budgeted of {s.add.numel()} entries (plain {plain_b:.1f} ms, "
              f"bound {bound_b[0]:.4f} ms by {bound_b[1]}: {ops_b:.4g} "
              "operations)", flush=True)
        if key == "gs":
            spill_row = (ms_b["grouped"], plain_b, bound_b)
    # The showcase sorted frame through both forms of kernel B, and the
    # checker mesh5120 frame through both forms of every kernel, in turns.
    _frames_grouped_vs_thread("ext", "showcase", _ext_scene("showcase"))
    _frames_grouped_vs_thread("ext", "mesh5120 checker floor",
                              _checker_stress("icosphere:4"), frames=4)
    # Kernel A at the EXT gates in both forms at the checker stress:256 and
    # stress:64 (EXT_A_SCENES), where the wrapper takes the grouped entry:
    # each bit for bit with its lane-iterations, timed side by side
    # (_base_both); then the checker stress:256 frame with kernel A in
    # either form, in turns.
    grouped_a = {}
    for label, name in EXT_A_SCENES:
        tr = PathTracer(_checker_stress(name), "cuda")
        if tr.chunk_base or not kernels.takes_grouped(tr, "base"):
            fail(f"[ext] {label}: chunks, or no grouped EXT kernel A")
        grouped_a[label], _ = _base_both("ext", f"{label} shapes", tr, peak)
    _frames_grouped_vs_thread("ext", EXT_A_SCENES[0][0],
                              _checker_stress(EXT_A_SCENES[0][1]),
                              base_only=True)
    # The kernels line keeps showcase's times, and the checker stress1024
    # shapes' for the chunked EXT kernel A (its GroupSpill form's the
    # checker mesh5120 shapes').
    ms_a, plain_a, bound_a, ms_b, plain_b, bound_b = results["showcase"]
    c_big = chunked["stress1024 checker floor"]
    c_mesh = chunked["mesh5120 checker floor"]
    ga = [grouped_a[label] for label, _ in EXT_A_SCENES]
    err["a"] = max(err["a"], *(r["thread"][0] for r in ga))
    return launches, {"ga": (max(r["grouped"][0] for r in ga),
                             *ga[0]["grouped"][1:]),
                      "a": (err["a"], ms_a, plain_a, bound_a),
                      "b": (err["b"], ms_b["thread"], plain_b, bound_b),
                      "g": (err["g"], ms_b["grouped"], plain_b, bound_b),
                      "gs": (err["gs"], *spill_row),
                      "c": (err["c"], *c_big["thread"][1:]),
                      "cg": (max(err["cg"], c_big["grouped"][0]),
                             *c_big["grouped"][1:]),
                      "cgs": c_mesh["grouped"]}


# The transport and camera extensions' configurations: the JAX package's
# bench configurations fog, stratified and manylights_one (bench.py:93-94,
# :117-118, :127-128), a depth-of-field Cornell at the same size, showcase
# under MIS at its own size, and stress:1024 in fog under MIS (the chunked
# XT kernel A): (label, scene, (width, height, spp, depth) or None for the
# scene's own, overrides, transport).
XT_CONFIGS = (
    ("fog", "Cornell_Box", (400, 200, 16, 32), {"fog": 0.15}, "reference"),
    ("stratified", "Cornell_Box", (400, 200, 16, 32),
     {"sampler": "stratified"}, "reference"),
    ("dof", "Cornell_Box", (400, 200, 16, 32),
     {"aperture": 0.1, "focus_distance": 3.0}, "reference"),
    ("manylights_one", "lights:16", None, {"light_sample": "power"},
     "reference"),
    ("showcase mis", "showcase", None, {}, "mis"),
    ("stress1024 fog mis", "stress:1024", (200, 100, 8, 6), {"fog": 0.15},
     "mis"),
)


# Where [xt] also holds both forms' executed lane-iterations to the plain
# model (the plain scheduler's per-entry iterations cost a plain run), and
# where it times them; and the XT config whose rows exceed the grouped
# kernels' budget (Engine through the thread-per-entry XT kernel B).
XT_ITERS = ("fog", "manylights_one", "stress1024 fog mis")
XT_TIMED = ("fog", "stress1024 fog mis")
XT_OVER_BUDGET = ("mesh5120 fog", "icosphere:4", (200, 100, 8, 6),
                  {"fog": 0.15}, "reference")


def _xt_scene(name, size, over):
    from terminal_raytracer_tpu_torch.models import load_scene
    from terminal_raytracer_tpu_torch.models.scene import Fog

    over = dict(over)
    if "fog" in over:
        over["fog"] = Fog(density=over["fog"])
    if size is not None:
        over.update(zip(("width", "height", "samples_per_pixel",
                         "max_depth"), size))
    return load_scene(name).with_overrides(**over)


def phase_xt(peak):
    """The transport and camera extensions: (a) each XT kernel against its
    plain version at the XT_CONFIGS shapes (the chunked kernel A and its
    chunked kernel B stream on stress:1024), timed at the fog and
    stress:1024 shapes: kernel B and the chunked A in both forms (the
    grouped entry, which the wrapper takes, and the thread-per-entry
    entry), kernel A at fog in both forms (held to its residency bound,
    which the wrapper takes, and unbound), each bit for bit, their
    lane-iterations held to the plain model at XT_ITERS (the chunked A at
    stress:1024, A at fog); (b) the XT kernels on Cornell_Box with every
    gate off (xt tables bound to a reference tracer) against the reference
    kernels, bit for bit; (c) Engine through every XT config, through
    manylights (every light: the reference kernels) and through
    XT_OVER_BUDGET, the fog frame with the grouped and the thread-per-entry
    kernels in turns and with kernel A bound and unbound in turns, and the
    mesh5120 fog frame profiled and in turns; (d) cli.main with --mis
    --fog. Returns (launches, per-kernel results)."""
    import torch

    from terminal_raytracer_tpu_torch import cli
    from terminal_raytracer_tpu_torch.ops import build, kernels
    from terminal_raytracer_tpu_torch.ops import geometry as geom
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
    from terminal_raytracer_tpu_torch.ops.vecmath import V3

    pose = _pose()
    err = {"a": 0.0, "b": 0.0, "c": 0.0, "cg": 0.0, "g": 0.0}
    timed = {}
    # (a)
    for label, name, size, over, transport in XT_CONFIGS:
        tr = PathTracer(_xt_scene(name, size, over), "cuda",
                        transport=transport)
        if not tr.xt:
            fail(f"[xt] {label}: the tracer takes no XT kernel")
        shape = (f"{label} {tr.width}x{tr.height} spp {tr.spp} depth "
                 f"{tr.max_depth}, 1 + {tr.nee_sweeps} sweeps an iteration")
        fixed = 4 * (tr.tables.buf.numel() + tr.atlas.numel())
        if tr.chunk_base:
            # Both forms of the chunked XT kernel A: the grouped entry, which
            # the wrapper takes, and the thread per entry, launched directly.
            n0 = kernels.base_kernel_chunked_xt_grouped.launches
            k = kernels.base_kernel_chunked_xt(tr, pose, SEED, 0)
            if kernels.base_kernel_chunked_xt_grouped.launches != n0 + 1:
                fail(f"[xt] {label}: the wrapper took no grouped chunked XT "
                     "kernel A")
            th = kernels._launch_chunked(tr, pose, SEED, 0, 0, None, "xt")
            ms = _time_cuda(lambda: kernels.base_kernel_chunked_xt(
                tr, pose, SEED, 0), 5)
            ms_t = _time_cuda(lambda: kernels._launch_chunked(
                tr, pose, SEED, 0, 0, None, "xt"), 5)
            plain, ops, p = _time_plain(
                tr, lambda: kernels.base_kernel_chunked_plain(tr, pose, SEED,
                                                              0))
            err["cg"] = max(err["cg"], _compare_base(
                "xt", f"{shape}, chunked XT kernel A grouped", k, p, (), tr,
                exact=True))
            err["c"] = max(err["c"], _compare_base(
                "xt", f"{shape}, chunked XT kernel A thread-per-entry", th, p,
                (), tr, exact=True))
            it = kernels.chunked_entry_iters(tr, pose, SEED, 0)
            _iters_model("xt", f"{label} chunked XT kernel A grouped",
                         k.iters, it, kernels.group_k("chunked_xt"))
            _iters_model("xt", f"{label} chunked XT kernel A thread", th.iters,
                         it, 1)
            n_ent = tr.n_base_chunks * tr.width * tr.height
            bound_c = _bound(ops, fixed + 36 * n_ent, peak)
            timed["cg"] = (ms, plain, bound_c)
            _grouped_vs_thread("xt", f"{label} shapes", "chunked_xt", tr, ms,
                               ms_t, it)
            print(f"[xt] {label} shapes: base_kernel_chunked_xt_grouped "
                  f"{ms:.3f} ms, thread per entry {ms_t:.3f} ms on {n_ent} "
                  f"entries (plain {plain:.1f} ms, bound {bound_c[0]:.4f} ms "
                  f"by {bound_c[1]}: {ops:.4g} operations)", flush=True)
            var = tr.variance_of(V3(*(tr.chunk_total(v) for v in k.csum)),
                                 V3(*(tr.chunk_total(v) for v in k.csumsq)))
            s = kernels.sorted_stream(tr, k.state[0], tr.extra_quota(var)[1])
        else:
            k = kernels.base_kernel_xt(tr, pose, SEED, 0)
            if label == "fog":
                # Both forms: held to its residency bound (shipped) and
                # unbound (group_tune.cu's), bit for bit, timed side by side.
                unbound = build.load_kernels((_unbound_a_source(),))

                def launch_u():
                    return kernels._launch_base(tr, pose, SEED, 0, 0, None,
                                                None, "xt", unbound)

                ku = launch_u()
                ms_a = _time_cuda(
                    lambda: kernels.base_kernel_xt(tr, pose, SEED, 0), 5)
                ms_u = _time_cuda(launch_u, 5)
                plain_a, ops_a, p = _time_plain(
                    tr, lambda: kernels.base_kernel_plain(tr, pose, SEED, 0))
                bound_a = _bound(ops_a, fixed + 44 * k.var.numel(), peak)
                timed["a"] = (ms_a, plain_a, bound_a)
                err["a"] = max(err["a"], _compare_base(
                    "xt", f"{shape}, XT kernel A unbound", ku, p,
                    ("additional", "var"), exact=True))
                it = kernels.base_entry_iters(tr, pose, SEED, 0)
                _iters_model("xt", f"{label} XT kernel A", k.iters, it, 1)
                _iters_model("xt", f"{label} XT kernel A unbound", ku.iters,
                             it, 1)
                minb = build.load_kernels().trt_kernel_base_xt_min_blocks()
                print(f"[xt] {label} shapes: base_kernel_xt held to {minb} "
                      f"blocks an SM {ms_a:.3f} ms, unbound {ms_u:.3f} ms "
                      f"(x{ms_u / ms_a:.2f}) on {k.var.numel()} pixels, "
                      f"{-(-k.var.numel() // 128)} blocks (plain {plain_a:.1f}"
                      f" ms, bound {bound_a[0]:.4f} ms by {bound_a[1]}: "
                      f"{ops_a:.4g} operations)", flush=True)
            else:
                p = kernels.base_kernel_plain(tr, pose, SEED, 0)
            err["a"] = max(err["a"], _compare_base(
                "xt", f"{shape}, XT kernel A", k, p, ("additional", "var"),
                exact=True))
            s = kernels.sorted_stream(tr, k.state, k.additional)
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        b = kernels.extra_kernel_xt(*args)
        n0 = kernels.extra_kernel_xt_grouped.launches
        g = kernels.extra_kernel(*args)
        if kernels.extra_kernel_xt_grouped.launches != n0 + 1:
            fail(f"[xt] {label}: the wrapper took no grouped XT kernel B")
        if label in XT_TIMED:
            ms_b = _time_cuda(lambda: kernels.extra_kernel_xt(*args), 5)
            ms_g = _time_cuda(lambda: kernels.extra_kernel(*args), 5)
            plain_b, ops_b, pb = _time_plain(
                tr, lambda: kernels.extra_kernel_plain(*args))
            bound_b = _bound(ops_b, fixed + 40 * s.add.numel(), peak)
            if label == "fog":
                timed["b"] = (ms_b, plain_b, bound_b)
                timed["g"] = (ms_g, plain_b, bound_b)
            print(f"[xt] {label} shapes: extra_kernel_xt_grouped {ms_g:.3f} "
                  f"ms, extra_kernel_xt {ms_b:.3f} ms on "
                  f"{int((s.add > 0).sum())} budgeted of {s.add.numel()} "
                  f"entries (plain {plain_b:.1f} ms, bound {bound_b[0]:.4f} "
                  f"ms by {bound_b[1]}: {ops_b:.4g} operations)", flush=True)
        else:
            pb = kernels.extra_kernel_plain(*args)
        err["b"] = max(err["b"], _check_extra(
            "xt", f"{shape} thread-per-entry", s, b, pb, exact=True))
        err["g"] = max(err["g"], _check_extra("xt", f"{shape} grouped", s, g,
                                              pb, exact=True))
        if label in XT_ITERS:
            it = kernels.extra_entry_iters(*args)
            _iters_model("xt", label, g[2], it, kernels.group_k("extra_xt"))
            _iters_model("xt", label, b[2], it, 1)
            if label in XT_TIMED:
                _grouped_vs_thread("xt", f"{label} shapes", "extra_xt", tr,
                                   ms_g, ms_b, it)
    for key, kernel, where in (("a", "base_kernel_xt", "fog"),
                               ("b", "extra_kernel_xt", "fog"),
                               ("g", "extra_kernel_xt_grouped", "fog"),
                               ("cg", "base_kernel_chunked_xt_grouped",
                                "stress1024 fog mis")):
        ms, plain, bound = timed[key]
        print(f"[xt] {kernel} at the {where} shapes: {ms:.3f} ms (plain "
              f"{plain:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]})",
              flush=True)

    # (b) The reference scene through the XT kernels, every gate off.
    scene = _cornell(128, 16, 16, 8)

    def with_xt(**kw):
        t = PathTracer(scene, "cuda", **kw)
        t.bind_tables(geom.scene_tables(scene, "cuda", t.accel, xt=True))
        return t

    ref, xt = PathTracer(scene, "cuda"), with_xt()
    a_ref = kernels.base_kernel(ref, pose, SEED, 0)
    a_xt = kernels.base_kernel_xt(xt, pose, SEED, 0)
    _compare_base("xt", "Cornell_Box, every gate off: XT kernel A vs "
                  "reference kernel A", a_xt, a_ref, ("additional", "var"))
    s = kernels.sorted_stream(ref, a_ref.state, a_ref.additional)
    b_ref = kernels.extra_kernel(ref, pose, s.xs, s.ys, s.state, s.add,
                                 s.samp0)
    b_xt = kernels.extra_kernel_xt(xt, pose, s.xs, s.ys, s.state, s.add,
                                   s.samp0)
    c_ref = kernels.base_kernel_chunked(
        PathTracer(scene, "cuda", chunk_base=2), pose, SEED, 0)
    c_xt = kernels.base_kernel_chunked_xt(with_xt(chunk_base=2), pose, SEED,
                                          0)
    torch.cuda.synchronize()
    bits_a = all(bool(torch.equal(x, y)) for x, y in
                 zip((*a_xt.csum, *a_xt.csumsq), (*a_ref.csum, *a_ref.csumsq)))
    same_b = (all(bool(torch.equal(x, y)) for x, y in zip(b_xt[0], b_ref[0]))
              and bool(torch.equal(b_xt[1], b_ref[1])))
    same_c = (all(bool(torch.equal(getattr(c_xt, f), getattr(c_ref, f)))
                  for f in ("rays", "state"))
              and all(bool(torch.equal(x, y)) for x, y in
                      zip((*c_xt.csum, *c_xt.csumsq),
                          (*c_ref.csum, *c_ref.csumsq))))
    print(f"[xt] Cornell_Box, every gate off: XT kernels bit-equal to the "
          f"reference kernels: A {bits_a}, B {same_b}, chunked A {same_c}",
          flush=True)
    if not (bits_a and same_b and same_c):
        fail("[xt] the XT kernels change a reference scene")

    # (c) Engine, and manylights beside manylights_one; then the fog frame
    # through both forms of kernel B in turns.
    launches = {}
    manylights = ("manylights", "lights:16", None, {}, "reference")
    for label, name, size, over, transport in ((manylights,) + XT_CONFIGS
                                               + (XT_OVER_BUDGET,)):
        _add(launches, _run_engine("xt", label, _xt_scene(name, size, over),
                                   True, 4 if name == "icosphere:4" else 8,
                                   transport=transport))
    _frames_grouped_vs_thread("xt", "fog", _xt_scene(*XT_CONFIGS[0][1:4]))
    _frames_xt_a_in_turns("xt", "fog", _xt_scene(*XT_CONFIGS[0][1:4]))
    _device_busy("xt", "mesh5120 fog", _xt_scene(*XT_OVER_BUDGET[1:4]), 4)
    _frames_grouped_vs_thread("xt", "mesh5120 fog",
                              _xt_scene(*XT_OVER_BUDGET[1:4]), frames=4)

    # (d)
    _reset_launches()
    rc = cli.main(["--device", "cuda", "--full-color", "--scene",
                   "Cornell_Box", "--width", "128", "--height", "32",
                   "--spp", "16", "--depth", "8", "--frames", "2", "--mis",
                   "--fog", "0.15"])
    got = _launches()
    print(f"[xt] cli.main --mis --fog 0.15 rc {rc}, launches "
          f"{_nonzero(got)}",
          flush=True)
    if rc != 0 or got != dict(dict.fromkeys(LAUNCH_NAMES, 0),
                              base_kernel_xt=2, extra_kernel_xt_grouped=2):
        fail("[xt] cli.main run failed")
    _add(launches, got)
    res = {k: (err[k], *timed[k]) for k in ("a", "b", "g", "cg")}
    return launches, {**res, "c": (err["c"],)}


# The opt-in traversals' kernels against their plain versions, at the JAX
# bench's stress1024 and mesh1280 shapes: (label, scene, accel).
ACCEL_KERNELS = (("stress1024", "stress:1024", "grid"),
                 ("stress1024", "stress:1024", "gathered"),
                 ("mesh1280", "icosphere:3", "gathered"))
ACCEL_ENGINE = (("stress256", "stress:256"), ("stress1024", "stress:1024"),
                ("mesh1280", "icosphere:3"))
# Rows and group table over the grouped kernels' budget: Engine through the
# thread-per-entry grid kernel B.
ACCEL_OVER_BUDGET = ("mesh5120", "icosphere:4")
# The chunked grid kernel A's shapes (200x100, 8 spp, depth 6, chunks of 2):
# within the budget (its grouped entry over GroupCulled) and over it (its
# GroupCulledSpill form); the sorted main path runs at both.
CHUNKED_GRID = (("stress1024 grid cb 2", "stress:1024"),
                ("mesh5120 grid cb 2", "icosphere:4"))
# The chunked gathered kernel A's shapes (the same size and chunks): its
# grouped entry over GroupWalk, which serves every table size. Its
# main-path launches come from [sched].
CHUNKED_GATHERED = (("stress1024 gathered cb 2", "stress:1024"),
                    ("mesh1280 gathered cb 2", "icosphere:3"))


def _check_counts(label, k, p):
    """The kernels' traversal counters `k` equal the plain traversal's `p`,
    and (gathered) no walk reached the trip cap."""
    print(f"[accel] {label}: kernel counters {[int(v) for v in k]}, plain "
          f"{[int(v) for v in p]}", flush=True)
    if not bool((k == p).all()):
        fail(f"[accel] {label}: the kernel's traversal counters differ from "
             "the plain version's")
    if "gathered" in label and float(k[3]) != 0.0:
        fail(f"[accel] {label}: a walk reached the trip cap")


def _grid_vs_dense(pose):
    """How far the grid moves off the dense sweep over the same blocked
    scene (the JAX oracle's traversal under accel 'grid') at the stress1024
    shapes: one frame through the grid kernels and one through the XT
    kernels over the blocked scene's dense table sweep (bit-exact against
    their plain versions above and in [xt]), the same seed; the pixels and
    owed rays that differ."""
    import torch

    from terminal_raytracer_tpu_torch.ops import accel as accel_mod
    from terminal_raytracer_tpu_torch.ops import geometry as geom
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    scene = _scene("stress:1024", 200, 100, 8, 6)
    grid = PathTracer(scene, "cuda", accel="grid")
    blocked, _ = accel_mod.blocked_scene(scene)
    dense = PathTracer(blocked, "cuda", accel="baked")
    dense.bind_tables(geom.scene_tables(blocked, "cuda", "baked", xt=True))
    if dense.chunk_base is not None or not dense.xt:
        fail("[accel] the dense tracer splits chains or takes no XT kernel")
    diffs = []
    for seed in (SEED, 7, 9):
        g = kernels.make_sorted_render_frame(grid)(pose, seed, 0)
        d = kernels.make_sorted_render_frame(dense)(pose, seed, 0)
        torch.cuda.synchronize()
        px = torch.zeros_like(g[1], dtype=torch.bool)
        for a, b in zip(g[0], d[0]):
            px |= a != b
        err = max(maxabs(a, b) for a, b in zip(g[0], d[0]))
        diffs.append((seed, int(px.sum()), int((g[2] != d[2]).sum()),
                      float(g[3]) - float(d[3]), float(d[3]), err))
    print("[accel] stress1024 200x100 spp 8 depth 6, grid kernels vs the "
          "dense sweep over the blocked scene (the JAX oracle's traversal): "
          + "; ".join(f"seed {s}: {n} of {scene.width * scene.height} pixels "
                      f"differ ({t} in samples, max abs {e:.3g}), owed rays "
                      f"{r:+.0f} of {rd:.0f}" for s, n, t, r, rd, e in diffs),
          flush=True)


def _sorted_main_path(tag, label, tr, frames):
    """The sorted pipeline (make_render_frame(tr, 'sorted')) on tracer
    `tr`: a warm-up and `frames` frames, the launch counters reset just
    before and read just after; kernel A's wrapper (_a_name) and kernel B's
    (_b_name) must each have launched once a frame, and the frame be
    finite. Returns the launches."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels

    pose = _pose()
    render = kernels.make_render_frame(tr, "sorted")
    _reset_launches()
    render(pose, SEED, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = 0.0
    for f in range(frames):
        out = render(pose, SEED, f + 1)
        rays += float(out[3])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / frames
    got = _launches()
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    want[_a_name(tr)] = frames + 1
    if tr.base_samples < tr.spp:
        want[_b_name(tr)] = frames + 1
    finite = all(bool(torch.isfinite(c).all()) for c in out[0])
    print(f"[{tag}] {label} sorted main path, {frames} frames: "
          f"{1e3 * dt:.2f} ms/frame, {rays / frames / dt / 1e6:.1f} Mray/s, "
          f"occupancy {float(out[4]):.3f}, launches {_nonzero(got)}, finite "
          f"{finite}", flush=True)
    if got != want:
        fail(f"[{tag}] {label}: launch counts {got}, expected {want}")
    if not finite:
        fail(f"[{tag}] {label}: the frame is not finite")
    return got


def phase_accel(peak):
    """The opt-in traversals (module docstring). Returns (launches, results
    by kernel: max abs error, ms, plain ms, bound at the stress1024
    shapes; the chunked grid kernel A's GroupCulledSpill form at
    mesh5120)."""
    from terminal_raytracer_tpu_torch import cli
    from terminal_raytracer_tpu_torch.ops import build, kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    res, err_gs, err_at_all, err_a_all = {}, {}, {}, {}
    for label, name, accel in ACCEL_KERNELS:
        tr = PathTracer(_scene(name, 200, 100, 8, 6), "cuda", accel=accel)
        wrap_b = getattr(kernels, f"extra_kernel_{accel}")
        tag = f"{label} {accel}"
        # The plain versions are timed at the stress1024 shapes only (the
        # walk's plain version steps every lane at once: seconds a call).
        timed = label == "stress1024"
        plain_run = _time_plain if timed else _plain_counted
        # Kernel A's grouped entry, which the wrapper takes, and its
        # thread-per-pixel entry: bit for bit, both counters the plain
        # version's, the lane-iterations the plain model's.
        res_a, k = _base_both("accel", tag, tr, peak, timed_plain=timed)
        err_a, ms_a, plain_a, bound_a = res_a["grouped"]
        err_at_all[accel] = max(err_at_all.get(accel, 0.0),
                                res_a["thread"][0])
        err_a_all[accel] = max(err_a_all.get(accel, 0.0), err_a)
        s = kernels.sorted_stream(tr, k.state, k.additional)
        args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)
        b, kc = _counted_launch(tr, lambda: wrap_b(*args))
        pc = []
        plain_b, ops_b, pb = plain_run(
            tr, lambda: kernels.extra_kernel_plain(*args), pc)
        err_b = _check_extra("accel", tag, s, b, pb)
        _check_counts(f"{tag} kernel B", kc, pc[0])
        ms_b = _time_cuda(lambda: wrap_b(*args), 5)
        if err_a != 0.0 or err_b != 0.0:
            fail(f"[accel] {tag}: a kernel is not bit-exact against its "
                 "plain version")
        # Kernel B's grouped entry, which the wrapper takes (GroupCulled,
        # GroupWalk): bit for bit, its counters the plain version's and the
        # thread-per-entry entry's, its lane-iterations the plain model's.
        wrapper = kernels.GROUPED_EXTRA[accel]
        n0 = wrapper.launches
        g, gc = _counted_launch(tr, lambda: kernels.extra_kernel(*args))
        if wrapper.launches != n0 + 1:
            fail(f"[accel] {tag}: the wrapper took no grouped kernel B")
        err_g = _check_extra("accel", f"{tag} grouped", s, g, pb, exact=True)
        err_gs[accel] = max(err_gs.get(accel, 0.0), err_g)
        _check_counts(f"{tag} grouped kernel B", gc, pc[0])
        _check_counts(f"{tag} grouped against thread-per-entry kernel B", gc,
                      kc)
        it = kernels.extra_entry_iters(*args)
        _iters_model("accel", tag, g[2], it, kernels.group_k(f"extra_{accel}"))
        _iters_model("accel", tag, b[2], it, 1)
        ms_g = _time_cuda(lambda: kernels.extra_kernel(*args), 5)
        _grouped_vs_thread("accel", f"{tag} shapes", f"extra_{accel}", tr,
                           ms_g, ms_b, it)
        fixed = 4 * (tr.tables.buf.numel() + tr.atlas.numel())
        bound_b = _bound(ops_b, fixed + 40 * s.add.numel(), peak)
        print(f"[accel] {tag} shapes: {_a_name(tr)} {ms_a:.3f} ms "
              f"(plain {_fmt_ms(plain_a)}, bound {bound_a[0]:.4f} ms by "
              f"{bound_a[1]}), "
              f"extra_kernel_{accel} {ms_b:.3f} ms on "
              f"{int((s.add > 0).sum())} budgeted of {s.add.numel()} entries "
              f"(plain {_fmt_ms(plain_b)}, bound {bound_b[0]:.4f} ms by "
              f"{bound_b[1]}: {ops_b:.4g} operations)", flush=True)
        if timed:
            res[accel, "a"] = (err_a, ms_a, plain_a, bound_a)
            res[accel, "at"] = res_a["thread"][1:]
            res[accel, "b"] = (err_b, ms_b, plain_b, bound_b)
            res[accel, "g"] = (ms_g, plain_b, bound_b)
    for accel in ("grid", "gathered"):
        res[accel, "g"] = (err_gs[accel], *res[accel, "g"])
        res[accel, "at"] = (err_at_all[accel], *res[accel, "at"])
        res[accel, "a"] = (err_a_all[accel], *res[accel, "a"][1:])

    _grid_vs_dense(pose)

    # The chunked grid kernel A at chunks of 2 (CHUNKED_GRID): its grouped
    # entry, which the wrapper takes (over the budget its GroupCulledSpill
    # form), and the thread per entry, launched directly, bit for bit with
    # the traversal counters, timed in turns; then the sorted main path.
    launches, cg = {}, {}
    for label, name in CHUNKED_GRID:
        tr = PathTracer(_scene(name, 200, 100, 8, 6), "cuda", accel="grid",
                        chunk_base=2, chunk_extra=2)
        if not kernels.takes_grouped(tr, "chunked") or tr.n_base_chunks < 2:
            fail(f"[accel] {label}: no chunks or no grouped chunked grid A")
        cg[label] = _spill_both(label, tr, "chunked", peak, tag="accel",
                                turns=True)
        _add(launches, _sorted_main_path("accel", label, tr, 4))
    (w_label, _), (o_label, _) = CHUNKED_GRID
    res["grid", "cg"] = cg[w_label]["grouped"]
    res["grid", "cgs"] = cg[o_label]["grouped"]
    res["grid", "ct"] = (max(cg[w_label]["thread"][0],
                             cg[o_label]["thread"][0]),
                         *cg[w_label]["thread"][1:])
    # The chunked gathered kernel A at chunks of 2 (CHUNKED_GATHERED): its
    # grouped entry, which the wrapper takes, and the thread per entry,
    # launched directly, in turns. The rows' times at the stress1024
    # shapes, the errors over both.
    for label, name in CHUNKED_GATHERED:
        tr = PathTracer(_scene(name, 200, 100, 8, 6), "cuda",
                        accel="gathered", chunk_base=2, chunk_extra=2)
        if not kernels.takes_grouped(tr, "chunked") or tr.n_base_chunks < 2:
            fail(f"[accel] {label}: no chunks or no grouped chunked "
                 "gathered A")
        cg[label] = _spill_both(label, tr, "chunked", peak, tag="accel",
                                turns=True)
    (w_label, _), (m_label, _) = CHUNKED_GATHERED
    for form, key in (("grouped", "cg"), ("thread", "ct")):
        res["gathered", key] = (max(cg[w_label][form][0],
                                    cg[m_label][form][0]),
                                *cg[w_label][form][1:])
    for label, name in ACCEL_ENGINE:
        for accel in ("baked", "auto", "grid", "gathered"):
            _add(launches, _run_engine(
                "accel", f"{label} {accel}", _scene(name, 200, 100, 8, 6),
                True, 8, accel=accel))
    label, name = ACCEL_OVER_BUDGET
    _add(launches, _run_engine("accel", f"{label} grid",
                               _scene(name, 200, 100, 8, 6), True, 4,
                               accel="grid"))
    for base_only in (False, True):
        _frames_grouped_vs_thread("accel", "stress1024 grid",
                                  _scene("stress:1024", 200, 100, 8, 6),
                                  base_only=base_only, accel="grid")
    # The gathered frames through both forms of kernels A and B, and of
    # kernel A alone, in turns.
    for label, name in (("stress1024", "stress:1024"),
                        ("mesh1280", "icosphere:3")):
        for base_only in (False, True):
            _frames_grouped_vs_thread("accel", f"{label} gathered",
                                      _scene(name, 200, 100, 8, 6),
                                      base_only=base_only, accel="gathered")
    _add(launches, _run_engine("accel", "north star grid",
                               _cornell(400, 200, 16, 32), True, 8,
                               accel="grid"))
    # The thread-per-pixel grid kernel A at the north star under grid (too
    # few primitives for the grouped entry), which the wrapper takes, held
    # to its residency bound, and unbound (_unbound_a_source's): each bit
    # for bit with the plain version's counters, timed side by side at
    # that shape.
    ns = PathTracer(_cornell(400, 200, 16, 32), "cuda", accel="grid")
    if kernels.takes_grouped(ns, "base"):
        fail("[accel] north star grid takes the grouped kernel A")
    unbound = build.load_kernels((_unbound_a_source(),))

    def launch_u():
        return kernels._launch_base(ns, pose, SEED, 0, 0, None, None, "grid",
                                    unbound)

    k, kc = _counted_launch(ns, lambda: kernels.base_kernel(ns, pose, SEED, 0))
    ku, kuc = _counted_launch(ns, launch_u)
    pc = []
    plain, ops, p = _time_plain(
        ns, lambda: kernels.base_kernel_plain(ns, pose, SEED, 0), pc)
    err = max(_compare_base("accel", f"north star grid kernel A {form}", o,
                            p, ("additional", "var"), exact=True)
              for form, o in (("bound", k), ("unbound", ku)))
    it = kernels.base_entry_iters(ns, pose, SEED, 0)
    for form, o, c in (("bound", k, kc), ("unbound", ku, kuc)):
        _check_counts(f"north star grid kernel A {form}", c, pc[0])
        _iters_model("accel", f"north star grid kernel A {form}", o.iters, it,
                     1)
    ms_u = _time_cuda(launch_u, 5)
    ms = _time_cuda(lambda: kernels.base_kernel(ns, pose, SEED, 0), 5)
    bound = _bound(ops, 4 * (ns.tables.buf.numel() + ns.atlas.numel())
                   + 44 * k.var.numel(), peak)
    minb = build.load_kernels().trt_kernel_base_grid_min_blocks()
    print(f"[accel] north star grid shapes: base_kernel_grid held to {minb} "
          f"blocks an SM {ms:.3f} ms, unbound {ms_u:.3f} ms (x{ms_u / ms:.2f})"
          f" (plain {plain:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]}: "
          f"{ops:.4g} operations)", flush=True)
    res["grid", "ans"] = (err, ms, plain, bound)
    for accel in ("grid", "gathered"):
        _reset_launches()
        rc = cli.main(["--device", "cuda", "--full-color", "--scene",
                       "stress:256", "--accel", accel, "--frames", "1"])
        got = _launches()
        print(f"[accel] cli.main --scene stress:256 --accel {accel} rc {rc}, "
              f"launches {_nonzero(got)}", flush=True)
        a, b = (f"base_kernel_{accel}_grouped",
                f"extra_kernel_{accel}_grouped")
        want = dict(dict.fromkeys(LAUNCH_NAMES, 0), **{a: 1, b: 1})
        if rc != 0 or got != want:
            fail(f"[accel] cli.main --accel {accel} failed")
        _add(launches, got)
    return launches, res


# Kernels C and D at the main path's shapes, one config per instantiation
# (and the chunk-split stress1024 for the reference one), then mesh5120
# over the budget and one config for each other form of the queue entries
# (ops/kernels.frame_form: the thread per item below 16 primitives, the
# group within the 96 KB budget, the spill form over it), so that the main
# path launches every queue entry, those at 100x50 to keep the phase's plain
# frames short: (label, scene ('checker <scene>': with a checker floor, 8
# spp, depth 6), (width, height, spp, depth) or None for the scene's own,
# overrides, PathTracer keywords). The traversal configs of the first six
# split chains explicitly, so the sorted pipeline there runs the chunked
# kernel A over the traversal.
SCHED_CONFIGS = (
    ("north star", "Cornell_Box", (400, 200, 16, 32), {}, {}),
    ("stress1024", "stress:1024", (200, 100, 8, 6), {}, {}),
    ("showcase", "showcase", None, {}, {}),
    ("fog", "Cornell_Box", (400, 200, 16, 32), {"fog": 0.15}, {}),
    ("stress1024 grid cb 2", "stress:1024", (200, 100, 8, 6), {},
     dict(accel="grid", chunk_base=2, chunk_extra=2)),
    ("stress1024 gathered cb 2", "stress:1024", (200, 100, 8, 6), {},
     dict(accel="gathered", chunk_base=2, chunk_extra=2)),
    ("mesh5120", "icosphere:4", (200, 100, 8, 6), {}, {}),
    ("stress64 checker", "checker stress:64", (100, 50, 8, 6), {}, {}),
    ("mesh5120 checker", "checker icosphere:4", (100, 50, 8, 6), {}, {}),
    ("stress1024 fog mis", "stress:1024", (100, 50, 8, 6), {"fog": 0.15},
     dict(transport="mis")),
    ("mesh5120 fog", "icosphere:4", (100, 50, 8, 6), {"fog": 0.15}, {}),
    ("Cornell grid", "Cornell_Box", (100, 50, 8, 6), {}, dict(accel="grid")),
    ("mesh5120 grid", "icosphere:4", (100, 50, 8, 6), {}, dict(accel="grid")),
    ("Cornell gathered", "Cornell_Box", (100, 50, 8, 6), {},
     dict(accel="gathered")),
)
SCHED_FRAMES = 5


def _sched_scene(name, size, over):
    if name.startswith("checker "):
        return _checker_stress(name.split(" ", 1)[1], *size[:2])
    return _xt_scene(name, size, over)


def _frames_equal(a, b) -> bool:
    """current, variance, samples and rays of two FrameOuts, bit for bit."""
    import torch

    return all(bool(torch.equal(x, y)) for x, y in
               zip((*a.current, a.var, a.total, a.rays),
                   (*b.current, b.var, b.total, b.rays)))


def _queue_name(tr, mode) -> str:
    """The wrapper of the queue entry that tracer `tr` takes in `mode`."""
    from terminal_raytracer_tpu_torch.ops import kernels

    return kernels.FRAME_QUEUE[mode, kernels._kind(tr),
                               kernels.frame_form(tr)].__name__


def phase_sched(peak):
    """Kernels C and D (csrc/kernel_frame.cu) and the chunked kernel A over
    the opt-in traversals: (a) at the SCHED_CONFIGS shapes, each queue entry
    the tracer takes (group.cuh kernel_frame_queue, through the wrapper)
    and the thread-per-pixel entry of its instantiation (launched directly:
    OFF_PATH) against the plain version, bit for bit (planes; traversal
    counters; counts: lockstep's static formula for both, regen's between
    the items' sum and 32 / K times it for the queue entry and the warp
    count of the per-pixel iterations for the thread per pixel), both
    timed; (b) the chunked grid and gathered kernel A's thread per entry,
    launched directly, against its plain version at stress1024, with
    counters; (c) the main path of this slice: make_render_frame with
    'sorted', 'regen' and 'lockstep' on every config, the launch counters
    reset just before and read just after, ms/frame side by side with the
    queue entry's K, form and resident blocks an SM; C, D and sorted must
    give one frame. Returns (launches, results by row: queue rows by (mode,
    kind, form), thread-per-pixel rows by mode + suffix)."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = _pose()
    res, tracers = {}, []
    for label, name, size, over, kw in SCHED_CONFIGS:
        tr = PathTracer(_sched_scene(name, size, over), "cuda", **kw)
        tracers.append((label, tr))
        sfx, kind, form = _sfx(tr), kernels._kind(tr), kernels.frame_form(tr)
        kb, ke = kernels.FRAME_QUEUE_K[kind, form]
        fixed = 4 * tr.tables.buf.numel() + (
            4 * tr.atlas.numel() if tr.atlas is not None else 0)
        shape = (f"{label} {tr.width}x{tr.height} spp {tr.spp} depth "
                 f"{tr.max_depth}{', chunks ' if tr.chunk_base else ''}"
                 f"{tr.chunk_base or ''}")
        # One plain frame serves every entry: the queue regen's count lies
        # between the items' sum and 32 / K times it, the thread per
        # pixel's is the warp count of its per-pixel iterations, D's the
        # static formula.
        pc = [] if tr.traversal else None
        plain_ms, ops, p = _time_plain(
            tr, lambda: tr.render_pixels(pose, SEED, 0), pc)
        cur, var, total, rays, lane_iters, _ = p
        lo, hi = kernels.regen_iters_bounds(lane_iters, min(kb, ke))
        static = kernels.lockstep_iters(tr)
        n_budget = int((total > tr.base_samples).sum())
        if n_budget == 0:
            fail(f"[sched] {shape}: no pixel takes extra samples")
        n_pix = tr.width * tr.height
        bound = _bound(ops, fixed + 24 * n_pix, peak)
        for mode in ("regen", "lockstep"):
            queue = kernels.FRAME_QUEUE[mode, kind, form]

            def old(m=mode):
                return kernels._launch_frame(tr, pose, SEED, 0, 0, None,
                                             f"trt_kernel_{m}", kind)

            times = {}
            for entry, fn in (("queue", lambda: queue(tr, pose, SEED, 0)),
                              ("thread", old)):
                if tr.traversal:
                    k, kc = _counted_launch(tr, fn)
                    if not bool((kc == pc[0]).all()):
                        fail(f"[sched] {shape} {mode} {entry}: traversal "
                             f"counters {kc.tolist()} differ from the plain "
                             f"version's {pc[0].tolist()}")
                else:
                    k = fn()
                torch.cuda.synchronize()
                it = float(k.iters)
                if mode == "lockstep":
                    count_ok, model = it == static, f"static {static:.0f}"
                elif entry == "queue":
                    count_ok = lo <= it <= hi
                    model = f"items' sum {lo:.0f}, 32 / K x it {hi:.0f}"
                else:
                    w = float(kernels.warp_iters(lane_iters))
                    count_ok, model = it == w, f"warp count {w:.0f}"
                same = (_frames_equal(k, kernels.FrameOut(cur, var, total,
                                                          rays, None)))
                err = max(maxabs(a, b) for a, b in zip(k.current, cur))
                times[entry] = ms = _time_cuda(fn, 5)
                occ = float(k.rays.sum(dtype=torch.float64)) / max(
                    it * (1 + tr.nee_sweeps), 1.0)
                what = (f"{queue.__name__} (KB {kb}, KE {ke}, {form}, "
                        f"{kernels.frame_queue_per_sm(tr, mode, pose)} "
                        "blocks an SM)" if entry == "queue" else
                        f"{mode}_kernel{sfx} (thread per pixel)")
                print(f"[sched] {shape}: {what} {ms:.3f} ms, bit-equal to "
                      f"the plain frame {same}, lane-iterations {it:.0f} "
                      f"({model}: within {count_ok}; {it / static:.3f} of "
                      f"lockstep's), occupancy {occ:.3f}"
                      + (f"; {_traversal_counts(tr.traversal, kc)}"
                         if tr.traversal else ""), flush=True)
                if not same or not count_ok:
                    fail(f"[sched] {shape}: {what} disagrees with the plain "
                         "version")
                # Times from the first config of each entry, the error
                # over all of them.
                key = ((mode, kind, form) if entry == "queue"
                       else f"{mode}{sfx}")
                res[key] = ((max(res[key][0], err),) + res[key][1:]
                            if key in res else (err, ms, plain_ms, bound))
            print(f"[sched] {shape}: {mode} queue / thread per pixel "
                  f"{times['queue']:.3f} / {times['thread']:.3f} ms "
                  f"(plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms by "
                  f"{bound[1]}: {ops:.4g} FP32 operations; {n_budget} "
                  "budgeted pixels)", flush=True)
        if tr.traversal and tr.chunk_base:  # (b): the thread per entry
            def wrap(t, *a):
                return kernels._launch_chunked(t, *a, 0, None, t.traversal)

            k, kc = _counted_launch(tr, lambda: wrap(tr, pose, SEED, 0))
            pc = []
            plain_c, ops_c, pk = _time_plain(
                tr, lambda: kernels.base_kernel_chunked_plain(tr, pose, SEED,
                                                              0), pc)
            err = _compare_base("sched", f"{shape} chunked kernel A", k, pk,
                                (), tr)
            _check_counts(f"{shape} chunked kernel A{sfx}", kc, pc[0])
            ms = _time_cuda(lambda: wrap(tr, pose, SEED, 0), 5)
            n_ent = tr.n_base_chunks * tr.width * tr.height
            bound_c = _bound(ops_c, fixed + 36 * n_ent, peak)
            if err != 0.0:
                fail(f"[sched] {shape}: the chunked kernel A is not bit-exact")
            print(f"[sched] {shape}: kernel_base_chunked{sfx} (thread per "
                  f"entry) {ms:.3f} ms on "
                  f"{n_ent} entries (plain {plain_c:.1f} ms, bound "
                  f"{bound_c[0]:.4f} ms by {bound_c[1]}: {ops_c:.4g} FP32 "
                  "operations)", flush=True)
            key = f"chunked{sfx}"
            res[key] = ((max(res[key][0], err),) + res[key][1:]
                        if key in res else (err, ms, plain_c, bound_c))

    # (c) This slice's main path: every config through every scheduler.
    _reset_launches()
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    n = SCHED_FRAMES + 1
    for label, tr in tracers:
        first, times = {}, {}
        for mode in kernels.MODES:
            render = kernels.make_render_frame(tr, mode)
            first[mode] = render(pose, SEED, 0)  # warm-up, compared below
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(SCHED_FRAMES):
                out = render(pose, SEED, f + 1)
            torch.cuda.synchronize()
            times[mode] = (time.perf_counter() - t0) / SCHED_FRAMES
            times[mode, "occ"] = float(out[4])
            if mode == "sorted":
                want[_a_name(tr)] += n
                want[_b_name(tr)] += n
            else:
                want[_queue_name(tr, mode)] += n
        ref = first["sorted"]
        same = {mode: float(first[mode][3]) == float(ref[3])
                and bool(torch.equal(first[mode][2], ref[2]))
                and all(bool(torch.equal(a, b)) for a, b in
                        zip((*first[mode][0], first[mode][1]),
                            (*ref[0], ref[1])))
                for mode in ("regen", "lockstep")}
        kind, form = kernels._kind(tr), kernels.frame_form(tr)
        print(f"[sched] {label} {tr.width}x{tr.height} spp {tr.spp} depth "
              f"{tr.max_depth}, {SCHED_FRAMES} frames each: " + ", ".join(
                  f"{mode} {1e3 * times[mode]:.2f} ms/frame (occupancy "
                  f"{times[mode, 'occ']:.3f})" for mode in kernels.MODES)
              + f"; queue entries {kind} {form}, KB / KE "
              + " / ".join(map(str, kernels.FRAME_QUEUE_K[kind, form]))
              + ", resident blocks an SM "
              + " / ".join(str(kernels.frame_queue_per_sm(tr, m, pose))
                           for m in ("regen", "lockstep"))
              + f"; rays {float(ref[3]):.0f}; regen and lockstep frames equal "
              f"the sorted frame {same}", flush=True)
        if not all(same.values()):
            fail(f"[sched] {label}: C, D and sorted render different frames")
    got = _launches()
    print(f"[sched] main path launches {_nonzero(got)}", flush=True)
    if got != want:
        fail(f"[sched] launch counts {got}, expected {want}")
    missing = [k for k in QUEUE_NAMES + (
        "base_kernel_chunked_grid_grouped",
        "base_kernel_chunked_gathered_grouped") if got[k] == 0]
    if missing:
        fail(f"[sched] not launched on the main path: {missing}")
    return got, res


MESH_FRAMES = 5


def _plain_kernels():
    """A context in which ops/kernels.base_kernel and extra_kernel are their
    plain versions (on the card), so that the mesh module's phases run as
    their plain yardstick; launches made there count nowhere."""
    import contextlib

    from terminal_raytracer_tpu_torch.ops import kernels

    @contextlib.contextmanager
    def swap():
        saved = kernels.base_kernel, kernels.extra_kernel
        kernels.base_kernel = kernels.base_kernel_plain
        kernels.extra_kernel = kernels.extra_kernel_plain
        try:
            yield
        finally:
            kernels.base_kernel, kernels.extra_kernel = saved

    return swap()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh(peak):
    """The multi-GPU path (parallel/mesh.py) on one card: (a) kernel A with
    each shard's runtime quota and seed at the north star, sp = 3 (shares
    2, 1, 1) on the whole image and on the px = 2 row block y0 = 100,
    against base_kernel_plain with the same arguments, timed per share;
    (b) the sample-split composition (sample_split_frame: every shard's
    phases in one process, the sums over sp in rank order) for sp = 2 and
    3 against the same phases on the plain versions, and its ms/frame
    beside the unsharded sorted frame; (c) a real process group of one
    rank over NCCL: Engine with a (1, 1) mesh against Engine without one,
    bit for bit, every kernel of the path launched once a frame. The
    counters are reset before (b) and read after (c). Returns (launches,
    the kernel_base_quota row)."""
    import datetime

    import torch
    import torch.distributed as dist

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
    from terminal_raytracer_tpu_torch.parallel import mesh as pm
    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    pose = _pose()
    ns_scene = _cornell(400, 200, 16, 32)
    # (a) kernel A with a runtime quota, each share against its plain version.
    split3 = pm.SampleSplit(ns_scene, "cuda", 3)
    tr = split3.tracer
    scene_bytes = 4 * tr.tables.buf.numel()
    err, row = 0.0, None
    for y0, h_out, where in ((0, None, "400x200"),
                             (100, 100, "rows [100, 200)")):
        for sp_i in range(3):
            q, seed = split3.share(sp_i), split3.seed(SEED, sp_i)

            def launch():
                return kernels.base_kernel(tr, pose, seed, 0, y0, h_out,
                                           base_q=q)

            took = getattr(kernels, _a_name(tr))
            n0 = took.launches
            k = launch()
            if took.launches != n0 + 1:
                fail(f"[mesh] kernel A {where} quota {q}: not launched "
                     f"through {took.__name__}")
            plain_ms, ops, p = _time_plain(
                tr, lambda: kernels.base_kernel_plain(tr, pose, seed, 0, y0,
                                                      h_out, base_q=q))
            e = _compare_base("mesh", f"kernel A {where}, sp {sp_i} of 3, "
                              f"quota {q}", k, p, ("additional", "var"))
            err = max(err, e)
            ms = _time_cuda(launch, 5)
            n_pix = p.var.numel()
            bound = _bound(ops, scene_bytes + 44 * n_pix, peak)
            print(f"[mesh] kernel A {where} quota {q} (seed {seed}) through "
                  f"{took.__name__}: "
                  f"{ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
                  f"{bound[0]:.4f} ms by {bound[1]}: {ops:.4g} FP32 "
                  "operations)", flush=True)
            if row is None:  # the largest share at full width
                row = [ms, plain_ms, bound]

    # (b) the sample-split composition against its plain phases.
    _reset_launches()
    kernels.base_kernel.quota_launches = 0
    render = kernels.make_sorted_render_frame(PathTracer(ns_scene, "cuda"))
    render(pose, SEED, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(MESH_FRAMES):
        render(pose, SEED + f, f)
    torch.cuda.synchronize()
    flat_ms = 1e3 * (time.perf_counter() - t0) / MESH_FRAMES
    for n_sp in (2, 3):
        split = pm.SampleSplit(ns_scene, "cuda", n_sp)
        got = pm.sample_split_frame(split, pose, SEED, 0)
        with _plain_kernels():
            want = pm.sample_split_frame(split, pose, SEED, 0)
        torch.cuda.synchronize()
        cur, var, total, rays, _ = got
        pcur, pvar, ptotal, prays, _ = want
        # (The executed lane-iterations differ by design: a warp's count
        # against the plain scheduler's count over all lanes.)
        same = {"rays": float(rays) == float(prays),
                "totals": bool(torch.equal(total, ptotal)),
                "variance": bool(torch.equal(var, pvar))}
        rel = max(maxrel(a, b) for a, b in zip(cur, pcur))
        err_c = max(maxabs(a, b) for a, b in zip(cur, pcur))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(MESH_FRAMES):
            out = pm.sample_split_frame(split, pose, SEED + f, f)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / MESH_FRAMES
        budgeted = int((total > split.base_full).sum())
        print(f"[mesh] sample split sp {n_sp} (base shares "
              f"{[split.share(i) for i in range(n_sp)]}), north star: "
              f"{ms:.2f} ms/frame (unsharded sorted frame {flat_ms:.2f}), "
              f"rays {float(rays):.0f}, {budgeted} budgeted pixels, "
              f"occupancy {float(out[3]) / max(float(out[4]), 1.0):.3f}; "
              f"against the plain phases: equal {same}, maxrel {rel:.3e}, "
              f"max abs {err_c:.3e}", flush=True)
        if not all(same.values()) or not rel < TOL or budgeted == 0:
            fail(f"[mesh] sp {n_sp} composition disagrees with its plain "
                 "phases")

    # (c) one rank over NCCL: the sharded Engine against the plain Engine.
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0))
    try:
        engines = {}
        for label, kw in (("engine", {}), ("mesh (1, 1)",
                                           {"shard": (1, 1)})):
            eng = Engine(ns_scene, full_color=True, device="cuda",
                         deterministic=SEED, **kw)
            before = _launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetched = eng.run_headless(MESH_FRAMES)
            dt = (time.perf_counter() - t0) / MESH_FRAMES
            runs = {k: v - before[k] for k, v in _launches().items()}
            engines[label] = (eng, fetched, runs)
            print(f"[mesh] {label}: {MESH_FRAMES} frames, "
                  f"{1e3 * dt:.2f} ms/frame, launches {_nonzero(runs)}",
                  flush=True)
        (e1, f1, r1), (e2, f2, r2) = engines.values()
        same = {"rgb": bool((f1[0] == f2[0]).all()),
                "rays": f1[2] == f2[2], "mean samples": f1[3] == f2[3],
                "acc": bool(torch.equal(e1.state.acc, e2.state.acc)),
                "variance": bool(torch.equal(e1.state.variance,
                                             e2.state.variance)),
                "samples": bool(torch.equal(e1.state.samples,
                                            e2.state.samples))}
        want = dict(dict.fromkeys(LAUNCH_NAMES, 0), base_kernel=MESH_FRAMES,
                    extra_kernel_grouped=MESH_FRAMES)
        print(f"[mesh] the (1, 1) mesh over NCCL against Engine: equal "
              f"{same}", flush=True)
        if not all(same.values()) or r1 != want or r2 != want:
            fail("[mesh] the one-rank mesh disagrees with Engine, or a "
                 "kernel was not launched once a frame")
    finally:
        dist.destroy_process_group()
    got = _launches()
    quota = kernels.base_kernel.quota_launches
    print(f"[mesh] main path launches {_nonzero(got)}, kernel A with a "
          f"runtime quota {quota}", flush=True)
    if quota != (2 + 3) * (MESH_FRAMES + 1):
        fail(f"[mesh] kernel A with a runtime quota launched {quota} times")
    return got, (err, *row, quota)


def phase_denoise():
    """The à-trous filter (ops/denoise.py) on the card: one north-star
    Engine run with denoise 1.0 (finite, not flat, the filter changing the
    image), the filter held against the same filter on a CPU copy of its
    inputs (rtol 1e-5), and timed. Returns the launches."""
    import numpy as np
    import torch

    from terminal_raytracer_tpu_torch.ops import denoise as dn
    from terminal_raytracer_tpu_torch.ops.vecmath import V3
    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    scene = _cornell(400, 200, 16, 32)
    _reset_launches()
    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED,
                 denoise=1.0)
    eng.render_one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_FRAMES):
        out = eng.render_one(eng.frame_count)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / MESH_FRAMES
    got = _launches()
    st, fn = eng.state, eng.frame_count - 1
    args = (V3(*st.acc), st.variance, st.samples, fn, 1.0, 3)
    k = torch.stack(list(dn.denoise_acc(*args)))
    ms = _time_cuda(lambda: dn.denoise_acc(*args), 5, queued=False)
    cpu = torch.stack(list(dn.denoise_acc(
        V3(*st.acc.cpu()), st.variance.cpu(), st.samples.cpu(), fn, 1.0, 3)))
    rel = maxrel(k.cpu(), cpu)
    finite = bool(torch.isfinite(k).all())
    rgb = out.rgb
    flat = bool(rgb.max() == rgb.min())
    changed = not bool(torch.equal(k, st.acc))
    print(f"[denoise] north star, denoise 1.0, 3 passes, {MESH_FRAMES} "
          f"frames: {1e3 * dt:.2f} ms/frame; the filter {ms:.3f} ms on the "
          f"card, maxrel to the CPU filter {rel:.3e}, finite {finite}, "
          f"changes the image {changed}, rgb range [{int(rgb.min())}, "
          f"{int(rgb.max())}], launches {_nonzero(got)}", flush=True)
    if not finite or flat or not changed or not rel <= 1e-5:
        fail("[denoise] the filter on the card is wrong")
    want = dict(dict.fromkeys(LAUNCH_NAMES, 0), base_kernel=MESH_FRAMES + 1,
                extra_kernel_grouped=MESH_FRAMES + 1)
    if got != want:
        fail(f"[denoise] launch counts {got}, expected {want}")
    return got


OFFLINE_SIZE = (400, 200, 16, 32)  # Cornell_Box at its full width
OFFLINE_FRAMES = 8
CHUNK_TIMING = (("stress1024", "stress:1024", 200, 100, 8, 6),)
CHUNK_TIMING_FRAMES = 240
# run_headless's noise reads: (label, keyword arguments); timed in the
# order A B C C B A.
CHUNK_TIMING_MODES = (("read every frame", dict(until_noise=0.0, chunk=1)),
                      ("read every 8", dict(until_noise=0.0, chunk=8)),
                      ("no read", {}))


def _cli_quiet(argv):
    """cli.main(argv) with its output kept: (exit code, stdout, stderr)."""
    import contextlib
    import io

    from terminal_raytracer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _offline_frames(seed, n, start=0):
    """--scan's seeds of frames start .. start + n - 1."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2**32, size=n, dtype=np.uint64)
            + np.arange(start, start + n, dtype=np.uint64)).astype(np.uint32)


def phase_offline():
    """The display transforms, checkpoints and offline modes (runtime/
    offline.py, runtime/engine.py, cli.py) on the card at Cornell_Box's full
    width, each against per-frame driving of the same step, bit for bit;
    then the headless ms/frame at stress1024 by how often the noise
    scalar is read. Returns the launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from terminal_raytracer_tpu_torch.ops import tonemap as tm
    from terminal_raytracer_tpu_torch.ops.vecmath import V3
    from terminal_raytracer_tpu_torch.runtime import (init_state,
                                                      make_render_step)
    from terminal_raytracer_tpu_torch.runtime.engine import Engine
    from terminal_raytracer_tpu_torch.utils import imageio
    from terminal_raytracer_tpu_torch.utils.statefile import (load_state,
                                                              save_state)

    t_phase = time.perf_counter()
    w, h, spp, depth = OFFLINE_SIZE
    scene = _cornell(w, h, spp, depth)
    pose = _pose()
    base = ["--device", "cuda", "--scene", "Cornell_Box", "--width", str(w),
            "--height", str(h), "--spp", str(spp), "--depth", str(depth),
            "--full-color", "--deterministic", str(SEED)]
    frames = 0  # Cornell_Box frames rendered on the card in this phase
    _reset_launches()
    d = tempfile.mkdtemp(prefix="offline-")

    def same(a, b):
        return bool(torch.equal(a, b))

    # (a) cli --scan --frames 8 against the step driven once a frame.
    n = OFFLINE_FRAMES
    rc, _, err = _cli_quiet(base + ["--frames", str(n), "--scan",
                                    "--tonemap", "aces", "--exposure", "0.5",
                                    "--save-state", f"{d}/scan.npz",
                                    "--dump-image", f"{d}/scan.ppm"])
    frames += n
    if rc:
        fail(f"[offline] cli --scan exited {rc}: {err}")
    step = make_render_step(scene, True, device="cuda", tonemap="aces",
                            exposure=0.5)
    state = init_state(scene, "cuda")
    for i, seed in enumerate(_offline_frames(SEED, n)):
        out = step(state, pose, int(seed), i)
        state = out.state
    frames += n
    got, fc, _ = load_state(f"{d}/scan.npz", device="cuda")
    img = torch.from_numpy(imageio.read_ppm(f"{d}/scan.ppm").copy()).cuda()
    ok = {"acc": same(got.acc, state.acc), "image": same(img, out.rgb),
          "frames": fc == n}
    print(f"[offline] cli --scan --frames {n} --tonemap aces --exposure 0.5 "
          f"against the step once a frame: equal {ok}", flush=True)
    if not all(ok.values()):
        fail("[offline] --scan differs from per-frame driving")

    # (b) each tonemap mode on the card against the same function on the
    # CPU, from that accumulation.
    acc_d, acc_h = V3(*state.acc), V3(*state.acc.cpu())
    worst = 0
    for mode in ("reference", "aces", "gamma:2.2"):
        for stops in (-1.0, 0.0, 1.5):
            m, s = tm.parse_mode(mode), 2.0 ** stops
            pairs = [(tm.tonemap_fullcolor(acc_d, m, s),
                      tm.tonemap_fullcolor(acc_h, m, s))]
            pairs += list(zip(tm.tonemap_ascii(acc_d, m, s),
                              tm.tonemap_ascii(acc_h, m, s)))
            diffs = [(a.cpu().int() - b.int()).abs() for a, b in pairs]
            big = max(int(x.max()) for x in diffs)
            off = sum(int((x > 0).sum()) for x in diffs)
            worst = max(worst, big)
            print(f"[offline] tonemap {mode} exposure {stops:+.1f}: "
                  f"{off} of {sum(x.numel() for x in diffs)} u8 values "
                  f"differ from the CPU's, at most by {big}", flush=True)
    heat = (tm.variance_heatmap(state.variance).cpu().int()
            - tm.variance_heatmap(state.variance.cpu()).int()).abs()
    worst = max(worst, int(heat.max()))
    if worst > 1:
        fail("[offline] a tonemap on the card is more than one level off "
             "the CPU's")

    # (c) run_headless (one image, from the last frame) against the step
    # with its image once a frame.
    n_head = 2 * n + 3
    ea, e1 = (Engine(scene, full_color=True, device="cuda",
                     deterministic=SEED, tonemap="gamma:2.2", exposure=-1.0)
              for _ in range(2))
    fa = ea.run_headless(n_head)
    for _ in range(n_head):
        out = e1.render_one(e1.frame_count)
    frames += 2 * n_head
    ok = {"acc": same(ea.state.acc, e1.state.acc),
          "rgb": bool(np.array_equal(fa[0], out.rgb.cpu().numpy())),
          "rays": fa[2] == float(out.rays)}
    print(f"[offline] run_headless({n_head}) against the step with its "
          f"image once a frame: equal {ok}", flush=True)
    if not all(ok.values()):
        fail("[offline] the headless runner differs from per-frame driving")

    # (d) --until-noise with and without --scan: the scan's chunks of 8
    # against the engine's explicit chunks of 8, at a threshold between the
    # estimates after 2 and 3 chunks, and the per-frame stop.
    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED)
    est = []
    for _ in range(3):
        eng.run_headless(n)
        est.append(eng._noise_estimate(eng.state))
    frames += 3 * n
    thr = float(np.sqrt(est[1] * est[2]))
    done = {}
    for label, extra in (("--scan", ["--scan"]), ("per frame", [])):
        rc, _, err = _cli_quiet(base + ["--frames", str(4 * n),
                                        "--until-noise", repr(thr),
                                        "--save-state", f"{d}/noise.npz"]
                                + extra)
        if rc:
            fail(f"[offline] cli --until-noise {label} exited {rc}: {err}")
        done[label] = load_state(f"{d}/noise.npz")[1]
        frames += done[label]
    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED)
    eng.run_headless(4 * n, until_noise=thr, chunk=n)
    done["engine, chunks of 8"] = eng.frame_count
    frames += eng.frame_count
    print(f"[offline] --until-noise {thr:.6g} (estimates {est[1]:.6g} after "
          f"2 chunks, {est[2]:.6g} after 3; margin x"
          f"{min(est[1] / thr, thr / est[2]):.3f}), --frames {4 * n}: frames "
          f"done {done}", flush=True)
    if not done["--scan"] == done["engine, chunks of 8"] == 3 * n:
        fail("[offline] --until-noise --scan stopped elsewhere than the "
             "chunked engine")
    if not 0 < done["per frame"] <= 4 * n:
        fail("[offline] --until-noise without --scan rendered no frame")

    # (e) --turntable 3 --frames 4, with and without --scan.
    for label, extra in (("", []), (" --scan", ["--scan"])):
        rc, _, err = _cli_quiet(base + ["--frames", "4", "--turntable", "3",
                                        "--dump-image", f"{d}/tt.png"]
                                + extra)
        frames += 3 * 4
        imgs = [imageio.read_png(f"{d}/tt_{k:03d}.png") for k in range(3)]
        # The orbit leaves the open side of the box: the poses behind its
        # walls see (nearly) black, so only the first must be a picture.
        distinct = not all(np.array_equal(i, imgs[0]) for i in imgs)
        flat = imgs[0].max() == imgs[0].min()
        print(f"[offline] --turntable 3 --frames 4{label}: exit {rc}, "
              f"images {imgs[0].shape}, mean levels "
              f"{[round(float(i.mean()), 2) for i in imgs]}, distinct "
              f"{distinct}, first flat {flat}", flush=True)
        if rc or not distinct or flat:
            fail(f"[offline] --turntable{label}: {err}")

    # (f) --animate orbit --scan --frames 4 against an animated Engine.
    rc, _, err = _cli_quiet(base + ["--frames", "4", "--animate", "orbit",
                                    "--scan", "--dump-image",
                                    f"{d}/anim.ppm"])
    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED,
                 animate="orbit")
    eq = []
    for k in range(4):
        out = eng.render_one(0)
        img = imageio.read_ppm(f"{d}/anim_{k:03d}.ppm")
        eq.append(bool(np.array_equal(img, out.rgb.cpu().numpy())))
    frames += 8
    print(f"[offline] --animate orbit --scan --frames 4: exit {rc}, frames "
          f"equal to an animated Engine's {eq}", flush=True)
    if rc or not all(eq):
        fail(f"[offline] --animate --scan differs: {err}")

    # (g) a checkpoint after 4 frames, loaded, 4 more: 8 straight.
    eng = Engine(scene, full_color=True, device="cuda", deterministic=SEED)
    eng.run_headless(4)
    save_state(f"{d}/ck.npz", eng.state, eng.frame_count, eng.camera)
    straight = eng.run_headless(4)
    eng2 = Engine(scene, full_color=True, device="cuda", deterministic=SEED)
    eng2.restore(*load_state(f"{d}/ck.npz", expect_shape=(h, w)))
    for _ in range(eng2.frame_count):
        eng2._rng.randint(0, 2**32, dtype=np.uint64)
    resumed = eng2.run_headless(4)
    frames += 12 + 3  # and the 64x32 checkpoint's frames below
    ok = {"acc": same(eng.state.acc, eng2.state.acc),
          "rgb": bool((straight[0] == resumed[0]).all()),
          "frame_count": eng2.frame_count == 8}
    # A checkpoint written on the card resumes on the CPU (a small one:
    # the CPU renders the plain versions).
    small = _cornell(64, 32, 8, 3)
    ec = Engine(small, full_color=True, device="cuda", deterministic=SEED)
    ec.run_headless(2)
    save_state(f"{d}/small.npz", ec.state, ec.frame_count, ec.camera)
    cpu = Engine(small, full_color=True, device="cpu", deterministic=SEED)
    cpu.restore(*load_state(f"{d}/small.npz", expect_shape=(32, 64)))
    seeds = [cpu._seed() for _ in range(3)][2:]  # the card's third draw
    ec_out = ec.render_one(ec.frame_count)
    cpu_out = cpu.step(cpu.state, cpu.camera.pose(), seeds[0], 2)
    rel = maxrel(ec_out.state.acc.cpu(), cpu_out.state.acc)
    ok["resumes on the CPU"] = (float(ec_out.rays) == float(cpu_out.rays)
                                and rel < TOL)
    print(f"[offline] 4 frames, a checkpoint, 4 more against 8 straight; "
          f"a 64x32 checkpoint of the card resumed on the CPU (maxrel "
          f"{rel:.3e} to the card's third frame): equal {ok}", flush=True)
    if not all(ok.values()):
        fail("[offline] a resumed checkpoint differs")

    # (h) --profile DIR: a torch.profiler trace with the kernels in it.
    rc, _, err = _cli_quiet(base + ["--frames", "2", "--profile",
                                    f"{d}/prof"])
    frames += 2
    with open(f"{d}/prof/trace_rank0.json") as f:
        events = json.load(f).get("traceEvents", [])
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    kernels_seen = (any("kernel_base" in k for k in names)
                    and any("kernel_extra" in k for k in names))
    print(f"[offline] --profile: exit {rc}, {len(events)} trace events, "
          f"{len(names)} kernel names, kernels A and B among them "
          f"{kernels_seen}", flush=True)
    if rc or not kernels_seen:
        fail(f"[offline] --profile wrote no trace of the kernels: {err}")

    got = _launches()
    want = dict(dict.fromkeys(LAUNCH_NAMES, 0), base_kernel=frames,
                extra_kernel_grouped=frames)
    print(f"[offline] {frames} Cornell_Box {w}x{h} frames on the card, "
          f"launches {_nonzero(got)}", flush=True)
    if got != want:
        fail(f"[offline] launch counts {got}, expected {want}")

    # (i) the headless ms/frame by how often the noise scalar is read
    # (information).
    for label, name, cw, ch, cspp, cdepth in CHUNK_TIMING:
        cs = _scene(name, cw, ch, cspp, cdepth)
        engs = {mode: Engine(cs, full_color=True, device="cuda",
                             deterministic=SEED)
                for mode, _ in CHUNK_TIMING_MODES}
        for mode, kw in CHUNK_TIMING_MODES:
            engs[mode].run_headless(8, **kw)  # warm-up
        order = CHUNK_TIMING_MODES + CHUNK_TIMING_MODES[::-1]
        ms = []
        for mode, kw in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engs[mode].run_headless(CHUNK_TIMING_FRAMES, **kw)
            torch.cuda.synchronize()
            ms.append((mode, 1e3 * (time.perf_counter() - t0)
                       / CHUNK_TIMING_FRAMES))
        runs = ", ".join(f"{mode} {t:.3f}" for mode, t in ms)
        means = ", ".join(
            f"{mode} {np.mean([t for k, t in ms if k == mode]):.3f}"
            for mode, _ in CHUNK_TIMING_MODES)
        print(f"[offline] {label} {cw}x{ch} {cspp} spp depth {cdepth}: "
              f"run_headless({CHUNK_TIMING_FRAMES}) ms/frame, the noise "
              f"scalar (--until-noise 0) read every frame / every 8 frames "
              f"/ no read, in turns: {runs}; means {means} | "
              f"{_smi('name,power.limit')}", flush=True)
    got = _launches()
    print(f"[offline] done in {time.perf_counter() - t_phase:.1f} s, "
          f"launches {_nonzero(got)}", flush=True)
    return got


EXAMPLES = ("render_png", "custom_scene", "animate", "glass", "multichip")
# The frames of the card against the CPU, each scene cut to
# tools/card_vs_cpu.CUT (multichip's scene2 is render_png's). The kernel
# pipeline is held against the plain pipeline on the card uncut.
EXAMPLE_CUT_FRAMES = 2
# The card against the CPU: both render the same plain arithmetic, but
# torch's CUDA and CPU sin/cos/rsqrt differ by an ulp, which on a
# sphere-lit scene flips a NEE light sample at a knife-edge pixel (the
# self-shadow edge of tests/test_torch_slice.py). Rays and per-pixel
# samples must be equal; the pixels with a channel over TOL are bounded by
# count and by their summed absolute error over the cut's frames: twice
# the most that tools/card_vs_cpu.py shows at the cut in any two frames
# of any of the four scenes, rounded up (PERF.md §6, the examples).
KNIFE_CARD_CPU = (2, 0.75)


def _run_proc(cmd, timeout=300):
    """(exit code, stdout, stderr) of `cmd` in a session of its own, every
    process of which is killed if it outlives `timeout` seconds."""
    import os
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err
    return proc.returncode, out, err


def phase_examples():
    """The five examples of examples_torch/ on the card: each main() at its
    scene's own size with the launch counters reset just before and read
    just after (every kernel of its path launched once a frame, nothing
    else; multichip in a process group of one rank over NCCL made here,
    which its main keeps), its outputs checked (PNGs of the scene's shape,
    not flat; animate's frames pairwise distinct; custom_scene's 30 rows
    of 80 glyphs; multichip's image digest that of the one-device step);
    each scene at its own size, the shapes main() gives the kernels: the
    kernel pipeline against the plain pipeline on the card (rays, samples,
    variance equal, radiance maxrel < TOL); each scene cut (card_vs_cpu):
    the example's frame loop on the card against the CPU (rays and
    per-pixel samples equal, the knife-edge pixels over TOL bounded by
    KNIFE_CARD_CPU); multichip.py as a process under torchrun
    --nproc-per-node 1 and alone, each exit 0 with the one-device step's
    digest; each main()'s wall time a frame, its set-up and PNGs included
    (information). Returns the launches."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.dynamic import pack_scene
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
    from terminal_raytracer_tpu_torch.runtime import (init_state,
                                                      make_render_step)
    from terminal_raytracer_tpu_torch.tools import card_vs_cpu
    from terminal_raytracer_tpu_torch.utils import imageio

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="examples-")
    mods = {name: card_vs_cpu.example(name) for name in EXAMPLES}
    argv = {"render_png": [f"{d}/render.png"], "custom_scene": [],
            "animate": [f"{d}/anim"], "glass": [f"{d}/glass.png"],
            "multichip": []}
    n_frames = {"render_png": 16, "custom_scene": 8, "animate": 8,
                "glass": 32, "multichip": 8}
    total, ms, stdout = {}, {}, {}
    scenes = {name: mod.build_scene("cuda") for name, mod in mods.items()}
    mc = mods["multichip"]
    _, own = mc.join_group("cuda")
    try:
        for name, mod in mods.items():
            scene = scenes[name]
            tr = PathTracer(scene, "cuda", dynamic=name == "animate")
            n = n_frames[name]
            want = dict.fromkeys(LAUNCH_NAMES, 0)
            want[_a_name(tr)] = n
            if tr.base_samples < tr.spp:
                want[_b_name(tr)] = n
            out = io.StringIO()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = mod.main(argv[name] + ["--device", "cuda"])
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / n
            got = _launches()
            _add(total, got)
            stdout[name] = out.getvalue()
            print(f"[examples] {name}: main() exit {rc}, {scene.width}x"
                  f"{scene.height} spp {scene.samples_per_pixel} depth "
                  f"{scene.max_depth}, {scene.primitive_count} primitives, "
                  f"{n} frames; launches {_nonzero(got)}; "
                  f"{ms[name]:.3f} ms/frame", flush=True)
            if rc or got != want:
                fail(f"[examples] {name}: exit {rc}, launch counts {got}, "
                     f"expected {want}")
    finally:
        if own:
            dist.destroy_process_group()

    # The outputs.
    def picture(path, scene):
        img = imageio.read_png(path)
        if img.shape != (scene.height, scene.width, 3) or img.max() == img.min():
            fail(f"[examples] {path}: shape {img.shape}, range "
                 f"[{img.min()}, {img.max()}]")
        return img

    shapes = {}
    for name, path in (("render_png", "render.png"), ("glass", "glass.png")):
        shapes[name] = picture(f"{d}/{path}", scenes[name]).shape
    imgs = [picture(f"{d}/anim/frame_{t:03d}.png", scenes["animate"])
            for t in range(n_frames["animate"])]
    distinct = all(not np.array_equal(imgs[i], imgs[j])
                   for i in range(len(imgs)) for j in range(i))
    rows = stdout["custom_scene"].splitlines()
    scene2 = scenes["multichip"]
    step = make_render_step(scene2, full_color=True, device="cuda")
    state = init_state(scene2, "cuda")
    for f in range(n_frames["multichip"]):
        o = step(state, _pose(), 1 + f, f)
        state = o.state
    want_digest = mc.digest(o.rgb)
    ok = {"animate frames pairwise distinct": distinct,
          "custom_scene 30 rows of 80": (len(rows) == 30 and all(
              len(r) == 80 for r in rows)),
          "multichip digest": f"sha256 {want_digest}" in stdout["multichip"]}
    print(f"[examples] outputs: PNGs {shapes}, animate "
          f"{len(imgs)} x {imgs[0].shape}; one-device digest {want_digest}; "
          f"{ok}", flush=True)
    if not all(ok.values()):
        fail(f"[examples] outputs: {ok}")

    # Each scene at its own size: the kernel pipeline against the plain
    # pipeline on the card (the gate); then, cut, the example's frame loop
    # on the card against the CPU.
    def label(s):
        return (f"{s.width}x{s.height} spp {s.samples_per_pixel} depth "
                f"{s.max_depth}")

    for name in ("render_png", "custom_scene", "animate", "glass"):
        mod, scene = mods[name], scenes[name]
        dynamic = name == "animate"
        tr = PathTracer(scene, "cuda", dynamic=dynamic)
        _against_plain("examples", f"{name} {label(scene)}", tr,
                       kernels.make_sorted_render_frame(tr), _pose(),
                       card_vs_cpu.SEED0[name],
                       pack_scene(scene) if dynamic else None)
        cut = scene.with_overrides(**card_vs_cpu.CUT)
        runs = [card_vs_cpu.loop_frames(mod, cut, EXAMPLE_CUT_FRAMES, dev)
                for dev in ("cuda", "cpu")]
        same, _, (off, err) = card_vs_cpu.compare(*runs)
        rel = max(maxrel(a[2], b[2]) for a, b in zip(*runs))
        print(f"[examples] {name} {label(cut)}, {EXAMPLE_CUT_FRAMES} frames, "
              f"card against CPU: rays and samples equal {same}, radiance "
              f"maxrel {rel:.3e}, {off} pixels over {TOL} (summed error "
              f"{err:.4g}; at most {KNIFE_CARD_CPU})", flush=True)
        if not same or off > KNIFE_CARD_CPU[0] or err > KNIFE_CARD_CPU[1]:
            fail(f"[examples] {name}: the card disagrees with the CPU")

    # multichip.py as a process, under torchrun and alone.
    script = "examples_torch/multichip.py"
    for label, cmd in (
            ("torchrun --nproc-per-node 1",
             [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "1", script]),
            ("alone", [sys.executable, script])):
        t0 = time.perf_counter()
        rc, out, err = _run_proc(cmd)
        dt = time.perf_counter() - t0
        line = next((ln for ln in out.splitlines() if "sha256" in ln), "")
        print(f"[examples] multichip.py {label}: exit {rc} in {dt:.1f} s: "
              f"{line}", flush=True)
        if rc or f"sha256 {want_digest}" not in line:
            fail(f"[examples] multichip.py {label}: {err[-2000:]}")
    print("[examples] main() ms/frame: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" | {_smi('name,power.limit')}", flush=True)
    print(f"[examples] done in {time.perf_counter() - t_phase:.1f} s, "
          f"launches {_nonzero(total)}", flush=True)
    return total


PROBE_REPS = 3
# The probes' rows: (name, module, the TPU kernel it replaces, the form
# and config its `ms` is taken at).
PROBE_ROWS = (
    ("probe21", "perf_probe21", "tools/perf_probe21.py:73", ("ldg", 1024)),
    ("probe21b", "perf_probe21b", "tools/perf_probe21b.py:88",
     ("rowsel_ldg", None)),
    ("probe21c", "perf_probe21c", "tools/perf_probe21c.py:65",
     ("packed", None)),
    ("probe_when", "probe_when", "tools/probe_when.py:54", ("guarded", 0.5)),
    ("probe_cond", "probe_cond", "tools/probe_cond.py:58", ("cond", 0.25)))
# FP32 operations a lane-iteration of the probes' loops: the gathers' add;
# 21c packed: x = x0 + 0.001 i (2), the texel index (4 floors, 2
# subtracts, 3 multiplies), the unpack's 3 multiplies and the 3 adds; the
# heavy bodies 5 a step (multiply, add, multiply, floor, subtract).
PROBE_OPS_GATHER = 1
PROBE_OPS_PACKED = 17
PROBE_OPS_STEP = 5


def _probe_taken(mod, frac, iters):
    """Iterations whose scalar predicate holds (the guarded form's work)."""
    return sum((i * 40503 + mod.SEED) % 1000 < int(frac * 1000)
               for i in range(iters))


def phase_probes(peak):
    """The Hopper probes (terminal_raytracer_tpu_torch/tools/,
    csrc/probes.cu): every probe's main() on the card at its default sizes
    and loop counts (--reps 3), with the launch counters reset before and
    read after; then every form's kernel output from that run against its
    plain version on the card on the same inputs: bit for bit, atan2f
    within rtol 1e-6 of torch.atan2 (ulps printed); each branch probe's
    copies equal. Returns (launches by row, {row: (max abs error, ms,
    plain ms, bound)})."""
    import importlib

    import torch

    mods = {name: importlib.import_module(
        f"terminal_raytracer_tpu_torch.tools.{mod}")
        for name, mod, _, _ in PROBE_ROWS}
    wrappers = {"probe21": mods["probe21"].gather,
                "probe21b": mods["probe21b"].gather,
                "probe21c": mods["probe21c"].block,
                "probe_when": mods["probe_when"].branch,
                "probe_cond": mods["probe_cond"].branch}
    for w in wrappers.values():
        w.launches = dict.fromkeys(w.launches, 0)
    t0 = time.perf_counter()
    results = {name: mods[name].main(["--device", "cuda", "--reps",
                                      str(PROBE_REPS)])
               for name in wrappers}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: dict(w.launches) for name, w in wrappers.items()}
    print(f"[probes] the five probes' main() on the card in {dt:.1f} s, "
          f"launches {counts}", flush=True)
    for name, got in counts.items():
        idle = [form for form, n in got.items() if not n]
        if idle:
            fail(f"[probes] {name}: forms never launched: {idle}")

    p21, p21b, p21c = mods["probe21"], mods["probe21b"], mods["probe21c"]
    when, cond = mods["probe_when"], mods["probe_cond"]
    ins21 = {n: (tab, idx) for n, tab, idx in p21.inputs(p21.SIZES, "cuda")}
    tab_b, idx_b = p21b.inputs("cuda")
    tab_c, x0_c = p21c.inputs("cuda")
    x_w = when.inputs("cuda")
    plains = {
        "probe21": lambda r: p21.plain(r["form"], *ins21[r["n"]], p21.ITERS),
        "probe21b": lambda r: p21b.plain(r["form"], tab_b, idx_b,
                                         p21b.ITERS),
        "probe21c": lambda r: p21c.plain(r["form"], tab_c, x0_c, p21c.ITERS),
        "probe_when": lambda r: when.plain(r["form"], x_w, when.SEED,
                                           r["frac"], when.ITERS),
        "probe_cond": lambda r: cond.plain(r["form"], cond.SEED, r["frac"],
                                           cond.ITERS, "cuda")}
    out = {}
    for name, _, _, (form0, cfg0) in PROBE_ROWS:
        worst, ms, plain_ms = 0.0, None, None
        for r in results[name]:
            want = plains[name](r)
            got = r["out"]
            err = maxabs(got, want.expand_as(got))
            worst = max(worst, err)
            if r["form"] == "atan2f":
                ulps = int((got.view(torch.int32).long()
                            - want.view(torch.int32).long()).abs().max())
                rel = maxrel(got, want)
                print(f"[probes] {name} atan2f against torch.atan2 on the "
                      f"card: max abs {err:.3e}, maxrel {rel:.3e}, "
                      f"{ulps} ulps", flush=True)
                if not float(((got - want).abs() / want.abs()).max()) <= 1e-6:
                    fail(f"[probes] {name} atan2f beyond rtol 1e-6")
            elif err != 0.0:
                fail(f"[probes] {name} {r['form']} {r.get('n', '')}"
                     f"{r.get('frac', '')}: the kernel is off its plain "
                     f"version by {err:.3e}")
            cfg = r.get("n", r.get("frac"))
            if r["form"] == form0 and cfg == cfg0:
                ms = r["ms"]
                plain_ms = _time_cuda(lambda: plains[name](r), 1, queued=False)
        if name in ("probe21", "probe21b", "probe21c"):
            per = PROBE_OPS_PACKED if name == "probe21c" else PROBE_OPS_GATHER
            ops = mods[name].ITERS * TILE * per
            n_tab = {"probe21": cfg0, "probe21b": TILE, "probe21c": 1024}[name]
            n_bytes = 4 * (n_tab + 2 * TILE)
        elif name == "probe_when":
            taken = _probe_taken(when, cfg0, when.ITERS)
            ops = when.STEPS * TILE * taken * when.HEAVY * PROBE_OPS_STEP
            n_bytes = 4 * TILE * (1 + when.STEPS)
        else:
            taken = _probe_taken(cond, cfg0, cond.ITERS)
            ops = cond.STEPS * TILE * (1 + taken * cond.HEAVY * PROBE_OPS_STEP
                                       + (cond.ITERS - taken))
            n_bytes = 4 * TILE * cond.STEPS
        bound = _bound(ops, n_bytes, peak)
        out[name] = (worst, ms, plain_ms, bound)
        print(f"[probes] {name}: every form against its plain version on "
              f"the card, max abs {worst:.3e}; {form0} {cfg0 or ''}: "
              f"{ms:.4f} ms (plain {plain_ms:.1f} ms), bound "
              f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
    launches = {name: sum(c.values()) for name, c in counts.items()}
    return launches, out


def main() -> int:
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("torch is not installed")
    smi_line, peak = phase_device()
    try:
        import terminal_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    import torch

    phase_build()
    err_a, (tr, a) = phase_kernel_base(peak)
    res_a, res_a256, err_b, (ms_b, plain_b, bound_b) = phase_kernel_extra(
        tr, a, peak)
    err_c, (ms_c, plain_c, bound_c) = phase_kernel_base_chunked(peak)
    thread = phase_thread_per_entry(peak)
    launches = phase_main()
    _add(launches, phase_scale())
    ext_launches, ext = phase_ext(peak)
    _add(launches, ext_launches)
    xt_launches, xt = phase_xt(peak)
    _add(launches, xt_launches)
    accel_launches, acc = phase_accel(peak)
    _add(launches, accel_launches)
    sched_launches, sch = phase_sched(peak)
    _add(launches, sched_launches)
    _add(launches, phase_denoise())
    _add(launches, phase_offline())
    _add(launches, phase_examples())
    mesh_launches, quota_row = phase_mesh(peak)
    _add(launches, mesh_launches)
    launches["base_kernel_quota"] = quota_row[-1]
    probe_launches, probes = phase_probes(peak)
    src = "terminal_raytracer_tpu_torch/csrc/"
    ref = "terminal_raytracer_tpu/ops/pallas_kernel.py:"
    rows = (# Kernel A, thread per pixel at the north star (too few
            # primitives for the grouped entry), and grouped (csrc/group.cuh)
            # at stress256; each form's error includes the other's checks.
            ("kernel_base", "base_kernel", "kernel_base.cu", "796",
             max(err_a["thread"], res_a["thread"][0], res_a256["thread"][0]),
             *res_a["thread"][1:]),
            ("kernel_base_grouped", "base_kernel_grouped", "group.cuh", "796",
             max(err_a["grouped"], res_a["grouped"][0],
                 res_a256["grouped"][0]), *res_a256["grouped"][1:]),
            # Kernel B and the chunked kernel A, thread per entry (at the
            # mesh5120 shapes, launched directly: OFF_PATH) and grouped
            # (csrc/group.cuh; at the north star and stress1024; their
            # GroupSpill forms at mesh5120, [thread], where the main path
            # takes them, their errors including the split-point
            # libraries').
            ("kernel_extra", "extra_kernel", "kernel_extra.cu", "1028",
             *thread["b"]),
            ("kernel_extra_grouped", "extra_kernel_grouped", "group.cuh",
             "1028", err_b, ms_b, plain_b, bound_b),
            ("kernel_extra_grouped_spill", "extra_kernel_grouped_spill",
             "group.cuh", "1028", *thread["bs"]),
            # Kernel A with base_dynamic: the runtime quota read at :801.
            ("kernel_base_quota", "base_kernel_quota", "kernel_base.cu",
             "801", *quota_row[:4]),
            ("kernel_base_chunked", "base_kernel_chunked", "kernel_base.cu",
             "796", *thread["c"]),
            ("kernel_base_chunked_grouped", "base_kernel_chunked_grouped",
             "group.cuh", "796", err_c, ms_c, plain_c, bound_c),
            ("kernel_base_chunked_grouped_spill",
             "base_kernel_chunked_grouped_spill", "group.cuh", "796",
             *thread["cs"]),
            # The texel-atlas variants: the atlas is bound at :807 (A) and
            # :1031 (B), pallas_kernel._tex_bind_front.
            ("kernel_base_ext", "base_kernel_ext", "kernel_base.cu", "807",
             *ext["a"]),
            # Kernel A at the EXT gates grouped (csrc/group.cuh over
            # GroupSweep; entry in kernel_base.cu) at the checker stress256
            # shapes, its error including the checker stress64 shapes'.
            ("kernel_base_ext_grouped", "base_kernel_ext_grouped",
             "group.cuh", "807", *ext["ga"]),
            # Kernel B at the EXT gates, thread per entry (launched directly:
            # OFF_PATH) and grouped (csrc/group.cuh over GroupSweep; entry
            # in kernel_extra.cu) at the showcase shapes; its GroupSpill
            # form at the checker mesh5120 shapes, where the main path
            # takes it.
            ("kernel_extra_ext", "extra_kernel_ext", "kernel_extra.cu",
             "1031", *ext["b"]),
            ("kernel_extra_ext_grouped", "extra_kernel_ext_grouped",
             "group.cuh", "1031", *ext["g"]),
            ("kernel_extra_ext_grouped_spill",
             "extra_kernel_ext_grouped_spill", "group.cuh", "1031",
             *ext["gs"]),
            # The chunked EXT kernel A, thread per entry (launched
            # directly: OFF_PATH) and grouped (csrc/group.cuh over
            # GroupSweep) at the checker stress1024 shapes, its GroupSpill
            # form at the checker mesh5120 shapes, where the main path
            # takes them.
            ("kernel_base_chunked_ext", "base_kernel_chunked_ext",
             "kernel_base.cu", "807", *ext["c"]),
            ("kernel_base_chunked_ext_grouped",
             "base_kernel_chunked_ext_grouped", "group.cuh", "807",
             *ext["cg"]),
            ("kernel_base_chunked_ext_grouped_spill",
             "base_kernel_chunked_ext_grouped_spill", "group.cuh", "807",
             *ext["cgs"]),
            # The transport and camera gates: kernel A's body is the
            # PathTracer built with them at :739, kernel B's at :1013.
            ("kernel_base_xt", "base_kernel_xt", "kernel_base.cu", "739",
             *xt["a"]),
            # Thread per entry at mesh5120 in fog ([thread]), launched
            # directly (OFF_PATH); its fog-shape time beside the grouped
            # entry's is printed in [xt].
            ("kernel_extra_xt", "extra_kernel_xt", "kernel_extra.cu", "1013",
             max(xt["b"][0], thread["xt"][0]), *thread["xt"][1:]),
            # Grouped (csrc/group.cuh over GroupSweep; entry in
            # kernel_extra.cu), at the fog shapes; its GroupSpill form at
            # mesh5120 in fog, where the main path takes it.
            ("kernel_extra_xt_grouped", "extra_kernel_xt_grouped",
             "group.cuh", "1013", *xt["g"]),
            ("kernel_extra_xt_grouped_spill", "extra_kernel_xt_grouped_spill",
             "group.cuh", "1013", *thread["xts"]),
            # The chunked XT kernel A, thread per entry at mesh5120 in fog
            # ([thread]), launched directly (OFF_PATH; its stress1024 fog mis
            # time beside the grouped entry's is printed in [xt]); grouped
            # (csrc/group.cuh over GroupSweep) at stress1024 fog --mis, its
            # GroupSpill form at mesh5120 in fog, where the main path takes
            # them.
            ("kernel_base_chunked_xt", "base_kernel_chunked_xt",
             "kernel_base.cu", "739", max(xt["c"][0], thread["cxt"][0]),
             *thread["cxt"][1:]),
            ("kernel_base_chunked_xt_grouped",
             "base_kernel_chunked_xt_grouped", "group.cuh", "739",
             *xt["cg"]),
            ("kernel_base_chunked_xt_grouped_spill",
             "base_kernel_chunked_xt_grouped_spill", "group.cuh", "739",
             *thread["cxts"]),
            # The opt-in traversals, bound into kernel A at :808-809 and
            # into kernel B at :1032-1033 (the culled sweep's scratch,
            # _maybe_bind_sweep; the walk's tables, _gather_bind_front).
            # Thread per pixel at mesh5120 under grid ([thread], launched
            # directly beside the GroupCulledSpill form); the main path
            # takes it below 16 primitives (the north star under grid,
            # timed in [accel]). Grouped (csrc/group.cuh GroupCulled; entry
            # in kernel_accel.cu) at the stress1024 shapes, where its
            # comparisons include the thread-per-pixel entry's; its
            # GroupCulledSpill form at mesh5120 under grid ([thread]),
            # where the main path takes it, its error including the
            # split-point libraries'.
            ("kernel_base_grid", "base_kernel_grid", "kernel_accel.cu",
             "809", max(acc["grid", "at"][0], acc["grid", "ans"][0],
                        thread["ga"][0]), *thread["ga"][1:]),
            ("kernel_base_grid_grouped", "base_kernel_grid_grouped",
             "group.cuh", "809", *acc["grid", "a"]),
            ("kernel_base_grid_grouped_spill",
             "base_kernel_grid_grouped_spill", "group.cuh", "809",
             *thread["gas"]),
            # Thread per entry at mesh5120 under grid ([thread]), launched
            # directly (OFF_PATH); its stress1024 time is printed in
            # [accel].
            ("kernel_extra_grid", "extra_kernel_grid", "kernel_accel.cu",
             "1033", max(acc["grid", "b"][0], thread["grid"][0]),
             *thread["grid"][1:]),
            # Grouped (csrc/group.cuh GroupCulled; entry in
            # kernel_accel.cu), at the stress1024 shapes; its
            # GroupCulledSpill form at mesh5120 under grid ([thread]), where
            # the main path takes it.
            ("kernel_extra_grid_grouped", "extra_kernel_grid_grouped",
             "group.cuh", "1033", *acc["grid", "g"]),
            ("kernel_extra_grid_grouped_spill",
             "extra_kernel_grid_grouped_spill", "group.cuh", "1033",
             *thread["gs"]),
            # Kernel A over the walk, thread per pixel (the main path takes
            # it below 16 primitives: [sched]'s Cornell gathered) and
            # grouped (csrc/group.cuh GroupWalk; entry in kernel_accel.cu),
            # at the stress1024 shapes, the errors including mesh1280's.
            ("kernel_base_gathered", "base_kernel_gathered",
             "kernel_accel.cu", "808", *acc["gathered", "at"]),
            ("kernel_base_gathered_grouped", "base_kernel_gathered_grouped",
             "group.cuh", "808", *acc["gathered", "a"]),
            # Kernel B over the walk, thread per entry (launched directly:
            # OFF_PATH) and grouped (csrc/group.cuh GroupWalk; entry in
            # kernel_accel.cu), at the stress1024 shapes, the grouped
            # entry's error including mesh1280's.
            ("kernel_extra_gathered", "extra_kernel_gathered",
             "kernel_accel.cu", "1032", *acc["gathered", "b"]),
            ("kernel_extra_gathered_grouped", "extra_kernel_gathered_grouped",
             "group.cuh", "1032", *acc["gathered", "g"]),
            # The chunk-major stream (:951-970) over the traversals bound
            # at :808-809. Over the culled sweep: thread per entry (launched
            # directly: OFF_PATH) and grouped (csrc/group.cuh GroupCulled;
            # entry in kernel_accel.cu) at the stress1024 grid cb 2 shapes,
            # its GroupCulledSpill form at mesh5120 grid cb 2 ([accel]),
            # where the main path takes them.
            ("kernel_base_chunked_grid", "base_kernel_chunked_grid",
             "kernel_accel.cu", "809", max(sch["chunked_grid"][0],
                                           acc["grid", "ct"][0]),
             *acc["grid", "ct"][1:]),
            ("kernel_base_chunked_grid_grouped",
             "base_kernel_chunked_grid_grouped", "group.cuh", "809",
             *acc["grid", "cg"]),
            ("kernel_base_chunked_grid_grouped_spill",
             "base_kernel_chunked_grid_grouped_spill", "group.cuh", "809",
             *acc["grid", "cgs"]),
            # Over the walk: thread per entry (launched directly: OFF_PATH)
            # and grouped (csrc/group.cuh GroupWalk; entry in
            # kernel_accel.cu) at the stress1024 gathered cb 2 shapes
            # ([accel], in turns), the errors including mesh1280's and
            # (thread per entry) [sched]'s.
            ("kernel_base_chunked_gathered", "base_kernel_chunked_gathered",
             "kernel_accel.cu", "808", max(sch["chunked_gathered"][0],
                                           acc["gathered", "ct"][0]),
             *acc["gathered", "ct"][1:]),
            ("kernel_base_chunked_gathered_grouped",
             "base_kernel_chunked_gathered_grouped", "group.cuh", "808",
             *acc["gathered", "cg"])) + tuple(
        # Kernel C, kernel_regen (:420), and D, kernel_lockstep (:391),
        # both launched by the pallas_call at :499: one thread a pixel
        # (launched directly: OFF_PATH), timed at the first [sched] config
        # of each instantiation.
        (f"kernel_{mode}{sfx}", f"{mode}_kernel{sfx}", "kernel_frame.cu",
         "420" if mode == "regen" else "391", *sch[mode + sfx])
        for mode in ("regen", "lockstep")
        for sfx in ("", "_ext", "_xt", "_grid", "_gathered")) + tuple(
        # The same two on the queue schedule (csrc/group.cuh
        # kernel_frame_queue; entries in kernel_frame.cu), each form timed
        # at the first [sched] config that takes it.
        (name.replace("regen_kernel", "kernel_regen").replace(
            "lockstep_kernel", "kernel_lockstep"), name, "group.cuh",
         "420" if key[0] == "regen" else "391", *sch[key])
        for key, name in zip(QUEUE_KEYS, QUEUE_NAMES))
    counter_of = {name: counter for name, counter, *_ in rows}
    taken = [name for name in OFF_PATH if launches[counter_of[name]]]
    if taken:
        fail(f"the main path took a thread-per-entry entry: {taken}")
    unlaunched = [name for name, counter, *_ in rows
                  if not launches[counter] and name not in OFF_PATH]
    unlaunched += [name for name, *_ in PROBE_ROWS
                   if not probe_launches[name]]
    if unlaunched:
        fail(f"not launched on the main path: {unlaunched}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": ref + line, "launches": launches[counter],
         "max_abs_err": err, "ms": ms, "plain_ms": plain,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
        for name, counter, source, line, err, ms, plain, bound in rows
    ] + [
        {"name": name, "route": "cuda", "source": src + "probes.cu",
         "replaces": line, "launches": probe_launches[name],
         "max_abs_err": probes[name][0], "ms": probes[name][1],
         "plain_ms": probes[name][2], "bound_ms": probes[name][3][0],
         "bound_by": probes[name][3][1], "library_ms": None}
        for name, _, line, _ in PROBE_ROWS
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
