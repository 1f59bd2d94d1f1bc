"""The sweep over the group width K of the grouped kernels (csrc/group.cuh)
on the card: kernel B at the reference gates, at the XT gates and over the
culled sweep of `--accel grid`, the chunked kernel A, and kernel A at the
reference gates and over the culled sweep on both schedules (static: group
g takes pixel g; refill: the resident groups take pixels from a counter),
with K lanes an entry, for each K, beside the thread-per-entry kernels on
the same inputs.

    python -m terminal_raytracer_tpu_torch.tools.group_k [--ks 1,2,4,8,16,32]
        [--reps 5] [--only base|spill|budget|xt|ext|walk|grid|frame]
        [--a-only]

Each K is its own library, csrc/group_tune.cu built with -DTRT_TUNE_K=K,
and for K > 8 a second one with -DTRT_TUNE_WIDE=0 (the grid kernels'
other design: one candidate block a step on all K lanes, not K / 8 blocks
of 8 lanes); each of those again with -DTRT_TUNE_REFILL=1 (kernel A's
refill schedule), all built at once with the render libraries. The shapes
are the main path's: kernel B on the budget-sorted stream of the north
star (Cornell_Box 400x200, 16 spp, depth 32) and of stress1024
(stress:1024 200x100, 8 spp, depth 6, chunks of 2) and mesh1280
(icosphere:3, the same), the chunked kernel A at stress1024 and mesh1280;
the XT kernel B at the fog shapes (the north star in fog 0.15) and on the
stress1024 fog --mis stream; the grid kernel B at stress1024 under --accel
grid; kernel A at the north star and at its sp = 3 share-2 quota
(parallel/mesh.py) and unchunked at the bench's array shapes (200x100, 8
spp, depth 6) on Cornell_Box, demo, stress:32, lights:16, stress:64,
stress:128, stress:256 and, under --accel baked, stress:1024 and
icosphere:3 (the table sizes the dispatch decides between); the grid
kernel A at stress1024, mesh1280 and the north star under --accel grid.
Each line: the kernel's device ms (CUDA events, the least of --reps runs
of 3 launches after a warm-up), whether its outputs equal the plain
version's bit for bit, whether its executed lane-iterations equal the
plain model (ops/kernels.py warp_iters of the per-entry iterations at K;
on the refill schedule: whether they are at least the entries' sum), the
working warps (warps with an entry that renders, laid out statically) and
the longest entry's iterations with the µs an iteration on that chain;
the grid lines also whether the traversal counters equal the plain
version's; kernel A's lines its occupancy, owed sweeps over
lane-iterations x (1 + nee_sweeps). The widths and schedules the render
libraries ship are constants of kernel_extra.cu, kernel_accel.cu and
kernel_base.cu, chosen from this sweep. `--only base` sweeps kernel A
alone.

`--only spill` sweeps the forms for any table size (csrc/group.cuh
GroupSpill) of kernel B at the reference and XT gates and of the chunked
kernel A over tables above the 96 KB budget, at 200x100, 8 spp, depth 6:
mesh5120 (icosphere:4, 5120 triangles) and icosphere:5 (20480), each
plain and in fog 0.15 (the XT kernel B). For each K of --ks (default 8,
16, 32) and each shape of SPILL_SHAPES (block width, stage cap in bytes),
one library (-DTRT_TUNE_K, -DTRT_TUNE_THREADS, -DTRT_TUNE_STAGE_CAP),
timed beside the thread-per-entry entry, bit for bit
against the plain version (computed in row blocks, which icosphere:5's
dense plain sweep needs) with the lane-iterations the plain model's;
the ptxas lines of every GroupSpill kernel.

`--only budget` times, on tables within the budget, the shipped grouped
entries (GroupSweep: 12-word triangle rows staged whole) in turns with
GroupSpill at the same shape (the shipped K, 128 lanes, a 96 KB cap:
nine-word triangles staged plane-major, nothing spilled), bit for bit:
kernel B at the north star and mesh1280, the XT kernel B at the fog
shapes, the chunked kernel A at stress1024 and mesh1280.

`--only xt` sweeps kernel A at the XT gates: the chunked XT kernel A's
grouped entry at stress1024 fog --mis (stress:1024 200x100, 8 spp, depth
6, fog 0.15) at K of --ks (default XT_CHUNKED_KS), its GroupSpill forms
at mesh5120 fog
and icosphere:5 fog over XT_SPILL (K, block width, stage cap), each beside
the thread per entry; then the XT kernel A's forms (XT_BASE, libraries
built with -DTRT_TUNE_MIN_BLOCKS too) at fog (Cornell_Box 400x200, 16 spp,
depth 32, fog 0.15), manylights_one (lights:16, power) and showcase --mis
beside the shipped thread per pixel: (a) the thread per pixel held to 5
or 6 resident blocks an SM, (b) the grouped kernel A at K 1, 2, 4, static
and refill, (c) (b) held to 5. Each line also has the form's ptxas
registers, stack and spill stores, and for kernel A the resident blocks
an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the waves of
its grid.

`--only ext` sweeps kernel B and the chunked kernel A at the EXT gates:
kernel B's grouped entry over GroupSweep at K of EXT_KS on the five
extension scenes at their own size (400x200) and on stress:1024 with a
checker floor (200x100, 8 spp, depth 6; its chunk-major stream of cb = 2
for the chunked A), the chunked A's at K of CHUNKED_EXT_KS on the checker
stress:1024, and the GroupSpill forms of both (EXT_SPILL: K, block width;
a 227 KB cap) at icosphere:4 with a checker floor, each beside the thread
per entry, bit for bit with the lane-iterations the plain model's; then
kernel A at the EXT gates (EXT_BASE: the thread per pixel unbound and held
to 6 and 8 resident blocks an SM, the grouped entry at K 1-32 on both
schedules, at K 1-4 also held to 6) at the five packaged extension scenes
at their own size, spp and depth, twice in turns with each form's summed
time, at showcase and textured at 16 spp, depth 32 and at the checker
stress:256 and stress:64 (200x100, 8 spp, depth 6), each against the plain
version bit for bit with its ptxas line and residency (`--a-only`: kernel
A alone).
`--only walk` sweeps kernels B and A over the grid walk (csrc/group.cuh
GroupWalk) at stress1024, mesh1280 and mesh5120 under --accel gathered
(200x100, 8 spp, depth 6), and kernel A also at Cornell_Box (the same
size; 11 primitives, where the thread per pixel is expected to win):
walk_forms, K (--ks; default WALK_KS for B, WALK_A_KS for A) by row source
(rows and CSR through L1; rows staged; CSR and rows staged), kernel A on
both schedules (static, refill), 128 lanes a block, a 227 KB cap, beside
the thread per entry or pixel (traverse.cuh Walk), the walk counters
against the plain version's and (B) the thread per entry's. Both print
each form's ptxas registers and spills; `--a-only`: the chunked gathered
kernel A alone at chunks of 2, K of --ks (default CHUNKED_WALK_KS) by row
source beside the thread per entry, at stress1024, mesh1280, mesh5120
and icosphere:5, twice in turns, bit for bit with the walk counters
against the plain version's, with each form's summed time over the first
three. `--only grid` sweeps the grid
kernels A and B over tables above the 96 KB budget (csrc/group.cuh
GroupCulledSpill: the group table, then the rows, staged as far as a
227 KB cap holds them, the rest read through L1) at mesh5120 (icosphere:4)
and icosphere:5 under --accel grid, 200x100, 8 spp, depth 6: K of --ks
(default GRID_KS) in both designs where K > 8 (wide: K / 8 blocks a step;
narrow: one block a step), GRID_THREADS lanes a block, kernel A on both
schedules, beside the thread per pixel or entry (traverse.cuh Culled),
bit for bit with the traversal counters against the plain version's
(computed in row blocks at icosphere:5) and each form's ptxas line; then,
within the budget (stress1024 and mesh1280 under grid), every form in
turns with the shipped GroupCulled entries; then the grid kernel A's
thread per pixel at the north star under grid (Cornell_Box 400x200, 16
spp, depth 32: too few primitives for a group) as shipped and held to
GRID_MIN_BLOCKS resident blocks an SM (-DTRT_TUNE_MIN_BLOCKS, csrc/
group_tune.cu's trt_kernel_base_grid), twice in turns; then the chunked
grid kernel A at chunks of 2 (`--a-only`: it alone): within the budget
over GroupCulled at each K and design, over it over each GroupCulledSpill
form, beside the thread per entry, bit for bit with the counters. Needs a
CUDA GPU (exit 2 without one).

--only frame: kernels C and D on the queue schedule (the *_queue entries
of csrc/kernel_frame.cu and kernel_frame_lockstep.cu, group.cuh
kernel_frame_queue). Each K of --ks (default FRAME_KS) is one pair of
libraries of those queue entries (-DTRT_TUNE_QUEUE_ONLY=1) as the base width of every form (-DTRT_TUNE_KB;
the thread per item keeps one lane a base item) and one as the extra width
(-DTRT_TUNE_KE), the other width as shipped, and one a residency bound
of FRAME_MIN_BLOCKS at the shipped widths (-DTRT_TUNE_FRAME_MIN_BLOCKS:
__launch_bounds__(threads, m)). At the FRAME_SHAPES (the
[sched] configs of chip_smoke.py, one for each form of each
instantiation) each
library's entry for the tracer's form runs beside the shipped one and the
thread per pixel, regen and lockstep: ms (the least of --reps runs of 3),
the frame bit for bit the shipped entry's, regen's count and the resident
blocks an SM; each library's queue kernels' ptxas lines.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import torch

from ..models import Camera, load_scene
from ..models.scene import Fog
from ..ops import build, kernels
from ..ops.tracer import PathTracer
from ..parallel.mesh import SampleSplit
from . import ptxas_lines

KS = (1, 2, 4, 8, 16, 32)
SEED = 42
# The GroupSpill shapes of --only spill: (block width, stage cap in
# bytes). 128 lanes and 96 KB is the grouped kernels' shape below the
# budget (two blocks an SM); 227 KB is one block an SM.
GROUP_SMEM_BYTES, GROUP_SMEM_MAX = 96 * 1024, 232448
SPILL_SHAPES = ((128, GROUP_SMEM_BYTES), (256, GROUP_SMEM_BYTES),
                (256, GROUP_SMEM_MAX), (512, GROUP_SMEM_BYTES),
                (512, GROUP_SMEM_MAX))
# Rows of the image (chunked A) and of the stream (B) a plain call takes:
# icosphere:5's dense sweep holds lanes x 20481 primitives per temporary.
PLAIN_ROWS = 25


def _time(fn, reps: int) -> float:
    """Least ms a call over `reps` runs of 3 calls, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 3)
    return best


def _equal(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32) if b.is_floating_point()
                           else b) for a, b in zip(got, want))


def _line(label, k, ms, same, model, entry_iters, counters=None,
          extra=""):
    longest = int(entry_iters.max())
    width = 1 if k == "thread" else int(str(k).split()[0])
    print(f"[group_k] {label} {k}: {ms:.4f} ms, equal {same}, iterations "
          f"equal the model {model}, working warps "
          f"{kernels.working_warps(entry_iters, width)}, "
          f"longest entry {longest} iterations, "
          f"{1e3 * ms / max(longest, 1):.3f} µs an iteration"
          + ("" if counters is None else f", counters equal {counters}")
          + extra, flush=True)


def _counted(tr, fn):
    """fn() and the traversal counters of its launch (grid, gathered), else
    None."""
    if not tr.traversal:
        return fn(), None
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    out = fn()
    torch.cuda.synchronize()
    stats = tr.accel_stats.cpu()
    tr.accel_stats = None
    return out, stats


def _in_rows(fn, n, rows, dim=0):
    """fn(r0, r1) over [0, n) in blocks of `rows`, its tensors (or tuples
    of them) concatenated along `dim`."""
    step = rows or n
    parts = [fn(r, min(r + step, n)) for r in range(0, n, step)]

    def cat(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, dim)
        vals = [cat(v) for v in zip(*xs)]
        return type(xs[0])(*vals) if hasattr(xs[0], "_fields") else tuple(vals)

    return cat(parts)


def _sweep_extra(label, tr, pose, seed, libs, reps, spill=False, rows=0,
                 ptxas=None):
    """Kernel B of `tr`'s instantiation: thread per entry, then the grouped
    entry of every library of `libs` ({label: library}); `spill`: the
    GroupSpill forms. The plain version over `rows` stream rows a call
    (0: all at once). Each line with `ptxas`[label] where given; under an
    opt-in traversal the counters against the plain version's and the
    thread per entry's."""
    ptxas = ptxas or {}
    kind = kernels._kind(tr)
    grouped = "grouped" if kind == "ref" else f"{kind}_grouped"
    grouped += "_spill" if spill else ""
    a = kernels.base_phase(tr, pose, seed, 0)
    s = kernels.sorted_stream(tr, a[2], a[7])
    args = (tr, pose, s.xs, s.ys, s.state, s.add, s.samp0)

    def sliced(fn):
        return _in_rows(lambda r0, r1: fn(tr, pose, *(v[r0:r1] for v in
                                                      args[2:])),
                        s.xs.shape[0], rows)

    if tr.traversal:
        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    esum, rays = sliced(lambda *a_: kernels.extra_kernel_plain(*a_)[:2])
    plain_stats = None
    if tr.traversal:
        plain_stats = tr.prims.stats.long().cpu()
        tr.prims.ops = None
    want = (*esum, rays)
    it = sliced(kernels.extra_entry_iters)
    print(f"[group_k] {label} kernel B ({kind}) stream {tuple(s.xs.shape)}, "
          f"{int((s.add > 0).sum())} budgeted entries", flush=True)

    thread_stats = None

    def same_counts(stats):
        if stats is None:
            return None
        same = bool(torch.equal(stats, plain_stats))
        if thread_stats is not None:
            same = same and bool(torch.equal(stats, thread_stats))
        return same

    out, thread_stats = _counted(tr,
                                 lambda: kernels._launch_extra(*args, kind))
    if plain_stats is not None and tr.traversal == "gathered":
        print(f"[group_k] {label} walk counters (walks, tests, advances, "
              f"capped): plain {plain_stats.tolist()}", flush=True)
    ms = _time(lambda: kernels._launch_extra(*args, kind), reps)
    _line(f"{label} kernel B", "thread", ms, _equal((*out[0], out[1]), want),
          float(out[2]) == float(kernels.warp_iters(it, 1)), it,
          same_counts(thread_stats), ptxas.get("thread", ""))
    for k, lib in libs.items():
        width = int(str(k).split()[0])
        out, stats = _counted(
            tr, lambda: kernels._launch_extra(*args, grouped, lib))
        ms = _time(lambda: kernels._launch_extra(*args, grouped, lib), reps)
        _line(f"{label} kernel B K", k, ms, _equal((*out[0], out[1]), want),
              float(out[2]) == float(kernels.warp_iters(it, width)), it,
              same_counts(stats), ptxas.get(k, ""))


def _sweep_chunked(label, tr, pose, seed, libs, reps, spill=False, rows=0,
                   ptxas=None):
    """The chunked kernel A of `tr`'s instantiation ('ref', 'xt', 'ext' or
    'grid'): thread per entry, then the grouped entry (its GroupSpill or
    GroupCulledSpill form, `spill`) of every library of `libs`, each line
    with `ptxas`[label] where given; the plain version over `rows` image
    rows a call (0: all at once); under --accel grid the traversal counters
    against the plain version's and the thread per entry's."""
    kind = kernels._kind(tr)
    ptxas = ptxas or {}

    def plain(fn):
        return _in_rows(lambda r0, r1: fn(tr, pose, seed, 0, r0, r1 - r0),
                        tr.height, rows, dim=1)

    if tr.traversal:
        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    p = plain(lambda *a_: kernels.base_kernel_chunked_plain(*a_)[:4])
    plain_stats = None
    if tr.traversal:
        plain_stats = tr.prims.stats.long().cpu()
        tr.prims.ops = None
        print(f"[group_k] {label} chunked A counters: plain "
              f"{plain_stats.tolist()}", flush=True)
    want = (*p[0], *p[1], p[3], p[2])
    it = plain(kernels.chunked_entry_iters)
    thread_stats = None

    def same_counts(stats):
        if stats is None:
            return None
        same = bool(torch.equal(stats, plain_stats))
        if thread_stats is not None:
            same = same and bool(torch.equal(stats, thread_stats))
        return same
    grouped = ("grouped" if kind == "ref" else f"{kind}_grouped") + (
        "_spill" if spill else "")

    def launch(form, lib=None):
        return kernels._launch_chunked(tr, pose, seed, 0, 0, None, form, lib)

    def flat(o):
        return (*o.csum, *o.csumsq, o.rays, o.state)

    out, thread_stats = _counted(tr, lambda: launch(kind))
    ms = _time(lambda: launch(kind), reps)
    _line(f"{label} chunked A ({kind})", "thread", ms,
          _equal(flat(out), want),
          float(out.iters) == float(kernels.warp_iters(it, 1)), it,
          same_counts(thread_stats), ptxas.get("thread", ""))
    for k, lib in libs.items():
        width = int(str(k).split()[0])
        out, stats = _counted(tr, lambda: launch(grouped, lib))
        ms = _time(lambda: launch(grouped, lib), reps)
        _line(f"{label} chunked A ({kind}) K", k, ms, _equal(flat(out), want),
              float(out.iters) == float(kernels.warp_iters(it, width)), it,
              same_counts(stats), ptxas.get(k, ""))


def _sweep_base(label, tr, pose, seed, libs, reps, base_q=None,
                ptxas=None, spill=False, rows=0):
    """Kernel A of `tr`'s instantiation ('ref', 'grid' or 'gathered'):
    thread per pixel, then the grouped entry (`spill`: the grid's
    GroupCulledSpill form) of every library of `libs` ({label: library},
    each of its K and schedule), bit for bit against the plain version
    (computed over `rows` image rows a call, 0: all at once; under an
    opt-in traversal its counters too), with the occupancy; each line with
    `ptxas`[label] where given."""
    ptxas = ptxas or {}
    kind = kernels._kind(tr)
    grouped = ("grouped" if kind == "ref" else f"{kind}_grouped") + (
        "_spill" if spill else "")
    entry = ("base" if kind == "ref" else f"base_{kind}") + (
        "_spill" if spill else "")

    def plain(r0, r1):
        p = kernels.base_kernel_plain(tr, pose, seed, 0, r0, r1 - r0,
                                      base_q=base_q)
        return (*p.csum, *p.csumsq, p.rays, p.var, p.additional, p.state)

    if tr.traversal:
        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    want = _in_rows(plain, tr.height, rows)
    plain_stats = None
    if tr.traversal:
        plain_stats = tr.prims.stats.long().cpu()
        tr.prims.ops = None
        print(f"[group_k] {label} kernel A counters: plain "
              f"{plain_stats.tolist()}", flush=True)
    it = _in_rows(lambda r0, r1: kernels.base_entry_iters(
        tr, pose, seed, 0, r0, r1 - r0, base_q=base_q), tr.height, rows)
    owed = float(want[6].sum(dtype=torch.float64))
    per_iter = 1.0 + tr.nee_sweeps
    print(f"[group_k] {label} kernel A ({kind}) {tr.width}x{tr.height}, "
          f"quota {base_q or tr.base_samples}: {int(it.sum())} pixel "
          f"iterations, {owed:.0f} owed sweeps", flush=True)

    def launch(k, lib=None):
        return kernels._launch_base(tr, pose, seed, 0, 0, None, base_q, k,
                                    lib)

    def report(name, k, out, ms, refill):
        _, stats = out
        o = out[0]
        width = 1 if k == "thread" else int(str(k).split()[0])
        model = (float(o.iters) >= float(it.sum()) if refill
                 else float(o.iters) == float(kernels.warp_iters(it, width)))
        _line(name, k, ms, _equal((*o.csum, *o.csumsq, o.rays, o.var,
                                   o.additional, o.state), want), model, it,
              None if stats is None else bool(torch.equal(stats,
                                                          plain_stats)),
              f", occupancy {owed / (float(o.iters) * per_iter):.3f}"
              + ptxas.get(k, ""))

    out = _counted(tr, lambda: launch(kind))
    report(f"{label} kernel A", "thread", out, _time(lambda: launch(kind),
                                                     reps), False)
    for k, lib in libs.items():
        refill = kernels.group_refill(entry, lib)
        out = _counted(tr, lambda: launch(grouped, lib))
        report(f"{label} kernel A K", k, out,
               _time(lambda: launch(grouped, lib), reps), refill)


def _spill_ptxas(label, log: str) -> None:
    """The ptxas lines of the GroupSpill kernels in a build log."""
    take = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = "GroupSpill" in line
            if take:
                name = ("chunked A" if "chunked" in line else "XT B"
                        if "ILb1ELb1E" in line else "B")
                print(f"[group_k] {label} {name}:", flush=True)
        elif take and ("registers" in line or "spill" in line):
            print(f"[group_k]   {line.strip()}", flush=True)


def sweep_spill(ks, reps) -> None:
    """--only spill (the module docstring)."""
    tune = {f"{k} t{t} cap{cap}": (
        build.TUNE_SOURCE, (f"TRT_TUNE_K={k}", f"TRT_TUNE_THREADS={t}",
                            f"TRT_TUNE_STAGE_CAP={cap}"))
        for k in ks for t, cap in SPILL_SHAPES}
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(tune.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for label, src in tune.items():
        _spill_ptxas(label, paths[src].with_suffix(".log").read_text())
    libs = {label: build.load_kernels((src,)) for label, src in tune.items()}
    pose = Camera().pose()
    for name, label in (("icosphere:4", "mesh5120"),
                        ("icosphere:5", "icosphere5")):
        rows = PLAIN_ROWS if name == "icosphere:5" else 0
        for fog in (None, Fog(density=0.15)):
            scene = load_scene(name).with_overrides(
                width=200, height=100, samples_per_pixel=8, max_depth=6,
                fog=fog)
            tr = PathTracer(scene, "cuda")
            n_sph, n_pln, n_tri, _ = tr.tables.counts
            staged = [kernels.group_stage(n_sph, n_pln, n_tri, cap)
                      for cap in (GROUP_SMEM_BYTES, GROUP_SMEM_MAX)]
            print(f"[group_k] {label}{' fog' if fog else ''}: "
                  f"{kernels.group_rows_bytes(tr)} B of rows; staged at "
                  f"96 KB {staged[0]}, at 227 KB {staged[1]} (triangles, "
                  "spheres, planes)", flush=True)
            if fog is None:
                _sweep_chunked(label, tr, pose, SEED, libs, reps, True, rows)
                _sweep_extra(label, tr, pose, SEED, libs, reps, True, rows)
            else:
                _sweep_extra(f"{label} fog", tr, pose, SEED, libs, reps,
                             True, rows)


def sweep_budget(reps) -> None:
    """--only budget (the module docstring): each case in turns, GroupSweep,
    GroupSpill, GroupSpill, GroupSweep."""
    render = build.load_kernels()
    ks = {kernel: kernels.group_k(kernel, render)
          for kernel in ("extra", "extra_xt", "chunked")}
    tune = {k: (build.TUNE_SOURCE, (f"TRT_TUNE_K={k}", "TRT_TUNE_THREADS=128",
                                    f"TRT_TUNE_STAGE_CAP={GROUP_SMEM_BYTES}"))
            for k in sorted(set(ks.values()))}
    paths = build.library_paths(tuple(tune.values()))
    for k, src in tune.items():
        _spill_ptxas(f"{k} t128 cap{GROUP_SMEM_BYTES}",
                     paths[src].with_suffix(".log").read_text())
    libs = {k: build.load_kernels((src,)) for k, src in tune.items()}
    print(f"[group_k] budget: {torch.cuda.get_device_name(0)}", flush=True)
    pose = Camera().pose()

    def scene(name, w, h, spp, depth, **over):
        return load_scene(name).with_overrides(
            width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)

    fog = Fog(density=0.15)
    for label, tr, kernel in (
            ("north star", PathTracer(scene("Cornell_Box", 400, 200, 16, 32),
                                      "cuda"), "extra"),
            ("mesh1280", PathTracer(scene("icosphere:3", 200, 100, 8, 6),
                                    "cuda"), "extra"),
            ("fog", PathTracer(scene("Cornell_Box", 400, 200, 16, 32,
                                     fog=fog), "cuda"), "extra_xt"),
            ("stress1024", PathTracer(scene("stress:1024", 200, 100, 8, 6),
                                      "cuda"), "chunked"),
            ("mesh1280", PathTracer(scene("icosphere:3", 200, 100, 8, 6),
                                    "cuda"), "chunked")):
        k = ks[kernel]
        sweep = {f"{k} GroupSweep (shipped)": render}
        spill = {f"{k} GroupSpill t128 cap{GROUP_SMEM_BYTES}": libs[k]}
        run = _sweep_chunked if kernel == "chunked" else _sweep_extra
        for libs_, is_spill in ((sweep, False), (spill, True), (spill, True),
                                (sweep, False)):
            run(label, tr, pose, SEED, libs_, reps, is_spill)


# --only xt: the chunked XT kernel A's group widths within the budget, its
# GroupSpill forms' (K, block width, stage cap) above it, and the XT kernel
# A's forms, (group width, refill, resident blocks an SM; K = 1 static is
# the thread per pixel's form (a), the rest (b) without and (c) with the
# bound).
XT_CHUNKED_KS = (8, 16, 32)
XT_SPILL = tuple((k, t, cap) for k in (16, 32) for t in (256, 512)
                 for cap in (GROUP_SMEM_BYTES, GROUP_SMEM_MAX))
XT_BASE = tuple((k, refill, minb) for k in (1, 2, 4) for refill in (0, 1)
                for minb in (0, 5)) + ((1, 0, 6),)


def _ptxas(log: str, pattern: str) -> str:
    """', registers R, stack S B, spill stores T B' of the kernel whose
    mangled name holds `pattern` in an nvcc log (the first such kernel)."""
    take, regs, spill = False, "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if take:
                break
            take = pattern in line
        elif take and "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif take and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            stack = (line.split(",")[-1].strip() if "stack" in line
                     else "0 bytes cumulative stack size")
            return f", ptxas {regs} registers, {stack}, {spill}"
    return f", ptxas {regs} registers, {spill}"


def _sweep_base_forms(label, tr, pose, seed, libs, logs, reps, forms=None):
    """Kernel A's forms at the XT or EXT gates (`tr`'s instantiation;
    XT_BASE or EXT_BASE; `libs`, `logs` by form, (K, refill, bound)): the
    shipped entries (the thread per pixel; at the EXT gates also the
    grouped entry where the rows fit the budget), then each form (K = 1
    static: the thread per pixel too, with and without its residency
    bound) against the plain version bit for bit, its lane-iterations
    against the plain model (refill: at least the pixels' sum), its ptxas
    line, the resident blocks an SM that the occupancy calculator gives it
    and the waves of its grid. `forms`: the (name, form) pairs to time, in
    this order (default: every one). Returns {(name, form): ms}."""
    kind = kernels._kind(tr)
    gates = "ILb1ELb1E" if kind == "xt" else "ILb1ELb0E"
    p = kernels.base_kernel_plain(tr, pose, seed, 0)
    want = (*p.csum, *p.csumsq, p.rays, p.var, p.additional, p.state)
    it = kernels.base_entry_iters(tr, pose, seed, 0)
    n = tr.width * tr.height
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = kernels.group_rows_bytes(tr)
    print(f"[group_k] {label} kernel A ({kind}) {tr.width}x{tr.height}, spp "
          f"{tr.spp}, depth {tr.max_depth}, {tr.scene.primitive_count} "
          f"primitives: {int(it.sum())} pixel iterations, {rows} B of rows",
          flush=True)

    def launch(form, lib=None):
        return kernels._launch_base(tr, pose, seed, 0, 0, None, None, form,
                                    lib)

    def flat(o):
        return (*o.csum, *o.csumsq, o.rays, o.var, o.additional, o.state)

    every = [("shipped", (0, 0, 0))]
    if kind == "ext" and rows <= kernels.GROUP_SMEM_BYTES:
        every.append(("shipped grouped", (0, 0, 0)))
    for form in libs:
        if form[0] == 1 and not form[1]:
            every.append(("thread", form))
        every.append(("grouped", form))
    times = {}
    for name, form in forms or every:
        k, refill, minb = form
        lib = libs.get(form)
        if name == "shipped grouped":
            entry = f"base_{kind}"
            k = kernels.group_k(entry)
            refill = kernels.group_refill(entry)
        grouped = name.endswith("grouped")
        launched = f"{kind}_grouped" if grouped else kind
        out = launch(launched, lib)
        ms = _time(lambda: launch(launched, lib), reps)
        times[name, form] = ms
        model = (float(out.iters) >= float(it.sum()) if refill else
                 float(out.iters) == float(kernels.warp_iters(it, max(k, 1))))
        if name.startswith("shipped"):
            _line(f"{label} kernel A ({kind}) {name} trt_kernel_base_{kind}"
                  + ("_grouped" if grouped else ""),
                  f"{k} {'refill' if refill else 'static'}" if grouped
                  else "thread", ms, _equal(flat(out), want), model, it)
            continue
        if name == "thread":
            per_sm = getattr(lib, f"trt_kernel_base_{kind}_per_sm")()
            blocks = -(-n // 128)
            pattern = (f"20kernel_base_resident{gates}" if minb
                       else f"11kernel_base{gates}")
        else:
            query = getattr(lib, f"trt_kernel_base_{kind}_grouped_per_sm")
            per_sm = (query() if kind == "xt" else
                      query(ctypes.byref(ctypes.c_int(rows))))
            blocks = -(-n * k // 128)
            pattern = (f"kernel_base_grouped_resident{gates}" if minb
                       else f"19kernel_base_grouped{gates}N3trt10Group")
        waves = ("a resident grid" if refill else
                 f"{blocks / max(per_sm * n_sm, 1):.2f} waves")
        tag = (f"{k} {'refill' if refill else 'static'}"
               + (f" bound {minb}" if minb else ""))
        _line(f"{label} kernel A ({kind}) {name}", tag, ms,
              _equal(flat(out), want), model, it,
              extra=(_ptxas(logs[form], pattern)
                     + f", {per_sm} blocks an SM, {waves}"))
    return times


def sweep_xt(reps, ks=XT_CHUNKED_KS) -> None:
    """--only xt (the module docstring); `ks`: the chunked XT kernel A's
    group widths within the budget."""
    chunked = {k: (build.TUNE_SOURCE, (f"TRT_TUNE_K={k}",)) for k in ks}
    spill = {f"{k} t{t} cap{cap}": (
        build.TUNE_SOURCE, (f"TRT_TUNE_K={k}", f"TRT_TUNE_THREADS={t}",
                            f"TRT_TUNE_STAGE_CAP={cap}"))
        for k, t, cap in XT_SPILL}
    base = {form: (build.TUNE_SOURCE, (
        f"TRT_TUNE_K={form[0]}", f"TRT_TUNE_REFILL={form[1]}",
        f"TRT_TUNE_MIN_BLOCKS={form[2]}")) for form in XT_BASE}
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(chunked.values())
                                + tuple(spill.values())
                                + tuple(base.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def log(src):
        return paths[src].with_suffix(".log").read_text()

    render_log = log("kernel_base.cu")
    thread_xt = {"thread": _ptxas(render_log,
                                  "19kernel_base_chunkedILb1ELb1E")}
    pose = Camera().pose()

    def scene(name, w, h, spp, depth, **over):
        return load_scene(name).with_overrides(
            width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)

    fog = Fog(density=0.15)
    # The chunked XT kernel A within the budget.
    tr = PathTracer(scene("stress:1024", 200, 100, 8, 6, fog=fog), "cuda",
                    transport="mis")
    libs = {k: build.load_kernels((src,)) for k, src in chunked.items()}
    _sweep_chunked("stress1024 fog mis", tr, pose, SEED, libs, reps,
                   ptxas={**thread_xt, **{k: _ptxas(
                       log(src), "kernel_base_chunked_groupedILb1ELb1EN3trt10"
                       "GroupSweep") for k, src in chunked.items()}})
    # Its GroupSpill forms above it.
    libs = {k: build.load_kernels((src,)) for k, src in spill.items()}
    marks = {k: _ptxas(log(src), "kernel_base_chunked_groupedILb1ELb1EN3trt"
                       "10GroupSpill") for k, src in spill.items()}
    for name, label in (("icosphere:4", "mesh5120 fog"),
                        ("icosphere:5", "icosphere5 fog")):
        tr = PathTracer(scene(name, 200, 100, 8, 6, fog=fog), "cuda")
        n_sph, n_pln, n_tri, _ = tr.tables.counts
        print(f"[group_k] {label}: {kernels.group_rows_bytes(tr)} B of rows; "
              f"staged at 96 KB "
              f"{kernels.group_stage(n_sph, n_pln, n_tri, GROUP_SMEM_BYTES)}"
              f", at 227 KB "
              f"{kernels.group_stage(n_sph, n_pln, n_tri, GROUP_SMEM_MAX)}",
              flush=True)
        _sweep_chunked(label, tr, pose, SEED, libs, reps, spill=True,
                       rows=PLAIN_ROWS if name == "icosphere:5" else 0,
                       ptxas={**thread_xt, **marks})
    # The XT kernel A's forms at its main-path scenes.
    libs = {form: build.load_kernels((src,)) for form, src in base.items()}
    logs = {form: log(src) for form, src in base.items()}
    shipped = ("20kernel_base_residentILb1ELb1E"
               if "kernel_base_resident" in render_log
               else "11kernel_baseILb1ELb1E")
    print(f"[group_k] XT kernel A shipped: "
          f"{_ptxas(render_log, shipped)[2:]}", flush=True)
    for label, tr in (
            ("fog", PathTracer(scene("Cornell_Box", 400, 200, 16, 32,
                                     fog=fog), "cuda")),
            ("manylights_one", PathTracer(load_scene("lights:16")
                                          .with_overrides(
                                              light_sample="power"),
                                          "cuda")),
            ("showcase mis", PathTracer(load_scene("showcase"), "cuda",
                                        transport="mis"))):
        _sweep_base_forms(label, tr, pose, SEED, libs, logs, reps)


# --only ext: the grouped EXT kernel B's K over GroupSweep, the grouped
# chunked EXT kernel A's K over GroupSweep (CHUNKED_EXT_KS), one library a
# K, and the GroupSpill forms (K, block width) of both at a 227 KB cap.
EXT_KS = (1, 2, 4, 8, 16)
CHUNKED_EXT_KS = (4, 8, 16, 32)
EXT_SPILL = tuple((k, t) for k in (16, 32) for t in (256, 512))
# The EXT kernel A's forms, (group width, refill, resident blocks an SM; 0:
# unbound): K = 1 static is also the thread per pixel's (unbound, held to
# 6 and 8), the grouped form at every K on both schedules, and at K 1, 2,
# 4 held to 6 (ptxas fits it to 80 registers: 24 warps an SM).
EXT_BASE = (tuple((1, 0, minb) for minb in (0, 6, 8))
            + tuple((k, refill, 0) for k in (1, 2, 4, 8, 32)
                    for refill in (0, 1) if (k, refill) != (1, 0))
            + tuple((k, refill, 6) for k in (1, 2, 4) for refill in (0, 1)
                    if (k, refill) != (1, 0)))
# Its scenes: the packaged extension scenes at their own size, spp and
# depth (timed twice, in turns: the dispatch below GROUP_BASE_MIN_PRIMS
# primitives), showcase and textured at the JAX bench's 16 spp, depth 32,
# and the checker stress:256 and stress:64 at 200x100, 8 spp, depth 6.
EXT_PACKAGED = ("cornell_glass", "showcase", "textured", "envmap", "bumpy")
EXT_BENCH = ("showcase", "textured")
EXT_STRESS = ("stress:256", "stress:64")
# --only walk: the grouped gathered kernel B's (K, row source: 0 rows and
# CSR through L1, 1 rows staged, 2 CSR and rows staged; walk_forms) at 128
# lanes a block and a 227 KB stage cap; the grouped gathered kernel A's the
# same at the widths WALK_A_KS, on both schedules.
WALK_KS = (2, 4, 8, 16, 32)
WALK_A_KS = (8, 16, 32)
WALK_SOURCES = ("L1", "rows staged", "CSR and rows staged")
# --only walk --a-only: the grouped chunked gathered kernel A's widths (every
# row source at each), and its scenes under gathered at chunks of 2
# (label, scene, plain rows a call, summed): the three whose summed time
# picks the shipped form, and icosphere:5 (960 KB of rows) as a line only.
CHUNKED_WALK_KS = (4, 8, 16, 32)
CHUNKED_WALK_SCENES = (("stress1024", "stress:1024", 0, True),
                       ("mesh1280", "icosphere:3", 0, True),
                       ("mesh5120", "icosphere:4", 0, True),
                       ("icosphere5", "icosphere:5", PLAIN_ROWS, False))


def walk_forms(ks=WALK_KS):
    """The (K, row source) forms of --only walk at the group widths `ks`."""
    return tuple((k, src) for k in ks for src in (0, 1, 2))


def _checker(scene):
    """`scene` with a checker floor (its first plane): the EXT instantiation
    at array scale, as chip_smoke.py's checker stress:1024."""
    import dataclasses

    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


def _walk_libs(ks=WALK_KS, a_ks=WALK_A_KS):
    """The group_tune.cu builds of --only walk: {label: (source, defines)}
    of the walk forms at the group widths `ks` (the static schedule), and
    of those at `a_ks` on the refill schedule (kernel A)."""
    def forms(ks_, refill):
        return {f"{k} {WALK_SOURCES[src]}{' refill' if refill else ''}": (
            build.TUNE_SOURCE, (
                f"TRT_TUNE_K={k}", "TRT_TUNE_THREADS=128",
                f"TRT_TUNE_STAGE_CAP={GROUP_SMEM_MAX}",
                f"TRT_TUNE_WALK={src}") + (("TRT_TUNE_REFILL=1",) if refill
                                           else ()))
            for k, src in walk_forms(ks_)}

    return forms(sorted(set(ks) | set(a_ks)), False), forms(a_ks, True)


def _ext_libs():
    """The group_tune.cu builds of --only ext: {label: (source, defines)} of
    the GroupSweep widths (EXT_KS, CHUNKED_EXT_KS) and of the GroupSpill
    forms (EXT_SPILL) at a 227 KB cap."""
    sweep = {str(k): (build.TUNE_SOURCE, (f"TRT_TUNE_K={k}",))
             for k in sorted(set(EXT_KS) | set(CHUNKED_EXT_KS))}
    spill = {f"{k} t{t} cap{GROUP_SMEM_MAX}": (build.TUNE_SOURCE, (
        f"TRT_TUNE_K={k}", f"TRT_TUNE_THREADS={t}",
        f"TRT_TUNE_STAGE_CAP={GROUP_SMEM_MAX}")) for k, t in EXT_SPILL}
    return sweep, spill


def _ext_base_libs():
    """The group_tune.cu builds of the EXT kernel A's forms: {(K, refill,
    bound): (source, defines)}."""
    return {form: (build.TUNE_SOURCE, (
        f"TRT_TUNE_K={form[0]}", f"TRT_TUNE_REFILL={form[1]}",
        f"TRT_TUNE_MIN_BLOCKS={form[2]}")) for form in EXT_BASE}


def sweep_ext_base(srcs, paths, reps) -> None:
    """The EXT kernel A's forms (EXT_BASE; `srcs` their builds, `paths` the
    built libraries) at its scenes: the packaged five twice, the second run
    in the reverse order, with each form's summed time of each run beside
    the shipped thread per pixel's; then EXT_BENCH and EXT_STRESS."""
    libs = {form: build.load_kernels((src,)) for form, src in srcs.items()}
    logs = {form: paths[src].with_suffix(".log").read_text()
            for form, src in srcs.items()}
    render_log = paths["kernel_base.cu"].with_suffix(".log").read_text()
    print("[group_k] EXT kernel A shipped: thread per pixel"
          f"{_ptxas(render_log, '11kernel_baseILb1ELb0E')}; grouped"
          f"{_ptxas(render_log, '19kernel_base_groupedILb1ELb0E')}",
          flush=True)
    pose = Camera().pose()
    tracers = {name: PathTracer(load_scene(name), "cuda")
               for name in EXT_PACKAGED}
    order, sums = None, []
    for run in (1, 2):
        total = {}
        for name, tr in tracers.items():
            times = _sweep_base_forms(f"{name} 400x200 run {run}", tr, pose,
                                   SEED, libs, logs, reps, order)
            for form, ms in times.items():
                total[form] = total.get(form, 0.0) + ms
        sums.append(total)
        order = list(reversed(list(total)))
    shipped = ("shipped", (0, 0, 0))
    for form in sums[0]:
        a, b = sums[0][form], sums[1][form]
        print(f"[group_k] packaged five, summed: {form[0]} {form[1]}: run 1 "
              f"{a:.4f} ms, run 2 {b:.4f} ms; against the shipped thread per "
              f"pixel x{sums[0][shipped] / a:.3f}, "
              f"x{sums[1][shipped] / b:.3f}", flush=True)
    for name in EXT_BENCH:
        tr = PathTracer(load_scene(name).with_overrides(
            samples_per_pixel=16, max_depth=32), "cuda")
        _sweep_base_forms(f"{name} bench 400x200 spp 16 depth 32", tr, pose,
                       SEED, libs, logs, reps)
    for name in EXT_STRESS:
        tr = PathTracer(_checker(load_scene(name).with_overrides(
            width=200, height=100, samples_per_pixel=8, max_depth=6)), "cuda")
        if tr.chunk_base or kernels._kind(tr) != "ext":
            raise SystemExit(f"group_k: checker {name} is chunked or not EXT")
        _sweep_base_forms(f"{name} checker 200x100", tr, pose, SEED, libs, logs,
                       reps)


def _walk_table(label, tr) -> None:
    """Print the grid and what GroupWalk stages for gathered tracer `tr`."""
    h = kernels.accel_args(tr)
    n_sph, n_pln, n_tri, _ = tr.tables.counts
    csr = 4 * (h.dims[0] * h.dims[1] * h.dims[2] + 1 + h.n_groups)
    beside = ("the CSR over the cap, not staged" if csr > GROUP_SMEM_MAX
              else "beside the CSR "
              f"{kernels.group_stage(n_sph, 0, n_tri, GROUP_SMEM_MAX - csr)}")
    print(f"[group_k] {label} gathered: dims {list(h.dims)}, CSR "
          f"{csr} B, rows staged at 227 KB "
          f"{kernels.group_stage(n_sph, 0, n_tri, GROUP_SMEM_MAX)}, {beside}"
          " (triangles, spheres, planes)", flush=True)


def sweep_chunked_walk(reps, ks=CHUNKED_WALK_KS) -> None:
    """--only walk --a-only: the chunked gathered kernel A at chunks of 2
    over GroupWalk at each K of `ks` by row source (128 lanes a block, a
    227 KB cap) beside the thread per entry (traverse.cuh Walk), at
    CHUNKED_WALK_SCENES, twice, the second run in the reverse order: each
    line bit for bit against the plain version (planes, end states, rays),
    its lane-iterations the plain model's at K, its walk counters the plain
    version's and its ptxas line; then each form's summed time over the
    summed scenes in each run, the two best K through L1 with the staged
    sources at those K, and the least sum of a form chosen by the scene
    beside the least sum of one form."""
    srcs = _walk_libs(ks, ())[0]
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(srcs.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    libs = {label: build.load_kernels((src,)) for label, src in srcs.items()}
    marks = {label: _ptxas(paths[src].with_suffix(".log").read_text(),
                           "kernel_base_chunked_groupedILb1ELb1EN3trt9"
                           "GroupWalk") for label, src in srcs.items()}
    marks["thread"] = _ptxas(
        paths["kernel_accel.cu"].with_suffix(".log").read_text(),
        "19kernel_base_chunkedILb1ELb1EN3trt4Walk")
    pose = Camera().pose()
    cases = []
    for label, name, rows, summed in CHUNKED_WALK_SCENES:
        tr = PathTracer(load_scene(name).with_overrides(
            width=200, height=100, samples_per_pixel=8, max_depth=6), "cuda",
            accel="gathered", chunk_base=2, chunk_extra=2)
        _walk_table(label, tr)

        def plain(fn, tr=tr, rows=rows):
            return _in_rows(lambda r0, r1: fn(tr, pose, SEED, 0, r0,
                                              r1 - r0), tr.height, rows,
                            dim=1)

        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
        p = plain(lambda *a_: kernels.base_kernel_chunked_plain(*a_)[:4])
        stats = tr.prims.stats.long().cpu()
        tr.prims.ops = None
        print(f"[group_k] {label} gathered cb 2: {tr.n_base_chunks} chunks, "
              f"walk counters (walks, tests, advances, capped): plain "
              f"{stats.tolist()}", flush=True)
        cases.append((label, tr, (*p[0], *p[1], p[3], p[2]), stats,
                      plain(kernels.chunked_entry_iters), summed))
    forms = ["thread", *libs]
    sums = []
    for run in (1, 2):
        total = dict.fromkeys(forms, 0.0)
        per_scene = {}
        for label, tr, want, stats, it, summed in cases:
            for form in forms:
                lib = libs.get(form)
                kind = "gathered" if lib is None else "gathered_grouped"

                def launch(kind=kind, lib=lib, tr=tr):
                    return kernels._launch_chunked(tr, pose, SEED, 0, 0, None,
                                                   kind, lib)

                out, got = _counted(tr, launch)
                ms = _time(launch, reps)
                width = 1 if lib is None else int(form.split()[0])
                _line(f"{label} gathered cb 2 run {run} chunked A", form, ms,
                      _equal((*out.csum, *out.csumsq, out.rays, out.state),
                             want),
                      float(out.iters) == float(kernels.warp_iters(it, width)),
                      it, bool(torch.equal(got, stats)), marks[form])
                if summed:
                    total[form] += ms
                    per_scene[label, form] = ms
        sums.append((total, per_scene))
        forms.reverse()
    for form in sorted(sums[0][0], key=sums[0][0].get):
        a, b = sums[0][0][form], sums[1][0][form]
        print(f"[group_k] chunked gathered A summed over "
              f"{', '.join(c[0] for c in cases if c[5])}: {form}: run 1 "
              f"{a:.4f} ms, run 2 {b:.4f} ms", flush=True)
    l1 = sorted((f for f in libs if f.endswith(WALK_SOURCES[0])),
                key=lambda f: sums[0][0][f] + sums[1][0][f])[:2]
    for f in l1:
        staged = [f"{f.split()[0]} {WALK_SOURCES[src]}" for src in (1, 2)]
        print(f"[group_k] chunked gathered A, one of the two best K through "
              f"L1: {f} {sums[0][0][f]:.4f} / {sums[1][0][f]:.4f} ms; "
              + "; ".join(f"{g} {sums[0][0][g]:.4f} / {sums[1][0][g]:.4f} ms"
                          for g in staged), flush=True)
    for run, (total, per_scene) in enumerate(sums, 1):
        single = min(libs, key=total.get)
        chosen = sum(min(per_scene[label, f] for f in libs)
                     for label, *_ in (c for c in cases if c[5]))
        print(f"[group_k] chunked gathered A run {run}: one form {single} "
              f"{total[single]:.4f} ms, a form by scene {chosen:.4f} ms "
              f"(x{total[single] / chosen:.3f}); thread per entry "
              f"{total['thread']:.4f} ms", flush=True)


def sweep_ext_walk(only, reps, ks=None, a_only=False) -> None:
    """--only ext, --only walk (the module docstring); `ks`: the walk's
    group widths (default WALK_KS for kernel B, WALK_A_KS for kernel A,
    CHUNKED_WALK_KS for the chunked gathered kernel A; --only ext ignores
    it); `a_only`: --only ext sweeps the EXT kernel A alone, --only walk
    the chunked gathered kernel A alone (sweep_chunked_walk)."""
    base = {}
    if only == "walk" and a_only:
        sweep_chunked_walk(reps, ks or CHUNKED_WALK_KS)
        return
    if only == "walk":
        walk, refill = _walk_libs(ks or WALK_KS, ks or WALK_A_KS)
        srcs = {**walk, **refill}
    else:
        sweep, spill = _ext_libs()
        base = _ext_base_libs()
        srcs = {} if a_only else {**sweep, **spill}
        srcs.update({f"A {form}": src for form, src in base.items()})
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(srcs.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def log(src):
        return paths[src].with_suffix(".log").read_text()

    pose = Camera().pose()

    def scene(name, w=None, h=None, spp=None, depth=None):
        return load_scene(name).with_overrides(
            width=w, height=h, samples_per_pixel=spp, max_depth=depth)

    if only == "walk":
        b_ks = set(ks or WALK_KS)
        libs = {label: build.load_kernels((src,))
                for label, src in walk.items()
                if int(label.split()[0]) in b_ks}
        marks = {label: _ptxas(log(src), "kernel_extra_groupedILb1ELb1EN3trt9"
                               "GroupWalk") for label, src in walk.items()}
        marks["thread"] = _ptxas(log("kernel_accel.cu"),
                                 "12kernel_extraILb1ELb1EN3trt4Walk")
        a_ks = set(ks or WALK_A_KS)
        a_libs = {label: build.load_kernels((src,))
                  for label, src in {**walk, **refill}.items()
                  if int(label.split()[0]) in a_ks}
        a_marks = {label: _ptxas(log(src), "19kernel_base_groupedILb1ELb1EN3"
                                 "trt9GroupWalk")
                   for label, src in {**walk, **refill}.items()}
        a_marks["thread"] = _ptxas(log("kernel_accel.cu"),
                                   "11kernel_baseILb1ELb1EN3trt4Walk")
        for label, name in (("stress1024", "stress:1024"),
                            ("mesh1280", "icosphere:3"),
                            ("mesh5120", "icosphere:4"),
                            ("Cornell_Box", "Cornell_Box")):
            tr = PathTracer(scene(name, 200, 100, 8, 6), "cuda",
                            accel="gathered")
            _walk_table(label, tr)
            if label != "Cornell_Box":
                _sweep_extra(f"{label} gathered", tr, pose, SEED, libs, reps,
                             ptxas=marks)
            _sweep_base(f"{label} gathered", tr, pose, SEED, a_libs, reps,
                        ptxas=a_marks)
        return
    if a_only:
        sweep_ext_base(base, paths, reps)
        return
    libs = {k: build.load_kernels((src,)) for k, src in sweep.items()}
    marks = {k: _ptxas(log(src), "kernel_extra_groupedILb1ELb0EN3trt10"
                       "GroupSweep") for k, src in sweep.items()}
    marks["thread"] = _ptxas(log("kernel_extra.cu"), "12kernel_extraILb1ELb0E")
    b_libs = {k: lib for k, lib in libs.items() if int(k) in EXT_KS}
    for name in ("cornell_glass", "showcase", "textured", "envmap", "bumpy"):
        _sweep_extra(f"{name} 400x200", PathTracer(scene(name), "cuda"), pose,
                     SEED, b_libs, reps, ptxas=marks)
    big = PathTracer(_checker(scene("stress:1024", 200, 100, 8, 6)), "cuda")
    _sweep_extra("stress1024 checker", big, pose, SEED, b_libs, reps,
                 ptxas=marks)
    # The chunked EXT kernel A within the budget.
    a_marks = {k: _ptxas(log(src), "kernel_base_chunked_groupedILb1ELb0EN3trt"
                         "10GroupSweep") for k, src in sweep.items()}
    a_marks["thread"] = _ptxas(log("kernel_base.cu"),
                               "19kernel_base_chunkedILb1ELb0E")
    _sweep_chunked("stress1024 checker", big, pose, SEED,
                   {k: lib for k, lib in libs.items()
                    if int(k) in CHUNKED_EXT_KS}, reps, ptxas=a_marks)
    # Both over the budget, GroupSpill.
    libs = {label: build.load_kernels((src,)) for label, src in spill.items()}
    marks = {label: _ptxas(log(src), "kernel_extra_groupedILb1ELb0EN3trt10"
                           "GroupSpill") for label, src in spill.items()}
    marks["thread"] = _ptxas(log("kernel_extra.cu"), "12kernel_extraILb1ELb0E")
    tr = PathTracer(_checker(scene("icosphere:4", 200, 100, 8, 6)), "cuda")
    n_sph, n_pln, n_tri, _ = tr.tables.counts
    print(f"[group_k] mesh5120 checker: {kernels.group_rows_bytes(tr)} B of "
          f"rows; staged at 227 KB "
          f"{kernels.group_stage(n_sph, n_pln, n_tri, GROUP_SMEM_MAX)}",
          flush=True)
    _sweep_extra("mesh5120 checker", tr, pose, SEED, libs, reps, spill=True,
                 ptxas=marks)
    a_marks = {label: _ptxas(log(src), "kernel_base_chunked_groupedILb1ELb0EN"
                             "3trt10GroupSpill")
               for label, src in spill.items()}
    a_marks["thread"] = _ptxas(log("kernel_base.cu"),
                               "19kernel_base_chunkedILb1ELb0E")
    _sweep_chunked("mesh5120 checker", tr, pose, SEED, libs, reps, spill=True,
                   ptxas=a_marks)
    sweep_ext_base(base, paths, reps)


# --only grid: the grid kernels' GroupCulledSpill forms, (K, design, block
# width) at a 227 KB stage cap, kernel A on both schedules; the within-budget
# shapes at which they are also timed beside the shipped GroupCulled.
GRID_KS = (8, 16, 32)
GRID_THREADS = (256, 512)
GRID_OVER = (("mesh5120 grid", "icosphere:4", 0),
             ("icosphere5 grid", "icosphere:5", PLAIN_ROWS))
GRID_WITHIN = (("stress1024 grid", "stress:1024"),
               ("mesh1280 grid", "icosphere:3"))
# The grid kernel A's thread per pixel at the north star under grid (11
# primitives: no group), held to these resident blocks an SM (0: unbound).
GRID_MIN_BLOCKS = (0, 4, 5, 6)


def _grid_libs(ks=GRID_KS):
    """The group_tune.cu builds of --only grid: {label: (source, defines)},
    label 'K design tT[ refill]' (design 'wide', K / 8 blocks a step, or
    'narrow', one block a step on all K lanes; the same at K = 8)."""
    out = {}
    for k in ks:
        for wide in ((1, 0) if k > 8 else (0,)):
            for t in GRID_THREADS:
                for refill in (0, 1):
                    label = (f"{k} {'wide' if wide else 'narrow'} t{t}"
                             + (" refill" if refill else ""))
                    out[label] = (build.TUNE_SOURCE, (
                        f"TRT_TUNE_K={k}", f"TRT_TUNE_WIDE={wide}",
                        f"TRT_TUNE_THREADS={t}",
                        f"TRT_TUNE_STAGE_CAP={GROUP_SMEM_MAX}",
                        f"TRT_TUNE_REFILL={refill}"))
    return out


def _grid_resident(tr, pose, seed, libs, logs, reps):
    """The grid kernel A's thread per pixel on `tr`: the render library's,
    then held to each GRID_MIN_BLOCKS bound (`libs`, `logs` by bound), each
    against the plain version bit for bit with its counters, its
    lane-iterations the plain model's at K = 1, its ptxas line, resident
    blocks an SM and waves; twice, in turns."""
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    p = kernels.base_kernel_plain(tr, pose, seed, 0)
    plain_stats = tr.prims.stats.long().cpu()
    tr.prims.ops = None
    want = (*p.csum, *p.csumsq, p.rays, p.var, p.additional, p.state)
    it = kernels.base_entry_iters(tr, pose, seed, 0)
    blocks = -(-tr.width * tr.height // 128)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    label = f"north star grid kernel A (grid) {tr.width}x{tr.height}"

    def launch(lib=None):
        return kernels._launch_base(tr, pose, seed, 0, 0, None, None, "grid",
                                    lib)

    def flat(o):
        return (*o.csum, *o.csumsq, o.rays, o.var, o.additional, o.state)

    for _ in range(2):
        for n, lib in {"shipped": None, **libs}.items():
            out, stats = _counted(tr, lambda: launch(lib))
            extra = ""
            if lib is not None:
                per_sm = lib.trt_kernel_base_grid_per_sm()
                pattern = ("20kernel_base_residentILb1ELb1EN3trt6Culled" if n
                           else "11kernel_baseILb1ELb1EN3trt6Culled")
                extra = (_ptxas(logs[n], pattern) + f", {per_sm} blocks an "
                         f"SM, {blocks / max(per_sm * n_sm, 1):.2f} waves")
            tag = ("1 shipped" if lib is None else
                   f"1 bound {n}" if n else "1 unbound")
            _line(label, tag, _time(lambda: launch(lib), reps),
                  _equal(flat(out), want),
                  float(out.iters) == float(kernels.warp_iters(it, 1)), it,
                  bool(torch.equal(stats, plain_stats)), extra)


def sweep_chunked_grid(srcs, paths, reps) -> None:
    """The chunked grid kernel A at cb = 2 (--only grid): within the budget
    (GRID_WITHIN) over GroupCulled at each (K, design) of the static builds
    `srcs` (128 lanes a block whatever their width), over it (GRID_OVER)
    over each GroupCulledSpill form; each beside the thread per entry, bit
    for bit with the traversal counters and lane-iterations."""
    static = {label: src for label, src in srcs.items()
              if not label.endswith("refill")}
    libs = {label: build.load_kernels((src,)) for label, src in static.items()}
    within = {label.rsplit(" ", 1)[0]: lib for label, lib in libs.items()
              if label.endswith(f"t{GRID_THREADS[0]}")}

    def log(src):
        return paths[src].with_suffix(".log").read_text()

    culled = "kernel_base_chunked_groupedILb1ELb1EN3trt11GroupCulled"
    spill = "kernel_base_chunked_groupedILb1ELb1EN3trt16GroupCulledSpill"
    thread = _ptxas(log("kernel_accel.cu"),
                    "19kernel_base_chunkedILb1ELb1EN3trt6Culled")
    w_marks = {label.rsplit(" ", 1)[0]: _ptxas(log(src), culled)
               for label, src in static.items()}
    o_marks = {label: _ptxas(log(src), spill) for label, src in static.items()}
    pose = Camera().pose()
    for group, forms, marks, is_spill in (
            (tuple((label, name, 0) for label, name in GRID_WITHIN), within,
             w_marks, False),
            (GRID_OVER, libs, o_marks, True)):
        for label, name, rows in group:
            tr = PathTracer(load_scene(name).with_overrides(
                width=200, height=100, samples_per_pixel=8, max_depth=6),
                "cuda", accel="grid", chunk_base=2, chunk_extra=2)
            counts = kernels.grid_counts(tr)
            staged = kernels.culled_stage(*counts, GROUP_SMEM_MAX)
            print(f"[group_k] {label} cb 2: {tr.n_base_chunks} chunks, "
                  f"{kernels.group_smem_bytes(tr)} B of rows and group table"
                  + (f"; staged at 227 KB {staged}, "
                     f"{kernels.culled_stage_bytes(staged)} B" if is_spill
                     else ""), flush=True)
            _sweep_chunked(f"{label} cb 2", tr, pose, SEED, forms, reps,
                           spill=is_spill, rows=rows,
                           ptxas={**marks, "thread": thread})


def sweep_grid(reps, ks=GRID_KS, a_only=False) -> None:
    """--only grid (the module docstring); `a_only`: the chunked grid kernel
    A alone."""
    srcs = _grid_libs(ks)
    resident = {n: (build.TUNE_SOURCE, ("TRT_TUNE_K=1",
                                        f"TRT_TUNE_MIN_BLOCKS={n}"))
                for n in GRID_MIN_BLOCKS}
    if a_only:
        srcs = {label: src for label, src in srcs.items()
                if not label.endswith("refill")}
        resident = {}
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(srcs.values())
                                + tuple(resident.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def log(src):
        return paths[src].with_suffix(".log").read_text()

    if a_only:
        sweep_chunked_grid(srcs, paths, reps)
        return
    libs = {label: build.load_kernels((src,)) for label, src in srcs.items()}
    b_libs = {label: lib for label, lib in libs.items()
              if not label.endswith("refill")}
    spill = "N3trt16GroupCulledSpill"
    a_marks = {label: _ptxas(log(src), "kernel_base_groupedILb1ELb1E" + spill)
               for label, src in srcs.items()}
    b_marks = {label: _ptxas(log(src), "kernel_extra_groupedILb1ELb1E" + spill)
               for label, src in srcs.items()}
    accel = log("kernel_accel.cu")
    a_marks["thread"] = _ptxas(accel, "11kernel_baseILb1ELb1EN3trt6Culled")
    b_marks["thread"] = _ptxas(accel, "12kernel_extraILb1ELb1EN3trt6Culled")
    pose = Camera().pose()

    def tracer(name):
        return PathTracer(load_scene(name).with_overrides(
            width=200, height=100, samples_per_pixel=8, max_depth=6), "cuda",
            accel="grid")

    for label, name, rows in GRID_OVER:
        tr = tracer(name)
        counts = kernels.grid_counts(tr)
        staged = kernels.culled_stage(*counts, GROUP_SMEM_MAX)
        print(f"[group_k] {label}: {kernels.group_smem_bytes(tr)} B of rows "
              f"and group table, (groups, spheres, planes, triangles) "
              f"{counts}; staged at 227 KB {staged} (groups, triangles, "
              f"spheres, planes), {kernels.culled_stage_bytes(staged)} B",
              flush=True)
        _sweep_base(label, tr, pose, SEED, libs, reps, ptxas=a_marks,
                    spill=True, rows=rows)
        _sweep_extra(label, tr, pose, SEED, b_libs, reps, spill=True,
                     rows=rows, ptxas=b_marks)
    # Within the budget: the shipped GroupCulled in turns with each
    # GroupCulledSpill form (everything staged there).
    render = build.load_kernels()
    ka, kb = (kernels.group_k(k, render) for k in ("base_grid", "extra_grid"))
    for label, name in GRID_WITHIN:
        tr = tracer(name)
        for shipped, is_spill in ((True, False), (False, True),
                                  (False, True), (True, False)):
            _sweep_base(label, tr, pose, SEED,
                        {f"{ka} GroupCulled (shipped)": render} if shipped
                        else libs, reps, spill=is_spill)
            _sweep_extra(label, tr, pose, SEED,
                         {f"{kb} GroupCulled (shipped)": render} if shipped
                         else b_libs, reps, spill=is_spill)
    # The thread per pixel below GROUP_BASE_MIN_PRIMS, held to a residency.
    ns = PathTracer(load_scene("Cornell_Box").with_overrides(
        width=400, height=200, samples_per_pixel=16, max_depth=32), "cuda",
        accel="grid")
    _grid_resident(ns, pose, SEED,
                   {n: build.load_kernels((src,))
                    for n, src in resident.items()},
                   {n: log(src) for n, src in resident.items()}, reps)
    sweep_chunked_grid(srcs, paths, reps)


FRAME_KS = (1, 4, 8, 16, 32)
FRAME_SOURCES = ("kernel_frame.cu", "kernel_frame_lockstep.cu")
FRAME_MIN_BLOCKS = (4, 5, 6)
# (label, scene, (width, height, spp, depth) or None, fog density,
# PathTracer keywords)
FRAME_SHAPES = (
    ("north star", "Cornell_Box", (400, 200, 16, 32), None, {}),
    ("stress1024", "stress:1024", (200, 100, 8, 6), None, {}),
    ("showcase", "showcase", None, None, {}),
    ("fog", "Cornell_Box", (400, 200, 16, 32), 0.15, {}),
    ("stress1024 grid cb 2", "stress:1024", (200, 100, 8, 6), None,
     dict(accel="grid", chunk_base=2, chunk_extra=2)),
    ("stress1024 gathered cb 2", "stress:1024", (200, 100, 8, 6), None,
     dict(accel="gathered", chunk_base=2, chunk_extra=2)),
    ("mesh5120", "icosphere:4", (200, 100, 8, 6), None, {}),
    ("stress64 checker", "checker stress:64", (200, 100, 8, 6), None, {}),
    ("stress1024 fog mis", "stress:1024", (200, 100, 8, 6), 0.15,
     dict(transport="mis")),
    ("mesh5120 fog", "icosphere:4", (200, 100, 8, 6), 0.15, {}),
    ("Cornell grid", "Cornell_Box", (200, 100, 8, 6), None,
     dict(accel="grid")),
    ("mesh5120 grid", "icosphere:4", (200, 100, 8, 6), None,
     dict(accel="grid")),
    ("Cornell gathered", "Cornell_Box", (200, 100, 8, 6), None,
     dict(accel="gathered")),
)


def sweep_frame(reps, ks=FRAME_KS) -> None:
    """--only frame (the module's docstring)."""
    defines = {f"{which} {k}": f"TRT_TUNE_{which}={k}"
               for k in ks for which in ("KB", "KE")}
    # The shipped widths, held to m blocks an SM.
    defines.update({f"MB {m}": f"TRT_TUNE_FRAME_MIN_BLOCKS={m}"
                    for m in FRAME_MIN_BLOCKS})
    libs = {name: tuple((src, (build.QUEUE_ONLY, d)) for src in FRAME_SOURCES)
            for name, d in defines.items()}
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES
                                + sum(libs.values(), ()))
    print(f"[group_k] frame: {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for name, srcs in libs.items():
        for src in srcs:
            lines = ptxas_lines.kernels_of(
                paths[src].with_suffix(".log").read_text())
            plain = ptxas_lines.demangle(lines)
            for m, line in lines.items():
                print(f"[group_k] frame {name}: {plain[m]}: {line}",
                      flush=True)
    loaded = {name: build.load_kernels(srcs) for name, srcs in libs.items()}
    pose = Camera().pose()
    for label, name, size, fog, kw in FRAME_SHAPES:
        over = {} if fog is None else {"fog": Fog(density=fog)}
        if size is not None:
            over.update(zip(("width", "height", "samples_per_pixel",
                             "max_depth"), size))
        scene = load_scene(name.removeprefix("checker ")).with_overrides(
            **over)
        if name.startswith("checker "):
            scene = _checker(scene)
        tr = PathTracer(scene, "cuda", **kw)
        kind, form = kernels._kind(tr), kernels.frame_form(tr)
        for mode in ("regen", "lockstep"):
            def shipped():
                return kernels.FRAME_KERNELS[mode, kind](tr, pose, SEED, 0)

            def thread():
                return kernels._launch_frame(tr, pose, SEED, 0, 0, None,
                                             f"trt_kernel_{mode}", kind)

            want = shipped()
            ref = (*want.current, want.var, want.total, want.rays)
            kb, ke = kernels.FRAME_QUEUE_K[kind, form]
            print(f"[group_k] frame {label} {mode} {kind} {form}: shipped "
                  f"(KB {kb}, KE {ke}) {_time(shipped, reps):.4f} ms, "
                  f"{kernels.frame_queue_per_sm(tr, mode, pose)} blocks an "
                  f"SM, lane-iterations {float(want.iters):.0f}; thread per "
                  f"pixel {_time(thread, reps):.4f} ms", flush=True)
            for lname, lib in loaded.items():
                if form == "solo" and lname.startswith("KB"):
                    continue  # one lane a base item whatever KB

                def fn(lib=lib):
                    return kernels._launch_frame_queue(
                        tr, mode, pose, SEED, 0, 0, None, form, lib)

                got = fn()
                which, k = lname.split()
                kbl = int(k) if which == "KB" else kb
                kel = int(k) if which == "KE" else ke
                same = _equal((*got.current, got.var, got.total, got.rays),
                              ref)
                print(f"[group_k] frame {label} {mode} {lname} (KB {kbl}, "
                      f"KE {kel}): {_time(fn, reps):.4f} ms, equal {same}, "
                      f"lane-iterations {float(got.iters):.0f}, "
                      f"{kernels.frame_queue_per_sm(tr, mode, pose, lib)} "
                      "blocks an SM", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=("base", "spill", "budget", "xt", "ext",
                                       "walk", "grid", "frame"), default=None)
    ap.add_argument("--a-only", action="store_true",
                    help="--only ext: the EXT kernel A alone; --only grid: "
                    "the chunked grid kernel A alone; --only walk: the "
                    "chunked gathered kernel A alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("group_k: needs a CUDA GPU", file=sys.stderr)
        sys.exit(2)
    if args.only == "frame":
        sweep_frame(args.reps, [int(k) for k in args.ks.split(",")]
                    if args.ks else FRAME_KS)
        return 0
    if args.only == "xt":
        sweep_xt(args.reps, [int(k) for k in args.ks.split(",")] if args.ks
                 else XT_CHUNKED_KS)
        return 0
    if args.only == "spill":
        sweep_spill([int(k) for k in (args.ks or "8,16,32").split(",")],
                    args.reps)
        return 0
    if args.only == "budget":
        sweep_budget(args.reps)
        return 0
    if args.only == "grid":
        sweep_grid(args.reps, [int(k) for k in args.ks.split(",")] if args.ks
                   else GRID_KS, args.a_only)
        return 0
    if args.only in ("ext", "walk"):
        sweep_ext_walk(args.only, args.reps,
                       [int(k) for k in args.ks.split(",")] if args.ks
                       else None, args.a_only)
        return 0
    ks = [int(k) for k in (args.ks or ",".join(map(str, KS))).split(",")]
    tune = {k: (build.TUNE_SOURCE, (f"TRT_TUNE_K={k}",)) for k in ks}
    # The grid kernels' other design where the two differ (K > 8).
    narrow = {f"{k} one block a step": (build.TUNE_SOURCE,
                                         (f"TRT_TUNE_K={k}", "TRT_TUNE_WIDE=0"))
              for k in ks if k > 8}
    # Kernel A's refill schedule, in each of those.
    refill = {f"{k} refill": (src, (*defines, "TRT_TUNE_REFILL=1"))
              for k, (src, defines) in {**tune, **narrow}.items()}
    t0 = time.perf_counter()
    paths = build.library_paths(build.RENDER_SOURCES + tuple(tune.values())
                                + tuple(narrow.values())
                                + tuple(refill.values()))
    print(f"[group_k] {len(paths)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for k, src in {**tune, **narrow, **refill}.items():
        for line in paths[src].with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"[group_k] K {k}: {line.strip()}", flush=True)
    libs = {k: build.load_kernels((src,)) for k, src in tune.items()}
    narrow_libs = {k: build.load_kernels((src,)) for k, src in narrow.items()}
    refill_libs = {k: build.load_kernels((src,)) for k, src in refill.items()}
    pose = Camera().pose()

    def scene(name, w, h, spp, depth, **over):
        return load_scene(name).with_overrides(
            width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)

    # Kernel A: every K on both schedules (the grid's also in both designs).
    base_libs = {**libs, **{k: v for k, v in refill_libs.items()
                            if "one block" not in k}}
    ns_scene = scene("Cornell_Box", 400, 200, 16, 32)
    ns = PathTracer(ns_scene, "cuda")
    _sweep_base("north star", ns, pose, SEED, base_libs, args.reps)
    split = SampleSplit(ns_scene, "cuda", 3)
    _sweep_base("north star sp 3 share 2", split.tracer, pose,
                split.seed(SEED, 0), base_libs, args.reps,
                base_q=split.share(0))
    # The table sizes where the dispatch decides, at the bench's array
    # shapes, unchunked (stress:256 is the bench's stress256, lights:16
    # its manylights; stress:1024 and icosphere:3 under --accel baked).
    for name, accel in (("Cornell_Box", "auto"), ("demo", "auto"),
                        ("stress:32", "auto"), ("lights:16", "auto"),
                        ("stress:64", "auto"), ("stress:128", "auto"),
                        ("stress:256", "auto"), ("stress:1024", "baked"),
                        ("icosphere:3", "baked")):
        tr = PathTracer(scene(name, 200, 100, 8, 6), "cuda", accel=accel)
        _sweep_base(f"{name} {accel}", tr, pose, SEED, base_libs, args.reps)
    grid_libs = {**libs, **narrow_libs, **refill_libs}
    for label, name, size in (
            ("stress1024 grid", "stress:1024", (200, 100, 8, 6)),
            ("mesh1280 grid", "icosphere:3", (200, 100, 8, 6)),
            ("north star grid", "Cornell_Box", (400, 200, 16, 32))):
        tr = PathTracer(scene(name, *size), "cuda", accel="grid")
        _sweep_base(label, tr, pose, SEED, grid_libs, args.reps)
    if args.only == "base":
        return 0
    _sweep_extra("north star", ns, pose, SEED, libs, args.reps)
    for label, name in (("stress1024", "stress:1024"),
                        ("mesh1280", "icosphere:3")):
        tr = PathTracer(scene(name, 200, 100, 8, 6), "cuda")
        _sweep_chunked(label, tr, pose, SEED, libs, args.reps)
        _sweep_extra(label, tr, pose, SEED, libs, args.reps)
    fog = Fog(density=0.15)
    for label, tr in (
            ("fog", PathTracer(scene("Cornell_Box", 400, 200, 16, 32,
                                     fog=fog), "cuda")),
            ("stress1024 fog mis", PathTracer(
                scene("stress:1024", 200, 100, 8, 6, fog=fog), "cuda",
                transport="mis"))):
        _sweep_extra(label, tr, pose, SEED, libs, args.reps)
    tr = PathTracer(scene("stress:1024", 200, 100, 8, 6), "cuda",
                    accel="grid")
    _sweep_extra("stress1024 grid", tr, pose, SEED, {**libs, **narrow_libs},
                 args.reps)
    return 0


if __name__ == "__main__":
    main()
