"""The grouped kernels A and B over the culled sweep of `--accel grid` for
tables over the shared-memory budget: csrc/group.cuh GroupCulledSpill,
which stages the group table first, then the blocked scene's rows, as far
as they fit a stage cap, and reads the rest through L1.

On the CPU: ops/kernels.py culled_stage, the host's mirror of the
device's staged split (a hypothesis property: the table staged first,
every group and row staged or read through L1 exactly once, the stage's
layout within the cap, the greedy fill), the plan at the mesh5120 and
icosphere:5 grid tables (mesh5120's whole sweep staged at the 227 KB
opt-in limit), the dispatch (an over-budget grid tracer now takes both
GroupCulledSpill forms through base_kernel and extra_kernel; Cornell_Box
under grid keeps kernel A's thread per pixel; the chunked grid kernel A
takes its grouped entry, over the budget its GroupCulledSpill form),
followed on the CPU by standing in for the launch, the new
wrappers' refusals, and their plain versions for CPU tensors.

The `cuda` tests hold both entries bit for bit against their plain
versions on the card, with the traversal counters equal and the
lane-iterations the plain model's: the render library's forms at
icosphere:4 through the wrappers, beside the thread-per-entry entries, and
libraries of csrc/group_tune.cu built at stage caps of 0 bytes (every
group and row read through L1), 200 bytes (the group table cut at
icosphere:1 and stress:64, the triangles at Cornell_Box) and 640 bytes
(the triangles cut at icosphere:1, the spheres at stress:64, the planes at
Cornell_Box); and the grid kernel A's thread per pixel, which serves
Cornell_Box under grid, held to its residency bound and unbound. They skip
here.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import build, kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 42
GROUP_W = 10  # words of a group table row (ops/accel.py GROUP_W)
# The stage caps of the split-point libraries (K = 16, both designs' wide
# one, 128 lanes a block).
SPLIT_CAPS = (0, 200, 640)
SPLIT_SCENES = ("Cornell_Box", "icosphere:1", "stress:64")


def _scene(name, **over):
    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    return load_scene(name).with_overrides(**{**size, **over})


def _grid(name, **kw):
    return PathTracer(_scene(name), "cpu", accel="grid", **kw)


# ------------------------------------------------------------ staged split


@settings(max_examples=400, deadline=None, database=None)
@given(n_groups=st.integers(0, 6000), n_sph=st.integers(0, 5000),
       n_pln=st.integers(0, 200), n_tri=st.integers(0, 30000),
       cap=st.integers(0, kernels.GROUP_SMEM_MAX))
def test_culled_stage_stages_the_table_first(n_groups, n_sph, n_pln, n_tri,
                                             cap):
    """The group table first, as many groups as fit, then group_stage's
    greedy fill of the rest of the cap with rows;
    every group and row lies in shared memory or is read through L1,
    exactly once; the stage's layout (the table, the triangles
    plane-major, the spheres, the planes) within the cap."""
    g, t, s, p = kernels.culled_stage(n_groups, n_sph, n_pln, n_tri, cap)
    words = cap // 4
    assert g == min(n_groups, words // GROUP_W)
    if g < n_groups:  # a table cut short leaves no room for one more group
        assert words - GROUP_W * g < GROUP_W
    assert (t, s, p) == kernels.group_stage(n_sph, n_pln, n_tri,
                                            cap - 4 * GROUP_W * g)
    for staged, n in ((g, n_groups), (t, n_tri), (s, n_sph), (p, n_pln)):
        assert 0 <= staged <= n
    # Each group and row by its source: shared memory below its kind's
    # staged count (at its word offsets in the stage), else L1.
    smem = {}
    for kind, n, staged, width, base, plane in (
            ("group", n_groups, g, GROUP_W, 0, False),
            ("tri", n_tri, t, kernels.TRI_SWEEP_W, GROUP_W * g, True),
            ("sph", n_sph, s, 5, GROUP_W * g + 9 * t, False),
            ("pln", n_pln, p, 9, GROUP_W * g + 9 * t + 5 * s, False)):
        for i in {0, staged - 1, staged, n - 1}:
            if 0 <= i < staged:
                offs = [base + (w * staged + i if plane else width * i + w)
                        for w in range(width)]
                assert max(offs) < words
                for o in offs:
                    assert smem.setdefault(o, (kind, i)) == (kind, i)
    assert kernels.culled_stage_bytes((g, t, s, p)) <= cap
    assert kernels.culled_stage_bytes((g, t, s, p)) == 4 * (
        GROUP_W * g + 9 * t + 5 * s + 9 * p)


@pytest.mark.parametrize("name, cap, counts, want, n_bytes", [
    # mesh5120: 642 groups (640 of 8 triangles, the light's sphere block,
    # the floor), 25,680 B of table; the whole sweep in 210,196 B.
    ("icosphere:4", kernels.GROUP_SMEM_MAX, (642, 8, 1, 5120),
     (642, 5120, 8, 1), 210196),
    ("icosphere:4", kernels.GROUP_SMEM_BYTES, (642, 8, 1, 5120),
     (642, 2017, 0, 0), 98292),
    # icosphere:5: 2,562 groups, 102,480 B of table; 3,610 of 20,480
    # triangles fit the rest.
    ("icosphere:5", kernels.GROUP_SMEM_MAX, (2562, 8, 1, 20480),
     (2562, 3610, 0, 0), 232440),
    ("Cornell_Box", 200, (3, 8, 6, 8), (3, 2, 0, 0), 192),
    ("Cornell_Box", 640, (3, 8, 6, 8), (3, 8, 8, 2), 640),
    ("icosphere:1", 200, (12, 8, 1, 80), (5, 0, 0, 0), 200),
    ("icosphere:1", 640, (12, 8, 1, 80), (12, 4, 0, 0), 624),
    ("stress:64", 640, (9, 64, 1, 0), (9, 0, 14, 0), 640),
    ("stress:64", 0, (9, 64, 1, 0), (0, 0, 0, 0), 0)])
def test_culled_stage_of_the_grid_tables(name, cap, counts, want, n_bytes):
    """What the grid scenes stage at the 227 KB opt-in limit and at the
    96 KB budget, and the split points of the small-cap libraries."""
    tr = _grid(name)
    assert kernels.grid_counts(tr) == counts
    assert kernels.group_smem_bytes(tr) == 4 * (
        GROUP_W * counts[0] + 5 * counts[1] + 9 * counts[2]
        + 12 * counts[3])
    staged = kernels.culled_stage(*counts, cap)
    assert staged == want
    assert kernels.culled_stage_bytes(staged) == n_bytes


# ---------------------------------------------------------------- dispatch


@pytest.fixture
def recorded(monkeypatch):
    """The launches the wrappers would make on the card, recorded instead:
    _on_cuda says yes, and _launch_base / _launch_extra / _launch_chunked
    note their `kind` and return the plain version's outputs."""
    kinds = []
    monkeypatch.setattr(kernels, "_on_cuda", lambda device, name: True)

    def base(tracer, pose, seed, frame_number, y0, h_out, base_q, kind,
             lib=None):
        kinds.append(kind)
        return kernels.base_kernel_plain(tracer, pose, seed, frame_number,
                                         y0, h_out, base_q)

    def extra(tracer, pose, xs, ys, state, add, samp0, kind, lib=None):
        kinds.append(kind)
        return kernels.extra_kernel_plain(tracer, pose, xs, ys, state, add,
                                          samp0)

    def chunked(tracer, pose, seed, frame_number, y0, h_out, kind, lib=None):
        kinds.append(kind)
        return kernels.base_kernel_chunked_plain(tracer, pose, seed,
                                                 frame_number, y0, h_out)

    monkeypatch.setattr(kernels, "_launch_base", base)
    monkeypatch.setattr(kernels, "_launch_extra", extra)
    monkeypatch.setattr(kernels, "_launch_chunked", chunked)
    return kinds


def _stream(tr, budget=2.0):
    x, y = tr.pixel_grid()
    s = kernels.sorted_stream(tr, tr.seed_lanes(x, y, SEED, 0),
                              torch.full((tr.height, tr.width), budget))
    return s.xs, s.ys, s.state, s.add, s.samp0


def _launches(*wrappers):
    return [w.launches for w in wrappers]


GRID_A = (kernels.base_kernel_grid, kernels.base_kernel_grid_grouped,
          kernels.base_kernel_grid_grouped_spill)
GRID_B = (kernels.extra_kernel_grid, kernels.extra_kernel_grid_grouped,
          kernels.extra_kernel_grid_grouped_spill)


@pytest.mark.parametrize("name", ["icosphere:4", "icosphere:5"])
def test_over_budget_grid_takes_both_spill_forms(name, recorded):
    """An over-budget grid tracer goes base_kernel -> base_kernel_grid ->
    base_kernel_grid_grouped -> base_kernel_grid_grouped_spill and
    extra_kernel -> extra_kernel_grid_grouped ->
    extra_kernel_grid_grouped_spill; only the spill forms count a
    launch."""
    tr = _grid(name)
    assert kernels._over_budget(tr)
    assert kernels.takes_grouped(tr) and kernels.takes_grouped(tr, "base")
    assert kernels.takes_grouped(tr, "chunked")
    assert kernels.SPILL_EXTRA["grid"] is kernels.extra_kernel_grid_grouped_spill
    a0, b0 = _launches(*GRID_A), _launches(*GRID_B)
    out = kernels.base_kernel(tr, POSE, SEED, 0, 0, 2)
    assert float(out.rays.sum()) > 0
    kernels.extra_kernel(tr, POSE, *(v[:1] for v in _stream(tr)))
    assert recorded == ["grid_grouped_spill", "grid_grouped_spill"]
    assert _launches(*GRID_A) == [a0[0], a0[1], a0[2] + 1]
    assert _launches(*GRID_B) == [b0[0], b0[1], b0[2] + 1]


@pytest.mark.parametrize("name, base_kind, extra_kind", [
    ("Cornell_Box", "grid", "grid_grouped"),
    ("stress:96:3", "grid_grouped", "grid_grouped"),
    ("icosphere:2", "grid_grouped", "grid_grouped")])
def test_grid_within_the_budget_keeps_its_entries(name, base_kind,
                                                  extra_kind, recorded):
    """Within the budget the grid kernels keep GroupCulled (kernel A from
    GROUP_BASE_MIN_PRIMS primitives on; Cornell_Box's 11 keep the thread
    per pixel)."""
    tr = _grid(name)
    assert not kernels._over_budget(tr)
    assert kernels.takes_grouped(tr, "base") is (base_kind != "grid")
    kernels.base_kernel(tr, POSE, SEED, 0)
    kernels.extra_kernel(tr, POSE, *_stream(tr))
    assert recorded == [base_kind, extra_kind]


@pytest.mark.parametrize("name", ["stress:96:3", "icosphere:4"])
def test_grid_chunked_kernel_a_is_unchanged(name, recorded):
    """`--accel grid` with an explicit chunk_base takes the chunked grid
    kernel A's grouped entry within the budget and its GroupCulledSpill
    form over it; the thread per entry counts no launch."""
    tr = _grid(name, chunk_base=2)
    assert tr.chunk_base == 2 and kernels.takes_grouped(tr, "chunked")
    spill = "_spill" if kernels._over_budget(tr) else ""
    assert bool(spill) is (name == "icosphere:4")
    wrapper = getattr(kernels, f"base_kernel_chunked_grid_grouped{spill}")
    n0 = (kernels.base_kernel_chunked_grid.launches, wrapper.launches)
    kernels.base_kernel_chunked(tr, POSE, SEED, 0, 0, 2)
    assert recorded == [f"grid_grouped{spill}"]
    assert (kernels.base_kernel_chunked_grid.launches,
            wrapper.launches) == (n0[0], n0[1] + 1)


def test_spill_wrappers_refuse_other_instantiations():
    """The GroupCulledSpill wrappers take `--accel grid` tracers alone, and
    kernel A's refuses a chunk split, as base_kernel_grid_grouped does."""
    others = (PathTracer(_scene("icosphere:4"), "cpu", accel="baked"),
              PathTracer(_scene("stress:64", fog=Fog(density=0.15)), "cpu"),
              PathTracer(_scene("showcase"), "cpu"),
              PathTracer(_scene("stress:96"), "cpu", accel="gathered"))
    for tr in others:
        with pytest.raises(ValueError, match="instantiation"):
            kernels.extra_kernel_grid_grouped_spill(tr, POSE, *_stream(tr))
        with pytest.raises(ValueError, match="instantiation"):
            kernels.base_kernel_grid_grouped_spill(tr, POSE, SEED, 0)
    with pytest.raises(ValueError, match="chunks"):
        kernels.base_kernel_grid_grouped_spill(_grid("stress:96",
                                                     chunk_base=2),
                                               POSE, SEED, 0)


@pytest.mark.parametrize("name", ["stress:48:3", "icosphere:1"])
def test_spill_wrappers_take_the_plain_versions_on_the_cpu(name):
    """For CPU tensors both wrappers return their plain versions' outputs
    (within the budget too: they serve any size) and count no launch."""
    tr = _grid(name)
    a0, b0 = _launches(*GRID_A), _launches(*GRID_B)
    got = kernels.base_kernel_grid_grouped_spill(tr, POSE, SEED, 0, 2, 4,
                                                 base_q=3)
    want = kernels.base_kernel_plain(tr, POSE, SEED, 0, 2, 4, base_q=3)
    for a, b in zip((*got.csum, *got.csumsq, got.rays, got.var, got.state),
                    (*want.csum, *want.csumsq, want.rays, want.var,
                     want.state)):
        assert torch.equal(a, b)
    assert float(got.rays.sum()) > 0
    args = (tr, POSE, *_stream(tr))
    got, want = (kernels.extra_kernel_grid_grouped_spill(*args),
                 kernels.extra_kernel_plain(*args))
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert float(got[1].sum()) > 0
    assert (_launches(*GRID_A), _launches(*GRID_B)) == (a0, b0)


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_tracer(device, name):
    scene = load_scene(name).with_overrides(width=64, height=16,
                                            samples_per_pixel=16, max_depth=8)
    return PathTracer(scene, device, accel="grid")


def _counted(tr, fn):
    """fn() and the kernels' traversal counters of its launch."""
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


def _plain(tr, fn):
    """The plain version fn() and its traversal counters."""
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    try:
        out = fn()
        return out, tr.prims.stats.long().cpu()
    finally:
        tr.prims.ops = None


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _held_a(tr, lib=None):
    """Kernel A's GroupCulledSpill form (from `lib`, else through
    base_kernel) and the thread per pixel against the plain version, bit
    for bit, with equal counters; the lane-iterations the plain model's
    (refill: at least the pixels' sum)."""
    if lib is None:
        n0 = kernels.base_kernel_grid_grouped_spill.launches
        g, gc = _counted(tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0))
        assert kernels.base_kernel_grid_grouped_spill.launches == n0 + 1
    else:
        g, gc = _counted(tr, lambda: kernels._launch_base(
            tr, POSE, SEED, 0, 0, None, None, "grid_grouped_spill", lib))
    t, tc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, "grid"))
    p, pc = _plain(tr, lambda: kernels.base_kernel_plain(tr, POSE, SEED, 0))
    for got in (g, t):
        for a, b in zip((*got.csum, *got.csumsq, got.rays, got.var,
                         got.additional, got.state),
                        (*p.csum, *p.csumsq, p.rays, p.var, p.additional,
                         p.state)):
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(gc, pc) and torch.equal(tc, pc)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0)
    assert float(t.iters) == float(kernels.warp_iters(it, 1))
    if kernels.group_refill("base_grid_spill", lib):
        assert float(g.iters) >= float(it.sum())
    else:
        assert float(g.iters) == float(kernels.warp_iters(
            it, kernels.group_k("base_grid_spill", lib)))
    return p


def _held_b(tr, a, lib=None):
    """Kernel B's GroupCulledSpill form (from `lib`, else through
    extra_kernel) and the thread per entry on the stream of kernel A's
    output `a`, against the plain version bit for bit with equal
    counters; the lane-iterations the plain model's."""
    s = kernels.sorted_stream(tr, a.state, a.additional)
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    assert int((s.add > 0).sum()) > 0
    if lib is None:
        n0 = kernels.extra_kernel_grid_grouped_spill.launches
        g, gc = _counted(tr, lambda: kernels.extra_kernel(*args))
        assert kernels.extra_kernel_grid_grouped_spill.launches == n0 + 1
    else:
        g, gc = _counted(tr, lambda: kernels._launch_extra(
            *args, "grid_grouped_spill", lib))
    t, tc = _counted(tr, lambda: kernels._launch_extra(*args, "grid"))
    p, pc = _plain(tr, lambda: kernels.extra_kernel_plain(*args))
    for got in (g, t):
        for x, y in zip((*got[0], got[1]), (*p[0], p[1])):
            assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(gc, pc) and torch.equal(tc, pc)
    it = kernels.extra_entry_iters(*args)
    assert float(g[2]) == float(kernels.warp_iters(
        it, kernels.group_k("extra_grid_spill", lib)))
    assert float(t[2]) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
def test_spill_entries_match_plain_versions_over_the_budget(cuda_device):
    """icosphere:4 at 64x16 under grid (271,636 B over the budget, all of
    it within the 227 KB stage) through the wrappers."""
    tr = _card_tracer(cuda_device, "icosphere:4")
    assert kernels._over_budget(tr)
    assert kernels.group_cap("extra_grid_spill") <= kernels.GROUP_SMEM_MAX
    a = _held_a(tr)
    _held_b(tr, a)


@pytest.fixture(scope="module")
def split_libs():
    """The group_tune.cu libraries at the SPLIT_CAPS stage caps (K = 16,
    the wide design, 128 lanes a block, kernel A static), built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    srcs = {cap: (build.TUNE_SOURCE, ("TRT_TUNE_K=16", "TRT_TUNE_THREADS=128",
                                      f"TRT_TUNE_STAGE_CAP={cap}"))
            for cap in SPLIT_CAPS}
    build.library_paths(tuple(srcs.values()))
    return {cap: build.load_kernels((src,)) for cap, src in srcs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cap", SPLIT_CAPS)
@pytest.mark.parametrize("name", SPLIT_SCENES)
def test_every_split_point_matches_plain_versions(cuda_device, split_libs,
                                                  name, cap):
    lib = split_libs[cap]
    assert kernels.group_cap("extra_grid_spill", lib) == cap
    assert not kernels.group_refill("base_grid_spill", lib)
    tr = _card_tracer(cuda_device, name)
    a = _held_a(tr, lib)
    _held_b(tr, a, lib)


@pytest.mark.cuda
def test_grid_kernel_a_bound_and_unbound_match_plain_version(cuda_device):
    """Cornell_Box under grid (11 primitives: the thread per pixel) through
    base_kernel, held to its residency bound, and unbound (csrc/
    group_tune.cu at its defaults): each against the plain version bit
    for bit with its counters, its lane-iterations the plain model's at
    K = 1."""
    tr = _card_tracer(cuda_device, "Cornell_Box")
    assert not kernels.takes_grouped(tr, "base")
    assert kernels.load_kernels().trt_kernel_base_grid_min_blocks() > 0
    unbound = build.load_kernels(((build.TUNE_SOURCE, (
        "TRT_TUNE_K=1", "TRT_TUNE_MIN_BLOCKS=0")),))
    assert unbound.trt_kernel_base_grid_min_blocks() == 0
    n0 = kernels.base_kernel_grid.launches
    k, kc = _counted(tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0))
    assert kernels.base_kernel_grid.launches == n0 + 1
    u, uc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, "grid", unbound))
    p, pc = _plain(tr, lambda: kernels.base_kernel_plain(tr, POSE, SEED, 0))
    it = kernels.base_entry_iters(tr, POSE, SEED, 0)
    for got, counts in ((k, kc), (u, uc)):
        for a, b in zip((*got.csum, *got.csumsq, got.rays, got.var,
                         got.additional, got.state),
                        (*p.csum, *p.csumsq, p.rays, p.var, p.additional,
                         p.state)):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(counts, pc)
        assert float(got.iters) == float(kernels.warp_iters(it, 1))
