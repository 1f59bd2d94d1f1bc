"""The grouped kernel B and chunked kernel A (reference and XT gates) for
tables of any size: csrc/group.cuh GroupSpill, which stages the rows that
fit a stage cap and reads the rest through L1.

On the CPU: ops/kernels.py group_stage, the host's mirror of the device's
staged split (a hypothesis property: every row staged or spilled exactly
once, the staged bytes within the cap, the counts the greedy formula's),
the C entry points' arities against the loader's, the dispatch (icosphere:4,
240 KB of rows, now takes the grouped entries of kernel B and the chunked
kernel A, plain and in fog, which pass it on to their GroupSpill forms;
kernel A at the reference gates keeps refusing it, and the grid kernels
pass it on to their GroupCulledSpill forms, tests/
test_torch_group_culled_spill.py) and the sorted frame at
icosphere:4, and in fog under --mis at Cornell_Box (the chunked XT kernel
A within the budget), through those wrappers (their plain versions here)
against the JAX oracle: rays and samples exact, radiance within rtol 1e-4
/ atol 1e-5 but for the knife-edge pixels of tests/test_torch_scale.py
(the sphere light's NEE self-shadow; in fog also an ulp of XLA-CPU's
transcendentals moving a direction, tests/test_torch_medium.py).

The `cuda` tests hold the GroupSpill entries bit for bit against their
plain versions and the thread-per-entry entries on the card, with their
lane-iterations equal to the plain model at their group width: the
render libraries' entries at icosphere:4 (and the chunked XT kernel A's
grouped entry in fog at Cornell_Box and under --mis at stress:64, its
GroupSpill form at icosphere:4), and libraries of
csrc/group_tune.cu built with a stage cap of 0 bytes (every row read
through L1) and of 168 bytes (Cornell_Box: triangles and spheres staged,
planes split; icosphere:1: triangles split; stress:64: spheres split).
They skip here.
"""

import dataclasses
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import build, kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 42
RTOL, ATOL = 1e-4, 1e-5
# Knife-edge bounds of the frames against the JAX oracle: (pixels off,
# their summed error), as each test's seed shows on the CPU: none.
KNIFE = {"icosphere:4": (0, 0.0), "icosphere:4 fog": (0, 0.0),
         "cornell fog mis": (0, 0.0)}
# The stage caps of the split-point libraries: nothing staged, and 168
# bytes = 42 floats (2 triangles, 3 spheres, 1 plane of Cornell_Box).
SPLIT_CAPS = (0, 168)


def _scene(name, **over):
    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    return load_scene(name).with_overrides(**{**size, **over})


# ------------------------------------------------------------ staged split


@settings(max_examples=400, deadline=None, database=None)
@given(n_sph=st.integers(0, 5000), n_pln=st.integers(0, 5000),
       n_tri=st.integers(0, 30000),
       cap=st.integers(0, kernels.GROUP_SMEM_MAX))
def test_group_stage_splits_every_row_once(n_sph, n_pln, n_tri, cap):
    """Each kind's rows are staged or spilled exactly once, the staged rows
    fit the cap, and the counts are the greedy fill in the order
    triangles (9 words), spheres (5), planes (9)."""
    t, s, p = kernels.group_stage(n_sph, n_pln, n_tri, cap)
    for staged, n in ((t, n_tri), (s, n_sph), (p, n_pln)):
        assert 0 <= staged <= n
        assert staged + (n - staged) == n
    assert kernels.stage_bytes((t, s, p)) <= cap
    left = cap // 4
    assert t == min(n_tri, left // 9)
    left -= 9 * t
    assert s == min(n_sph, left // 5)
    left -= 5 * s
    assert p == min(n_pln, left // 9)
    # Greedy: a kind cut short leaves no room for one more of its rows.
    words = cap // 4 - 9 * t - 5 * s - 9 * p
    for staged, n, w in ((t, n_tri, 9), (s, n_sph, 5), (p, n_pln, 9)):
        assert staged == n or words < w


@pytest.mark.parametrize("name, cap, want", [
    ("icosphere:4", kernels.GROUP_SMEM_MAX, (5120, 1, 1)),
    ("icosphere:4", kernels.GROUP_SMEM_BYTES, (2730, 1, 0)),
    ("icosphere:5", kernels.GROUP_SMEM_MAX, (6456, 1, 0)),
    ("Cornell_Box", 168, (2, 3, 1)),
    ("icosphere:1", 168, (4, 1, 0)),
    ("stress:64", 168, (0, 8, 0)),
    ("Cornell_Box", 0, (0, 0, 0))])
def test_group_stage_of_the_scenes(name, cap, want):
    """What the over-budget scenes stage at the 227 KB opt-in limit and at
    the 96 KB budget, and the split points of the small-cap libraries."""
    n_sph, n_pln, n_tri, _ = PathTracer(_scene(name), "cpu").tables.counts
    assert kernels.group_stage(n_sph, n_pln, n_tri, cap) == want


@pytest.mark.parametrize("src", build.RENDER_SOURCES + (build.TUNE_SOURCE,))
def test_entry_points_take_the_pointers_the_loader_declares(src):
    """Every C entry point that ops/build.py loads from `src` is defined
    there with as many parameters as it declares (ctypes passes each as a
    pointer), and `src` defines no other: the GroupSpill entries take the
    arguments of the grouped entries they extend, and nothing else."""
    text = (build.CSRC / src).read_text()
    defined = {m.group(1): [p for p in m.group(2).split(",") if p.strip()]
               for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
    entries = (build.TUNE_ENTRY_POINTS if src == build.TUNE_SOURCE
               else build.ENTRY_POINTS[src])
    assert set(defined) == {name for name, _ in entries}
    for name, n_ptr in entries:
        assert len(defined[name]) == n_ptr, name
        assert all("*" in p for p in defined[name]), name


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("name, fog, accel_, extra, chunked", [
    ("icosphere:4", False, "auto", True, True),
    ("icosphere:5", False, "auto", True, True),
    ("icosphere:4", True, "auto", True, True),
    ("icosphere:4", False, "grid", True, True),
    ("icosphere:3", False, "auto", True, True),
    ("stress:64", True, "auto", True, True),
    ("icosphere:4", "checker", "auto", True, True),
    ("icosphere:4", False, "gathered", True, True)])
def test_grouped_entries_serve_tables_of_any_size(name, fog, accel_, extra,
                                                  chunked):
    """Kernel B and the chunked kernel A at the reference, XT and EXT gates
    (`fog` "checker": a checker floor, the EXT instantiation) take their
    grouped entries whatever the table's size, and so do kernels B, A and
    the chunked A over the grid walk (which stages no rows) and over the
    culled sweep (over the budget the latter pass the tracer on to their
    GroupCulledSpill forms); kernel A at the reference and EXT gates above
    the budget takes the thread per pixel."""
    over = {"fog": Fog(density=0.15)} if fog is True else {}
    scene = _scene(name, **over)
    if fog == "checker":
        floor = scene.planes[0]
        mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                      checker_scale=1.0)
        scene = dataclasses.replace(
            scene, planes=(floor._replace(material=mat),))
    tr = PathTracer(scene, "cpu", accel=accel_)
    assert (kernels._kind(tr) == "ext") is (fog == "checker")
    assert kernels.takes_grouped(tr) is extra
    assert kernels.takes_grouped(tr, "chunked") is chunked
    over_budget = kernels.group_smem_bytes(tr) > kernels.GROUP_SMEM_BYTES
    assert over_budget is (name in ("icosphere:4", "icosphere:5"))
    assert kernels.takes_grouped(tr, "base") is (
        not over_budget and kernels._kind(tr) == "ref"
        or accel_ in ("grid", "gathered"))


def _stream(tr, budget=2.0):
    x, y = tr.pixel_grid()
    s = kernels.sorted_stream(tr, tr.seed_lanes(x, y, SEED, 0),
                              torch.full((tr.height, tr.width), budget))
    return s.xs, s.ys, s.state, s.add, s.samp0


def test_spill_wrappers_refuse_other_instantiations():
    big = PathTracer(_scene("icosphere:4"), "cpu")
    xt_big = PathTracer(_scene("icosphere:4", fog=Fog(density=0.15)), "cpu")
    grid_big = PathTracer(_scene("icosphere:4"), "cpu", accel="grid")
    ext = PathTracer(_scene("showcase"), "cpu")
    for fn, trs in ((kernels.extra_kernel_grouped_spill,
                     (xt_big, grid_big, ext)),
                    (kernels.extra_kernel_xt_grouped_spill,
                     (big, grid_big, ext))):
        for tr in trs:
            with pytest.raises(ValueError, match="instantiation"):
                fn(tr, POSE, *_stream(tr))
    for tr in (xt_big, grid_big, ext):
        with pytest.raises(ValueError, match="instantiation"):
            kernels.base_kernel_chunked_grouped_spill(tr, POSE, SEED, 0)
    # Still refused over the budget: the grouped kernel A at the reference
    # gates. Grid B serves it (its GroupCulledSpill form), and that form
    # refuses the table sweep.
    with pytest.raises(ValueError, match="shared memory"):
        kernels.base_kernel_grouped(big, POSE, SEED, 0)
    with pytest.raises(ValueError, match="instantiation"):
        kernels.extra_kernel_grid_grouped_spill(big, POSE, *_stream(big))


@pytest.mark.parametrize("fn, fog", [
    (kernels.extra_kernel_grouped_spill, False),
    (kernels.extra_kernel_xt_grouped_spill, True),
    (kernels.extra_kernel_grouped, False),
    (kernels.extra_kernel_xt_grouped, True)])
def test_spill_wrappers_take_the_plain_versions_on_the_cpu(fn, fog):
    over = {"fog": Fog(density=0.15)} if fog else {}
    tr = PathTracer(_scene("icosphere:2", **over), "cpu")
    counts = (fn.launches, kernels.extra_kernel_grouped_spill.launches,
              kernels.extra_kernel_xt_grouped_spill.launches)
    args = (tr, POSE, *_stream(tr))
    got, want = fn(*args), kernels.extra_kernel_plain(*args)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert float(got[1].sum()) > 0
    assert (fn.launches, kernels.extra_kernel_grouped_spill.launches,
            kernels.extra_kernel_xt_grouped_spill.launches) == counts


@pytest.mark.parametrize("fn", [kernels.base_kernel_chunked_xt_grouped,
                                kernels.base_kernel_chunked_xt_grouped_spill])
def test_chunked_xt_wrappers_refuse_other_instantiations(fn):
    """The chunked XT kernel A's grouped wrappers take XT tracers over the
    table sweep alone: not the reference gates, EXT, or an XT tracer under
    `--accel grid`, within or over the budget."""
    fog = Fog(density=0.15)
    for tr in (PathTracer(_scene("icosphere:4"), "cpu"),
               PathTracer(_scene("stress:64"), "cpu"),
               PathTracer(_scene("showcase"), "cpu"),
               PathTracer(_scene("icosphere:4", fog=fog), "cpu",
                          accel="grid"),
               PathTracer(_scene("stress:64", fog=fog), "cpu",
                          accel="grid")):
        with pytest.raises(ValueError, match="instantiation"):
            fn(tr, POSE, SEED, 0)


@pytest.mark.parametrize("fn", [kernels.base_kernel_chunked,
                                kernels.base_kernel_chunked_xt,
                                kernels.base_kernel_chunked_xt_grouped,
                                kernels.base_kernel_chunked_xt_grouped_spill])
def test_chunked_xt_wrappers_take_the_plain_version_on_the_cpu(fn):
    """On the CPU every wrapper of the chunked XT kernel A, from the
    dispatch down to the GroupSpill form, returns the plain version's
    outputs and counts no launch."""
    tr = PathTracer(_scene("icosphere:2", fog=Fog(density=0.15)), "cpu",
                    transport="mis", chunk_base=2)
    assert kernels.takes_grouped(tr, "chunked")
    wrappers = (kernels.base_kernel_chunked, kernels.base_kernel_chunked_xt,
                kernels.base_kernel_chunked_xt_grouped,
                kernels.base_kernel_chunked_xt_grouped_spill)
    counts = [w.launches for w in wrappers]
    got = fn(tr, POSE, SEED, 0)
    want = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    for a, b in zip((*got.csum, *got.csumsq, got.rays, got.state),
                    (*want.csum, *want.csumsq, want.rays, want.state)):
        assert torch.equal(a, b)
    assert float(got.rays.sum()) > 0
    assert [w.launches for w in wrappers] == counts


def test_chunked_spill_wrapper_takes_the_plain_version_on_the_cpu():
    tr = PathTracer(_scene("icosphere:2"), "cpu", chunk_base=2)
    n0 = kernels.base_kernel_chunked_grouped_spill.launches
    got = kernels.base_kernel_chunked_grouped_spill(tr, POSE, SEED, 0)
    want = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    for a, b in zip((*got.csum, got.rays, got.state),
                    (*want.csum, want.rays, want.state)):
        assert torch.equal(a, b)
    assert kernels.base_kernel_chunked_grouped_spill.launches == n0


# ------------------------------------------------ the frame over the budget


@pytest.mark.parametrize("fog", [False, True])
def test_over_budget_frame_matches_jax_oracle(fog):
    """The sorted frame at icosphere:4 (16x8, 8 spp, depth 3: chunks of 2,
    three pixels with an extra budget), through base_kernel_chunked and
    extra_kernel as the card dispatches them (the grouped wrappers, their
    plain versions here), against the JAX package's render_frame: rays and
    samples exact, radiance within the tolerance but for knife edges."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.models.scene import Fog as JFog
    from terminal_raytracer_tpu.ops import tracer as jtracer

    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    jscene = jload("icosphere:4").with_overrides(
        **size, **({"fog": JFog(density=0.15)} if fog else {}))
    jt = jtracer.PathTracer(jscene)
    jcur, _jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(SEED), np.int32(0)))
    over = {"fog": Fog(density=0.15)} if fog else {}
    tr = PathTracer(_scene("icosphere:4", **over), "cpu")
    assert kernels.takes_grouped(tr)
    assert kernels.takes_grouped(tr, "chunked")
    assert (tr.chunk_base, tr.chunk_extra) == (jt.chunk_base, jt.chunk_extra)
    cur, _var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    assert (jtot > tr.base_samples).any()
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(
                                   KNIFE["icosphere:4" + (" fog" if fog
                                                          else "")])


def test_xt_chunked_frame_within_the_budget_matches_jax_oracle():
    """The sorted frame at Cornell_Box in fog under --mis with chunks of 2
    (16x8, 8 spp, depth 3), through base_kernel_chunked_xt_grouped and
    extra_kernel_xt_grouped as the card dispatches them (their plain
    versions here), against the JAX package's render_frame with the same
    chunks: rays and samples exact, radiance within the tolerance but for
    knife edges."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.models.scene import Fog as JFog
    from terminal_raytracer_tpu.ops import tracer as jtracer

    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    jt = jtracer.PathTracer(jload("Cornell_Box").with_overrides(
        **size, fog=JFog(density=0.15)), transport="mis", chunk_base=2,
        chunk_extra=2)
    jcur, _jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(SEED), np.int32(0)))
    tr = PathTracer(_scene("Cornell_Box", fog=Fog(density=0.15)), "cpu",
                    transport="mis", chunk_base=2, chunk_extra=2)
    assert kernels.takes_grouped(tr, "chunked") and kernels.takes_grouped(tr)
    assert not kernels._over_budget(tr)
    cur, _var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(KNIFE["cornell fog mis"])


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_scene(name, **over):
    return load_scene(name).with_overrides(width=64, height=16,
                                           samples_per_pixel=16, max_depth=8,
                                           **over)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _held_b(tr, kind, lib=None):
    """Kernel B's GroupSpill form of `kind` ('grouped_spill' or
    'xt_grouped_spill', from `lib`, else through extra_kernel) and the
    thread-per-entry entry against the plain version, bit for bit, the
    counters the plain model's."""
    a = kernels.base_phase(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a[2], a[7])
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    assert int((s.add > 0).sum()) > 0
    if lib is None:
        wrapper = {"grouped_spill": kernels.extra_kernel_grouped_spill,
                   "xt_grouped_spill": kernels.extra_kernel_xt_grouped_spill
                   }[kind]
        n0 = wrapper.launches
        g = kernels.extra_kernel(*args)
        assert wrapper.launches == n0 + 1
    else:
        g = kernels._launch_extra(*args, kind, lib)
    th = kernels._launch_extra(*args, kernels._kind(tr))
    p = kernels.extra_kernel_plain(*args)
    it = kernels.extra_entry_iters(*args)
    for got in (g, th):
        for x, y in zip((*got[0], got[1]), (*p[0], p[1])):
            assert torch.equal(_bits(x), _bits(y))
    name = "extra_spill" if kind == "grouped_spill" else "extra_xt_spill"
    assert float(g[2]) == float(kernels.warp_iters(
        it, kernels.group_k(name, lib)))
    assert float(th[2]) == float(kernels.warp_iters(it, 1))


def _held_chunked(tr, lib=None):
    """The chunked kernel A's grouped entry of `tr`'s instantiation ('ref'
    or 'xt'): its GroupSpill form from `lib`, else the entry that
    base_kernel_chunked takes (GroupSpill over the budget, GroupSweep
    within it); and the thread-per-entry entry, each against the plain
    version bit for bit."""
    kind = kernels._kind(tr)
    spill = lib is not None or kernels._over_budget(tr)
    form = ("grouped" if kind == "ref" else "xt_grouped") + (
        "_spill" if spill else "")
    if lib is None:
        wrapper = getattr(kernels, f"base_kernel_chunked_{form}")
        n0 = wrapper.launches
        g = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
        assert wrapper.launches == n0 + 1
    else:
        g = kernels._launch_chunked(tr, POSE, SEED, 0, 0, None, form, lib)
    th = kernels._launch_chunked(tr, POSE, SEED, 0, 0, None, kind)
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0)
    for got in (g, th):
        for x, y in zip((*got.csum, *got.csumsq, got.rays, got.state),
                        (*p.csum, *p.csumsq, p.rays, p.state)):
            assert torch.equal(_bits(x), _bits(y))
    name = ("chunked" if kind == "ref" else "chunked_xt") + (
        "_spill" if spill else "")
    assert float(g.iters) == float(kernels.warp_iters(
        it, kernels.group_k(name, lib)))
    assert float(th.iters) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
def test_spill_entries_match_plain_versions_over_the_budget(cuda_device):
    """icosphere:4 at 64x16 through the wrappers: kernel B, chunked A (chunks
    of 2) and, in fog, the XT kernel B take their GroupSpill forms."""
    tr = PathTracer(_card_scene("icosphere:4"), cuda_device, chunk_base=2,
                    chunk_extra=2)
    assert 0 <= kernels.group_cap("extra_spill") <= kernels.GROUP_SMEM_MAX
    _held_chunked(tr)
    _held_b(tr, "grouped_spill")
    fog = PathTracer(_card_scene("icosphere:4", fog=Fog(density=0.15)),
                     cuda_device)
    _held_b(fog, "xt_grouped_spill")


@pytest.mark.cuda
@pytest.mark.parametrize("name, over, transport", [
    ("Cornell_Box", {}, "reference"), ("stress:64", {}, "mis"),
    ("icosphere:4", {}, "reference")])
def test_chunked_xt_entries_match_plain_versions(cuda_device, name, over,
                                                 transport):
    """The chunked XT kernel A in fog (chunks of 2) through the wrapper:
    its grouped entry at Cornell_Box and stress:64 (under --mis), its
    GroupSpill form at icosphere:4, beside the thread per entry."""
    tr = PathTracer(_card_scene(name, fog=Fog(density=0.15), **over),
                    cuda_device, transport=transport, chunk_base=2,
                    chunk_extra=2)
    assert kernels._over_budget(tr) is (name == "icosphere:4")
    _held_chunked(tr)


@pytest.fixture(scope="module")
def split_libs():
    """The group_tune.cu libraries at the SPLIT_CAPS stage caps (K = 8, 128
    lanes a block), built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    srcs = {cap: (build.TUNE_SOURCE, ("TRT_TUNE_K=8", "TRT_TUNE_THREADS=128",
                                      f"TRT_TUNE_STAGE_CAP={cap}"))
            for cap in SPLIT_CAPS}
    build.library_paths(tuple(srcs.values()))
    return {cap: build.load_kernels((src,)) for cap, src in srcs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cap", SPLIT_CAPS)
@pytest.mark.parametrize("name", ["Cornell_Box", "icosphere:1", "stress:64"])
def test_every_split_point_matches_plain_versions(cuda_device, split_libs,
                                                  name, cap):
    lib = split_libs[cap]
    assert kernels.group_cap("extra_spill", lib) == cap
    tr = PathTracer(_card_scene(name), cuda_device, chunk_base=2,
                    chunk_extra=2)
    _held_chunked(tr, lib)
    _held_b(tr, "grouped_spill", lib)
    fog = PathTracer(_card_scene(name, fog=Fog(density=0.15)), cuda_device,
                     transport="mis")
    _held_b(fog, "xt_grouped_spill", lib)
    _held_chunked(PathTracer(_card_scene(name, fog=Fog(density=0.15)),
                             cuda_device, transport="mis", chunk_base=2,
                             chunk_extra=2), lib)
