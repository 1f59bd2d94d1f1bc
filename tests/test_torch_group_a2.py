"""The grouped chunked kernel A at the EXT gates and the grouped kernel A
over the grid walk of `--accel gathered` (csrc/group.cuh): their dispatch,
the wrappers' refusals and plain versions on the CPU, a frame through each
new dispatch against the JAX oracle, and the gathered kernel A's iteration
model; the kernels on the card.

base_kernel_chunked_ext passes an EXT tracer on to
base_kernel_chunked_ext_grouped at every table size (over the 96 KB budget
on to its GroupSpill form, base_kernel_chunked_ext_grouped_spill);
base_kernel_gathered passes a gathered tracer of at least
GROUP_BASE_MIN_PRIMS primitives on to base_kernel_gathered_grouped, whose
walk reads its rows through L1 and so serves every table size. Here the
wrappers take their plain PyTorch versions (the tensors lie on the CPU).
Against the JAX oracle (its render_frame, as the card's dispatch renders
the frame): owed rays and samples exact, radiance within rtol 1e-4 / atol
1e-5 but for the knife edges of KNIFE (tests/test_torch_knife.py).

The `cuda` tests hold each new entry bit for bit against its plain version
on the card: the chunked EXT A on the whole image and a row block, its
GroupSpill form at every split cap of tests/test_torch_group_spill.py, the
gathered A on the whole image, a row block and a runtime quota with its
walk counters equal to the plain version's and the thread per pixel's, on
both schedules; lane-iterations the plain model's. They skip here; the
file imports the JAX package only inside its JAX tests.
"""

import dataclasses

import numpy as np
import pytest

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
SIZE = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
SPLIT_CAPS = (0, 168)  # tests/test_torch_group_spill.py
# Knife-edge bounds of the frames against the JAX oracle, by scene: (pixels
# off, their summed error), as the test's seed shows on the CPU.
KNIFE = {"stress:64 checker": (0, 0.0), "icosphere:1 gathered": (0, 0.0)}


def _scene(name, **over):
    return load_scene(name).with_overrides(**{**SIZE, **over})


def _checker(scene):
    """`scene` (of either package) with a checker floor: an extension scene
    (its first plane checkered, as chip_smoke.py's checker stress:1024)."""
    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


def _equal(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


# ----------------------------------------------------------------- dispatch


@pytest.mark.parametrize("name, spill", [("stress:64", False),
                                         ("icosphere:4", True)])
def test_chunked_ext_a_dispatch(name, spill):
    """The checker array scenes take the grouped chunked EXT kernel A, and
    the one whose rows exceed the budget its GroupSpill form; kernel B at
    the EXT gates stays grouped."""
    tr = PathTracer(_checker(_scene(name)), "cpu", chunk_base=2)
    assert kernels._kind(tr) == "ext" and tr.chunk_base == 2
    assert kernels.takes_grouped(tr, "chunked") and kernels.takes_grouped(tr)
    assert (kernels.GROUPED_CHUNKED["ext"]
            is kernels.base_kernel_chunked_ext_grouped)
    assert kernels._over_budget(tr) is spill
    assert "ext" in kernels.ANY_SIZE["chunked"]


@pytest.mark.parametrize("name, want", [
    ("stress:64", "base_kernel_gathered_grouped"),
    ("icosphere:1", "base_kernel_gathered_grouped"),
    ("icosphere:4", "base_kernel_gathered_grouped"),
    ("Cornell_Box", "base_kernel_gathered")])
def test_gathered_a_dispatch(name, want):
    """Kernel A over the walk takes its grouped entry at every table size
    from GROUP_BASE_MIN_PRIMS primitives on; Cornell_Box's 11 keep the
    thread per pixel. The chunked kernel A over the walk is grouped at
    every size and primitive count (tests/test_torch_group_walk_chunked.py)."""
    tr = PathTracer(_scene(name), "cpu", accel="gathered")
    assert tr.traversal == "gathered" and tr.chunk_base is None
    grouped = kernels.takes_grouped(tr, "base")
    assert grouped is (tr.scene.primitive_count
                       >= kernels.GROUP_BASE_MIN_PRIMS)
    got = (kernels.GROUPED_BASE["gathered"].__name__ if grouped
           else "base_kernel_gathered")
    assert got == want
    assert kernels.takes_grouped(tr, "chunked")


def test_new_wrappers_refuse_other_instantiations():
    ext = PathTracer(_scene("showcase"), "cpu", chunk_base=2)
    ref = PathTracer(_scene("Cornell_Box"), "cpu")
    gath = PathTracer(_scene("stress:64"), "cpu", accel="gathered")
    grid = PathTracer(_scene("stress:64"), "cpu", accel="grid")
    xt = PathTracer(_scene("Cornell_Box", fog=Fog(density=0.15)), "cpu")
    gath_chunked = PathTracer(_scene("stress:64"), "cpu", accel="gathered",
                              chunk_base=2)
    for fn, cases in ((kernels.base_kernel_chunked_ext_grouped,
                       ((ref, "instantiation"), (gath, "instantiation"),
                        (grid, "instantiation"), (xt, "instantiation"))),
                      (kernels.base_kernel_chunked_ext_grouped_spill,
                       ((ref, "instantiation"), (gath, "instantiation"),
                        (grid, "instantiation"), (xt, "instantiation"))),
                      (kernels.base_kernel_gathered_grouped,
                       ((ext, "instantiation"), (ref, "instantiation"),
                        (grid, "instantiation"), (xt, "instantiation"),
                        (gath_chunked, "chunks")))):
        for tr, match in cases:
            with pytest.raises(ValueError, match=match):
                fn(tr, POSE, SEED, 0)


@pytest.mark.parametrize("fn, name", [
    (kernels.base_kernel_chunked_ext_grouped, "stress:64"),
    (kernels.base_kernel_chunked_ext_grouped_spill, "icosphere:4")])
def test_chunked_ext_wrappers_take_the_plain_version_on_the_cpu(fn, name):
    tr = PathTracer(_checker(_scene(name)), "cpu", chunk_base=2)
    n0 = fn.launches
    got = fn(tr, POSE, SEED, 0, 2, 4)
    _equal(got, kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, 2, 4))
    assert got.rays.shape == (tr.n_base_chunks, 4, tr.width)
    assert tr.n_base_chunks > 1 and float(got.rays.sum()) > 0
    _equal(kernels.base_kernel_chunked(tr, POSE, SEED, 0, 2, 4), got)
    assert fn.launches == n0


def test_gathered_wrapper_takes_the_plain_version_on_the_cpu():
    tr = PathTracer(_scene("stress:64"), "cpu", accel="gathered")
    fn = kernels.base_kernel_gathered_grouped
    n0, q0 = fn.launches, kernels.base_kernel.quota_launches
    got = fn(tr, POSE, SEED, 0, 2, 4, base_q=3)
    _equal(got, kernels.base_kernel_plain(tr, POSE, SEED, 0, 2, 4, base_q=3))
    _equal(kernels.base_kernel(tr, POSE, SEED, 0, 2, 4, base_q=3), got)
    assert float(got.rays.sum()) > 0
    assert (fn.launches, kernels.base_kernel.quota_launches) == (n0, q0)


# ------------------------------------------------------------------ frames


@pytest.mark.parametrize("name, accel_, chunked", [
    ("stress:64", "auto", True), ("icosphere:1", "gathered", False)],
    ids=["stress:64 checker", "icosphere:1 gathered"])
def test_frame_through_the_new_dispatch_matches_jax_oracle(name, accel_,
                                                           chunked):
    """The sorted frame (16x8, 8 spp, depth 3) through base_kernel_chunked
    (the checker stress:64 with chunks of 2: the grouped chunked EXT A) or
    base_kernel (icosphere:1 under gathered: the grouped gathered A), their
    plain versions here, against the JAX package's render_frame with the
    same scene and chunks: rays and samples exact, radiance within the
    tolerance but for KNIFE."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import tracer as jtracer

    chunks = dict(chunk_base=2, chunk_extra=2) if chunked else {}
    jscene = jload(name).with_overrides(**SIZE)
    scene = _scene(name)
    if chunked:
        jscene, scene = _checker(jscene), _checker(scene)
    jt = jtracer.PathTracer(jscene, accel=accel_, **chunks)
    jcur, _jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(SEED), np.int32(0)))
    tr = PathTracer(scene, "cpu", accel=accel_, **chunks)
    assert (tr.chunk_base, tr.chunk_extra) == (jt.chunk_base, jt.chunk_extra)
    if chunked:
        assert kernels._kind(tr) == "ext" and kernels.takes_grouped(
            tr, "chunked")
    else:
        assert kernels.takes_grouped(tr, "base")
    cur, _var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0)
    assert float(rays) == float(np.asarray(jrays).sum())
    np.testing.assert_array_equal(tot.numpy(), jtot)
    assert (jtot > tr.base_samples).any()
    key = f"{name} {'checker' if chunked else accel_}"
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(KNIFE[key])


# ------------------------------------------------------- iteration model


@pytest.mark.parametrize("k", [8, 16, 32])
def test_gathered_a_iteration_model(k):
    """base_entry_iters over the walk (a 7x5 image, 35 pixels): the plain
    scheduler's loop count times the pixels is the plain version's
    lane-iterations; warp_iters at K, by hand, is the static schedule's
    count, and at least the pixels' summed iterations, the refill
    schedule's lower bound."""
    tr = PathTracer(_scene("stress:64", width=7, height=5, max_depth=4),
                    "cpu", accel="gathered")
    it = kernels.base_entry_iters(tr, POSE, SEED, 0)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0)
    assert it.shape == p.rays.shape and it.dtype == torch.int64
    assert float(p.iters) == float(it.max()) * it.numel()
    flat = it.reshape(-1).tolist()
    slots = 32 // k
    want = sum(slots * max(flat[w0:w0 + slots])
               for w0 in range(0, len(flat), slots))
    got = float(kernels.warp_iters(it, k))
    assert got == want and got >= sum(flat)
    assert kernels.working_warps(it, k) == -(-len(flat) // slots)


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


def _chunked_equal(k, p):
    for a, b in zip((*k.csum, *k.csumsq, k.rays, k.state),
                    (*p.csum, *p.csumsq, p.rays, p.state)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def split_libs():
    """csrc/group_tune.cu at K = 8, 128 lanes a block and the SPLIT_CAPS
    stage caps (the libraries of chip_smoke.py's split points)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    srcs = {cap: (build.TUNE_SOURCE, ("TRT_TUNE_K=8", "TRT_TUNE_THREADS=128",
                                      f"TRT_TUNE_STAGE_CAP={cap}"))
            for cap in SPLIT_CAPS}
    build.library_paths(tuple(srcs.values()))
    return {cap: build.load_kernels((src,)) for cap, src in srcs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None), (8, 8)],
                         ids=["whole", "rows8-16"])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:4"])
def test_chunked_ext_grouped_matches_plain_version(cuda_device, name,
                                                   region):
    """base_kernel_chunked through the grouped chunked EXT entry (its
    GroupSpill form over the budget) and the thread-per-entry entry against
    the plain version, bit for bit, the lane-iterations the plain model's
    at each group width."""
    tr = PathTracer(_checker(_card_scene(name)), cuda_device, chunk_base=2,
                    chunk_extra=2)
    spill = "_spill" if kernels._over_budget(tr) else ""
    wrapper = getattr(kernels, f"base_kernel_chunked_ext_grouped{spill}")
    n0 = wrapper.launches
    g = kernels.base_kernel_chunked(tr, POSE, SEED, 0, *region)
    assert wrapper.launches == n0 + 1
    t = kernels._launch_chunked(tr, POSE, SEED, 0, *region, "ext")
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, *region)
    _chunked_equal(g, p)
    _chunked_equal(t, p)
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0, *region)
    assert float(g.iters) == float(kernels.warp_iters(
        it, kernels.group_k(f"chunked_ext{spill}")))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", SPLIT_CAPS)
@pytest.mark.parametrize("name", ["Cornell_Box", "icosphere:1", "stress:64"])
def test_chunked_ext_spill_at_every_split_point(cuda_device, split_libs,
                                                name, cap):
    """The chunked EXT GroupSpill form with nothing staged and with 168
    bytes (Cornell_Box: its planes split; icosphere:1: its triangles;
    stress:64: its spheres), checker floors, bit for bit."""
    lib = split_libs[cap]
    assert kernels.group_cap("chunked_ext_spill", lib) == cap
    tr = PathTracer(_checker(_card_scene(name)), cuda_device, chunk_base=2,
                    chunk_extra=2)
    k = kernels._launch_chunked(tr, POSE, SEED, 0, 0, None,
                                "ext_grouped_spill", lib)
    _chunked_equal(k, kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0))
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0)
    assert float(k.iters) == float(kernels.warp_iters(
        it, kernels.group_k("chunked_ext_spill", lib)))


def _counted(tr, fn):
    """fn() and the kernels' walk counters."""
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


def _plain(tr, *args):
    """The plain version and its walk counters."""
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    try:
        out = kernels.base_kernel_plain(tr, POSE, SEED, 0, *args)
        return out, tr.prims.stats.long().cpu()
    finally:
        tr.prims.ops = None


def _base_equal(k, p):
    for name in ("rays", "state", "var", "additional"):
        assert torch.equal(_bits(getattr(k, name)), _bits(getattr(p, name)))
    for a, b in zip((*k.csum, *k.csumsq), (*p.csum, *p.csumsq)):
        assert torch.equal(_bits(a), _bits(b))


def _iters_model(got, it, k, refill):
    if refill:
        assert float(got) >= float(it.sum())
    else:
        assert float(got) == float(kernels.warp_iters(it, k))


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None, None), (8, 8, None),
                                    (0, None, 2)],
                         ids=["whole", "rows8-16", "quota2"])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:1",
                                  "icosphere:4"])
def test_gathered_grouped_matches_plain_version(cuda_device, name, region):
    """base_kernel through the grouped gathered entry and the
    thread-per-pixel entry against the plain version, bit for bit, the walk
    counters equal to the plain version's (none at the trip cap); the
    lane-iterations as the schedule's model says."""
    tr = PathTracer(_card_scene(name), cuda_device, accel="gathered")
    assert kernels.takes_grouped(tr, "base")
    fn = kernels.base_kernel_gathered_grouped
    n0, q0 = fn.launches, kernels.base_kernel.quota_launches
    g, gc = _counted(tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0,
                                                     *region))
    assert fn.launches == n0 + 1
    assert kernels.base_kernel.quota_launches == q0 + (region[2] is not None)
    t, tc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, *region, "gathered"))
    p, pc = _plain(tr, *region)
    _base_equal(g, p)
    _base_equal(t, p)
    assert torch.equal(gc, pc) and torch.equal(tc, pc), (gc, tc, pc)
    assert int(pc[3]) == 0 and int(pc[1]) > 0
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, *region)
    _iters_model(g.iters, it, kernels.group_k("base_gathered"),
                 kernels.group_refill("base_gathered"))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("refill", [False, True], ids=["static", "refill"])
def test_gathered_each_schedule_counts_its_slots(cuda_device, refill):
    """Both schedules of the grouped gathered kernel A at the shipped group
    width (the other one from csrc/group_tune.cu, rows through L1, 128
    lanes a block): bit for bit, walk counters the plain version's, the
    lane-iterations as the schedule's model says."""
    tr = PathTracer(_card_scene("stress:64"), cuda_device, accel="gathered")
    k = kernels.group_k("base_gathered")
    lib = None
    if kernels.group_refill("base_gathered") != refill:
        lib = build.load_kernels(((build.TUNE_SOURCE, (
            f"TRT_TUNE_K={k}", "TRT_TUNE_THREADS=128", "TRT_TUNE_WALK=0")
            + (("TRT_TUNE_REFILL=1",) if refill else ())),))
        assert kernels.group_k("base_gathered", lib) == k
    assert kernels.group_refill("base_gathered", lib) == refill
    g, gc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, "gathered_grouped", lib))
    p, pc = _plain(tr)
    _base_equal(g, p)
    assert torch.equal(gc, pc), (gc, pc)
    _iters_model(g.iters, kernels.base_entry_iters(tr, POSE, SEED, 0), k,
                 refill)
