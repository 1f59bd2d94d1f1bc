"""The grouped kernel A (csrc/group.cuh kernel_base_grouped) at the
reference gates over the table sweep and over the culled sweep of `--accel
grid`: its dispatch, its refusals, its plain version against the JAX
package's Pallas kernel A and its per-pixel iteration model on the CPU; the
kernels on the card.

Here the wrappers take their plain PyTorch versions (the tensors lie on the
CPU). Against the JAX kernel A in interpret mode (make_base_kernel with
fold_budget, as tests/test_torch_kernels.py runs it): owed rays, adaptive
budgets and end states exact; sums within rtol 1e-4 / atol 1e-5 but for
at most one knife-edge pixel in 1,024 off by at most 1e-4 (at 64x16 one
pixel's green sum differs by 1.6e-5 with equal rays: an ulp of XLA-CPU's
transcendentals moves a direction, as in tests/test_torch_transport.py),
and under `--accel grid` at stress:120, whose lights are spheres, the
counted knife edges of KNIFE_GRID beyond it (the NEE self-shadow of
tests/test_torch_slice.py).

The `cuda` tests hold both grouped entries against their plain versions on
the card bit for bit (whole image, a row block, a runtime quota; the grid's
traversal counters too), the executed lane-iterations of the static
schedule against the plain model at the group width and those of the
refill schedule against the pixels' summed iterations, and, where a
grid table exceeds the budget, the GroupCulledSpill form that the wrapper
takes beside the thread-per-pixel entry; they skip here.
"""

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
# The grid kernel A at stress:120 against the JAX kernel A: (pixels off,
# their summed error), as the test's seed shows on the CPU (the error
# rounded up to 3 digits).
KNIFE_GRID = (1, 0.000509)
CORNELL = dict(width=64, height=16, samples_per_pixel=16, max_depth=3)
STRESS = ("stress:120", dict(width=32, height=8, samples_per_pixel=8,
                             max_depth=3))


def _scene(name, **over):
    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    return load_scene(name).with_overrides(**{**size, **over})


def _checker(scene):
    """`scene` with a checker floor (its first plane): the EXT
    instantiation at array scale."""
    import dataclasses

    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


def _off(got, want):
    """The share of pixels where any plane is beyond the tolerance."""
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    return bad.reshape(-1, *bad.shape[-2:]).any(0).mean()


def _knife_edges(got, want, n_max=1):
    """Planes [c, h, w] (at most 1,024 pixels) within the tolerance but for
    at most n_max pixels, each at most 1e-4 off."""
    assert got.shape[-2] * got.shape[-1] <= 1024
    assert _off(got, want) * got.shape[-2] * got.shape[-1] <= n_max
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("scene, accel_, want", [
    (lambda: _scene("Cornell_Box"), "auto", "base_kernel"),
    (lambda: _scene("Cornell_Box"), "grid", "base_kernel_grid"),
    (lambda: _scene("demo"), "auto", "base_kernel_grouped"),
    (lambda: _scene("demo"), "grid", "base_kernel_grid_grouped"),
    (lambda: _scene("stress:64"), "auto", "base_kernel_grouped"),
    (lambda: _scene("stress:256"), "auto", "base_kernel_grouped"),
    (lambda: _scene("stress:1024"), "baked", "base_kernel_grouped"),
    (lambda: _scene("icosphere:4"), "baked", "base_kernel"),
    (lambda: _scene("stress:1024"), "grid", "base_kernel_grid_grouped"),
    (lambda: _scene("icosphere:3"), "grid", "base_kernel_grid_grouped"),
    (lambda: _scene("icosphere:4"), "grid", "base_kernel_grid_grouped"),
    (lambda: _scene("showcase"), "auto", "base_kernel_ext"),
    (lambda: _checker(_scene("stress:64")), "auto",
     "base_kernel_ext_grouped"),
    (lambda: _checker(_scene("stress:256")), "auto",
     "base_kernel_ext_grouped"),
    (lambda: _scene("Cornell_Box", fog=Fog(density=0.15)), "auto",
     "base_kernel_xt"),
    (lambda: _scene("stress:96"), "gathered",
     "base_kernel_gathered_grouped"),
    (lambda: _scene("Cornell_Box"), "gathered", "base_kernel_gathered")])
def test_kernel_a_dispatch(scene, accel_, want):
    """Kernel A's entry by instantiation and table size: the reference
    gates take their grouped entry where what they stage fits the budget
    and the scene has GROUP_BASE_MIN_PRIMS primitives (Cornell_Box's 11
    are too few, demo's 21 not), the thread-per-pixel one otherwise; the
    culled sweep (`--accel grid`, over the budget through its
    GroupCulledSpill form) and the walk (`--accel gathered`) take their
    grouped entries at every table size from GROUP_BASE_MIN_PRIMS
    primitives on; the EXT gates take theirs as the reference gates do
    (the checker stress:64 and stress:256; showcase's 8 primitives keep
    the thread per pixel); XT keeps its thread per pixel."""
    tr = PathTracer(scene(), "cpu", accel=accel_)
    kind = kernels._kind(tr)
    grouped = kernels.takes_grouped(tr, "base")
    assert grouped == want.endswith("grouped")
    assert grouped == (
        (kind in ("ref", "ext")
         and kernels.group_smem_bytes(tr) <= kernels.GROUP_SMEM_BYTES
         or kind in kernels.ANY_SIZE["base"])
        and tr.scene.primitive_count >= kernels.GROUP_BASE_MIN_PRIMS)
    got = kernels.GROUPED_BASE[kind].__name__ if grouped else (
        "base_kernel" + ("" if kind == "ref" else f"_{kind}"))
    assert got == want


@pytest.mark.parametrize("scene, transport", [
    (lambda: _scene("Cornell_Box", fog=Fog(density=0.15)), "reference"),
    (lambda: _scene("lights:16", light_sample="power"), "reference"),
    (lambda: _scene("showcase"), "mis")], ids=["fog", "manylights_one",
                                                "showcase_mis"])
def test_kernel_a_dispatch_at_the_xt_scenes(scene, transport):
    """Kernel A's XT main-path scenes take the thread per pixel at the XT
    gates (held to its residency bound on the card), no grouped entry:
    base_kernel sends them to base_kernel_xt, which counts no launch on
    the CPU and returns the plain version's outputs."""
    tr = PathTracer(scene(), "cpu", transport=transport)
    assert kernels._kind(tr) == "xt" and tr.chunk_base is None
    assert not kernels.takes_grouped(tr, "base")
    assert "xt" not in kernels.GROUPED_BASE
    counts = (kernels.base_kernel.launches, kernels.base_kernel_xt.launches)
    got = kernels.base_kernel(tr, POSE, SEED, 0)
    want = kernels.base_kernel_plain(tr, POSE, SEED, 0)
    for a, b in zip((*got.csum, got.rays, got.var, got.state),
                    (*want.csum, want.rays, want.var, want.state)):
        assert torch.equal(a, b)
    assert (kernels.base_kernel.launches,
            kernels.base_kernel_xt.launches) == counts


def test_grouped_kernel_a_wrappers_refuse_what_they_do_not_serve():
    big = PathTracer(_scene("icosphere:4"), "cpu", accel="baked")
    grid_big = PathTracer(_scene("icosphere:4"), "cpu", accel="grid")
    ref = PathTracer(_scene("Cornell_Box"), "cpu")
    grid = PathTracer(_scene("stress:96"), "cpu", accel="grid")
    ext = PathTracer(_scene("showcase"), "cpu")
    xt = PathTracer(_scene("Cornell_Box", fog=Fog(density=0.15)), "cpu")
    gathered = PathTracer(_scene("stress:96"), "cpu", accel="gathered")
    chunked = PathTracer(_scene("stress:1024"), "cpu")
    grid_chunked = PathTracer(_scene("stress:96"), "cpu", accel="grid",
                              chunk_base=2)
    assert chunked.chunk_base and grid_chunked.chunk_base
    # The grid's over-budget table is served (base_kernel_grid_grouped
    # passes it on to its GroupCulledSpill form); what it refuses is a
    # chunk split.
    assert kernels._over_budget(grid_big)
    assert kernels.takes_grouped(grid_big, "base")
    for fn, cases in ((kernels.base_kernel_grouped,
                       ((big, "shared memory"), (grid, "instantiation"),
                        (ext, "instantiation"), (xt, "instantiation"),
                        (gathered, "instantiation"), (chunked, "chunks"))),
                      (kernels.base_kernel_grid_grouped,
                       ((grid_chunked, "chunks"), (ref, "instantiation"),
                        (xt, "instantiation"),
                        (gathered, "instantiation")))):
        for tr, match in cases:
            with pytest.raises(ValueError, match=match):
                fn(tr, POSE, SEED, 0)


@pytest.mark.parametrize("fn, scene, accel_", [
    (kernels.base_kernel_grouped, lambda: _scene("Cornell_Box"), "auto"),
    (kernels.base_kernel_grid_grouped, lambda: _scene("stress:48:3"),
     "grid")])
def test_grouped_kernel_a_wrappers_take_the_plain_version_on_the_cpu(
        fn, scene, accel_):
    tr = PathTracer(scene(), "cpu", accel=accel_)
    n0, q0 = fn.launches, kernels.base_kernel.quota_launches
    got = fn(tr, POSE, SEED, 0, 2, 4, base_q=3)
    want = kernels.base_kernel_plain(tr, POSE, SEED, 0, 2, 4, base_q=3)
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert float(got.rays.sum()) > 0
    assert (fn.launches, kernels.base_kernel.quota_launches) == (n0, q0)


_JAX = {}


def _jax_kernel_a(key, name, over, y0, **kw):
    """The JAX Pallas kernel A on scene `name` with `over`, with the
    fold_budget epilogue in interpret mode (built and jitted once a key),
    run at row y0: its seven planes. The JAX package is imported here
    only: the GPU machine that runs this file's `cuda` tests has none."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import pallas_kernel as pk

    if key not in _JAX:
        base_fn, _, _ = pk.make_base_kernel(
            jload(name).with_overrides(**over), interpret=True,
            fold_budget=True, **kw)
        _JAX[key] = jax.jit(base_fn)
    return jax.device_get(_JAX[key](POSE, np.uint32(SEED), np.int32(0),
                                    np.int32(y0)))


@pytest.mark.parametrize("case", ["whole", "rows8-16", "quota2"])
def test_kernel_a_matches_pallas_kernel_a(case):
    """base_kernel on the CPU (the plain version of the grouped and the
    thread-per-pixel entry alike) against the JAX kernel A: the whole
    image, the row block y0 = 8, h_out = 8, and the runtime quota base_q =
    2 (the JAX kernel built with base_quota 2: the epilogue's variance and
    budget cap are the quota's)."""
    y0, h_out, q = {"whole": (0, None, None), "rows8-16": (8, 8, None),
                    "quota2": (0, None, 2)}[case]
    kw = {} if h_out is None else {"shard_rows": h_out}
    if q is not None:
        kw["base_quota"] = q
    jcsum, jcsq, jstate, jrays, _it, jvar, jadd = _jax_kernel_a(
        case, "Cornell_Box", CORNELL, y0, **kw)
    tr = PathTracer(load_scene("Cornell_Box").with_overrides(**CORNELL),
                    "cpu")
    t = kernels.base_kernel(tr, POSE, SEED, 0, y0=y0, h_out=h_out, base_q=q)
    assert t.rays.shape == (h_out or CORNELL["height"], CORNELL["width"])
    np.testing.assert_array_equal(t.rays.numpy(), jrays)
    np.testing.assert_array_equal(t.additional.numpy(), jadd)
    np.testing.assert_array_equal(t.state.numpy(), jstate.astype(np.int64))
    assert (jadd > 0).any()
    _knife_edges(np.stack([v.numpy() for v in (*t.csum, *t.csumsq, t.var)]),
                 np.stack([*jcsum, *jcsq, jvar]))


def test_grid_kernel_a_matches_pallas_kernel_a_under_grid():
    """base_kernel on a CPU tracer under `--accel grid` (which takes the
    grouped grid entry on the card) against the JAX kernel A with accel
    'grid' at stress:120: rays and budgets exact, sums within the
    tolerance but for the knife edges of KNIFE_GRID."""
    name, over = STRESS
    jcsum, jcsq, jstate, jrays, _it, jvar, jadd = _jax_kernel_a(
        "grid", name, over, 0, accel="grid")
    tr = PathTracer(load_scene(name).with_overrides(**over), "cpu",
                    accel="grid")
    assert kernels.takes_grouped(tr, "base") and tr.chunk_base is None
    t = kernels.base_kernel(tr, POSE, SEED, 0)
    np.testing.assert_array_equal(t.rays.numpy(), jrays)
    np.testing.assert_array_equal(t.additional.numpy(), jadd)
    np.testing.assert_array_equal(t.state.numpy(), jstate.astype(np.int64))
    got = np.stack([v.numpy() for v in (*t.csum, *t.csumsq, t.var)])
    KnifeEdges(RTOL, ATOL).add(got, np.stack([*jcsum, *jcsq, jvar])).check(
        KNIFE_GRID)


@pytest.mark.parametrize("y0, h_out, q", [(0, None, None), (3, 5, None),
                                          (0, None, 2)])
def test_base_entry_iters_follow_the_plain_scheduler(y0, h_out, q):
    """Each pixel's iterations from the plain scheduler: the longest is the
    scheduler's loop count (base_kernel_plain's lane-iterations are it times
    the pixels), and an unchunked tracer's chunked count is the same."""
    tr = PathTracer(_scene("Cornell_Box", width=24, height=8), "cpu")
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, y0, h_out, q)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0, y0, h_out, q)
    assert it.shape == p.rays.shape and it.dtype == torch.int64
    assert float(p.iters) == float(it.max()) * it.numel()
    assert int(it.min()) >= (q or tr.base_samples)  # a bounce a sample
    if q is None:
        chunked = kernels.chunked_entry_iters(tr, POSE, SEED, 0, y0, h_out)
        assert torch.equal(chunked[0], it)
    else:
        full = kernels.base_entry_iters(tr, POSE, SEED, 0, y0, h_out)
        assert bool((it <= full).all()) and int(it.sum()) < int(full.sum())


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_warp_iters_of_kernel_a_by_hand(k):
    """warp_iters(base_entry_iters, k) on a 7x5 image (35 pixels, a multiple
    of no 32 / k but 1): each warp carries 32 / k consecutive pixels and
    spends 32 / k slots for its longest pixel's iterations; the partial
    last warp counts its full width."""
    tr = PathTracer(_scene("Cornell_Box", width=7, height=5, max_depth=4),
                    "cpu")
    flat = kernels.base_entry_iters(tr, POSE, SEED, 0).reshape(-1).tolist()
    slots = 32 // k
    want = 0
    for w0 in range(0, len(flat), slots):
        want += slots * max(flat[w0:w0 + slots])
    assert float(kernels.warp_iters(torch.tensor(flat), k)) == want
    assert kernels.working_warps(torch.tensor(flat), k) == -(-35 // slots)


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_tracer(device, name, accel_):
    scene = load_scene(name).with_overrides(width=64, height=16,
                                            samples_per_pixel=16, max_depth=8)
    return PathTracer(scene, device, accel=accel_)


# (scene, accel, group_k's name, the grouped kind of _launch_base, the
# design defines of csrc/group_tune.cu that kernel_accel.cu ships).
CARD = {"ref": ("stress:96:3", "auto", "base", "grouped", ()),
        "grid": ("stress:96:3", "grid", "base_grid", "grid_grouped",
                 ("TRT_TUNE_WIDE=0",))}


def _counted(tr, fn):
    """fn() and, under grid, the kernels' traversal counters."""
    if tr.traversal != "grid":
        return fn(), None
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


def _plain(tr, *args):
    """The plain version and, under grid, its traversal counters."""
    if tr.traversal != "grid":
        return kernels.base_kernel_plain(tr, POSE, SEED, 0, *args), None
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    try:
        out = kernels.base_kernel_plain(tr, POSE, SEED, 0, *args)
        return out, tr.prims.stats.long().cpu()
    finally:
        tr.prims.ops = None


def _bits_equal(k, p):
    for name in ("rays", "state", "var", "additional"):
        assert torch.equal(getattr(k, name).view(torch.int32)
                           if name != "state" else k.state,
                           getattr(p, name).view(torch.int32)
                           if name != "state" else p.state), name
    for a, b in zip((*k.csum, *k.csumsq), (*p.csum, *p.csumsq)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None, None), (8, 8, None),
                                    (0, None, 2)],
                         ids=["whole", "rows8-16", "quota2"])
@pytest.mark.parametrize("kind", ["ref", "grid"])
def test_grouped_kernel_a_matches_plain_version(cuda_device, kind, region):
    """base_kernel through the grouped entry and the thread-per-pixel entry
    against the plain version, bit for bit, with equal traversal
    counters under grid; the static schedule's lane-iterations are the
    plain model at K, the refill schedule's at least the pixels' sum."""
    name, accel_, kname, grouped, _ = CARD[kind]
    tr = _card_tracer(cuda_device, name, accel_)
    assert kernels.takes_grouped(tr, "base")
    wrapper = kernels.GROUPED_BASE[kind]
    n0, q0 = wrapper.launches, kernels.base_kernel.quota_launches
    g, gc = _counted(tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0,
                                                     *region))
    assert wrapper.launches == n0 + 1
    assert kernels.base_kernel.quota_launches == q0 + (region[2] is not None)
    t, tc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, *region, kind))
    p, pc = _plain(tr, *region)
    _bits_equal(g, p)
    _bits_equal(t, p)
    assert gc is None or (torch.equal(gc, pc) and torch.equal(tc, pc))
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, *region)
    k = kernels.group_k(kname)
    assert float(t.iters) == float(kernels.warp_iters(it, 1))
    if kernels.group_refill(kname):
        assert float(g.iters) >= float(it.sum())
    else:
        assert float(g.iters) == float(kernels.warp_iters(it, k))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ref", "grid"])
@pytest.mark.parametrize("refill", [False, True], ids=["static", "refill"])
def test_each_schedule_counts_its_slots(cuda_device, kind, refill):
    """Both schedules at the shipped group width (the other one from
    csrc/group_tune.cu): bit for bit against the plain version; static,
    the lane-iterations of the plain model at K; refill, at least the
    pixels' summed iterations (every slot busy), printed beside the static
    model's."""
    name, accel_, kname, grouped, design = CARD[kind]
    tr = _card_tracer(cuda_device, name, accel_)
    k = kernels.group_k(kname)
    lib = None
    if kernels.group_refill(kname) != refill:
        defines = (f"TRT_TUNE_K={k}", *design) + (
            ("TRT_TUNE_REFILL=1",) if refill else ())
        lib = build.load_kernels(((build.TUNE_SOURCE, defines),))
        assert kernels.group_k(kname, lib) == k
    assert kernels.group_refill(kname, lib) == refill
    g, gc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, grouped, lib))
    p, pc = _plain(tr)
    _bits_equal(g, p)
    assert gc is None or torch.equal(gc, pc)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0)
    model = float(kernels.warp_iters(it, k))
    print(f"{kind} K {k} {'refill' if refill else 'static'}: "
          f"lane-iterations {float(g.iters):.0f}, static model {model:.0f}, "
          f"pixels' sum {int(it.sum())}")
    if refill:
        assert float(g.iters) >= float(it.sum())
    else:
        assert float(g.iters) == model


@pytest.mark.cuda
def test_over_the_budget_takes_the_thread_per_pixel_grid_entry(cuda_device):
    """Over the budget under grid, base_kernel now takes the GroupCulledSpill
    form (base_kernel_grid_grouped passes the tracer on to it), not the
    thread per pixel; both, the latter launched directly, against the plain
    version bit for bit with its counters."""
    tr = PathTracer(load_scene("icosphere:4").with_overrides(
        width=32, height=8, samples_per_pixel=8, max_depth=4), cuda_device,
        accel="grid")
    assert kernels.takes_grouped(tr, "base") and kernels._over_budget(tr)
    n0, m0, s0 = (kernels.base_kernel_grid.launches,
                  kernels.base_kernel_grid_grouped.launches,
                  kernels.base_kernel_grid_grouped_spill.launches)
    k, kc = _counted(tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0))
    p, pc = _plain(tr)
    assert (kernels.base_kernel_grid.launches,
            kernels.base_kernel_grid_grouped.launches,
            kernels.base_kernel_grid_grouped_spill.launches) == (n0, m0,
                                                                  s0 + 1)
    t, tc = _counted(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, "grid"))
    _bits_equal(k, p)
    _bits_equal(t, p)
    assert torch.equal(kc, pc) and torch.equal(tc, pc)


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None, None), (8, 8, None),
                                    (0, None, 2)],
                         ids=["whole", "rows8-16", "quota2"])
def test_xt_kernel_a_bound_and_unbound_match_plain_version(cuda_device,
                                                            region):
    """Kernel A at the XT gates in fog (Cornell_Box 64x16) through
    base_kernel, held to its residency bound, and unbound (csrc/
    group_tune.cu at its defaults): each against the plain version bit for
    bit, its lane-iterations the plain model at K = 1."""
    tr = PathTracer(load_scene("Cornell_Box").with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=8,
        fog=Fog(density=0.15)), cuda_device)
    assert kernels.load_kernels().trt_kernel_base_xt_min_blocks() > 0
    unbound = build.load_kernels(((build.TUNE_SOURCE, (
        "TRT_TUNE_K=1", "TRT_TUNE_MIN_BLOCKS=0")),))
    assert unbound.trt_kernel_base_xt_min_blocks() == 0
    n0 = kernels.base_kernel_xt.launches
    k = kernels.base_kernel(tr, POSE, SEED, 0, *region)
    assert kernels.base_kernel_xt.launches == n0 + 1
    u = kernels._launch_base(tr, POSE, SEED, 0, *region, "xt", unbound)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0, *region)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, *region)
    for got in (k, u):
        _bits_equal(got, p)
        assert float(got.iters) == float(kernels.warp_iters(it, 1))
