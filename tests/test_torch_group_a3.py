"""The grouped kernel A at the EXT gates and the grouped chunked kernel A
over the culled sweep of `--accel grid` (csrc/group.cuh): their dispatch,
the wrappers' refusals and plain versions on the CPU, each plain version
against the JAX package's Pallas kernel A; the kernels on the card.

base_kernel_ext passes an EXT tracer of at least GROUP_BASE_MIN_PRIMS
primitives whose rows fit the 96 KB budget on to base_kernel_ext_grouped
(the packaged extension scenes, 4-12 primitives, keep the thread per pixel;
an EXT table over the budget too). base_kernel_chunked_grid passes every
`--accel grid` tracer with a chunk split on to
base_kernel_chunked_grid_grouped, and that one a table over the budget on
to base_kernel_chunked_grid_grouped_spill. Here the wrappers take their
plain PyTorch versions (the tensors lie on the CPU); the dispatch tests
stand in for the launch by monkeypatching `_on_cuda` and the launchers.
Against the JAX kernel A in interpret mode: owed rays, budgets and end
states exact, sums within rtol 1e-4 / atol 1e-5 but for the knife edges of
KNIFE (tests/test_torch_knife.py: by count and summed error).

The `cuda` tests hold each new entry bit for bit against its plain version
on the card (whole image, a row block; the EXT A also a runtime quota),
the EXT A on both schedules (the other one from csrc/group_tune.cu) with
its lane-iterations as the schedule's model says, and the chunked grid A
in both forms with its traversal counters equal to the plain version's and
the thread per entry's. They skip here; the file imports the JAX package
only inside its JAX tests.
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
# The JAX comparisons' shapes: the checker stress:32 (EXT kernel A) and
# stress:48:3 under grid with chunks of 2 (the chunked grid kernel A).
EXT_JAX = ("stress:32", dict(width=32, height=8, samples_per_pixel=8,
                             max_depth=3))
GRID_JAX = ("stress:48:3", dict(width=32, height=8, samples_per_pixel=8,
                                max_depth=3))
# Knife-edge bounds against the JAX kernel A, by case: (pixels off, their
# summed error), as the tests' seed shows on the CPU (the error rounded up
# to 3 digits). Both scenes' lights are spheres: one pixel's NEE shadow
# test flips on an ulp (tests/test_torch_slice.py), its rays equal, every
# plane about 1e-3 off.
KNIFE = {"ext": (1, 0.00792), "chunked grid": (1, 0.0784)}


def _scene(name, **over):
    return load_scene(name).with_overrides(**{**SIZE, **over})


def _checker(scene):
    """`scene` with a checker floor (its first plane): the EXT
    instantiation at array scale, as chip_smoke.py's checker stress:256."""
    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


def _equal(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.fixture
def recorded(monkeypatch):
    """The launches the wrappers would make on the card, recorded instead:
    _on_cuda says yes, and _launch_base / _launch_chunked note their `kind`
    and return the plain version's outputs."""
    kinds = []
    monkeypatch.setattr(kernels, "_on_cuda", lambda device, name: True)

    def base(tracer, pose, seed, frame_number, y0, h_out, base_q, kind,
             lib=None):
        kinds.append(kind)
        return kernels.base_kernel_plain(tracer, pose, seed, frame_number,
                                         y0, h_out, base_q)

    def chunked(tracer, pose, seed, frame_number, y0, h_out, kind, lib=None):
        kinds.append(kind)
        return kernels.base_kernel_chunked_plain(tracer, pose, seed,
                                                 frame_number, y0, h_out)

    monkeypatch.setattr(kernels, "_launch_base", base)
    monkeypatch.setattr(kernels, "_launch_chunked", chunked)
    return kinds


# ----------------------------------------------------------------- dispatch


EXT_A = (kernels.base_kernel_ext, kernels.base_kernel_ext_grouped)


@pytest.mark.parametrize("scene, accel_, kind, counts", [
    (lambda: _checker(_scene("stress:64")), "auto", "ext_grouped", (0, 1)),
    (lambda: _checker(_scene("stress:256")), "auto", "ext_grouped", (0, 1)),
    (lambda: _scene("showcase"), "auto", "ext", (1, 0)),
    (lambda: _scene("cornell_glass"), "auto", "ext", (1, 0)),
    (lambda: _checker(_scene("icosphere:4")), "baked", "ext", (1, 0))],
    ids=["stress:64 checker", "stress:256 checker", "showcase",
         "cornell_glass", "icosphere:4 checker baked"])
def test_ext_a_dispatch_launches(scene, accel_, kind, counts, recorded):
    """base_kernel -> base_kernel_ext -> base_kernel_ext_grouped for an EXT
    scene of at least GROUP_BASE_MIN_PRIMS primitives within the budget
    (the grouped entry counts the launch); the packaged extension scenes
    and an EXT table over the budget launch the thread per pixel."""
    tr = PathTracer(scene(), "cpu", accel=accel_)
    assert kernels._kind(tr) == "ext" and tr.chunk_base is None
    assert kernels.GROUPED_BASE["ext"] is kernels.base_kernel_ext_grouped
    n0 = [w.launches for w in EXT_A]
    out = kernels.base_kernel(tr, POSE, SEED, 0, 2, 4)
    assert float(out.rays.sum()) > 0
    assert recorded == [kind]
    assert [w.launches - n for w, n in zip(EXT_A, n0)] == list(counts)


CHUNKED_GRID = (kernels.base_kernel_chunked_grid,
                kernels.base_kernel_chunked_grid_grouped,
                kernels.base_kernel_chunked_grid_grouped_spill)


@pytest.mark.parametrize("name, kind, counts", [
    ("stress:1024", "grid_grouped", (0, 1, 0)),
    ("Cornell_Box", "grid_grouped", (0, 1, 0)),
    ("icosphere:4", "grid_grouped_spill", (0, 0, 1))])
def test_chunked_grid_a_dispatch(name, kind, counts, recorded):
    """base_kernel_chunked -> base_kernel_chunked_grid ->
    base_kernel_chunked_grid_grouped (-> its GroupCulledSpill form over the
    budget) at chunks of 2, whatever the primitive count; only the entry
    that launches counts."""
    tr = PathTracer(_scene(name), "cpu", accel="grid", chunk_base=2)
    assert tr.chunk_base == 2 and kernels.takes_grouped(tr, "chunked")
    assert "grid" in kernels.ANY_SIZE["chunked"]
    assert (kernels.GROUPED_CHUNKED["grid"]
            is kernels.base_kernel_chunked_grid_grouped)
    assert kernels._over_budget(tr) is kind.endswith("spill")
    n0 = [w.launches for w in CHUNKED_GRID]
    out = kernels.base_kernel_chunked(tr, POSE, SEED, 0, 0, 2)
    assert out.rays.shape == (tr.n_base_chunks, 2, tr.width)
    assert recorded == [kind]
    assert [w.launches - n for w, n in zip(CHUNKED_GRID, n0)] == list(counts)


def test_new_wrappers_refuse_what_they_do_not_serve():
    ext = PathTracer(_checker(_scene("stress:64")), "cpu")
    ext_big = PathTracer(_checker(_scene("icosphere:4")), "cpu",
                         accel="baked")
    ext_chunked = PathTracer(_checker(_scene("stress:64")), "cpu",
                             chunk_base=2)
    ref = PathTracer(_scene("stress:64"), "cpu")
    xt = PathTracer(_scene("stress:64", fog=Fog(density=0.15)), "cpu")
    grid = PathTracer(_scene("stress:64"), "cpu", accel="grid")
    gath = PathTracer(_scene("stress:64"), "cpu", accel="gathered",
                      chunk_base=2)
    assert kernels._over_budget(ext_big) and not kernels._over_budget(ext)
    cases = ((kernels.base_kernel_ext_grouped,
              ((ref, "instantiation"), (xt, "instantiation"),
               (grid, "instantiation"), (gath, "instantiation"),
               (ext_big, "shared memory"), (ext_chunked, "chunks"))),
             (kernels.base_kernel_chunked_grid_grouped,
              ((ref, "instantiation"), (ext, "instantiation"),
               (xt, "instantiation"), (gath, "instantiation"))),
             (kernels.base_kernel_chunked_grid_grouped_spill,
              ((ref, "instantiation"), (ext, "instantiation"),
               (xt, "instantiation"), (gath, "instantiation"))))
    for fn, refused in cases:
        for tr, match in refused:
            with pytest.raises(ValueError, match=match):
                fn(tr, POSE, SEED, 0)


def test_ext_grouped_wrapper_takes_the_plain_version_on_the_cpu():
    tr = PathTracer(_checker(_scene("stress:64")), "cpu")
    fn = kernels.base_kernel_ext_grouped
    n0, q0 = fn.launches, kernels.base_kernel.quota_launches
    got = fn(tr, POSE, SEED, 0, 2, 4, base_q=3)
    _equal(got, kernels.base_kernel_plain(tr, POSE, SEED, 0, 2, 4, base_q=3))
    _equal(kernels.base_kernel(tr, POSE, SEED, 0, 2, 4, base_q=3), got)
    assert float(got.rays.sum()) > 0 and float(got.additional.sum()) > 0
    assert (fn.launches, kernels.base_kernel.quota_launches) == (n0, q0)


@pytest.mark.parametrize("name", ["stress:48:3", "icosphere:4"])
def test_chunked_grid_wrappers_take_the_plain_version_on_the_cpu(name):
    """Both chunked grid wrappers (the spill form within the budget too: it
    serves any size) return the plain version's outputs on the CPU and
    count no launch."""
    tr = PathTracer(_scene(name), "cpu", accel="grid", chunk_base=2)
    want = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, 2, 4)
    n0 = [w.launches for w in CHUNKED_GRID]
    for fn in CHUNKED_GRID:
        got = fn(tr, POSE, SEED, 0, 2, 4)
        _equal(got, want)
    _equal(kernels.base_kernel_chunked(tr, POSE, SEED, 0, 2, 4), want)
    assert want.rays.shape == (tr.n_base_chunks, 4, tr.width)
    assert tr.n_base_chunks > 1 and float(want.rays.sum()) > 0
    assert [w.launches for w in CHUNKED_GRID] == n0


# ------------------------------------------------- against the JAX kernel A


def test_ext_a_plain_matches_pallas_kernel_a():
    """base_kernel on a CPU tracer of the checker stress:32 (33 primitives:
    the grouped EXT entry on the card) against the JAX kernel A with the
    fold_budget epilogue in interpret mode on the same scene: rays, budgets
    and end states exact, sums and variance within the tolerance but for
    KNIFE['ext']."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import pallas_kernel as pk

    name, over = EXT_JAX
    base_fn, _, _ = pk.make_base_kernel(_checker(jload(name).with_overrides(
        **over)), interpret=True, fold_budget=True)
    jcsum, jcsq, jstate, jrays, _it, jvar, jadd = jax.device_get(
        jax.jit(base_fn)(POSE, np.uint32(SEED), np.int32(0), np.int32(0)))
    tr = PathTracer(_checker(load_scene(name).with_overrides(**over)), "cpu")
    assert kernels._kind(tr) == "ext" and kernels.takes_grouped(tr, "base")
    t = kernels.base_kernel(tr, POSE, SEED, 0)
    np.testing.assert_array_equal(t.rays.numpy(), jrays)
    np.testing.assert_array_equal(t.additional.numpy(), jadd)
    np.testing.assert_array_equal(t.state.numpy(), jstate.astype(np.int64))
    assert (jadd > 0).any()
    got = np.stack([v.numpy() for v in (*t.csum, *t.csumsq, t.var)])
    KnifeEdges(RTOL, ATOL).add(got, np.stack([*jcsum, *jcsq, jvar])).check(
        KNIFE["ext"])


def test_chunked_grid_a_plain_matches_pallas_kernel_a():
    """base_kernel_chunked on a CPU tracer under `--accel grid` with chunks
    of 2 (the grouped chunked grid entry on the card) against the JAX
    kernel A built with accel 'grid' and chunk_base 2 in interpret mode:
    the per-entry planes added in chunk order equal its totals (rays
    exact, sums within the tolerance but for KNIFE['chunked grid']), the
    end state chunk 0's."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import pallas_kernel as pk

    name, over = GRID_JAX
    base_fn, jt, _ = pk.make_base_kernel(jload(name).with_overrides(**over),
                                         interpret=True, accel="grid",
                                         chunk_base=2)
    assert jt.chunk_base == 2
    jcsum, jcsq, jstate, jrays, _it = jax.device_get(jax.jit(base_fn)(
        POSE, np.uint32(SEED), np.int32(0), np.int32(0)))
    tr = PathTracer(load_scene(name).with_overrides(**over), "cpu",
                    accel="grid", chunk_base=2)
    assert kernels.takes_grouped(tr, "chunked") and tr.n_base_chunks == 2
    out = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    np.testing.assert_array_equal(tr.chunk_total(out.rays).numpy(), jrays)
    np.testing.assert_array_equal(out.state[0].numpy(),
                                  jstate.astype(np.int64))
    got = [tr.chunk_total(v).numpy() for v in (*out.csum, *out.csumsq)]
    KnifeEdges(RTOL, ATOL).add(np.stack(got),
                               np.stack([*jcsum, *jcsq])).check(
                                   KNIFE["chunked grid"])


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_scene(name):
    return load_scene(name).with_overrides(width=64, height=16,
                                           samples_per_pixel=16, max_depth=8)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _base_equal(k, p):
    for name in ("rays", "state", "var", "additional"):
        assert torch.equal(_bits(getattr(k, name)), _bits(getattr(p, name)))
    for a, b in zip((*k.csum, *k.csumsq), (*p.csum, *p.csumsq)):
        assert torch.equal(_bits(a), _bits(b))


def _chunked_equal(k, p):
    for a, b in zip((*k.csum, *k.csumsq, k.rays, k.state),
                    (*p.csum, *p.csumsq, p.rays, p.state)):
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
@pytest.mark.parametrize("name", ["stress:64", "stress:256"])
def test_ext_grouped_matches_plain_version(cuda_device, name, region):
    """base_kernel through the grouped EXT entry and the thread-per-pixel
    EXT entry on checker scenes against the plain version, bit for bit, the
    lane-iterations as the shipped schedule's model says."""
    tr = PathTracer(_checker(_card_scene(name)), cuda_device)
    assert kernels.takes_grouped(tr, "base")
    fn = kernels.base_kernel_ext_grouped
    n0, q0 = fn.launches, kernels.base_kernel.quota_launches
    g = kernels.base_kernel(tr, POSE, SEED, 0, *region)
    assert fn.launches == n0 + 1
    assert kernels.base_kernel.quota_launches == q0 + (region[2] is not None)
    t = kernels._launch_base(tr, POSE, SEED, 0, *region, "ext")
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0, *region)
    _base_equal(g, p)
    _base_equal(t, p)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, *region)
    _iters_model(g.iters, it, kernels.group_k("base_ext"),
                 kernels.group_refill("base_ext"))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("refill", [False, True], ids=["static", "refill"])
def test_ext_each_schedule_counts_its_slots(cuda_device, refill):
    """Both schedules of the grouped EXT kernel A at the shipped group width
    (the other one from csrc/group_tune.cu, unbound): bit for bit, the
    lane-iterations as the schedule's model says."""
    tr = PathTracer(_checker(_card_scene("stress:64")), cuda_device)
    k = kernels.group_k("base_ext")
    lib = None
    if kernels.group_refill("base_ext") != refill:
        lib = build.load_kernels(((build.TUNE_SOURCE, (
            f"TRT_TUNE_K={k}", f"TRT_TUNE_REFILL={int(refill)}")),))
        assert kernels.group_k("base_ext", lib) == k
    assert kernels.group_refill("base_ext", lib) == refill
    g = kernels._launch_base(tr, POSE, SEED, 0, 0, None, None, "ext_grouped",
                             lib)
    _base_equal(g, kernels.base_kernel_plain(tr, POSE, SEED, 0))
    _iters_model(g.iters, kernels.base_entry_iters(tr, POSE, SEED, 0), k,
                 refill)


def _counted(tr, fn):
    """fn() and the kernels' traversal counters."""
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None), (8, 8)],
                         ids=["whole", "rows8-16"])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:4"])
def test_chunked_grid_grouped_matches_plain_version(cuda_device, name,
                                                    region):
    """base_kernel_chunked through the grouped chunked grid entry (its
    GroupCulledSpill form over the budget) and the thread-per-entry entry
    against the plain version at chunks of 2, bit for bit, the traversal
    counters equal to the plain version's (Culled's), the lane-iterations
    the plain model's at each group width."""
    tr = PathTracer(_card_scene(name), cuda_device, accel="grid",
                    chunk_base=2, chunk_extra=2)
    spill = "_spill" if kernels._over_budget(tr) else ""
    assert bool(spill) is (name == "icosphere:4")
    wrapper = getattr(kernels, f"base_kernel_chunked_grid_grouped{spill}")
    n0 = wrapper.launches
    g, gc = _counted(tr, lambda: kernels.base_kernel_chunked(
        tr, POSE, SEED, 0, *region))
    assert wrapper.launches == n0 + 1
    t, tc = _counted(tr, lambda: kernels._launch_chunked(
        tr, POSE, SEED, 0, *region, "grid"))
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    try:
        p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, *region)
        pc = tr.prims.stats.long().cpu()
    finally:
        tr.prims.ops = None
    _chunked_equal(g, p)
    _chunked_equal(t, p)
    assert torch.equal(gc, pc) and torch.equal(tc, pc), (gc, tc, pc)
    assert int(pc[0]) > 0 and int(pc[2]) > 0
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0, *region)
    assert float(g.iters) == float(kernels.warp_iters(
        it, kernels.group_k(f"chunked_grid{spill}")))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))
