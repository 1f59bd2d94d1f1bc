"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU. The
file imports no jax, so it runs on a GPU machine without the JAX package's
dependencies; tests/conftest.py imports jax, hence ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_cuda.py

The kernels build with --fmad=false and use the same CUDA math functions
as PyTorch's own kernels, so they must agree with the plain versions bit
for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.models.scene import Fog
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step

POSE = Camera().pose()
SEED = 42


def _cornell(w, h, spp, depth):
    return load_scene("Cornell_Box").with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 8])
def test_kernels_match_plain_versions(cuda_device, depth):
    tr = PathTracer(_cornell(128, 16, 16, depth), cuda_device)
    wrap_a = _base_wrapper(tr)
    n0 = wrap_a.launches
    k = kernels.base_kernel(tr, POSE, SEED, 0)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0)
    assert wrap_a.launches == n0 + 1
    for name in ("rays", "additional", "state", "var"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    for a, b in zip(list(k.csum) + list(k.csumsq),
                    list(p.csum) + list(p.csumsq)):
        assert torch.equal(a, b)
    s = kernels.sorted_stream(tr, k.state, k.additional)
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    n0 = kernels.extra_kernel_grouped.launches
    ek, rk, _ = kernels.extra_kernel(*args)
    ep, rp, _ = kernels.extra_kernel_plain(*args)
    assert kernels.extra_kernel_grouped.launches == n0 + 1
    assert torch.equal(rk, rp)
    for a, b in zip(ek, ep):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("spp, depth", [(16, 6), (2, 4)])
def test_render_step_matches_plain_frame(cuda_device, spp, depth):
    """The step on the card (both kernels, or kernel A alone when base >=
    spp) against the plain whole-frame render."""
    scene = _cornell(96, 24, spp, depth)
    out = make_render_step(scene, device=cuda_device)(
        init_state(scene, cuda_device), POSE, SEED, 0)
    cur, var, total, rays, _occ = PathTracer(scene, cuda_device).render_frame(
        POSE, SEED, 0)
    assert float(out.rays) == float(rays)
    assert torch.equal(out.state.samples, total)
    assert torch.equal(out.state.variance, var)
    assert torch.equal(out.state.acc, torch.stack(list(cur)))


@pytest.mark.cuda
def test_chunked_kernel_matches_plain_version(cuda_device):
    """kernel_base_chunked against its plain version on stress:120:7 with
    chunks of 2: every per-entry plane equal."""
    scene = load_scene("stress:120:7").with_overrides(
        width=64, height=16, samples_per_pixel=8, max_depth=6)
    tr = PathTracer(scene, cuda_device, chunk_base=2, chunk_extra=2)
    n0 = kernels.base_kernel_chunked_grouped.launches
    k = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    assert kernels.base_kernel_chunked_grouped.launches == n0 + 1
    assert k.rays.shape == (2, 16, 64)
    assert torch.equal(k.rays, p.rays) and torch.equal(k.state, p.state)
    for a, b in zip(list(k.csum) + list(k.csumsq),
                    list(p.csum) + list(p.csumsq)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stress:120:7", "Cornell_Box"])
def test_animated_chunked_frame_matches_plain_frame(cuda_device, name):
    """The sorted pipeline on an animated frame's buffer (chunk split
    forced) against the plain whole frame on the same buffer."""
    scene = load_scene(name).with_overrides(
        width=64, height=16, samples_per_pixel=8, max_depth=6)
    tr = PathTracer(scene, cuda_device, dynamic=True, chunk_base=2,
                    chunk_extra=2)
    arrays = ANIMATORS["orbit"](dyn.pack_scene(scene), 5)
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0, arrays)
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, SEED, 0)
    assert float(rays) == float(prays)
    for a, b in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a, b)


def _assert_base_equal(k, p):
    for name in ("rays", "state"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    for a, b in zip(list(k.csum) + list(k.csumsq),
                    list(p.csum) + list(p.csumsq)):
        assert torch.equal(a, b)


EXT_CASES = [("showcase", "nearest"), ("textured", "nearest"),
             ("textured", "bilinear"), ("envmap", "bilinear"),
             ("bumpy", "nearest"), ("cornell_glass", "nearest")]


@pytest.mark.cuda
@pytest.mark.parametrize("name, filt", EXT_CASES,
                         ids=[f"{n}-{f}" for n, f in EXT_CASES])
def test_ext_kernels_match_plain_versions(cuda_device, name, filt):
    """The EXT instantiations of kernels A and B against their plain
    versions on an extension scene: every output equal. envmap's sky is
    brightened 8 / 1.4 times: at its own intensity no pixel's variance
    reaches the adaptive threshold, and kernel B would trace nothing."""
    scene = load_scene(name).with_overrides(
        width=96, height=24, samples_per_pixel=32, max_depth=8,
        texture_filter=filt)
    if scene.sky is not None:
        scene = dataclasses.replace(
            scene, sky=dataclasses.replace(scene.sky, intensity=8.0))
    tr = PathTracer(scene, cuda_device)
    assert tr.ext
    n0, m0 = kernels.base_kernel_ext.launches, kernels.base_kernel.launches
    k = kernels.base_kernel(tr, POSE, SEED, 0)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0)
    assert kernels.base_kernel_ext.launches == n0 + 1
    assert kernels.base_kernel.launches == m0
    _assert_base_equal(k, p)
    assert torch.equal(k.additional, p.additional)
    s = kernels.sorted_stream(tr, k.state, k.additional)
    assert int((s.add > 0).sum()) > 0
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    wrap = _extra_wrapper(tr)  # the grouped EXT kernel B
    n0 = wrap.launches
    ek, rk, _ = kernels.extra_kernel(*args)
    ep, rp, _ = kernels.extra_kernel_plain(*args)
    assert wrap.launches == n0 + 1
    assert torch.equal(rk, rp)
    for a, b in zip(ek, ep):
        assert torch.equal(a, b)
    # The thread-per-entry EXT kernel B, launched directly.
    et, rt, _ = kernels._launch_extra(*args, "ext")
    assert torch.equal(rt, rp)
    for a, b in zip(et, ep):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ext_chunked_kernel_matches_plain_version(cuda_device):
    scene = load_scene("showcase").with_overrides(
        width=64, height=16, samples_per_pixel=32, max_depth=8)
    tr = PathTracer(scene, cuda_device, chunk_base=2, chunk_extra=2)
    n0 = kernels.base_kernel_chunked_ext_grouped.launches
    k = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    assert kernels.base_kernel_chunked_ext_grouped.launches == n0 + 1
    assert k.rays.shape == (4, 16, 64)
    _assert_base_equal(k, p)
    # The thread-per-entry entry, which no dispatch takes now.
    _assert_base_equal(kernels._launch_chunked(tr, POSE, SEED, 0, 0, None,
                                               "ext"), p)


@pytest.mark.cuda
def test_ext_kernels_on_a_reference_scene_equal_the_reference_kernels(
        cuda_device):
    """Zero channels and no atlas: the EXT instantiation gives the
    reference instantiation's outputs bit for bit."""
    scene = _cornell(128, 16, 16, 8)
    ref = PathTracer(scene, cuda_device)
    ext = PathTracer(scene, cuda_device)
    ext.bind_tables(geom.scene_tables(scene, cuda_device, ext.accel,
                                      ext=True))
    _assert_base_equal(kernels.base_kernel_ext(ext, POSE, SEED, 0),
                       kernels.base_kernel(ref, POSE, SEED, 0))


@pytest.mark.cuda
def test_animated_ext_frame_matches_plain_frame(cuda_device):
    scene = load_scene("showcase").with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=6)
    tr = PathTracer(scene, cuda_device, dynamic=True)
    arrays = ANIMATORS["orbit"](dyn.pack_scene(scene), 5)
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0, arrays)
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, SEED, 0)
    assert float(rays) == float(prays)
    for a, b in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a, b)


XT_CASES = {
    "mis": ("Cornell_Box", {}, "mis"),
    "unbiased": ("Cornell_Box", {}, "unbiased"),
    "fog": ("Cornell_Box", {"fog": Fog(density=0.15)}, "reference"),
    "fog-hg-mis": ("Cornell_Box",
                   {"fog": Fog(density=0.2, albedo=(1.0, 1.0, 1.0), g=0.7)},
                   "mis"),
    "dof": ("Cornell_Box", {"aperture": 0.1, "focus_distance": 3.0},
            "reference"),
    "stratified": ("Cornell_Box", {"sampler": "stratified"}, "reference"),
    "lights4-power-mis": ("lights:4", {"light_sample": "power"}, "mis"),
    "lights4-uniform": ("lights:4", {"light_sample": "uniform"}, "reference"),
    "showcase-mis": ("showcase", {}, "mis"),
}


def _base_wrapper(tr):
    """The kernel A wrapper that base_kernel passes `tr` on to: the grouped
    entry of its instantiation where takes_grouped (the table fits the
    budget and has GROUP_BASE_MIN_PRIMS primitives)."""
    kind = kernels._kind(tr)
    if kernels.takes_grouped(tr, "base"):
        return kernels.GROUPED_BASE[kind]
    return getattr(kernels, "base_kernel" + ("" if kind == "ref"
                                             else f"_{kind}"))


def _extra_wrapper(tr):
    """The kernel B wrapper that extra_kernel passes `tr` on to: the grouped
    entry of its instantiation where the table fits the budget."""
    kind = kernels._kind(tr)
    if kernels.takes_grouped(tr):
        return kernels.GROUPED_EXTRA[kind]
    return getattr(kernels, "extra_kernel" + ("" if kind == "ref"
                                              else f"_{kind}"))


def _xt_tracer(device, name, w=96, h=24, spp=32, depth=8, **kw):
    scene, over, transport = XT_CASES[name]
    scene = load_scene(scene).with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)
    return PathTracer(scene, device, transport=transport, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(XT_CASES))
def test_xt_kernels_match_plain_versions(cuda_device, name):
    """The XT instantiations of kernels A and B against their plain
    versions under each transport and camera gate: every output equal,
    and kernel B on a stream with work."""
    tr = _xt_tracer(cuda_device, name)
    assert tr.xt
    n0, m0 = kernels.base_kernel_xt.launches, kernels.base_kernel_ext.launches
    k = kernels.base_kernel(tr, POSE, SEED, 0)
    p = kernels.base_kernel_plain(tr, POSE, SEED, 0)
    assert kernels.base_kernel_xt.launches == n0 + 1
    assert kernels.base_kernel_ext.launches == m0
    _assert_base_equal(k, p)
    assert torch.equal(k.additional, p.additional)
    s = kernels.sorted_stream(tr, k.state, k.additional)
    assert int((s.add > 0).sum()) > 0
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    wrap_b = _extra_wrapper(tr)
    n0 = wrap_b.launches
    ek, rk, _ = kernels.extra_kernel(*args)
    ep, rp, _ = kernels.extra_kernel_plain(*args)
    assert wrap_b.launches == n0 + 1
    assert torch.equal(rk, rp)
    for a, b in zip(ek, ep):
        assert torch.equal(a, b)
    # The thread-per-entry XT entry, which tables over the budget take.
    et, rt, _ = kernels._launch_extra(*args, kernels._kind(tr))
    assert torch.equal(rt, rp)
    for a, b in zip(et, ep):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fog-hg-mis", "lights4-power-mis"])
def test_xt_chunked_kernel_matches_plain_version(cuda_device, name):
    """The chunked XT kernel A through the wrapper (its grouped entry) and
    its thread-per-entry entry, launched directly, against the plain
    version."""
    tr = _xt_tracer(cuda_device, name, 64, 16, chunk_base=2, chunk_extra=2)
    n0, m0 = (kernels.base_kernel_chunked_xt.launches,
              kernels.base_kernel_chunked_xt_grouped.launches)
    k = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    assert (kernels.base_kernel_chunked_xt.launches,
            kernels.base_kernel_chunked_xt_grouped.launches) == (n0, m0 + 1)
    _assert_base_equal(k, p)
    _assert_base_equal(kernels._launch_chunked(tr, POSE, SEED, 0, 0, None,
                                               "xt"), p)


@pytest.mark.cuda
def test_xt_kernels_with_every_gate_off_equal_the_reference_kernels(
        cuda_device):
    """xt tables on Cornell_Box with every gate off: the XT instantiations
    give the reference instantiations' outputs bit for bit."""
    scene = _cornell(128, 16, 16, 8)
    ref = PathTracer(scene, cuda_device)
    xt = PathTracer(scene, cuda_device)
    xt.bind_tables(geom.scene_tables(scene, cuda_device, xt.accel, xt=True))
    a_ref = kernels.base_kernel(ref, POSE, SEED, 0)
    a_xt = kernels.base_kernel_xt(xt, POSE, SEED, 0)
    _assert_base_equal(a_xt, a_ref)
    s = kernels.sorted_stream(ref, a_ref.state, a_ref.additional)
    args = (POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    (e_ref, r_ref, _), (e_xt, r_xt, _) = (kernels.extra_kernel(ref, *args),
                                          kernels.extra_kernel_xt(xt, *args))
    assert torch.equal(r_ref, r_xt)
    for a, b in zip(e_ref, e_xt):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_animated_xt_frame_matches_plain_frame(cuda_device):
    """One-light NEE on an animated scene: the per-frame lia channel and
    pick table, through the pipeline, against the plain whole frame."""
    scene = load_scene("lights:4").with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=6,
        light_sample="power")
    tr = PathTracer(scene, cuda_device, dynamic=True, transport="mis")
    arrays = ANIMATORS["pulse"](dyn.pack_scene(scene), 5)
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0, arrays)
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, SEED, 0)
    assert float(rays) == float(prays)
    for a, b in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    tr = PathTracer(_cornell(32, 8, 16, 3), cuda_device)
    a = kernels.base_kernel(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a.state, a.additional)
    with pytest.raises(ValueError, match="int32"):
        kernels.extra_kernel(tr, POSE, s.xs.long(), s.ys, s.state, s.add,
                             s.samp0)
    with pytest.raises(ValueError, match="one device"):
        kernels.extra_kernel(tr, POSE, s.xs.cpu(), s.ys, s.state, s.add,
                             s.samp0)


ACCEL_CASES = {
    "stress-grid": ("stress:96:3", "grid", {}, "reference"),
    "stress-gathered": ("stress:96:3", "gathered", {}, "reference"),
    "mesh-grid": ("icosphere:1", "grid", {}, "reference"),
    "mesh-gathered": ("icosphere:1", "gathered", {}, "reference"),
    "cornell-fog-mis-grid": ("Cornell_Box", "grid",
                             {"fog": Fog(density=0.15)}, "mis"),
    "cornell-fog-mis-gathered": ("Cornell_Box", "gathered",
                                 {"fog": Fog(density=0.15)}, "mis"),
    "showcase-gathered": ("showcase", "gathered", {}, "reference"),
}


def _kernel_counts(tr, fn):
    """fn() with the kernels' traversal counters on: (out, counters)."""
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device=tr.device)
    try:
        return fn(), tr.accel_stats.double()
    finally:
        tr.accel_stats = None


def _plain_counts(tr, fn):
    """fn() with the plain traversal counting: (out, counters)."""
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device=tr.device)
    try:
        return fn(), tr.prims.stats.clone()
    finally:
        tr.prims.ops = None


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ACCEL_CASES))
def test_accel_kernels_match_plain_versions(cuda_device, name):
    """The grid and gathered instantiations of kernels A and B against
    their plain versions: every output equal, and the traversal counters
    (blocks swept and skipped; walks, tests, advances) equal to the plain
    version's count; no walk reaches max_trips."""
    scene, accel, over, transport = ACCEL_CASES[name]
    scene = load_scene(scene).with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=6, **over)
    tr = PathTracer(scene, cuda_device, accel=accel, transport=transport)
    wrap_a = _base_wrapper(tr)
    wrap_b = _extra_wrapper(tr)
    n0 = wrap_a.launches
    k, ks = _kernel_counts(tr,
                           lambda: kernels.base_kernel(tr, POSE, SEED, 0))
    p, ps = _plain_counts(
        tr, lambda: kernels.base_kernel_plain(tr, POSE, SEED, 0))
    assert wrap_a.launches == n0 + 1
    _assert_base_equal(k, p)
    assert torch.equal(k.additional, p.additional)
    assert torch.equal(ks, ps), (ks, ps)
    if accel == "gathered":
        assert float(ks[3]) == 0.0
    # The thread-per-pixel entry, which tables over the budget take.
    kt, kts = _kernel_counts(tr, lambda: kernels._launch_base(
        tr, POSE, SEED, 0, 0, None, None, kernels._kind(tr)))
    _assert_base_equal(kt, p)
    assert torch.equal(kt.additional, p.additional)
    assert torch.equal(kts, ps), (kts, ps)
    s = kernels.sorted_stream(tr, k.state, k.additional)
    assert int((s.add > 0).sum()) > 0
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    n0 = wrap_b.launches
    (ek, rk, _), ks = _kernel_counts(tr, lambda: kernels.extra_kernel(*args))
    (ep, rp, _), ps = _plain_counts(
        tr, lambda: kernels.extra_kernel_plain(*args))
    assert wrap_b.launches == n0 + 1
    assert torch.equal(rk, rp)
    for a, b in zip(ek, ep):
        assert torch.equal(a, b)
    assert torch.equal(ks, ps), (ks, ps)
    # The thread-per-entry entry, which tables over the budget take.
    (et, rt, _), ts = _kernel_counts(
        tr, lambda: kernels._launch_extra(*args, kernels._kind(tr)))
    assert torch.equal(rt, rp)
    for a, b in zip(et, ep):
        assert torch.equal(a, b)
    assert torch.equal(ts, ps), (ts, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ["grid", "gathered"])
def test_accel_render_step_matches_plain_frame(cuda_device, accel):
    """The step through the grid or gathered kernels against the plain
    whole-frame render of the same tracer."""
    scene = load_scene("stress:96:3").with_overrides(
        width=96, height=24, samples_per_pixel=16, max_depth=6)
    step = make_render_step(scene, device=cuda_device, accel=accel)
    out = step(init_state(scene, cuda_device), POSE, SEED, 0)
    cur, var, total, rays, _occ = step.tracer.render_frame(POSE, SEED, 0)
    assert float(out.rays) == float(rays)
    assert torch.equal(out.state.samples, total)
    assert torch.equal(out.state.variance, var)
    assert torch.equal(out.state.acc, torch.stack(list(cur)))


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ["grid", "gathered"])
def test_chunked_accel_kernels_match_plain_versions(cuda_device, accel):
    """The chunked kernel A over the grid and gathered traversals, through
    the entry the dispatch takes (the grouped entry of either), against its
    plain version: every per-entry plane equal, and the traversal counters
    equal to the plain version's count."""
    scene = load_scene("stress:96:3").with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=6)
    tr = PathTracer(scene, cuda_device, accel=accel, chunk_base=2)
    wrap = kernels.GROUPED_CHUNKED[accel]
    assert kernels.takes_grouped(tr, "chunked")
    n0 = wrap.launches
    k, ks = _kernel_counts(
        tr, lambda: kernels.base_kernel_chunked(tr, POSE, SEED, 0))
    p, ps = _plain_counts(
        tr, lambda: kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0))
    assert wrap.launches == n0 + 1
    assert k.rays.shape == (2, 16, 64)
    _assert_base_equal(k, p)
    assert torch.equal(ks, ps), (ks, ps)


# Kernels C and D: (scene, overrides, PathTracer keywords, transport).
FRAME_CASES = {
    "cornell": ("Cornell_Box", {}, {}, "reference"),
    "stress-chunked": ("stress:120:7", {},
                       dict(chunk_base=2, chunk_extra=2), "reference"),
    "showcase": ("showcase", {}, {}, "reference"),
    "fog-mis": ("Cornell_Box", {"fog": Fog(density=0.15)}, {}, "mis"),
    "grid": ("stress:96:3", {}, dict(accel="grid"), "reference"),
    "grid-chunked": ("stress:96:3", {}, dict(accel="grid", chunk_base=2,
                                             chunk_extra=3), "reference"),
    "gathered": ("stress:96:3", {}, dict(accel="gathered"), "reference"),
    "gathered-chunked": ("stress:96:3", {},
                         dict(accel="gathered", chunk_base=2), "reference"),
}
FRAME_KIND = {"cornell": "", "stress-chunked": "", "showcase": "_ext",
              "fog-mis": "_xt", "grid": "_grid", "grid-chunked": "_grid",
              "gathered": "_gathered", "gathered-chunked": "_gathered"}


def _frame_tracer(device, name, w=64, h=16, spp=16, depth=6):
    scene, over, kw, transport = FRAME_CASES[name]
    scene = load_scene(scene).with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)
    return PathTracer(scene, device, transport=transport, **kw)


def _assert_frames_equal(k, p):
    for a, b in zip((*k.current, k.var, k.total, k.rays),
                    (*p.current, p.var, p.total, p.rays)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["regen", "lockstep"])
@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_frame_kernels_match_plain_versions(cuda_device, name, mode):
    """Each instantiation of kernels C and D (the queue entry its tracer
    takes) against its plain version: every plane equal, the executed
    lane-iterations within the plain version's count model (regen: from the
    items' sum, the plain count, to 32 / K times it; lockstep: the static
    formula) and the traversal counters equal."""
    tr = _frame_tracer(cuda_device, name)
    wrap = getattr(kernels, f"{mode}_kernel{FRAME_KIND[name]}")
    # The wrapper passes the tracer on to its queue entry, which counts.
    counter = kernels.FRAME_QUEUE[mode, kernels._kind(tr),
                                  kernels.frame_form(tr)]
    n0 = counter.launches
    if tr.traversal:
        k, ks = _kernel_counts(tr, lambda: wrap(tr, POSE, SEED, 0))
        p, ps = _plain_counts(tr, lambda: kernels.render_frame_plain(
            tr, mode, POSE, SEED, 0))
        assert torch.equal(ks, ps), (ks, ps)
        if tr.traversal == "gathered":
            assert float(ks[3]) == 0.0
    else:
        k = wrap(tr, POSE, SEED, 0)
        p = kernels.render_frame_plain(tr, mode, POSE, SEED, 0)
    assert counter.launches == n0 + 1
    assert (p.total > tr.base_samples).any()
    _assert_frames_equal(k, p)
    if mode == "lockstep":
        assert float(k.iters) == float(p.iters)
    else:
        _, _, _, _, it, _ = tr.render_pixels(POSE, SEED, 0)
        lo, hi = kernels.regen_iters_bounds(it, min(kernels.FRAME_QUEUE_K[
            kernels._kind(tr), kernels.frame_form(tr)]))
        assert float(p.iters) == lo <= float(k.iters) <= hi


@pytest.mark.cuda
@pytest.mark.parametrize("w, h, spp", [(50, 7, 16), (64, 16, 3)])
def test_lockstep_counter_equals_static_formula(cuda_device, w, h, spp):
    """Kernel D's own count of executed lane-iterations is the static
    formula over ceil(h * w / 32) * 32 lanes, a partial warp included and
    with base >= spp; a row block counts its own lanes."""
    tr = _frame_tracer(cuda_device, "stress-chunked", w, h, spp, 5)
    k = kernels.lockstep_kernel(tr, POSE, SEED, 0)
    assert float(k.iters) == kernels.lockstep_iters(tr)
    k = kernels.lockstep_kernel(tr, POSE, SEED, 0, y0=2, h_out=3)
    assert float(k.iters) == kernels.lockstep_iters(tr, 3)
    p = kernels.render_frame_plain(tr, "lockstep", POSE, SEED, 0, 2, 3)
    _assert_frames_equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "showcase", "fog-mis",
                                  "grid-chunked", "gathered"])
def test_schedulers_render_equal_frames(cuda_device, name):
    """C, D and the sorted pipeline on one scene of each instantiation:
    the same frame, bit for bit, and lockstep's occupancy no higher than
    the others'."""
    tr = _frame_tracer(cuda_device, name)
    outs = {mode: kernels.make_render_frame(tr, mode)(POSE, SEED, 3)
            for mode in kernels.MODES}
    want = outs["sorted"]
    for mode in ("regen", "lockstep"):
        got = outs[mode]
        assert float(got[3]) == float(want[3]), mode
        for a, b in zip((*got[0], *got[1:3]), (*want[0], *want[1:3])):
            assert torch.equal(a, b), mode
    assert float(outs["lockstep"][4]) <= float(outs["regen"][4])


@pytest.mark.cuda
@pytest.mark.parametrize("name, fog", [("Cornell_Box", None),
                                       ("showcase", None),
                                       ("Cornell_Box", 0.15)],
                         ids=["ref", "ext", "xt"])
def test_quota_kernels_match_plain_versions(cuda_device, name, fog):
    """Kernel A of a sample-split shard (a tracer with base_quota) with each
    runtime share on a row block, and the shard's extra phase continuing at
    its share, against the plain versions, bit for bit."""
    from terminal_raytracer_tpu_torch.parallel import mesh as pm

    scene = load_scene(name).with_overrides(
        width=96, height=24, samples_per_pixel=20, max_depth=6,
        fog=None if fog is None else Fog(density=fog))
    split = pm.SampleSplit(scene, cuda_device, 3, y0=8, rows=8)
    tr = split.tracer
    for sp_i in range(3):
        q, seed = split.share(sp_i), split.seed(SEED, sp_i)
        n0 = kernels.base_kernel.quota_launches
        k = kernels.base_kernel(tr, POSE, seed, 0, 8, 8, base_q=q)
        p = kernels.base_kernel_plain(tr, POSE, seed, 0, 8, 8, base_q=q)
        assert kernels.base_kernel.quota_launches == n0 + 1
        for field in ("rays", "state", "var", "additional"):
            assert torch.equal(getattr(k, field), getattr(p, field)), field
        for a, b in zip((*k.csum, *k.csumsq), (*p.csum, *p.csumsq)):
            assert torch.equal(a, b)
        add = torch.full_like(p.var, 3.0)  # 3 extra samples a pixel
        s = kernels.sorted_stream(tr, k.state, add, 8, q)
        args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
        (ek, rk, _), (ep, rp, _) = (kernels.extra_kernel(*args),
                                    kernels.extra_kernel_plain(*args))
        assert torch.equal(rk, rp) and float(rk.sum()) > 0
        for a, b in zip(ek, ep):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sample_split_composition_matches_plain_phases(cuda_device,
                                                       monkeypatch):
    """The sample-split frame of the mesh module (sp = 3 in one process) on
    the card against the same phases with the plain versions of kernels A
    and B on the card, bit for bit (but for the executed lane-iterations,
    a warp's count against the plain scheduler's)."""
    from terminal_raytracer_tpu_torch.parallel import mesh as pm

    split = pm.SampleSplit(_cornell(96, 24, 16, 6), cuda_device, 3)
    got = pm.sample_split_frame(split, POSE, SEED, 0)
    monkeypatch.setattr(kernels, "base_kernel", kernels.base_kernel_plain)
    monkeypatch.setattr(kernels, "extra_kernel", kernels.extra_kernel_plain)
    want = pm.sample_split_frame(split, POSE, SEED, 0)
    for a, b in zip((*got[0], *got[1:4]), (*want[0], *want[1:4])):
        assert torch.equal(a, b)
