"""The port's schedulers against the JAX package: ``make_render_frame(tracer,
mode)`` with kernel C ('regen'), kernel D ('lockstep') and the sorted
pipeline, on the CPU, where each kernel wrapper takes its plain version.

Against the JAX oracle (``PathTracer.render_frame``, the same scene, pose,
seed and frame at 64x16, 8 spp, depth 3): owed rays and per-pixel sample
totals exact; radiance and variance within rtol 1e-4 / atol 1e-5 but for
the knife-edge pixels that the file covering each scene bounds: none on
Cornell_Box (triangle lights), a counted few on the sphere-light stress
field and on showcase (KNIFE: their count and summed error), and in fog
under MIS at most 2 pixels, each at
most 1e-4 off (test_torch_medium.py: an ulp of XLA-CPU's log or exp moves
a direction). The chunk-split stress case sweeps arrays (accel 'array'):
the JAX oracle compiles the baked stress field's chunk loops slowly
(about 50 s). The frame tests under accel 'grid' are in
test_torch_accel.py (the JAX oracle's blocked scene compiles in 25-45 s
there).

Against the JAX Pallas kernels in interpret mode (``pallas_kernel.
make_render_frame(mode=...)`` on Cornell_Box 64x16, as
tests/test_pallas.py runs them): rays and totals exact, radiance within
atol 2e-5.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera, load_scene as jload_scene
from terminal_raytracer_tpu.models.animate import ANIMATOR_KEYS
from terminal_raytracer_tpu.models.animate import ANIMATORS as JANIMATORS
from terminal_raytracer_tpu.models.scene import Fog as JFog
from terminal_raytracer_tpu.ops import dynamic as jdyn
from terminal_raytracer_tpu.ops import pallas_kernel as pk
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.models.scene import Fog
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 11
KW = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
RTOL, ATOL = 1e-4, 1e-5
# Sphere-light scenes and showcase, by case: (pixels off, their summed
# error over radiance and variance), the largest the three modes show on
# the CPU (the error rounded up to 3 digits).
KNIFE = {"stress-chunked": (7, 0.000876), "showcase": (4, 0.776),
         "gathered": (8, 0.000231), "gathered-chunked": (8, 0.000486)}
KNIFE_PIXELS, KNIFE_ATOL = 2, 1e-4  # fog under MIS: pixels off, how far
PALLAS_ATOL = 2e-5

# name: (scene, fog density, PathTracer keywords, knife-edge rule, animated)
CASES = {
    "cornell": ("Cornell_Box", None, {}, "none", False),
    "stress-chunked": ("stress:48", None, dict(accel="array", chunk_base=2,
                                               chunk_extra=2), "share", False),
    "showcase": ("showcase", None, {}, "share", False),
    "fog-mis": ("Cornell_Box", 0.15, dict(transport="mis"), "pixels", False),
    "gathered": ("stress:48:3", None, dict(accel="gathered"), "share",
                 False),
    "gathered-chunked": ("stress:48:3", None, dict(accel="gathered",
                                                   chunk_base=2), "share",
                         False),
    "dynamic-orbit": ("Cornell_Box", None, dict(dynamic=True), "none", True),
}
T_ORBIT = 5  # the animated case's frame time


def _tracers(name):
    """(port tracer, JAX tracer, the animated case's per-frame arrays for
    each: (port, JAX) or None)."""
    scene, fog, kw, _, animated = CASES[name]
    over = dict(KW)
    s = load_scene(scene).with_overrides(
        **over, **({"fog": Fog(density=fog)} if fog else {}))
    js = jload_scene(scene).with_overrides(
        **over, **({"fog": JFog(density=fog)} if fog else {}))
    jkw = dict(kw)
    if animated:
        jkw["dyn_animated"] = ANIMATOR_KEYS["orbit"]
        arrays = (ANIMATORS["orbit"](dyn.pack_scene(s), T_ORBIT),
                  JANIMATORS["orbit"](jdyn.pack_scene(js), T_ORBIT))
    else:
        arrays = None
    return PathTracer(s, "cpu", **kw), jtracer.PathTracer(js, **jkw), arrays


_ORACLE = {}


def _oracle(name):
    """The port tracer, its per-frame arrays and the JAX oracle's frame
    (current, variance, total, rays), computed once per case."""
    if name not in _ORACLE:
        tr, jt, arrays = _tracers(name)
        assert (tr.chunk_base, tr.chunk_extra) == (jt.chunk_base,
                                                   jt.chunk_extra)
        args = (POSE, np.uint32(SEED), np.int32(0))
        if arrays is None:
            want = jax.jit(jt.render_frame)(*args)
        else:
            want = jax.jit(jt.render_frame_dynamic)(*args, arrays[1])
        _ORACLE[name] = (tr, arrays and arrays[0], jax.device_get(want))
    return _ORACLE[name]


def _render(name, mode):
    tr, arrays, _ = _oracle(name)
    return tr, kernels.make_render_frame(tr, mode)(POSE, SEED, 0, arrays)


def _assert_matches(name, got, want, base):
    rule = CASES[name][3]
    cur, var, tot, rays, occ = got
    jcur, jvar, jtot, jrays = want
    assert float(rays) == float(np.asarray(jrays).sum())
    np.testing.assert_array_equal(tot.numpy(), jtot)
    assert (jtot > base).any()  # the extra phase is exercised
    g = np.stack([c.numpy() for c in cur] + [var.numpy()])
    w = np.stack([*jcur, jvar])
    err = np.abs(g - w)
    off = (err > ATOL + RTOL * np.abs(w)).any(0)
    if rule == "none":
        assert off.sum() == 0, f"{off.sum()} pixels off"
    elif rule == "share":
        KnifeEdges(RTOL, ATOL).add(g, w).check(KNIFE[name])
    else:
        assert err[:3].max() <= KNIFE_ATOL, f"a pixel is {err[:3].max()} off"
        assert off.sum() <= KNIFE_PIXELS, f"{off.sum()} pixels off"
    assert 0.0 < float(occ) <= 1.0


@pytest.mark.parametrize("mode", kernels.MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_render_frame_matches_jax_oracle(name, mode):
    tr, got = _render(name, mode)
    _assert_matches(name, got, _oracle(name)[2], tr.base_samples)


@pytest.mark.parametrize("name", ["cornell", "stress-chunked",
                                  "gathered-chunked"])
def test_schedulers_render_one_frame(name):
    """Scheduling never changes a chain: C, D and the sorted pipeline give
    the same frame, bit for bit."""
    outs = {mode: _render(name, mode)[1] for mode in kernels.MODES}
    for mode in ("regen", "lockstep"):
        assert float(outs[mode][3]) == float(outs["sorted"][3])
        for a, b in zip((*outs[mode][0], *outs[mode][1:3]),
                        (*outs["sorted"][0], *outs["sorted"][1:3])):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("mode", ["regen", "lockstep"])
def test_matches_pallas_kernel_in_interpret_mode(mode):
    """The port's scheduler against the JAX Pallas kernel of the same mode,
    run in interpret mode as the JAX package's tests run it."""
    tr, _, _ = _oracle("cornell")
    jrender = jax.jit(pk.make_render_frame(
        jload_scene("Cornell_Box").with_overrides(**KW), mode=mode,
        interpret=True))
    jcur, jvar, jtot, jrays, _ = jax.device_get(
        jrender(POSE, np.uint32(SEED), np.int32(0)))
    cur, var, tot, rays, _ = kernels.make_render_frame(tr, mode)(
        POSE, SEED, 0)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    for c, jc in zip(cur, jcur):
        np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=PALLAS_ATOL)


def test_occupancy_orders_the_schedulers():
    """Lockstep's occupancy is owed sweeps over its static lane-iterations
    (every lane of ceil(h * w / 32) warps runs lockstep_samples x
    max_depth, 1 + nee_sweeps sweeps each); regen's and the sorted
    pipeline's are at least as high."""
    occ = {}
    for mode in kernels.MODES:
        tr, (_, _, _, rays, occ[mode]) = _render("cornell", mode)
    lanes = -(-tr.height * tr.width // 32) * 32
    assert kernels.lockstep_samples(tr) == tr.spp
    static = lanes * tr.spp * tr.max_depth * (1.0 + tr.nee_sweeps)
    assert kernels.lockstep_iters(tr) * (1 + tr.nee_sweeps) == static
    assert float(occ["lockstep"]) == pytest.approx(float(rays) / static,
                                                   rel=1e-12)
    assert float(occ["regen"]) >= float(occ["lockstep"])
    assert float(occ["sorted"]) >= float(occ["lockstep"])
    tr, _, _ = _oracle("stress-chunked")
    # Whole chunks of ce slots: base 4 + ceil(4 / 2) * 2.
    assert kernels.lockstep_samples(tr) == 8


@pytest.mark.parametrize("spp, depth", [(16, 12), (3, 6)])
def test_regen_iterations_stay_within_the_phase_quotas(spp, depth):
    """Each pixel's executed iterations are at most its samples x
    max_depth, so the JAX kernel's loop cap (spp + 1) * max_depth + 4,
    which the port's kernel drops, never binds (roulette at depth 12;
    base >= spp at spp 3); regen's count lies between the items' summed
    iterations (the queue schedule's least) and lockstep's static count."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=40, height=8, samples_per_pixel=spp, max_depth=depth)
    tr = PathTracer(scene, "cpu")
    _, _, total, _, lane_iters, _ = tr.render_pixels(POSE, SEED, 0)
    assert bool((lane_iters <= total.to(torch.int64) * depth).all())
    assert int(lane_iters.max()) < (spp + 1) * depth + 4
    out = kernels.regen_kernel(tr, POSE, SEED, 0)
    assert int(lane_iters.sum()) <= float(out.iters) \
        <= kernels.lockstep_iters(tr)


def test_row_block_equals_the_frame_rows():
    """A row block [y0, y0 + h_out) (the entry points' multi-GPU form) is
    those rows of the whole frame."""
    tr, _, _ = _oracle("stress-chunked")
    whole = kernels.regen_kernel(tr, POSE, SEED, 0)
    block = kernels.lockstep_kernel(tr, POSE, SEED, 0, y0=5, h_out=4)
    for a, b in zip((*block.current, block.var, block.total, block.rays),
                    (*whole.current, whole.var, whole.total, whole.rays)):
        assert torch.equal(a, b[5:9])
    assert float(block.iters) == kernels.lockstep_iters(tr, 4)


def test_unknown_mode_and_wrong_instantiation_raise():
    tr, _, _ = _oracle("cornell")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        kernels.make_render_frame(tr, "wavefront")
    with pytest.raises(ValueError, match="'ref' instantiation"):
        kernels.regen_kernel_ext(tr, POSE, SEED, 0)
    with pytest.raises(ValueError, match="unknown kernel mode"):
        kernels.render_frame_plain(tr, "sorted", POSE, SEED, 0)
    g, _, _ = _oracle("gathered")
    with pytest.raises(ValueError, match="'gathered' instantiation"):
        kernels.lockstep_kernel_grid(g, POSE, SEED, 0)
    with pytest.raises(ValueError, match="not 'grid'"):
        kernels.base_kernel_chunked_grid(g, POSE, SEED, 0)
