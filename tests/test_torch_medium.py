"""The port's fog, thin-lens depth of field and stratified sampler against
the JAX package: the Henyey-Greenstein sampler and phase, the stratified
jitter and the thin-lens camera ray lane by lane, whole frames, render
steps and an animated fog frame against the jnp oracle, and the CLI's
--fog, --aperture / --focus and --sampler.

Inputs come from numpy seeds and go through both packages. RNG states
must agree bit for bit; values to rtol 1e-5 / atol 1e-6 (XLA-CPU rounds
sqrt, sin, cos, log and exp by an ulp otherwise than PyTorch on the CPU,
and contracts multiply-adds). Frames (64x16, 8 spp, depth 3, below the
roulette start) must agree in owed rays and per-pixel samples; radiance
within rtol 1e-4 / atol 1e-5 except on knife-edge pixels, at most 2 in a
frame or a run of steps, each at most 1e-4 off: an ulp of log moves a fog
scatter distance, or of sin and cos a scattered or lens direction, which
moves one sample's radiance by an ulp-sized step but changes no decision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.models.scene import Fog as JFog
from terminal_raytracer_tpu.ops import dynamic as jdyn
from terminal_raytracer_tpu.ops import sampling as jsamp
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.cli import parse_fog
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.models.scene import Fog
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops import sampling as tsamp
from terminal_raytracer_tpu_torch.ops import tracer as ttracer
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
N = 4096
RTOL, ATOL = 1e-5, 1e-6  # lane-wise values
F_RTOL, F_ATOL = 1e-4, 1e-5  # frame radiance
KNIFE_PIXELS = 2  # knife-edge pixels a frame may have (docstring)
KNIFE_ATOL = 1e-4  # how far a knife edge may move a pixel
KW = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
SEEDS = (1001, 1002)
FOGS = {"iso": (0.15, (1.0, 1.0, 1.0), 0.0),
        "hg": (0.2, (1.0, 1.0, 1.0), 0.7),
        "tinted": (0.2, (0.8, 0.85, 0.9), -0.3)}


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _both(fog=None, **over):
    """(JAX scene, port scene): Cornell_Box with `over` and the FOGS entry
    `fog`."""
    jover, tover = dict(over), dict(over)
    if fog is not None:
        density, albedo, g = FOGS[fog]
        jover["fog"] = JFog(density=density, albedo=albedo, g=g)
        tover["fog"] = Fog(density=density, albedo=albedo, g=g)
    return (jload_scene("Cornell_Box").with_overrides(**jover),
            load_scene("Cornell_Box").with_overrides(**tover))


def _states(rs):
    return rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ lane math


@pytest.mark.parametrize("g", [0.7, -0.3, 0.95])
def test_henyey_greenstein_dir_matches_jax(g):
    rs = np.random.RandomState(0)
    s = _states(rs)
    d = rs.normal(size=(3, N)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    gate = rs.rand(N) < 0.7
    js, jd = jsamp.henyey_greenstein_dir(jnp.asarray(s), JV3(*jnp.asarray(d)),
                                         g, jnp.asarray(gate))
    ts, td = tsamp.henyey_greenstein_dir(
        torch.from_numpy(s.astype(np.int64)), V3(*torch.from_numpy(d)), g,
        torch.from_numpy(gate))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    _close(_np3(td), _np3(jd))


@pytest.mark.parametrize("g", [0.0, 0.7, -0.3])
def test_hg_phase_matches_jax(g):
    cos_t = np.random.RandomState(1).uniform(-1.0, 1.0, N).astype(np.float32)
    cos_t[:2] = (-1.0, 1.0)
    _close(tsamp.hg_phase(torch.from_numpy(cos_t), g),
           jsamp.hg_phase(jnp.asarray(cos_t), g))


@pytest.mark.parametrize("spp", [16, 64, 256])
def test_stratify_jitter_matches_jax(spp):
    """Base samples (index < base) land in their cell of the g x g grid,
    extra samples keep the raw jitter; g as the JAX package resolves it."""
    jscene, scene = _both(samples_per_pixel=spp, sampler="stratified")
    jtr, tr = jtracer.PathTracer(jscene), PathTracer(scene, "cpu")
    assert tr.strat_g == jtr.strat_g > 1
    rs = np.random.RandomState(2)
    samp = rs.randint(0, spp, N).astype(np.int32)
    rx, ry = rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    jx, jy = jtr.stratify_jitter(jnp.asarray(samp), jnp.asarray(rx),
                                 jnp.asarray(ry))
    tx, ty = tr.stratify_jitter(torch.from_numpy(samp.astype(np.int64)),
                                torch.from_numpy(rx), torch.from_numpy(ry))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_stratified_grid_resolution_matches_jax():
    for spp in (1, 4, 16, 24, 36, 64, 128):
        jscene, scene = _both(samples_per_pixel=spp, sampler="stratified")
        assert (PathTracer(scene, "cpu").strat_g
                == jtracer.PathTracer(jscene).strat_g), spp


@pytest.mark.parametrize("aperture, focus", [(0.1, 3.0), (0.25, 1.7)])
def test_thin_lens_gen_ray_matches_jax(aperture, focus):
    """The jitter pair, then the lens pair (RNG states bit-equal), the
    lens-disk origin and the ray toward the pinhole ray's focus point."""
    jscene, scene = _both(aperture=aperture, focus_distance=focus)
    jtr, tr = jtracer.PathTracer(jscene), PathTracer(scene, "cpu")
    rs = np.random.RandomState(3)
    s = _states(rs)
    xf = rs.randint(0, jscene.width, N).astype(np.float32)
    yf = rs.randint(0, jscene.height, N).astype(np.float32)
    gate = rs.rand(N) < 0.8
    js, jo, jd = jtr.gen_ray(jnp.asarray(s),
                             jtracer.cam_from_pose(jnp.asarray(POSE)),
                             jnp.asarray(xf), jnp.asarray(yf),
                             jnp.asarray(gate))
    ts, to, td = tr.gen_ray(torch.from_numpy(s.astype(np.int64)),
                            ttracer.cam_from_pose(POSE), torch.from_numpy(xf),
                            torch.from_numpy(yf), torch.from_numpy(gate))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    _close(_np3(to), _np3(jo))
    _close(_np3(td), _np3(jd))
    assert np.abs(_np3(to) - np.asarray(POSE[:3])[:, None]).max() > 0.05


def test_fog_constants_fold_once():
    """-1/sigma folds in f64 and rounds once; the CLI keeps --fog's density
    as given, like the JAX CLI."""
    _, scene = _both(fog="hg")
    tr = PathTracer(scene, "cpu")
    assert tr._neg_inv_sigma == -1.0 / 0.2 and tr.fog_g == 0.7
    assert tr.has_fog and tr.xt and tr.nee_sweeps == tr.n_lights
    fog = parse_fog("0.2:1,1,1:0.7")
    assert (fog.density, fog.albedo, fog.g) == (0.2, (1.0, 1.0, 1.0), 0.7)
    assert parse_fog("0.15") == Fog(density=0.15)
    with pytest.raises(ValueError, match="3 comma-separated"):
        parse_fog("0.2:1,1")


# ----------------------------------------------------------------- frames

FRAME_CASES = [("fog-iso", "reference", dict(fog="iso")),
               ("fog-hg-mis", "mis", dict(fog="hg")),
               ("fog-tinted-unbiased", "unbiased", dict(fog="tinted")),
               ("dof", "reference", dict(aperture=0.1, focus_distance=3.0)),
               ("stratified", "reference", dict(sampler="stratified"))]


def _knife_edges(acc, want):
    """The pixels off by more than the frame tolerance, once no pixel is
    off by more than KNIFE_ATOL."""
    err = np.abs(acc - want)
    assert err.max() <= KNIFE_ATOL, f"a pixel is {err.max()} off"
    return (err > F_ATOL + F_RTOL * np.abs(want)).any(0)


@pytest.mark.parametrize("name, transport, over", FRAME_CASES,
                         ids=[c[0] for c in FRAME_CASES])
def test_render_frame_matches_jax_oracle(name, transport, over):
    jscene, scene = _both(**KW, **over)
    jstep = j_make_step(jscene, full_color=True, backend="jnp",
                        transport=transport)
    tracer = PathTracer(scene, "cpu", transport=transport)
    assert tracer.xt
    for seed in SEEDS:
        j = jax.device_get(jstep(j_init_state(jscene), POSE,
                                 np.uint32(seed), np.int32(0)))
        cur, _var, total, rays, occ = tracer.render_frame(POSE, seed, 0)
        assert float(rays) == float(j.rays)
        np.testing.assert_array_equal(total.numpy(), j.state.samples)
        bad = _knife_edges(np.stack([c.numpy() for c in cur]), j.state.acc)
        assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"
        assert 0.0 < float(occ) <= 1.0


def test_render_step_matches_jax_step_in_fog_with_dof_and_strata():
    """Three accumulated frames, every camera and medium gate at once,
    through the port's render step (the sorted pipeline through the
    kernels' plain versions) against the JAX step."""
    over = dict(KW, samples_per_pixel=16, aperture=0.1, focus_distance=3.0,
                sampler="stratified")
    jscene, scene = _both(fog="hg", **over)
    jstep = j_make_step(jscene, full_color=True, backend="jnp",
                        transport="mis")
    step = make_render_step(scene, device="cpu", transport="mis")
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    bad = np.zeros((16, 64), bool)
    for f, seed in enumerate((11, 12, 13)):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(seed), np.int32(f)))
        jstate = j.state
        out = step(state, POSE, seed, f)
        state = out.state
        assert float(out.rays) == float(j.rays)
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        bad |= _knife_edges(out.state.acc.numpy(), j.state.acc)
    assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"


def test_animated_fog_matches_jax_dynamic_step():
    jscene, scene = _both(fog="iso", **KW)
    jstep = j_make_step(jscene, backend="jnp", dynamic=True)
    step = make_render_step(scene, device="cpu", dynamic=True)
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    j0, t0 = jdyn.pack_scene(jscene), dyn.pack_scene(scene)
    for t in (0, 5):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(11 + t),
                                 np.int32(0), ANIMATORS["orbit"](j0, t)))
        jstate = j.state
        out = step(state, POSE, 11 + t, 0, ANIMATORS["orbit"](t0, t))
        state = out.state
        assert float(out.rays) == float(j.rays), t
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        bad = _knife_edges(out.state.acc.numpy(), j.state.acc)
        assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"


def test_chunked_pipeline_in_fog_equals_plain_frame():
    """The chunk-split pipeline (chunked kernel A's plain version, the
    chunked sort glue) in fog with strata: bit for bit the plain frame."""
    _, scene = _both(fog="hg", **dict(KW, samples_per_pixel=16,
                                      sampler="stratified"))
    tr = PathTracer(scene, "cpu", chunk_base=2, chunk_extra=2,
                    transport="mis")
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(POSE, 3, 0)
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, 3, 0)
    assert float(rays) == float(prays)
    for a, b in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("flags", [["--fog", "0.15"],
                                   ["--fog", "0.2:1,1,1:0.7", "--mis"],
                                   ["--fog", "0.2:0.8,0.85,0.9"],
                                   ["--aperture", "0.1", "--focus", "3"],
                                   ["--sampler", "stratified"]])
def test_cli_renders_medium_and_camera_flags_on_cpu(flags, capsys):
    assert torch_main(["--device", "cpu", "--width", "32", "--height", "8",
                       "--spp", "4", "--depth", "3", "--frames", "1",
                       *flags]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 8 and all(len(r) == 32 for r in rows)
    assert len(set("".join(rows))) > 3  # a picture, not a flat field


@pytest.mark.parametrize("flags, msg", [
    (["--fog", "0.2:1,1"], "3 comma-separated"),
    (["--fog", "-1"], "fog"),
    (["--aperture", "-0.5"], "aperture"),
    (["--aperture", "0.1", "--focus", "0"], "focus_distance")])
def test_cli_refuses_bad_medium_and_lens_specs(flags, msg, capsys):
    assert torch_main(["--device", "cpu", "--frames", "1", *flags]) == 2
    assert msg in capsys.readouterr().err
