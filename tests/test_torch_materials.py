"""The port's material extensions (dielectrics, rough metals, checker) and
the extension table against the JAX package: the samplers and scatter
math lane by lane, the per-primitive channels, the closest hit's channels,
whole frames and render steps of cornell_glass and showcase against the
jnp oracle, an animated showcase against the JAX dynamic step, and the
CLI on every packaged extension scene.

Inputs come from numpy seeds and go through both packages. RNG states
must agree bit for bit; values to rtol 1e-5 / atol 1e-6 (XLA-CPU contracts
multiply-adds and rounds rsqrt, sin and cos differently from PyTorch by an
ulp). Channels are table values and agree exactly. Frames (64x16, 8 spp,
depth 3, below the roulette start, as the JAX package's own checker and
texture tests pin it) must agree in owed rays and per-pixel samples;
radiance within rtol 1e-4 / atol 1e-5 except on knife-edge pixels (a
checker cell edge an ulp away, the sphere-light NEE self-shadow of
test_torch_slice.py, a fuzzed mirror direction an ulp from the surface):
a counted few, bounded by their count and summed error (KNIFE,
tests/test_torch_knife.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.models.animate import ANIMATOR_KEYS
from terminal_raytracer_tpu.models.animate import ANIMATORS as JANIMATORS
from terminal_raytracer_tpu.ops import dynamic as jdyn
from terminal_raytracer_tpu.ops import geometry as jgeom
from terminal_raytracer_tpu.ops import rng as jrng
from terminal_raytracer_tpu.ops import sampling as jsamp
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops import sampling as tsamp
from terminal_raytracer_tpu_torch.ops import tracer as ttracer
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
N = 4096
RTOL, ATOL = 1e-5, 1e-6  # lane-wise values
F_RTOL, F_ATOL = 1e-4, 1e-5  # frame radiance
EXT_SCENES = ["cornell_glass", "showcase", "textured", "envmap", "bumpy"]


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _unit(rs, n):
    d = rs.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ lane math


def test_uniform_sphere_dir_matches_jax():
    rs = np.random.RandomState(0)
    s = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    gate = rs.rand(N) < 0.7
    js, jd = jsamp.uniform_sphere_dir(jnp.asarray(s), jnp.asarray(gate))
    ts, td = tsamp.uniform_sphere_dir(torch.from_numpy(s.astype(np.int64)),
                                      torch.from_numpy(gate))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    _close(_np3(td), _np3(jd))


def test_atan2_matches_jax():
    rs = np.random.RandomState(1)
    y, x = rs.normal(size=(2, N)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30], np.float32)
    y[:36] = np.repeat(special, 6)
    x[:36] = np.tile(special, 6)
    want = np.asarray(jax.jit(jsamp.atan2)(y, x))
    got = tsamp.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    # The polynomial, not libm: within ~1e-5 rad of the true angle off the
    # signed zeros (where libm's branch cut takes -0 to pi).
    assert np.abs(got - np.arctan2(y, x))[36:].max() < 2e-5


def test_fresnel_and_refract_match_jax():
    rs = np.random.RandomState(2)
    n = _unit(rs, N)
    d = _unit(rs, N)
    d = np.where((d * n).sum(0) > 0, -d, d).astype(np.float32)  # incoming
    eta = rs.choice([1 / 1.5, 1.5, 1 / 1.33, 1.33], N).astype(np.float32)
    jt, jci, jct, jtir = jtracer.refract(JV3(*jnp.asarray(d)),
                                         JV3(*jnp.asarray(n)),
                                         jnp.asarray(eta))
    tt, tci, tct, ttir = ttracer.refract(V3(*torch.from_numpy(d)),
                                         V3(*torch.from_numpy(n)),
                                         torch.from_numpy(eta))
    np.testing.assert_array_equal(ttir.numpy(), np.asarray(jtir))
    assert ttir.any() and not ttir.all()
    ok = ~ttir.numpy()
    _close(_np3(tt)[:, ok], _np3(jt)[:, ok])
    _close(tci, jci)
    _close(tct, jct)
    cos = rs.uniform(0.0, 1.0, N).astype(np.float32)
    _close(ttracer.fresnel_schlick(torch.from_numpy(cos),
                                   torch.from_numpy(eta)),
           jtracer.fresnel_schlick(jnp.asarray(cos), jnp.asarray(eta)))


# ------------------------------------------------------ extension table


def _jax_channels(scene):
    """[n_prims, 12] channel values from the JAX package's own scene, in
    the JAX baked sweep's conventions (ior zeroed off glass, checker scale
    0 when unchecked, signed texture and normal-map ids)."""
    rows = []
    for tag, p in scene.primitives:
        m = p.material
        ck = m.checker_color or (0.0, 0.0, 0.0)
        rows.append([m.transparency, m.ior if m.transparency > 0 else 0.0,
                     m.roughness, *ck,
                     m.checker_scale if m.is_checker else 0.0,
                     *scene.texture_channel(tag, m),
                     *scene.normal_channel(tag, m)])
    return np.asarray(rows, np.float32).reshape(-1, geom.EXT_W)


@pytest.mark.parametrize("name", EXT_SCENES + ["Cornell_Box"])
def test_ext_table_matches_jax_channels(name):
    scene = load_scene(name)
    tables = geom.scene_tables(scene, "cpu", ext=True)
    np.testing.assert_array_equal(tables.ext.numpy(),
                                  _jax_channels(jload_scene(name)))
    assert geom.uses_extensions(scene) == (name != "Cornell_Box")
    assert not geom.scene_tables(scene, "cpu").has_ext


@pytest.mark.parametrize("name", EXT_SCENES)
def test_animated_ext_table_at_t0_equals_the_static_one(name):
    scene = load_scene(name)
    got = dyn.tables_from_packed(dyn.pack_scene(scene),
                                 dyn.topology(scene, True), "cpu")
    want = geom.scene_tables(scene, "cpu", accel="array", ext=True)
    for field, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), field


@pytest.mark.parametrize("name", ["cornell_glass", "showcase", "bumpy"])
def test_closest_hit_channels_match_jax(name):
    """Random rays from inside the scene: the same winners, the pre-flip
    `front` mask and the winner's channels, exactly."""
    rs = np.random.RandomState(3)
    o = (rs.uniform(-0.9, 0.9, (3, N)) + [[0], [0], [-2.5]]).astype(
        np.float32)
    d = _unit(rs, N)
    jscene = jload_scene(name)
    jh = jgeom.ScenePrims(jscene).closest_hit(JV3(*jnp.asarray(o)),
                                              JV3(*jnp.asarray(d)))
    th = geom.ScenePrims(geom.scene_tables(load_scene(name), "cpu",
                                           ext=True)).closest_hit(
        V3(*torch.from_numpy(o)), V3(*torch.from_numpy(d)))
    found = np.asarray(jh.found)
    np.testing.assert_array_equal(th.found.numpy(), found)
    assert found.mean() > 0.5
    np.testing.assert_array_equal(th.front.numpy()[found],
                                  np.asarray(jh.front)[found])
    for ours, theirs in (("transparency", "transparency"), ("ior", "ior"),
                         ("roughness", "roughness"),
                         ("checker_scale", "checker_scale"),
                         ("tex_index", "tex_index"),
                         ("tex_scale", "tex_scale"),
                         ("nm_index", "nm_index"),
                         ("nm_strength", "nm_strength")):
        want = getattr(jh, theirs)
        want = np.zeros(N, np.float32) if want is None else np.broadcast_to(
            np.asarray(want), (N,))
        np.testing.assert_array_equal(getattr(th, ours).numpy()[found],
                                      want[found], err_msg=ours)


def test_ext_path_on_a_reference_scene_is_bit_identical():
    """Zero channels and no atlas change nothing: Cornell_Box through the
    extension path equals the reference path bit for bit."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=48, height=12, samples_per_pixel=16, max_depth=6)
    ref = PathTracer(scene, "cpu").render_frame(POSE, 5, 0)
    tr = PathTracer(scene, "cpu")
    tr.bind_tables(geom.scene_tables(scene, "cpu", tr.accel, ext=True))
    assert tr.ext and tr.atlas is not None
    ext = tr.render_frame(POSE, 5, 0)
    assert float(ref[3]) == float(ext[3])
    for a, b in zip((*ref[0], ref[1], ref[2]), (*ext[0], ext[1], ext[2])):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- frames

KW = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
SEEDS = (1001, 1002, 1003)
# Knife-edge bounds, by test: (pixels off, their summed error), the largest
# the test's seeds show on the CPU (a frame test's over its seeds; the
# error rounded up to 3 digits).
KNIFE = {"cornell_glass": (0, 0.0), "showcase": (4, 1.66),
         "step": (10, 1.51), "animated": (5, 0.678)}


@pytest.mark.parametrize("name", ["cornell_glass", "showcase"])
def test_render_frame_matches_jax_oracle(name):
    jscene = jload_scene(name).with_overrides(**KW)
    jstep = j_make_step(jscene, full_color=True, backend="jnp")
    tracer = PathTracer(load_scene(name).with_overrides(**KW), "cpu")
    for seed in SEEDS:
        j = jax.device_get(jstep(j_init_state(jscene), POSE,
                                 np.uint32(seed), np.int32(0)))
        cur, _var, total, rays, occ = tracer.render_frame(POSE, seed, 0)
        assert float(rays) == float(j.rays)
        np.testing.assert_array_equal(total.numpy(), j.state.samples)
        KnifeEdges(F_RTOL, F_ATOL).add(np.stack([c.numpy() for c in cur]),
                                       j.state.acc).check(KNIFE[name])
        assert 0.0 < float(occ) <= 1.0


def test_render_step_matches_jax_step_on_showcase():
    """Three accumulated frames through the port's render step (the sorted
    pipeline through the kernels' plain versions) against the JAX step."""
    jscene = jload_scene("showcase").with_overrides(**KW)
    jstep = j_make_step(jscene, full_color=True, backend="jnp")
    step = make_render_step(load_scene("showcase").with_overrides(**KW),
                            device="cpu")
    jstate, state = j_init_state(jscene), init_state(jscene, "cpu")
    knife = KnifeEdges(F_RTOL, F_ATOL)
    for f, seed in enumerate(SEEDS):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(seed), np.int32(f)))
        jstate = j.state
        out = step(state, POSE, seed, f)
        state = out.state
        assert float(out.rays) == float(j.rays)
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        knife.add(out.state.acc.numpy(), j.state.acc)
    knife.check(KNIFE["step"])


def test_animated_showcase_matches_jax_dynamic_step():
    """Two --animate orbit frames (t = 0, 5) on the per-frame buffer with
    its extension table against the JAX jnp step with dynamic=True."""
    jscene = jload_scene("showcase").with_overrides(**KW)
    jstep = j_make_step(jscene, backend="jnp", dynamic=True,
                        animated=ANIMATOR_KEYS["orbit"])
    scene = load_scene("showcase").with_overrides(**KW)
    step = make_render_step(scene, device="cpu", dynamic=True)
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    j0, t0 = jdyn.pack_scene(jscene), dyn.pack_scene(scene)
    knife = KnifeEdges(F_RTOL, F_ATOL)
    for t in (0, 5):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(11 + t),
                                 np.int32(0), JANIMATORS["orbit"](j0, t)))
        jstate = j.state
        out = step(state, POSE, 11 + t, 0, ANIMATORS["orbit"](t0, t))
        state = out.state
        assert float(out.rays) == float(j.rays), t
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        knife.add(out.state.acc.numpy(), j.state.acc)
    knife.check(KNIFE["animated"])


@pytest.mark.parametrize("name", EXT_SCENES)
def test_cli_renders_extension_scenes_on_cpu(name, capsys):
    assert torch_main(["--device", "cpu", "--scene", name, "--width", "32",
                       "--height", "8", "--spp", "4", "--depth", "3",
                       "--frames", "1"]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 8 and all(len(r) == 32 for r in rows)
    assert len(set("".join(rows))) > 3  # a picture, not a flat field
