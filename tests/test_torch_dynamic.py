"""The port's animated path (runtime scene values) against the JAX package:
the packed layout, the per-frame scene buffer, animated frame sequences of
the render step against the JAX step with ``dynamic=True`` on the jnp
backend, the animated engine and the --animate CLI.

At t = 0 the per-frame buffer (ops/dynamic.py tables_from_packed) must
equal the static ``scene_tables(scene, accel='array')`` bit for bit. Frame
sequences must agree in every decision (owed rays, per-pixel samples);
radiance within rtol 1e-4 / atol 1e-5, except on knife-edge pixels of
sphere-light scenes (test_torch_slice.py): a counted few, bounded by
their count and summed error (KNIFE, tests/test_torch_knife.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera, list_scenes
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.models.animate import ANIMATOR_KEYS
from terminal_raytracer_tpu.models.animate import ANIMATORS as JANIMATORS
from terminal_raytracer_tpu.ops import dynamic as jdyn
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models import scene as scene_mod
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.runtime.engine import Engine
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE = Camera().pose()
RTOL, ATOL = 1e-4, 1e-5
TABLE_SCENES = ["Cornell_Box", "demo", "scene2", "mesh_demo", "stress:120:7",
                "icosphere:2"]


def _scene(name, w=64, h=16, spp=8, depth=3):
    return load_scene(name).with_overrides(width=w, height=h,
                                           samples_per_pixel=spp,
                                           max_depth=depth)


@pytest.mark.parametrize("name", list_scenes() + ["stress:120:7",
                                                  "icosphere:1"])
def test_packed_layout_matches_jax(name):
    scene, jscene = load_scene(name), jload_scene(name)
    assert dyn.scene_keys(scene) == jdyn.scene_keys(jscene)
    got, want = dyn.pack_scene(scene), jdyn.pack_scene(jscene)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", TABLE_SCENES)
def test_per_frame_tables_at_t0_equal_the_static_tables(name):
    scene = load_scene(name)
    got = dyn.tables_from_packed(dyn.pack_scene(scene), dyn.topology(scene),
                                 "cpu")
    want = geom.scene_tables(scene, "cpu", accel="array")
    for field, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape, field
        assert torch.equal(a, b), field


def test_per_frame_tables_follow_the_animation():
    """An orbit moves the spheres' centers and keeps their radii; the
    buffer's derived values are recomputed from the moved values."""
    scene = load_scene("stress:120:7")
    a5 = ANIMATORS["orbit"](dyn.pack_scene(scene), 5)
    t5 = dyn.tables_from_packed(a5, dyn.topology(scene), "cpu")
    np.testing.assert_array_equal(t5.sph[:, 0].numpy(), a5["s_cx"])
    np.testing.assert_array_equal(t5.sph[:, 2].numpy(), a5["s_cz"])
    np.testing.assert_array_equal(t5.sph[:, 3].numpy(),
                                  a5["s_r"] * a5["s_r"])
    assert t5.lights[0, 5] == a5["s_cx"][0]  # the light moved with it


CASES = [(name, anim) for name in ("Cornell_Box", "stress:120:7")
         for anim in ("orbit", "pulse", "bob")]
# Knife-edge bounds of the sphere-light scene's three frames: (pixels off,
# their summed error), as each animator's seeds show them on the CPU (the
# error rounded up to 3 digits); the triangle-light Cornell_Box has none.
KNIFE = {"orbit": (5, 0.00725), "pulse": (2, 0.000782), "bob": (5, 0.0011)}


@pytest.mark.parametrize("name, anim", CASES,
                         ids=[f"{n}-{a}" for n, a in CASES])
def test_animated_steps_match_jax_dynamic_step(name, anim):
    """Frames at t = 0, 5, 9 through the port's step (the sorted pipeline on
    the per-frame buffer; stress:120:7 takes the array sweep) against the
    JAX jnp step with dynamic=True and the animator's key set."""
    scene = _scene(name)
    jscene = jload_scene(name).with_overrides(
        width=64, height=16, samples_per_pixel=8, max_depth=3)
    jstep = j_make_step(jscene, backend="jnp", dynamic=True,
                        animated=ANIMATOR_KEYS[anim])
    step = make_render_step(scene, device="cpu", dynamic=True)
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    j0, t0 = jdyn.pack_scene(jscene), dyn.pack_scene(scene)
    bound = (KNIFE[anim] if scene.lights[0][0] == scene_mod.SPHERE
             else (0, 0.0))
    knife = KnifeEdges(RTOL, ATOL)
    for t in (0, 5, 9):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(11 + t),
                                 np.int32(0), JANIMATORS[anim](j0, t)))
        jstate = j.state
        out = step(state, POSE, 11 + t, 0, ANIMATORS[anim](t0, t))
        state = out.state
        assert float(out.rays) == float(j.rays), t
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        knife.add(out.state.acc.numpy(), j.state.acc)
    knife.check(bound)


def test_dynamic_chunked_pipeline_equals_plain_frame():
    """The animated, chunk-split pipeline (kernels' plain versions) and the
    plain whole frame on the same per-frame buffer: bit for bit."""
    scene = _scene("stress:120:7")
    tr = PathTracer(scene, "cpu", dynamic=True, chunk_base=2, chunk_extra=2)
    arrays = ANIMATORS["orbit"](dyn.pack_scene(scene), 7)
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, 3, 0, arrays)
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, 3, 0)
    assert float(rays) == float(prays)
    for a, b in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a, b)
    static = PathTracer(scene, "cpu", chunk_base=2, chunk_extra=2)
    assert float(static.render_frame(POSE, 3, 0)[3]) != float(prays)


def test_animated_engine_renders_fresh_frames():
    eng = Engine(_scene("Cornell_Box", 32, 8, 4, 2), full_color=True,
                 device="cpu", deterministic=3, animate="orbit")
    imgs = []
    for _ in range(3):
        out = eng.render_one(eng.frame_count)
        imgs.append(out.rgb.numpy().copy())
    assert eng._anim_t == 3 and eng.frame_count == 0
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])
    with pytest.raises(ValueError, match="unknown animator"):
        Engine(_scene("Cornell_Box", 8, 4, 4, 2), device="cpu",
               animate="spin")


def test_cli_animates_a_stress_scene():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "terminal_raytracer_tpu_torch", "--device",
         "cpu", "--scene", "stress:120:7", "--accel", "array", "--animate",
         "orbit", "--width", "32", "--height", "8", "--spp", "8", "--depth",
         "3", "--frames", "2", "--verbose"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rows = r.stdout.splitlines()[1:]
    assert len(rows) == 8 and all(len(row) == 32 for row in rows)
    assert "[headless] 2 frames" in r.stderr
