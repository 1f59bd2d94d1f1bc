"""The port's transports (unbiased, MIS) and one-light NEE against the JAX
package: the fuzz lobe's pdf, the light-inverse-area channel and the pick
table lane by lane and value by value, one-light NEE estimates (pick index
and 1/p weight) lane by lane, whole frames and render steps against the
jnp oracle (``PathTracer(..., transport=...)``), one frame against the
Pallas sorted scheduler in interpret mode, the xt path with every gate off
against the reference path, and the CLI.

Inputs come from numpy seeds and go through both packages. RNG states
must agree bit for bit; values to rtol 1e-5 / atol 1e-6 (XLA-CPU rounds
sqrt, sin, cos and exp by an ulp otherwise than PyTorch on the CPU, and
contracts multiply-adds). Frames (64x16, 8 spp, depth 3, below the
roulette start) must agree in owed rays and per-pixel samples; radiance
within rtol 1e-4 / atol 1e-5 except on knife-edge pixels, at most 2 in a
frame or a run of steps. An ulp of those transcendentals moves a sphere
light's sampled point (the lights:4 spheres), which moves one sample's
radiance by an ulp-sized step: such a pixel is at most 1e-4 off. On
showcase under 'mis' it moves a refracted or fuzzed direction across the
edge of a glass or rough-metal sphere, so one of the frame's 8 samples
sees the other side: such a pixel is at most 1/8 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.models import scene as jscene_mod
from terminal_raytracer_tpu.ops import dynamic as jdyn
from terminal_raytracer_tpu.ops import geometry as jgeom
from terminal_raytracer_tpu.ops import pallas_kernel
from terminal_raytracer_tpu.ops import sampling as jsamp
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models import scene as scene_mod
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops import sampling as tsamp
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
KNIFE_ATOL = 1e-4  # how far an ulp-sized knife edge may move a pixel
KW = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
SEEDS = (1001, 1002)


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _lights_cfg(light_sample="all", tri=True, powers=(6.0, 1.5, 0.4)):
    """Floor and two diffuse spheres lit by small sphere lights and (tri)
    a vertical triangle panel last: one-light NEE over both light kinds
    (the fixture of tests/test_lightsample.py)."""
    spheres, tris = [], []
    for i, p in enumerate(powers):
        x, y, z = -3.0 + 3.0 * i, 3.5 + 0.5 * (i % 2), -6.0 - 1.5 * i
        if tri and i == len(powers) - 1:
            tris.append({"v0": [x - 0.8, y - 0.8, z],
                         "v1": [x + 0.8, y - 0.8, z],
                         "v2": [x, y + 0.8, z], "color": [0, 0, 0],
                         "emission": [p, p, p], "reflectivity": 0.0})
        else:
            spheres.append({"center": [x, y, z], "radius": 0.5,
                            "color": [1, 1, 1], "emission": [p, p, p],
                            "reflectivity": 0.0})
    spheres += [{"center": [-1.0, 0.8, -7.0], "radius": 0.8,
                 "color": [0.8, 0.4, 0.3], "emission": [0, 0, 0],
                 "reflectivity": 0.0},
                {"center": [1.5, 0.6, -6.0], "radius": 0.6,
                 "color": [0.3, 0.6, 0.8], "emission": [0, 0, 0],
                 "reflectivity": 0.0}]
    return {"width": 48, "height": 12, "samples_per_pixel": 4,
            "max_depth": 4, "frames_to_accumulate": 1,
            "camera": {"fov_degrees": 55.0, "char_aspect_ratio": 1.0},
            "spheres": spheres, "triangles": tris,
            "planes": [{"point": [0, 0, 0], "normal": [0, 1, 0],
                        "color": [0.6, 0.6, 0.6], "emission": [0, 0, 0],
                        "reflectivity": 0.0}],
            "light_sample": light_sample}


def _both(name, **over):
    """(JAX scene, port scene) by packaged name or "mixed-<mode>" (the
    fixture above), with overrides."""
    if name.startswith("mixed"):
        cfg = _lights_cfg(name.split("-")[1])
        return (jscene_mod.scene_from_dict(cfg).with_overrides(**over),
                scene_mod.scene_from_dict(cfg).with_overrides(**over))
    return (jload_scene(name).with_overrides(**over),
            load_scene(name).with_overrides(**over))


# ------------------------------------------------------------ lane math


def test_fuzz_pdf_matches_jax():
    rs = np.random.RandomState(0)
    cos_r = rs.uniform(-0.2, 1.0, N).astype(np.float32)
    rough = rs.choice([0.0, 0.05, 0.3, 0.7, 1.0], N).astype(np.float32)
    cos_r[:8] = np.sqrt(1.0 - rough[:8] ** 2)  # on the cone's edge
    want = np.asarray(jsamp.fuzz_pdf(jnp.asarray(cos_r), jnp.asarray(rough)))
    got = tsamp.fuzz_pdf(torch.from_numpy(cos_r), torch.from_numpy(rough))
    _close(got, want)
    assert (want > 0).mean() > 0.15 and (want == 0).any()


@pytest.mark.parametrize("name", ["Cornell_Box", "demo", "scene2", "lights:4",
                                  "mixed-all", "showcase"])
def test_light_inv_area_channel_matches_jax(name):
    jscene, scene = _both(name)
    want = np.asarray(jgeom.ScenePrims(jscene)._light_inv_area, np.float32)
    np.testing.assert_array_equal(geom.light_inv_area(scene), want)
    assert (want > 0).any()
    tables = geom.scene_tables(scene, "cpu", xt=True)
    assert tables.has_xt and tables.ext.shape[1] == geom.XT_W
    np.testing.assert_array_equal(tables.ext[:, geom.X_LIA].numpy(), want)


def test_closest_hit_lia_matches_jax():
    """Rays from around the Cornell box toward its ceiling light: front
    faces see 1 / area, back faces and other primitives 0, as in the JAX
    sweep."""
    rs = np.random.RandomState(1)
    jscene, scene = _both("Cornell_Box")
    light = scene.lights[0][1]
    target = np.asarray(light.v0, np.float32)[:, None] + rs.uniform(
        -0.3, 0.3, (3, N)).astype(np.float32)
    o = target + np.stack([rs.uniform(-0.5, 0.5, N),
                           rs.uniform(-1.5, 0.2, N),
                           rs.uniform(-0.5, 0.5, N)]).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    jh = jgeom.ScenePrims(jscene).closest_hit(JV3(*jnp.asarray(o)),
                                              JV3(*jnp.asarray(d)))
    th = geom.ScenePrims(geom.scene_tables(scene, "cpu", xt=True)).closest_hit(
        V3(*torch.from_numpy(o)), V3(*torch.from_numpy(d)))
    found = np.asarray(jh.found)
    np.testing.assert_array_equal(th.found.numpy(), found)
    want = np.asarray(jh.light_inv_area)[found]
    np.testing.assert_array_equal(th.lia.numpy()[found], want)
    assert (want > 0).any() and (want == 0).any()


PICK_CASES = [("mixed-power", "power"), ("mixed-uniform", "uniform"),
              ("lights:4", "power"), ("Cornell_Box", "power")]


@pytest.mark.parametrize("name, mode", PICK_CASES)
def test_pick_table_matches_jax_light_pick(name, mode):
    """The baked pick table (f64 folding, rounded once) against the JAX
    PathTracer's _light_pick over its baked lights."""
    jscene, scene = _both(name, light_sample=mode)
    jtr = jtracer.PathTracer(jscene)
    probs, cums, inv_total = jtr._light_pick(jtr.lights)
    want = np.array([*probs, *cums, inv_total or 0.0], np.float32)
    tr = PathTracer(scene, "cpu")
    assert tr.one_light and tr.nee_sweeps == 1
    np.testing.assert_array_equal(tr.tables.pick.numpy(), want)


def test_runtime_pick_table_matches_jax_traced_light_pick():
    """An animated scene's pick table: the f32 steps of _light_pick over
    traced values (the JAX package's dynamic mode), on the host."""
    jscene, scene = _both("mixed-power")
    arrays = ANIMATORS["pulse"](dyn.pack_scene(scene), 3)
    jtr = jtracer.PathTracer(jscene, dynamic=True)
    jtr.prims.bind({k: jnp.asarray(v) for k, v in arrays.items()})
    lights = [jtracer._Light(*l) for l in jtr.prims.light_list()]
    probs, cums, inv_total = jtr._light_pick(lights)
    want = np.array([*map(float, probs), *map(float, cums), float(inv_total)],
                    np.float32)
    topo = dyn.topology(scene, xt=True, pick="power")
    np.testing.assert_array_equal(dyn.pick_table(arrays, topo), want)
    tables = dyn.tables_from_packed(arrays, topo, "cpu")
    np.testing.assert_array_equal(tables.pick.numpy(), want)


@pytest.mark.parametrize("name", ["lights:4", "mixed-power", "Cornell_Box"])
def test_animated_xt_tables_at_t0_equal_the_static_ones(name):
    """The per-frame lia channel at t = 0 equals the static one (the
    baked 4 pi r^2 and DynPrims' (4 pi r) r round alike here); the pick
    tables agree to an ulp (f32 steps against the baked f64 folding)."""
    _, scene = _both(name, light_sample="power")
    topo = dyn.topology(scene, geom.uses_extensions(scene), True, "power")
    got = dyn.tables_from_packed(dyn.pack_scene(scene), topo, "cpu")
    want = geom.scene_tables(scene, "cpu", accel="array", xt=True,
                             pick="power")
    for field, a, b in zip(want._fields[1:], got[1:], want[1:]):
        assert a.shape == b.shape, field
        if field == "pick":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        else:
            assert torch.equal(a, b), field


NEE_CASES = [("mixed", "uniform", "reference"),
             ("mixed", "power", "reference"), ("mixed", "power", "mis"),
             ("lights:4", "power", "mis")]


@pytest.mark.parametrize("name, mode, transport", NEE_CASES)
def test_one_light_nee_matches_jax(name, mode, transport):
    """One-light NEE lane by lane on random surface points: the selection
    draw and the pair (RNG states bit-equal), the picked light's estimate
    with its 1/p weight (and under 'mis' the pick in the NEE density)."""
    rs = np.random.RandomState(2)
    jscene, scene = _both(name if name != "mixed" else f"mixed-{mode}",
                          light_sample=mode)
    jtr = jtracer.PathTracer(jscene, transport=transport)
    tr = PathTracer(scene, "cpu", transport=transport)
    assert jtr.one_light and tr.one_light
    p = (rs.uniform(-4.0, 4.0, (3, N)) * [[1], [0.5], [1]]
         + [[0], [1.5], [-7]]).astype(np.float32)
    n = rs.normal(size=(3, N)).astype(np.float32)
    n = (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)
    color = rs.uniform(0.2, 1.0, (3, N)).astype(np.float32)
    att = rs.uniform(0.5, 1.0, (3, N)).astype(np.float32)
    refl = rs.uniform(0.0, 0.5, N).astype(np.float32)
    s = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    gate = rs.rand(N) < 0.8
    kw = {}
    if transport == "mis":
        kw = dict(refl=jnp.asarray(refl))
    js, jd = jtr.direct_light(jnp.asarray(s), JV3(*jnp.asarray(p)),
                              JV3(*jnp.asarray(n)), JV3(*jnp.asarray(color)),
                              JV3(*jnp.asarray(att)), jnp.asarray(gate), **kw)
    ts, td = tr.direct_light(
        torch.from_numpy(s.astype(np.int64)), V3(*torch.from_numpy(p)),
        V3(*torch.from_numpy(n)), V3(*torch.from_numpy(color)),
        V3(*torch.from_numpy(att)), torch.from_numpy(gate),
        torch.from_numpy(refl) if transport == "mis" else None)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    want = _np3(jd)
    _close(_np3(td), want)
    assert (want.max(0) > 0).mean() > 0.1


# ----------------------------------------------------------------- frames

FRAME_CASES = [("Cornell_Box", "unbiased", {}), ("Cornell_Box", "mis", {}),
               ("showcase", "mis", {}),
               ("lights:4", "reference", {"light_sample": "uniform"}),
               ("lights:4", "reference", {"light_sample": "power"}),
               ("mixed-power", "mis", {})]
# One sample of the frame's 8 across a glass or rough-metal edge (docstring).
EDGE_ATOL = {"showcase": 1.0 / KW["samples_per_pixel"]}


def _knife_edges(acc, want, atol=KNIFE_ATOL):
    """The pixels off by more than the frame tolerance, once no pixel is
    off by more than `atol`."""
    err = np.abs(acc - want)
    assert err.max() <= atol, f"a pixel is {err.max()} off"
    return (err > F_ATOL + F_RTOL * np.abs(want)).any(0)


@pytest.mark.parametrize("name, transport, over", FRAME_CASES,
                         ids=[f"{n}-{t}-{o.get('light_sample', 'all')}"
                              for n, t, o in FRAME_CASES])
def test_render_frame_matches_jax_oracle(name, transport, over):
    jscene, scene = _both(name, **KW, **over)
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
        bad = _knife_edges(np.stack([c.numpy() for c in cur]), j.state.acc,
                           EDGE_ATOL.get(name, KNIFE_ATOL))
        assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"
        assert 0.0 < float(occ) <= 1.0


def test_render_step_matches_jax_step_with_one_light_mis():
    """Three accumulated frames through the port's render step (the sorted
    pipeline through the kernels' plain versions) against the JAX step."""
    jscene, scene = _both("mixed-power", **KW)
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


def test_animated_one_light_mis_matches_jax_dynamic_step():
    """--animate pulse on a one-light MIS scene: the per-frame lia channel
    and pick table against the JAX dynamic step (every value traced)."""
    jscene, scene = _both("mixed-power", **KW)
    jstep = j_make_step(jscene, backend="jnp", dynamic=True, transport="mis")
    step = make_render_step(scene, device="cpu", dynamic=True,
                            transport="mis")
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    j0, t0 = jdyn.pack_scene(jscene), dyn.pack_scene(scene)
    for t in (0, 5):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(11 + t),
                                 np.int32(0), ANIMATORS["pulse"](j0, t)))
        jstate = j.state
        out = step(state, POSE, 11 + t, 0, ANIMATORS["pulse"](t0, t))
        state = out.state
        assert float(out.rays) == float(j.rays), t
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        bad = _knife_edges(out.state.acc.numpy(), j.state.acc)
        assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"


def test_pipeline_matches_jax_pallas_sorted_mis():
    """The port's sorted pipeline (plain versions) against the JAX
    package's Pallas sorted scheduler under 'mis' in interpret mode."""
    over = dict(width=64, height=8, samples_per_pixel=8, max_depth=3)
    jscene, scene = _both("Cornell_Box", **over)
    pf = jax.jit(pallas_kernel.make_render_frame(
        jscene, mode="sorted", transport="mis", interpret=True))
    cur_p, _var, tot_p, rays_p, _occ = pf(POSE, np.uint32(11), np.int32(0))
    tr = PathTracer(scene, "cpu", transport="mis")
    cur, _v, tot, rays, _o = kernels.make_sorted_render_frame(tr)(POSE, 11, 0)
    assert float(rays) == float(rays_p)
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_p))
    bad = _knife_edges(np.stack([c.numpy() for c in cur]), _np3(cur_p))
    assert bad.sum() <= KNIFE_PIXELS, f"{bad.sum()} pixels off"


def test_one_light_occupancy_charges_one_shadow_sweep():
    """Cornell_Box at depth 3 keeps every lane busy every iteration, so
    the occupancy is exactly 1 when an iteration owes 1 + nee_sweeps
    sweeps (one-light: 2, not the 1 + n_lights = 3 of the 'all' loop),
    in the plain frame and through the sorted pipeline."""
    scene = load_scene("Cornell_Box").with_overrides(**KW,
                                                     light_sample="power")
    tr = PathTracer(scene, "cpu")
    assert tr.one_light and tr.n_lights == 2 and tr.nee_sweeps == 1
    assert float(tr.render_frame(POSE, 5, 0)[4]) == 1.0
    assert float(kernels.make_sorted_render_frame(tr)(POSE, 5, 0)[4]) == 1.0


def test_xt_path_with_every_gate_off_is_bit_identical():
    """xt tables (the lia column, no pick table) and every gate off: the
    xt plain path equals the reference path bit for bit, frame and sorted
    pipeline alike."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=48, height=12, samples_per_pixel=16, max_depth=6)
    ref = PathTracer(scene, "cpu")
    xt = PathTracer(scene, "cpu")
    xt.bind_tables(geom.scene_tables(scene, "cpu", xt.accel, xt=True))
    assert xt.xt and xt.ext and not ref.xt
    for render in (lambda t: t.render_frame(POSE, 5, 0),
                   lambda t: kernels.make_sorted_render_frame(t)(POSE, 5, 0)):
        a, b = render(ref), render(xt)
        assert float(a[3]) == float(b[3])
        for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
            assert torch.equal(x, y)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("flags", [["--unbiased"], ["--mis"],
                                   ["--scene", "lights:4", "--light-sample",
                                    "power"],
                                   ["--scene", "lights:4", "--light-sample",
                                    "uniform", "--mis"]])
def test_cli_renders_transport_flags_on_cpu(flags, capsys):
    assert torch_main(["--device", "cpu", "--width", "32", "--height", "8",
                       "--spp", "4", "--depth", "3", "--frames", "1",
                       *flags]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 8 and all(len(r) == 32 for r in rows)
    assert len(set("".join(rows))) > 3  # a picture, not a flat field


def test_cli_refuses_mis_with_unbiased(capsys):
    assert torch_main(["--device", "cpu", "--mis", "--unbiased",
                       "--frames", "1"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        torch_main(["--device", "cpu", "--light-sample", "brightest"])
    with pytest.raises(ValueError, match="unknown transport"):
        PathTracer(load_scene("Cornell_Box"), "cpu", transport="bdpt")
