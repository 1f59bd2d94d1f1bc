"""The port's block-culled traversal (``--accel grid``) against the JAX
package: the blocked scene and its group boxes, the plain closest-hit and
occlusion sweeps on random rays, whole frames against the JAX oracle, and
the CLI. The kernels' plain versions run here (the tensors lie on the CPU);
the JAX side runs its jnp oracle (its own tests/test_accel.py holds its
Pallas kernels against that oracle in interpret mode).

The blocked scene, its boxes and the sweep results must agree exactly
(rays, budgets and samples too): the JAX oracle sweeps the blocked scene
densely, and culling skips no hit near the scene (far away it skips the
f32 test's phantom hits, test_far_shadow_ray_skips_a_phantom_hit). Radiance within rtol 1e-4 / atol 1e-5,
but for the few knife-edge pixels of sphere-light scenes
(a counted few, KNIFE) and, with fog under MIS, at most 2
pixels each at most 1e-4 off (test_torch_medium.py: an ulp of XLA-CPU's
log or exp moves a direction).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from terminal_raytracer_tpu.models import Camera, load_scene as jload_scene
from terminal_raytracer_tpu.models.scene import Fog as JFog
from terminal_raytracer_tpu.ops import accel as jaccel
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.scene import Fog
from terminal_raytracer_tpu_torch.ops import accel, geometry as geom, kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
RTOL, ATOL = 1e-4, 1e-5
# Knife-edge bounds of the sphere-light frames, by scene (the grid frame)
# and by traversal (the chunked frame): (pixels off, their summed error),
# the largest the test's schedulers show on the CPU: none.
KNIFE = {"stress:48:3": (0, 0.0), "chunked grid": (0, 0.0),
         "chunked gathered": (0, 0.0)}
SCENES = ["stress:96:3", "icosphere:1", "showcase", "Cornell_Box"]


def _scenes(name, **kw):
    return (load_scene(name).with_overrides(**kw),
            jload_scene(name).with_overrides(**kw))


def _prim_key(tag, p):
    """A primitive's geometry and material as a comparable tuple."""
    geo = ((p.center, p.radius) if tag == 0 else
           (p.point, p.normal) if tag == 1 else (p.v0, p.v1, p.v2))
    return tag, geo, tuple(p.material)


@pytest.mark.parametrize("name", SCENES)
def test_blocked_scene_matches_jax(name):
    """Primitive order, pads and block boxes equal the JAX package's, and
    the group table rounds each box bound once to f32."""
    scene, jscene = _scenes(name)
    got, groups = accel.blocked_scene(scene)
    want, jgroups = jaccel.blocked_scene(jscene)
    assert ([_prim_key(t, p) for t, p in got.primitives]
            == [_prim_key(t, p) for t, p in want.primitives])
    assert [(g.aabb, len(g.prims)) for g in groups] == \
        [(g.aabb, len(g.prims)) for g in jgroups]
    assert ([_prim_key(t, p) for t, p in got.lights]
            == [_prim_key(t, p) for t, p in scene.lights])
    table = accel.group_table(groups)
    for row, g in zip(table, jgroups):
        assert row[0] == g.prims[0][0] and row[2] == len(g.prims)
        if g.aabb is None:
            assert row[3] == 0.0
        else:
            assert row[3] == 1.0
            np.testing.assert_array_equal(
                row[4:], np.float32([*g.aabb[0], *g.aabb[1]]))
    tr = PathTracer(scene, "cpu", accel="grid")
    assert tr.traversal == "grid" and tr.xt
    assert tr.tables.counts[:3] == (len(got.spheres), len(got.planes),
                                    len(got.triangles))
    np.testing.assert_array_equal(tr.tables.acc.view(-1, accel.GROUP_W),
                                  table)


def random_rays(n, lo, hi, seed=3):
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32).T
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tmax = rng.uniform(0.5, 30.0, n).astype(np.float32)
    return o, d, tmax


def _j(a):
    return JV3(*(jnp.asarray(c) for c in a))


def _t(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def assert_hits_equal(got, want, rtol=0.0, atol=0.0, n_atol=2.4e-7):
    """Every field of the port's Hit equals the JAX Hit's on the lanes
    where both found a hit (found everywhere); ior where the primitive is
    glass (the port zeroes it elsewhere). t within `rtol` and p within
    `rtol` and `atol` (0: equal), the normal within `n_atol` (by default 2
    ulp of a unit component: the JAX package normalizes with XLA's rsqrt,
    the port and its kernels with an IEEE 1 / sqrt)."""
    found = np.asarray(want.found)
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.front.numpy()[found],
                                  np.asarray(want.front)[found])
    np.testing.assert_allclose(got.t.numpy()[found], np.asarray(want.t)[found],
                               rtol=rtol, atol=0)
    for name, tol in (("p", dict(rtol=rtol, atol=atol)),
                      ("normal", dict(rtol=0, atol=n_atol))):
        for c in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, name), c).numpy()[found],
                np.asarray(getattr(getattr(want, name), c))[found],
                err_msg=name, **tol)
    vecs = ["color", "emission"]
    scal = ["reflectivity", "transparency", "roughness", "checker_scale",
            "tex_index", "tex_scale", "nm_index", "nm_scale", "nm_strength"]
    if want.checker_color is not None:
        vecs.append("checker_color")
    for name in vecs:
        for c in "xyz":
            np.testing.assert_array_equal(
                getattr(getattr(got, name), c).numpy()[found],
                np.asarray(getattr(getattr(want, name), c))[found], name)
    for name in scal:
        w = getattr(want, name)
        if w is not None:
            np.testing.assert_array_equal(getattr(got, name).numpy()[found],
                                          np.asarray(w)[found], name)
    np.testing.assert_array_equal(got.lia.numpy()[found],
                                  np.asarray(want.light_inv_area)[found])
    if want.ior is not None:
        glass = found & (np.asarray(want.transparency) > 0)
        np.testing.assert_array_equal(got.ior.numpy()[glass],
                                      np.asarray(want.ior)[glass])


@pytest.mark.parametrize("name, box", [
    ("stress:96:3", ((-14, 0.2, -26), (14, 8, 0))),
    ("icosphere:1", ((-3, -1, -8), (3, 3, 2))),
    ("showcase", ((-3, 0.1, -6), (3, 3, 2)))])
def test_closest_hit_and_occluded_match_jax_oracle(name, box):
    """The plain culled sweep (the dense sweep over the blocked tables)
    against the JAX CulledPrims oracle on 512 random rays, lane for lane;
    occlusion on random segments."""
    scene, jscene = _scenes(name)
    prims = PathTracer(scene, "cpu", accel="grid").prims
    assert isinstance(prims, accel.CulledPrims)
    jprims = jaccel.CulledPrims(jscene)
    o, d, tmax = random_rays(512, *box)
    gate = torch.ones(512, dtype=torch.bool)
    assert_hits_equal(prims.closest_hit(_t(o), _t(d), gate=gate),
                      jprims.closest_hit(_j(o), _j(d)))
    got = prims.occluded(_t(o), _t(d), geom.RAY_EPS,
                         torch.from_numpy(tmax), gate)
    want = jprims.occluded(_j(o), _j(d), geom.RAY_EPS, jnp.asarray(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 512


def test_counts_follow_the_culled_sweep():
    """The plain version's counters: every sweep either sweeps or skips
    each guarded block it reaches, the tests are the swept blocks'
    primitives and the planes', and culling skips most blocks of the
    stress field."""
    scene = load_scene("stress:96:3")
    prims = PathTracer(scene, "cpu", accel="grid").prims
    o, d, tmax = random_rays(256, (-14, 0.2, -26), (14, 8, 0))
    gate = torch.ones(256, dtype=torch.bool)
    prims.ops = torch.zeros((), dtype=torch.float64)
    prims.closest_hit(_t(o), _t(d), gate=gate)
    sweeps, swept, skipped, tests = prims.stats.tolist()
    n_blocks = int(prims._guarded.sum())
    assert sweeps == 256 and swept + skipped == 256 * n_blocks
    assert tests == swept * accel.BLOCK + 256 * len(scene.planes)
    assert skipped > swept
    ops = float(prims.ops)
    assert ops == (tests - 256) * geom.TEST_OPS[0] \
        + 256 * geom.TEST_OPS[1] + accel.SLAB_OPS * (swept + skipped) \
        + accel.SLAB_SETUP_OPS * 256
    prims.ops = None


def _off(got, want):
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    return bad.reshape(-1, *bad.shape[-2:]).any(0)


@pytest.mark.parametrize("name, over, transport, seed", [
    ("stress:48:3", {}, "reference", 7),
    ("Cornell_Box", {"fog": 0.15}, "mis", 11)])
def test_render_frame_matches_jax_oracle(name, over, transport, seed):
    """The plain whole frame and the sorted, regen and lockstep schedulers
    through the grid kernels' plain versions against the JAX PathTracer
    with accel 'grid': rays and samples exact, radiance within the
    tolerance (module docstring)."""
    kw = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
    scene = load_scene(name).with_overrides(**kw, **(
        {"fog": Fog(density=over["fog"])} if over else {}))
    jscene = jload_scene(name).with_overrides(**kw, **(
        {"fog": JFog(density=over["fog"])} if over else {}))
    jt = jtracer.PathTracer(jscene, accel="grid", transport=transport)
    jcur, jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(seed), np.int32(0)))
    tr = PathTracer(scene, "cpu", accel="grid", transport=transport)
    assert (tr.chunk_base, tr.chunk_extra) == (jt.chunk_base, jt.chunk_extra)
    assert (jtot > tr.base_samples).any()
    plain = tr.render_frame(POSE, seed, 0)
    piped = kernels.make_sorted_render_frame(tr)(POSE, seed, 0)
    single = [kernels.make_render_frame(tr, mode)(POSE, seed, 0)
              for mode in ("regen", "lockstep")]
    for cur, var, tot, rays, occ in [plain, piped] + single:
        assert float(rays) == float(np.asarray(jrays).sum())
        np.testing.assert_array_equal(tot.numpy(), jtot)
        off = _off(np.stack([c.numpy() for c in cur]), np.stack(jcur))
        if over:
            assert off.sum() <= 2
            err = np.abs(np.stack([c.numpy() for c in cur]) - np.stack(jcur))
            assert err.max() <= 1e-4
        else:
            KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                                       np.stack(jcur)).check(KNIFE[name])
    for out in [piped] + single:
        _assert_same_frame(plain, out)


def _assert_same_frame(a, b):
    """Two frames' current, variance and samples equal, bit for bit."""
    for x, y in zip((*a[0], *a[1:3]), (*b[0], *b[1:3])):
        assert torch.equal(x, y)


def test_far_shadow_ray_skips_a_phantom_hit():
    """Far from the scene the f32 sphere test is fuzzy: a shadow ray from a
    floor point near the horizon (|o| ~ 9000) toward the light reports a
    hit on a sphere it misses by 1.9 units (radius 0.4), outside the
    block's padded box. The dense sweep (the JAX oracle) counts it as a
    blocker; the culled sweep, as the kernels run it, skips the block."""
    scene = load_scene("stress:1024")
    tr = PathTracer(scene, "cpu", accel="grid")
    dense = geom.ScenePrims(tr.tables)
    o = _t(np.float32([[-4896.11279296875], [0.0010000000474974513],
                       [7828.30908203125]]))
    d = _t(np.float32([[0.5297151803970337], [0.001034751534461975],
                       [-0.8481749296188354]]))
    t_max = torch.tensor([9240.76953125])
    gate = torch.ones(1, dtype=torch.bool)
    hits = dense._tests(o, d, geom.RAY_EPS, t_max, blocked=True)[0]
    assert torch.nonzero(hits).flatten().tolist() == [961]
    c = tr.tables.sph[961, :3].double()
    oo = torch.tensor([c[0] for c in o], dtype=torch.float64)
    dd = torch.tensor([c[0] for c in d], dtype=torch.float64)
    miss = torch.linalg.norm(oo + dd * torch.dot(c - oo, dd) - c)
    assert float(miss) > 4 * float(tr.tables.sph[961, 3].sqrt())
    assert bool(dense.occluded(o, d, geom.RAY_EPS, t_max, gate))
    assert not bool(tr.prims.occluded(o, d, geom.RAY_EPS, t_max, gate))


def test_grid_equals_the_dense_sweep_over_the_blocked_scene():
    """Near the scene culling skips no hit: the grid tracer's frame equals
    the baked tracer's over the blocked scene with xt tables, bit for
    bit."""
    scene = load_scene("stress:48:3").with_overrides(
        width=32, height=8, samples_per_pixel=8, max_depth=3)
    grid = PathTracer(scene, "cpu", accel="grid")
    blocked, _ = accel.blocked_scene(scene)
    dense = PathTracer(blocked, "cpu", accel="baked")
    dense.bind_tables(geom.scene_tables(blocked, "cpu", "baked", xt=True))
    for a, b in zip(grid.render_frame(POSE, 3, 0)[:4],
                    dense.render_frame(POSE, 3, 0)[:4]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_cli_renders_with_accel_grid(capsys):
    assert torch_main(["--device", "cpu", "--accel", "grid", "--scene",
                       "stress:48:3", "--width", "32", "--height", "8",
                       "--spp", "4", "--depth", "2", "--frames", "1"]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 8 and len(set("".join(rows))) > 3


def test_accel_grid_animated_takes_the_dynamic_path():
    """Under --animate the grid is ignored (the JAX package's DynPrims):
    the step equals the dynamic baked step, bit for bit."""
    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    scene = load_scene("stress:48:3").with_overrides(
        width=32, height=8, samples_per_pixel=8, max_depth=3)
    outs = []
    for acc in ("grid", "baked"):
        eng = Engine(scene, full_color=True, device="cpu", deterministic=5,
                     accel=acc, animate="orbit")
        assert eng.step.tracer.traversal is None
        outs.append([eng.render_one(eng.frame_count) for _ in range(2)])
    for a, b in zip(*outs):
        assert torch.equal(a.rgb, b.rgb)
        assert float(a.rays) == float(b.rays)


@pytest.mark.parametrize("accel", ["grid", "gathered"])
def test_explicit_base_chunks_match_jax_oracle(accel):
    """An explicit base chunk split under either opt-in traversal (the
    chunked kernel A over it): resolved as the JAX PathTracer resolves it,
    and the plain whole frame and every scheduler's frame against the JAX
    oracle: rays and samples exact, radiance within the tolerance (module
    docstring), one frame bit for bit."""
    kw = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
    scene = load_scene("stress:48:3").with_overrides(**kw)
    jt = jtracer.PathTracer(jload_scene("stress:48:3").with_overrides(**kw),
                            accel=accel, chunk_base=2)
    jcur, jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(5), np.int32(0)))
    tr = PathTracer(scene, "cpu", accel=accel, chunk_base=2)
    assert (tr.traversal, tr.chunk_base, tr.chunk_extra) == (
        accel, jt.chunk_base, jt.chunk_extra)
    assert tr.n_base_chunks == 2 and (jtot > tr.base_samples).any()
    plain = tr.render_frame(POSE, 5, 0)
    outs = [kernels.make_render_frame(tr, mode)(POSE, 5, 0)
            for mode in kernels.MODES]
    for cur, var, tot, rays, occ in [plain] + outs:
        assert float(rays) == float(np.asarray(jrays).sum())
        np.testing.assert_array_equal(tot.numpy(), jtot)
        KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                                   np.stack(jcur)).check(
                                       KNIFE[f"chunked {accel}"])
        assert 0.0 < float(occ) <= 1.0
    for out in outs:
        _assert_same_frame(plain, out)
