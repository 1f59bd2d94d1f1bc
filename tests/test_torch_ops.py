"""The PyTorch port's math against the JAX package, lane by lane.

Inputs come from numpy seeds and go through both packages. RNG functions
must agree bit for bit (including states >= 2**31, where the u32 -> f32
conversion double-rounds); samplers and sweeps must agree exactly in every
decision (RNG states, found, the winning primitive) and to rtol 1e-5 in
values: XLA-CPU and PyTorch-CPU round sin/cos/rsqrt differently by an ulp
and XLA contracts multiply-adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import load_scene
from terminal_raytracer_tpu.ops import geometry as jgeom
from terminal_raytracer_tpu.ops import rng as jrng
from terminal_raytracer_tpu.ops import sampling as jsamp
from terminal_raytracer_tpu.ops import tonemap as jtm
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu_torch.ops import geometry as tgeom
from terminal_raytracer_tpu_torch.ops import rng as trng
from terminal_raytracer_tpu_torch.ops import sampling as tsamp
from terminal_raytracer_tpu_torch.ops import tonemap as ttm
from terminal_raytracer_tpu_torch.ops import vecmath as tvm
from terminal_raytracer_tpu_torch.ops.vecmath import V3 as TV3
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

N = 4096
SCENES = ["Cornell_Box", "demo", "scene2"]


def _states(seed=0, n=N):
    s = np.random.RandomState(seed).randint(0, 2**32, size=n, dtype=np.uint64)
    s[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    return s.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(t):
    return np.asarray(t)


def _jv(a):
    return JV3(*(jnp.asarray(c, jnp.float32) for c in a))


def _tv(a):
    return TV3(*(torch.from_numpy(np.asarray(c, np.float32)) for c in a))


def _close(t_vals, j_vals, rtol=1e-5, atol=1e-6):
    for a, b in zip(t_vals, j_vals):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _unit_dirs(rs, n):
    d = rs.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


# --------------------------------------------------------------------- rng


def test_pcg_hash_bit_exact():
    s = _states(1)
    np.testing.assert_array_equal(
        trng.pcg_hash(_t(s)).numpy(), _np(jrng.pcg_hash(jnp.asarray(s))))


def test_u32_to_f32_matches_int32_wrap():
    s = _states(2)
    got = trng.u32_to_f32(_t(s)).numpy()
    np.testing.assert_array_equal(got, _np(jrng.u32_to_f32(jnp.asarray(s))))
    assert got.dtype == np.float32


@pytest.mark.parametrize("gated", [False, True])
def test_next_f32_and_pair_bit_exact(gated):
    s = _states(3)
    gate = np.random.RandomState(4).rand(N) < 0.5 if gated else None
    tg = None if gate is None else torch.from_numpy(gate)
    jg = None if gate is None else jnp.asarray(gate)
    ts, tv = trng.next_f32(_t(s), tg)
    js, jv = jrng.next_f32(jnp.asarray(s), jg)
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    ts, ta, tb = trng.next_f32_pair(_t(s), tg)
    js, ja, jb = jrng.next_f32_pair(jnp.asarray(s), jg)
    for a, b in ((ts, js), (ta, ja), (tb, jb)):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_advance_sample_and_seed_pixel_bit_exact():
    s = _states(5)
    samp = np.random.RandomState(6).randint(0, 200, size=N)
    gate = np.random.RandomState(7).rand(N) < 0.5
    got = trng.advance_sample(_t(s), _t(samp), torch.from_numpy(gate))
    want = jrng.advance_sample(jnp.asarray(s), jnp.asarray(samp, jnp.int32),
                               jnp.asarray(gate))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    pix = np.arange(N)
    for seed, frame in ((42, 0), (2**32 - 5, 7), (123456789, 2**31 - 1)):
        got = trng.seed_pixel(_t(pix), seed, frame)
        want = jrng.seed_pixel(jnp.asarray(pix, jnp.uint32),
                               jnp.uint32(seed), jnp.int32(frame))
        np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------- sampling


def test_cosine_hemisphere_and_basis():
    rs = np.random.RandomState(8)
    n = _unit_dirs(rs, N)
    s = _states(9)
    gate = rs.rand(N) < 0.7
    ts, td = tsamp.cosine_hemisphere(_t(s), _tv(n), torch.from_numpy(gate))
    js, jd = jsamp.cosine_hemisphere(jnp.asarray(s), _jv(n), jnp.asarray(gate))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    _close(td, jd)
    tu, tw = tsamp.orthonormal_basis(_tv(n))
    ju, jw = jsamp.orthonormal_basis(_jv(n))
    _close(list(tu) + list(tw), list(ju) + list(jw))


def test_light_point_samplers():
    s = _states(10)
    ts, tp, tn = tsamp.sphere_light_point(
        _t(s), TV3(torch.tensor(0.5), torch.tensor(4.0), torch.tensor(-7.0)),
        torch.tensor(1.25))
    js, jp, jn, _area = jsamp.sphere_light_point(
        jnp.asarray(s), JV3(0.5, 4.0, -7.0), 1.25)
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    _close(list(tp) + list(tn), list(jp) + list(jn))
    v = [(-0.5, 1.9, -3.0), (0.5, 1.9, -3.0), (0.0, 1.9, -2.5)]
    ts, tp = tsamp.triangle_light_point(
        _t(s), *(TV3(*(torch.tensor(c) for c in p)) for p in v))
    js, jp = jsamp.triangle_light_point(jnp.asarray(s), *(JV3(*p) for p in v))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    _close(tp, jp)


# ------------------------------------------------------------------ sweeps


def _random_rays(scene, seed):
    """Origins spread over the scene's extent, random unit directions."""
    rs = np.random.RandomState(seed)
    c = scene.centroid()
    o = (c[:, None] + rs.uniform(-2.5, 2.5, size=(3, N))).astype(np.float32)
    return o, _unit_dirs(rs, N)


@pytest.mark.parametrize("name", SCENES)
def test_closest_hit_sweep(name):
    scene = load_scene(name)
    o, d = _random_rays(scene, 11)
    th = tgeom.ScenePrims(tgeom.scene_tables(scene, "cpu")).closest_hit(
        _tv(o), _tv(d))
    jh = jgeom.ScenePrims(scene).closest_hit(_jv(o), _jv(d))
    found = _np(jh.found)
    np.testing.assert_array_equal(th.found.numpy(), found)
    assert 0.1 < found.mean() < 1.0  # the rays exercise both outcomes
    # The winner decides the material: exact where found.
    for a, b in zip(list(th.color) + list(th.emission) + [th.reflectivity],
                    list(jh.color) + list(jh.emission) + [jh.reflectivity]):
        np.testing.assert_array_equal(a.numpy()[found], _np(b)[found])
    _close([th.t.numpy()[found]], [_np(jh.t)[found]])
    _close([c.numpy()[found] for c in list(th.p) + list(th.normal)],
           [_np(c)[found] for c in list(jh.p) + list(jh.normal)],
           atol=1e-5)


@pytest.mark.parametrize("name", SCENES)
def test_occluded_sweep(name):
    scene = load_scene(name)
    o, d = _random_rays(scene, 12)
    t_max = np.random.RandomState(13).uniform(0.1, 8.0, N).astype(np.float32)
    got = tgeom.ScenePrims(tgeom.scene_tables(scene, "cpu")).occluded(
        _tv(o), _tv(d), tgeom.RAY_EPS, torch.from_numpy(t_max))
    want = jgeom.ScenePrims(scene).occluded(_jv(o), _jv(d), jgeom.RAY_EPS,
                                            jnp.asarray(t_max))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert 0.05 < got.numpy().mean() < 0.95


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_hold_the_jax_constants(name):
    """Triangle edges, normals and areas come out of the same f32 steps as
    the JAX package's baked constants."""
    scene = load_scene(name)
    tab = tgeom.scene_tables(scene, "cpu")
    for row, tri in zip(tab.tri.numpy(), scene.triangles):
        e1, e2, n, _area = jgeom._tri_edges_f32(tri)
        np.testing.assert_array_equal(row[3:12], np.concatenate([e1, e2, n]))
    for row, s in zip(tab.sph.numpy(), scene.spheres):
        assert row[3] == np.float32(float(s.radius) ** 2)
        assert row[4] == np.float32(1.0) / np.float32(s.radius)
    assert tab.lights.shape[0] == len(scene.lights)
    assert tab.mat.shape[0] == scene.primitive_count


# ---------------------------------------------------------- vecmath/tonemap


def test_vecmath_against_numpy():
    rs = np.random.RandomState(14)
    a, b = rs.normal(size=(2, 3, 64)).astype(np.float32)
    ta, tb = _tv(a), _tv(b)
    np.testing.assert_allclose(tvm.dot(ta, tb).numpy(), (a * b).sum(0),
                               rtol=1e-5, atol=1e-6)
    _close(tvm.cross(ta, tb), np.cross(a.T, b.T).T)
    _close(tvm.normalize(ta), a / np.linalg.norm(a, axis=0))
    _close(tvm.reflect(ta, tb), a - b * 2 * (a * b).sum(0))
    np.testing.assert_array_equal(tvm.max_component(ta).numpy(), a.max(0))


def test_tonemap_matches_jax_except_straddles():
    """Both tonemaps truncate; an f32 value that lands within an ulp of a
    quantisation step may round to either side, nowhere else."""
    acc = np.random.RandomState(15).gamma(0.7, 0.5, size=(3, 16, 64))
    acc = acc.astype(np.float32)
    got = ttm.tonemap_fullcolor(_tv(acc)).numpy()
    want = _np(jtm.tonemap_fullcolor(_jv(acc)))
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3
    trgb, tidx = ttm.tonemap_ascii(_tv(acc))
    jrgb, jidx = jtm.tonemap_ascii(_jv(acc))
    for g, w in ((trgb.numpy(), _np(jrgb)), (tidx.numpy(), _np(jidx))):
        assert np.abs(g.astype(int) - w).max() <= 1
        assert (g != w).mean() < 1e-2
    assert ttm.GLYPH_RAMP == jtm.GLYPH_RAMP
