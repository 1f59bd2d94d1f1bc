"""The port's texture family against the JAX package: the texel fetch from
the packed atlas (nearest and bilinear), the sky map, the mapped texel of
image textures and normal maps, and whole frames of the textured packaged
scenes against the JAX package's jnp oracle.

Inputs come from numpy seeds and go through both packages. A texel fetch
at the same flat index gives the same packed texel, so the unpacked colors
are equal bit for bit, inside and outside the atlas rows [lo, hi) that the
JAX package's row sweep covers (outside, both give 0). The uv of a sky
direction or of a hit goes through the polynomial atan2 and floor; XLA-CPU
contracts multiply-adds and rounds rsqrt differently from PyTorch, so uv
may differ by an ulp, but the texel indices of these seeded inputs are
equal and the colors agree to rtol 1e-5 / atol 1e-6 (the bilinear weights
carry the uv ulp). Whole frames (64x16, 8 spp, depth 3, below the roulette
start, so a texel-boundary flip cannot change a roulette decision) must
agree in owed rays and per-pixel samples; radiance within rtol 1e-4 /
atol 1e-5 except on knife-edge pixels (a hit point an ulp apart across a
texel edge, the sphere-light NEE self-shadow of test_torch_slice.py): a
counted few, bounded by their count and summed error (KNIFE). bumpy is the exception in decisions, bounded here: its
normal maps turn an ulp of a scatter direction (XLA-CPU's sin/cos and
multiply-add rounding against PyTorch's; not the rsqrt, since the counts
stay the same with JAX's rsqrt replaced by 1/sqrt) into a jump of the
next hit's normal whenever the hit point crosses a texel edge, so a few
paths per frame (3-6 of ~18,800 owed rays at seeds 1001-1003) end a
bounce earlier or later: its owed rays may differ by at most 0.05%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.ops import geometry as jgeom
from terminal_raytracer_tpu.ops.tracer import PathTracer as JPathTracer
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
N = 4096
RTOL, ATOL = 1e-5, 1e-6  # lane-wise colors
F_RTOL, F_ATOL = 1e-4, 1e-5  # whole-frame radiance


def _tracers(name, filt="nearest"):
    kw = dict(width=8, height=4, texture_filter=filt)
    return (JPathTracer(jload_scene(name).with_overrides(**kw)),
            PathTracer(load_scene(name).with_overrides(**kw), "cpu"))


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _unit(rs, n):
    d = rs.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def test_texel_fetch_matches_jax_inside_and_outside_the_rows():
    jt, tt = _tracers("textured")
    rows = tt.atlas.numel() // 128
    idx = np.random.RandomState(0).randint(-300, rows * 128 + 300, N)
    for lo, hi in ((0, rows), (jt.tex_prim_lo, jt.tex_prim_hi),
                   (rows // 2, rows)):
        want = jax.jit(lambda i: jt._fetch_texel(i, lo, hi))(
            jnp.asarray(idx, jnp.int32))
        got = tt.fetch_texel(torch.from_numpy(idx.astype(np.int64)), lo, hi)
        np.testing.assert_array_equal(_np3(got), _np3(want))
    outside = (idx < (rows // 2) * 128) | (idx >= rows * 128)
    assert outside.any() and (_np3(got)[:, outside] == 0.0).all()


def test_bilinear_fetch_matches_jax():
    """Random uv in each texture (edges and the wrap at 0 and 1 included):
    the 2x2 blend with its wrapped neighbours."""
    jt, tt = _tracers("textured", "bilinear")
    rs = np.random.RandomState(4)
    u, v = rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    u[:4], v[:4] = [0.0, 0.99999994, 0.5 / 64, 0.0], [0.0, 0.0, 1 / 128, 0.5]
    tex = rs.randint(0, 2, N)
    base = tex * tt.tex_rows * 128
    hi = tt.atlas.numel() // 128
    want = jax.jit(lambda b, x, y: jt._fetch_bilinear(b, x, y, 0, hi))(
        jnp.asarray(base, jnp.int32), jnp.asarray(u), jnp.asarray(v))
    got = tt.fetch_bilinear(torch.from_numpy(base.astype(np.int64)),
                            torch.from_numpy(u), torch.from_numpy(v), 0, hi)
    np.testing.assert_allclose(_np3(got), _np3(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_sky_radiance_matches_jax(filt):
    jt, tt = _tracers("envmap", filt)
    d = _unit(np.random.RandomState(1), N)
    d[:, :4] = [[0, 0, 0, 1], [1, -1, 0, 0], [0, 0, 1, 0]]  # poles, axes
    want = jax.jit(lambda x: jt._sky_radiance(JV3(*x)))(jnp.asarray(d))
    got = tt.sky_radiance(V3(*torch.from_numpy(d)))
    np.testing.assert_allclose(_np3(got), _np3(want), rtol=RTOL, atol=ATOL)
    # Equal texel indices: the nearest fetch is exact wherever uv agrees.
    ju, jv = jax.jit(lambda x: jt._spherical_uv(JV3(*x)))(jnp.asarray(d))
    tu, tv = tt.spherical_uv(V3(*torch.from_numpy(d)))
    s = float(tt.tex_size)
    for a, b in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-7)
        np.testing.assert_array_equal(np.floor(a.numpy() * s),
                                      np.floor(np.asarray(b) * s))


def _random_hits(rs, n, ids, scales):
    """A JAX and a port Hit at random points with random unit normals and
    the given channel values."""
    p = rs.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
    nrm = _unit(rs, n)
    nrm[:, :3] = [[0, 0, 1], [1, 0, 0], [0, 1, 0]]  # an exact pole first
    ch = {k: v.astype(np.float32) for k, v in (("id", ids), ("scale", scales))}
    ones = np.ones(n, np.float32)

    def hits(v3, arr):
        a = {k: arr(v) for k, v in ch.items()}
        return dict(found=arr(ones) > 0, t=arr(ones), p=v3(p), normal=v3(nrm),
                    color=v3(np.stack([ones * 0.5] * 3)),
                    emission=v3(np.zeros((3, n), np.float32)),
                    reflectivity=arr(ones * 0), **a)

    j = hits(lambda x: JV3(*(jnp.asarray(c) for c in x)), jnp.asarray)
    t = hits(lambda x: V3(*(torch.from_numpy(c) for c in x)),
             torch.from_numpy)
    return j, t


@pytest.mark.parametrize("name, filt", [("textured", "nearest"),
                                        ("textured", "bilinear"),
                                        ("bumpy", "nearest")])
def test_mapped_texel_matches_jax(name, filt):
    """Planar (+id), spherical (-id) and unmapped (0) lanes; the unmapped
    lanes' fetch is dropped by the callers, so only mapped lanes count."""
    jt, tt = _tracers(name, filt)
    rs = np.random.RandomState(2)
    ids = rs.choice([-2.0, -1.0, 0.0, 1.0, 2.0], N)
    scales = rs.choice([0.15, 0.25, 1.0], N)
    jh, th = _random_hits(rs, N, ids, scales)
    lo, hi = 0, tt.atlas.numel() // 128
    want = jax.jit(lambda h, s, i: jt._mapped_texel(
        jgeom.Hit(**h), i, s, lo, hi))(
            {k: v for k, v in jh.items() if k not in ("id", "scale")},
            jh["scale"], jh["id"])
    got = tt.mapped_texel(
        geom.Hit(**{k: v for k, v in th.items() if k not in ("id", "scale")}),
        th["id"], th["scale"], lo, hi)
    mapped = ids != 0.0
    np.testing.assert_allclose(_np3(got)[:, mapped], _np3(want)[:, mapped],
                               rtol=RTOL, atol=ATOL)


def test_normal_map_matches_jax():
    """Planar and spherical tangent frames (a pole included), strengths
    from 0.5 to 2; unmapped lanes keep their normal bit for bit."""
    jt, tt = _tracers("bumpy")
    rs = np.random.RandomState(3)
    ids = rs.choice([-2.0, 0.0, 2.0], N)
    ids[:3] = -2.0
    jh, th = _random_hits(rs, N, ids, rs.choice([0.15, 0.25], N))
    strength = rs.uniform(0.5, 2.0, N).astype(np.float32)
    jhit = jgeom.Hit(**{k: v for k, v in jh.items() if k not in ("id",
                                                                  "scale")},
                     nm_index=jh["id"], nm_scale=jh["scale"],
                     nm_strength=jnp.asarray(strength))
    thit = geom.Hit(**{k: v for k, v in th.items() if k not in ("id",
                                                                "scale")},
                    nm_index=th["id"], nm_scale=th["scale"],
                    nm_strength=torch.from_numpy(strength))
    want = _np3(jax.jit(jt._apply_normal_map)(jhit).normal)
    got = _np3(tt.apply_normal_map(thit).normal)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, ids == 0.0], _np3(jh["normal"])[
        :, ids == 0.0])


# ------------------------------------------------------------------ frames

FRAME_CASES = [("textured", "nearest"), ("textured", "bilinear"),
               ("envmap", "nearest"), ("bumpy", "nearest")]
SEEDS = (1001, 1002)
# Knife-edge bounds by case: (pixels off, their summed error), the largest
# a frame of the two seeds shows on the CPU (the error rounded up to 3
# digits; bumpy's include the pixels whose owed rays differ).
KNIFE = {"textured-nearest": (17, 1.07), "textured-bilinear": (24, 1.08),
         "envmap-nearest": (0, 0.0), "bumpy-nearest": (28, 2.04)}


@pytest.mark.parametrize("name, filt", FRAME_CASES,
                         ids=[f"{n}-{f}" for n, f in FRAME_CASES])
def test_render_frame_matches_jax_oracle(name, filt):
    kw = dict(width=64, height=16, samples_per_pixel=8, max_depth=3,
              texture_filter=filt)
    jscene = jload_scene(name).with_overrides(**kw)
    jstep = j_make_step(jscene, full_color=True, backend="jnp")
    tracer = PathTracer(load_scene(name).with_overrides(**kw), "cpu")
    assert tracer.ext
    for seed in SEEDS:
        j = jax.device_get(jstep(j_init_state(jscene), POSE,
                                 np.uint32(seed), np.int32(0)))
        cur, _var, total, rays, _occ = tracer.render_frame(POSE, seed, 0)
        if name == "bumpy":
            assert abs(float(rays) - float(j.rays)) <= 5e-4 * float(j.rays)
        else:
            assert float(rays) == float(j.rays)
        np.testing.assert_array_equal(total.numpy(), j.state.samples)
        KnifeEdges(F_RTOL, F_ATOL).add(np.stack([c.numpy() for c in cur]),
                                       j.state.acc).check(
                                           KNIFE[f"{name}-{filt}"])
