"""The port's many-primitive path against the JAX package: the accel and
chunk-split policy, the chunked plain pipeline (kernel A over the
chunk-major stream, the chunk-split sort glue, kernel B), mesh scenes, and
the --accel CLI. The kernels' plain versions run here (the tensors lie on
the CPU); the JAX side runs its jnp oracle and its Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU.

Sizes follow tests/test_chunk.py: stress:120:7 at 64x16, 8 spp, depth 3,
with the chunk split forced to cb = ce = 2. Decisions must agree exactly:
owed rays, per-pixel sample counts (so adaptive budgets), end RNG states.
Radiance within rtol 1e-4 / atol 1e-5, except on the few pixels where the
stress field's sphere light puts an NEE shadow ray on the self-shadow knife
edge (test_torch_slice.py explains it): a counted few, as for
demo/scene2, bounded by their count and summed error (KNIFE,
tests/test_torch_knife.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera, load_scene as jload_scene
from terminal_raytracer_tpu.ops import pallas_kernel as pk
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.ops import kernels, tracer
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer, cam_from_pose
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE = Camera().pose()
SEED = 123
RTOL, ATOL = 1e-4, 1e-5
# Knife-edge bounds of the sphere-light scenes, by test: (pixels off,
# their summed error), the largest each test's seeds show on the CPU (the
# error rounded up to 3 digits).
KNIFE = {"frame radiance": (7, 0.00108), "frame variance": (15, 0.00111),
         "pallas sorted": (1, 3.59e-05), "chunked kernel A": (8, 0.0204),
         "mesh": (1, 0.0739)}
CHUNKED = dict(chunk_base=2, chunk_extra=2)
STRESS = ("stress:120:7", 64, 16, 8, 3)


def _scenes(name, w, h, spp, depth):
    """The same scene from both packages' loaders."""
    kw = dict(width=w, height=h, samples_per_pixel=spp, max_depth=depth)
    return (load_scene(name).with_overrides(**kw),
            jload_scene(name).with_overrides(**kw))


@pytest.mark.parametrize("spp", [4, 8])
@pytest.mark.parametrize("name", ["stress:95", "stress:96", "stress:256",
                                  "stress:512", "icosphere:3", "Cornell_Box"])
def test_accel_and_chunk_policy_matches_jax(name, spp):
    scene, jscene = _scenes(name, 16, 4, spp, 3)
    j = jtracer.PathTracer(jscene)
    t = PathTracer(scene, "cpu")
    assert (t.accel, t.chunk_base, t.chunk_extra) == (
        j.accel, j.chunk_base, j.chunk_extra)
    for kw in (dict(accel="array"), dict(accel="baked"), CHUNKED):
        j = jtracer.PathTracer(jscene, **kw)
        t = PathTracer(scene, "cpu", **kw)
        assert (t.accel, t.chunk_base, t.chunk_extra) == (
            j.accel, j.chunk_base, j.chunk_extra), kw


@pytest.fixture(scope="module")
def stress():
    """The forced-chunk stress scene and the JAX oracle's frame."""
    scene, jscene = _scenes(*STRESS)
    jt = jtracer.PathTracer(jscene, **CHUNKED)
    want = jax.device_get(jax.jit(jt.render_frame)(POSE, np.uint32(SEED),
                                                   np.int32(0)))
    return scene, jscene, want


def test_chunked_render_frame_matches_jax_oracle(stress):
    """The plain whole frame (image-order entries) and the chunked sorted
    pipeline (through the kernels' plain versions) against the oracle."""
    scene, _jscene, (jcur, jvar, jtot, jrays) = stress
    tr = PathTracer(scene, "cpu", **CHUNKED)
    assert (tr.n_base_chunks, tr.n_extra_chunks) == (2, 2)
    assert (jtot > tr.base_samples).any()  # the extra chunks are exercised
    plain = tr.render_frame(POSE, SEED, 0)
    piped = kernels.make_sorted_render_frame(tr)(POSE, SEED, 0)
    for cur, var, tot, rays, occ in (plain, piped):
        assert float(rays) == float(jrays)
        np.testing.assert_array_equal(tot.numpy(), jtot)
        KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                                   np.stack(jcur)).check(
                                       KNIFE["frame radiance"])
        KnifeEdges(RTOL, ATOL).add(var.numpy(), jvar).check(
            KNIFE["frame variance"])
        assert 0.0 < float(occ) <= 1.0
    # Pipeline and plain whole frame: one estimator, bit for bit.
    for a, b in zip(plain[:3], piped[:3]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_chunked_pipeline_matches_pallas_sorted_pipeline(stress):
    scene, jscene, _ = stress
    jrender = jax.jit(pk.make_sorted_render_frame(jscene, interpret=True,
                                                  chunk_base=2, chunk=2))
    jcur, jvar, jtot, jrays, _ = jax.device_get(
        jrender(POSE, np.uint32(SEED), np.int32(1)))
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(
        PathTracer(scene, "cpu", **CHUNKED))(POSE, SEED, 1)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(KNIFE["pallas sorted"])


def test_chunked_kernel_a_matches_pallas_kernel_a(stress):
    """The chunked kernel A's per-entry planes, added in chunk order, equal
    the Pallas kernel A's assembled totals; the end state is chunk 0's."""
    scene, jscene, _ = stress
    base_fn, jt, _pair = pk.make_base_kernel(jscene, interpret=True,
                                             chunk_base=2)
    assert jt.chunk_base == 2
    jcsum, jcsq, jstate, jrays, _it = jax.device_get(jax.jit(base_fn)(
        POSE, np.uint32(SEED), np.int32(0), np.int32(0)))
    tr = PathTracer(scene, "cpu", **CHUNKED)
    out = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    assert out.rays.shape == (2, scene.height, scene.width)
    np.testing.assert_array_equal(tr.chunk_total(out.rays).numpy(), jrays)
    np.testing.assert_array_equal(out.state[0].numpy(),
                                  jstate.astype(np.int64))
    got = [tr.chunk_total(v).numpy() for v in (*out.csum, *out.csumsq)]
    KnifeEdges(RTOL, ATOL).add(np.stack(got),
                               np.stack([*jcsum, *jcsq])).check(
                                   KNIFE["chunked kernel A"])
    with pytest.raises(ValueError, match="base_kernel_chunked"):
        kernels.base_kernel(tr, POSE, SEED, 0)


def test_chunk0_is_the_head_of_the_sequential_chain():
    """Chunk 0 of the chunked kernel A renders the first cb samples of the
    pixel's sequential chain; chunk 1 runs its own sub-chain."""
    scene, _ = _scenes(*STRESS)
    tr = PathTracer(scene, "cpu", **CHUNKED)
    a = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    x, y = tr.pixel_grid()
    xf, yf = x.float(), y.float()
    c0 = tr.regen_carry0(tr.seed_lanes(x, y, SEED, 0), torch.zeros_like(x),
                         torch.full_like(xf, 2.0))
    head, _ = tr.run_regen(cam_from_pose(POSE), xf, yf, c0)
    assert torch.equal(a.state[0], head.state)
    assert torch.equal(a.rays[0], head.rays)
    for got, want in zip(a.csum, head.csum):
        assert torch.equal(got[0], want)
    assert not torch.equal(a.state[1], a.state[0])


def test_chunked_stream_glue():
    """The chunk-split extra entries: budgets slice each pixel's budget in
    chunk order, chunk c > 0 starts at base + c * ce on its own sub-chain,
    and kernel B over the sorted stream equals the extra phase over the
    image-order entries, bit for bit."""
    scene, _ = _scenes(*STRESS)
    tr = PathTracer(scene, "cpu", **CHUNKED)
    a = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    csum = [tr.chunk_total(v) for v in (*a.csum, *a.csumsq)]
    var = tr.variance_of(tracer.V3(*csum[:3]), tracer.V3(*csum[3:]))
    _needs, add = tr.extra_quota(var)
    state = a.state[0]
    budget, st_e, samp0 = tr.extra_entries(state, add)
    assert torch.equal(budget.sum(0), add)
    assert torch.equal(samp0[1], torch.full_like(state, 4 + 2))
    assert torch.equal(st_e[1], (state + tracer.CHUNK_GOLDEN) & 0xFFFFFFFF)
    s = kernels.sorted_stream(tr, state, add)
    assert s.n_chunks == 2 and s.xs.shape[1] == 512
    flat = s.add.reshape(-1)
    assert bool((flat[:-1] >= flat[1:]).all())
    esum, rays, _ = kernels.make_sorted_extra_phase(tr)(POSE, state, add)
    x, y = tr.pixel_grid()
    shape = budget.shape
    want, want_rays, _ = tr.extra_phase(
        cam_from_pose(POSE), x.expand(shape).float(), y.expand(shape).float(),
        st_e, budget, samp0)
    for g, w in zip(esum, want):
        assert torch.equal(g, tr.chunk_total(w))
    assert float(rays) == float(want_rays.sum())


@pytest.fixture(scope="module")
def mesh():
    """icosphere:1 (80 triangles, a sphere light, a floor) and the JAX
    oracle's frame over its array sweep (the baked sweep's unrolled program
    takes minutes to compile on the CPU; both sweeps agree, test_mesh.py)."""
    scene, jscene = _scenes("icosphere:1", 64, 16, 8, 3)
    jt = jtracer.PathTracer(jscene, accel="array")
    return scene, jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(5), np.int32(0)))


@pytest.mark.parametrize("accel", ["baked", "array"])
def test_mesh_scene_matches_jax_oracle(mesh, accel):
    """Rays and samples exact; radiance within the tolerance but for
    knife-edge pixels of the sphere light. Mesh triangles in general
    position also let f32 rounding order matter by an ulp in t (XLA
    contracts multiply-adds)."""
    scene, (jcur, _jvar, jtot, jrays) = mesh
    cur, var, tot, rays, _ = kernels.make_sorted_render_frame(
        PathTracer(scene, "cpu", accel=accel))(POSE, 5, 0)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(KNIFE["mesh"])


def test_array_accel_squares_the_f32_radius():
    """The JAX array sweep squares the f32 radius in f32; the baked sweep
    squares the scene's f64 radius."""
    scene = load_scene("Cornell_Box")
    for accel in ("baked", "array"):
        sph = PathTracer(scene, "cpu", accel=accel).tables.sph.numpy()
        for row, s in zip(sph, scene.spheres):
            r32 = np.float32(s.radius)
            want = r32 * r32 if accel == "array" else np.float32(
                float(s.radius) ** 2)
            assert row[3] == want


def _run(args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_renders_a_chunked_stress_scene():
    r = _run(["-m", "terminal_raytracer_tpu_torch", "--device", "cpu",
              "--scene", "stress:600:3", "--width", "32", "--height", "8",
              "--spp", "8", "--depth", "3", "--frames", "1", "--verbose"])
    assert r.returncode == 0, r.stderr
    rows = r.stdout.splitlines()[1:]
    assert len(rows) == 8 and all(len(row) == 32 for row in rows)
    assert len(set("".join(rows))) > 4
    assert "601 primitives" in r.stderr
