"""The port's grid walk (``--accel gathered``) against the JAX package: the
grid and its walk constants, the plain closest-hit and occlusion walks on
random rays, whole frames against the JAX oracle, and the CLI. The
kernels' plain versions run here (the tensors lie on the CPU); the JAX side
runs its jnp oracle (its own tests/test_gathered.py holds its Pallas
kernels against that oracle in interpret mode).

The grid, the walk's decisions (found, the winner) and every record
channel must agree exactly, rays, budgets and samples too. The JAX walk
runs inside a compiled while loop, where XLA-CPU contracts multiply-adds:
t within rtol 1e-5 and p within rtol / atol 1e-5 (as
tests/test_torch_ops.py), and a sphere normal, which amplifies them at
grazing incidence, within 1e-4. Radiance
within rtol 1e-4 / atol 1e-5, but for the knife-edge pixels of
sphere-light scenes (a counted few, KNIFE) and, with fog under
MIS, at most 2 pixels each at most 1e-4 off (test_torch_medium.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from terminal_raytracer_tpu.models import Camera, load_scene as jload_scene
from terminal_raytracer_tpu.models.scene import Fog as JFog
from terminal_raytracer_tpu.ops import gathered as jgathered
from terminal_raytracer_tpu.ops import grid as jgrid
from terminal_raytracer_tpu.ops import tracer as jtracer
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.scene import Fog
from terminal_raytracer_tpu_torch.ops import gathered, geometry as geom
from terminal_raytracer_tpu_torch.ops import grid, kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

from test_torch_accel import (_j, _off, _t, assert_hits_equal,
                              random_rays)
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
# Knife-edge bounds of the sphere-light frames, by scene: (pixels off,
# their summed error), the largest the test's seed shows on the CPU (the
# error rounded up to 3 digits).
KNIFE = {"stress:48:3": (0, 0.0), "stress:96:3": (2, 0.000977),
         "icosphere:1": (1, 0.0739)}
SCENES = ["stress:96:3", "icosphere:1", "showcase", "Cornell_Box",
          "mesh_demo"]


def _scenes(name, **kw):
    return (load_scene(name).with_overrides(**kw),
            jload_scene(name).with_overrides(**kw))


@pytest.mark.parametrize("name", SCENES)
def test_grid_matches_jax(name):
    """The uniform grid (the reference's factor and the walk's), and the
    walk's constants: dims, grid box, cell, max_trips, CSR offsets and
    indices, equal the JAX package's; each Python float the JAX package
    folds is rounded to f32 once."""
    scene, jscene = _scenes(name)
    for factor in (grid.RESOLUTION_FACTOR, gathered.DEFAULT_FACTOR, 3.0):
        got = grid.build_uniform_grid(scene, factor)
        want = jgrid.build_uniform_grid(jscene, factor)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    jg = jgathered.GatheredPrims(jscene)
    h = gathered.grid_header(torch.from_numpy(gathered.grid_section(scene)))
    assert h["dims"] == list(jg.dims) and h["max_trips"] == jg.max_trips
    assert h["lo"] == list(jg.grid_min)
    for key, want in (("hi", jg.grid_max), ("cell", jg.cell),
                      ("inv_cell", [1.0 / c for c in jg.cell])):
        assert h[key] == [float(np.float32(v)) for v in want], key
    tr = PathTracer(scene, "cpu", accel="gathered")
    assert tr.traversal == "gathered" and tr.xt
    ints = tr.tables.acc[gathered.HDR_W:].view(torch.int32).numpy()
    n_off = jg.n_cells + 1
    np.testing.assert_array_equal(
        ints[:n_off], jg.i32_tab_host[jg.off_base:].reshape(-1)[:n_off])
    nnz = h["nnz"]
    np.testing.assert_array_equal(ints[n_off:n_off + nnz],
                                  jg.i32_tab_host[:jg.idx_rows]
                                  .reshape(-1)[:nnz])
    # The walk squares the f32 radius, as the array sweep does.
    for row, s in zip(tr.tables.sph.numpy(), scene.spheres):
        assert row[3] == np.float32(s.radius) * np.float32(s.radius)


@pytest.mark.parametrize("name, box", [
    ("stress:96:3", ((-14, 0.2, -26), (14, 8, 0))),
    ("icosphere:1", ((-3, -1, -8), (3, 3, 2))),
    ("showcase", ((-3, 0.1, -6), (3, 3, 2))),
    ("Cornell_Box", ((-1.5, 0.1, -4), (1.5, 2.5, 1)))])
def test_closest_hit_and_occluded_match_jax_oracle(name, box):
    """The plain walk against the JAX GatheredPrims oracle (the same walk)
    on 512 random rays, lane for lane: hits, records, extension channels;
    occlusion on random segments."""
    scene, jscene = _scenes(name)
    prims = PathTracer(scene, "cpu", accel="gathered").prims
    assert isinstance(prims, gathered.GatheredPrims)
    jprims = jgathered.GatheredPrims(jscene)
    o, d, tmax = random_rays(512, *box)
    gate = torch.ones(512, dtype=torch.bool)
    got = prims.closest_hit(_t(o), _t(d), gate=gate)
    assert_hits_equal(got, jprims.closest_hit(_j(o), _j(d)), rtol=1e-5,
                      atol=1e-5, n_atol=1e-4)
    assert int(got.found.sum()) > 0
    got = prims.occluded(_t(o), _t(d), geom.RAY_EPS,
                         torch.from_numpy(tmax), gate)
    want = jprims.occluded(_j(o), _j(d), geom.RAY_EPS, jnp.asarray(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 512


def test_walk_counts_and_trip_cap():
    """The plain walk's counters: tests and advances per walk; with
    max_trips cut to a few steps the walks that need more stop there and
    are counted, as the JAX loop stops them."""
    scene = load_scene("stress:96:3")
    prims = PathTracer(scene, "cpu", accel="gathered").prims
    o, d, _ = random_rays(256, (-14, 0.2, -26), (14, 8, 0))
    gate = torch.ones(256, dtype=torch.bool)
    prims.ops = torch.zeros((), dtype=torch.float64)
    full = prims.closest_hit(_t(o), _t(d), gate=gate)
    walks, tests, advances, capped = prims.stats.tolist()
    assert walks == 256 and capped == 0
    assert 0 < tests < 256 * len(scene.spheres) and advances > 0
    cap = torch.full((256,), 1e10)
    r = prims.walk(_t(o), _t(d), geom.RAY_EPS, cap, None, any_hit=False)
    trips = r.sph_tests + r.advances
    assert int(trips.max()) <= prims.max_trips
    prims.max_trips = 4
    cut = prims.walk(_t(o), _t(d), geom.RAY_EPS, cap, None, any_hit=False)
    assert torch.equal(cut.capped, trips > 4) and bool(cut.capped.any())
    assert torch.equal(cut.sph_tests + cut.advances, torch.clamp(trips, max=4))
    prims.ops = torch.zeros((), dtype=torch.float64)
    hit = prims.closest_hit(_t(o), _t(d), gate=gate)
    assert prims.stats[3] > 0 and not torch.equal(hit.found, full.found)
    prims.ops = None


def _frame_case(name, over, transport, seed, w=64, h=16, spp=8, depth=3):
    kw = dict(width=w, height=h, samples_per_pixel=spp, max_depth=depth)
    fog = over.get("fog")
    scene = load_scene(name).with_overrides(
        **kw, **({"fog": Fog(density=fog)} if fog else {}))
    jscene = jload_scene(name).with_overrides(
        **kw, **({"fog": JFog(density=fog)} if fog else {}))
    jt = jtracer.PathTracer(jscene, accel="gathered", transport=transport)
    want = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(seed), np.int32(0)))
    return scene, jt, want


@pytest.mark.parametrize("name, over, transport, seed", [
    ("stress:48:3", {}, "reference", 7),
    ("stress:96:3", {}, "reference", 5),
    ("icosphere:1", {}, "reference", 5),
    ("Cornell_Box", {"fog": 0.15}, "mis", 11)])
def test_render_frame_matches_jax_oracle(name, over, transport, seed):
    """The plain whole frame and the sorted pipeline through the gathered
    kernels' plain versions against the JAX PathTracer with accel
    'gathered': rays and samples exact, radiance within the tolerance
    (module docstring)."""
    scene, jt, (jcur, jvar, jtot, jrays) = _frame_case(name, over, transport,
                                                       seed)
    tr = PathTracer(scene, "cpu", accel="gathered", transport=transport)
    assert (tr.chunk_base, tr.chunk_extra) == (jt.chunk_base, jt.chunk_extra)
    assert (jtot > tr.base_samples).any()
    plain = tr.render_frame(POSE, seed, 0)
    piped = kernels.make_sorted_render_frame(tr)(POSE, seed, 0)
    for cur, var, tot, rays, occ in (plain, piped):
        assert float(rays) == float(np.asarray(jrays).sum())
        np.testing.assert_array_equal(tot.numpy(), jtot)
        got = np.stack([c.numpy() for c in cur])
        off = _off(got, np.stack(jcur))
        if over:
            assert off.sum() <= 2
            assert np.abs(got - np.stack(jcur)).max() <= 1e-4
        else:
            KnifeEdges().add(got, np.stack(jcur)).check(KNIFE[name])
    for a, b in zip(plain[:3], piped[:3]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_cli_renders_with_accel_gathered(capsys):
    assert torch_main(["--device", "cpu", "--accel", "gathered", "--scene",
                       "icosphere:1", "--width", "32", "--height", "8",
                       "--spp", "4", "--depth", "2", "--frames", "1"]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 8 and len(set("".join(rows))) > 3


def test_accel_gathered_refusals(capsys):
    """--accel gathered --animate exits 2 with the JAX package's message
    and no traceback; a scene of planes alone has nothing to walk."""
    assert torch_main(["--device", "cpu", "--accel", "gathered", "--animate",
                       "orbit", "--frames", "1"]) == 2
    err = capsys.readouterr().err
    assert "accel='gathered' needs static geometry" in err
    assert "Traceback" not in err
    with pytest.raises(ValueError, match="needs static geometry"):
        jtracer.PathTracer(jload_scene("Cornell_Box"), accel="gathered",
                           dynamic=True)
    scene = load_scene("Cornell_Box")
    planes = dataclasses.replace(scene, spheres=(), triangles=())
    with pytest.raises(ValueError, match="needs spheres/triangles"):
        PathTracer(planes, "cpu", accel="gathered")
