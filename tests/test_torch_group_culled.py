"""The grouped kernel B over the culled sweep of `--accel grid`
(csrc/group.cuh GroupCulled) and the grouped kernel B at the XT gates,
their plain model and their dispatch on the CPU; the kernels on the card.

ops/group.py split_culled_closest / split_culled_occluded model the
split culled sweep in plain PyTorch: windows of k groups whose boxes are
tested at once, the candidate groups swept p at a time (l = k / p lanes a
group, each lane with its own running closest from the closest at the
step's start) and the serial cull decisions replayed from the groups'
minima. Held here against the serial culled sweep (ops/accel.py
CulledPrims, the plain version of the kernels, and the JAX package's
CulledPrims oracle where culling skips no hit) at k in {1, 2, 4, 8, 16,
32}, both designs where k > 8: the hit's t bits and primitive index and
the four traversal counters equal, on random rays over blocked `stress:`,
icosphere and Cornell scenes, on rays from inside spheres, on ties across
and within blocks, and on the far shadow ray whose f32 test reports a hit
outside its block's padded box. A model that culls with each lane's own
running closest (GroupSweep's split applied to the culled sweep) fails
them.

The `cuda` tests hold the two grouped entries against their plain
versions at 64x16 on the card (rays and esum bits equal, the counter equal
to the plain model at the kernel's group width, the grid entry's traversal
counters equal to the plain version's) and skip here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import accel, group, kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops import geometry as geom  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from terminal_raytracer_tpu_torch.ops.vecmath import V3  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

KS = (1, 2, 4, 8, 16, 32)
# (k, wide): both designs where they differ.
DESIGNS = [(k, None) for k in KS] + [(16, False), (32, False)]
N_RAYS = 384
POSE = Camera().pose()
SEED = 42
SCENES = {"stress:96:3": ((-14, 0.3, -27), (6, 9, -2)),
          "icosphere:1": ((-3, -1, -8), (3, 4, 2)),
          "Cornell_Box": ((-0.9, -0.9, -3.9), (0.9, 0.9, -0.5))}


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _rays(n, lo, hi, seed):
    """Seeded rays: origins uniform in the box [lo, hi], unit directions,
    shadow-ray bounds in [0.5, 30)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32).T
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = rs.uniform(0.5, 30.0, n).astype(np.float32)
    return o, d, t_max


def _prims(scene):
    prims = PathTracer(scene, "cpu", accel="grid").prims
    assert isinstance(prims, accel.CulledPrims)
    return prims


def _serial_closest(prims, o, d):
    """CulledPrims' closest hit: (t, primitive index, its counters)."""
    seen = {}
    hit_at = prims.hit_at

    def capture(o_, d_, found, closest, idx):
        seen["idx"] = torch.where(found, idx, group.NONE)
        return hit_at(o_, d_, found, closest, idx)

    prims.hit_at = capture
    prims.ops = torch.zeros((), dtype=torch.float64)
    try:
        hit = prims.closest_hit(o, d, gate=torch.ones(o.x.shape,
                                                      dtype=torch.bool))
        stats = prims.stats.clone()
    finally:
        prims.ops = None
        del prims.hit_at
    return hit.t, seen["idx"], stats


def _serial_occluded(prims, o, d, t_max):
    prims.ops = torch.zeros((), dtype=torch.float64)
    try:
        blocked = prims.occluded(o, d, geom.RAY_EPS, t_max,
                                 torch.ones(o.x.shape, dtype=torch.bool))
        stats = prims.stats.clone()
    finally:
        prims.ops = None
    return blocked, stats


def _assert_closest(prims, o, d, k, wide):
    t, idx, cnt = group.split_culled_closest(prims, o, d, k, wide)
    t_s, idx_s, stats = _serial_closest(prims, o, d)
    assert torch.equal(t.view(torch.int32), t_s.view(torch.int32))
    assert torch.equal(idx, idx_s)
    assert cnt.sum(1).double().tolist() == stats.tolist()
    return t, idx


def _assert_occluded(prims, o, d, t_max, k, wide):
    blocked, cnt = group.split_culled_occluded(prims, o, d, geom.RAY_EPS,
                                               t_max, k, wide)
    want, stats = _serial_occluded(prims, o, d, t_max)
    assert torch.equal(blocked, want)
    assert cnt.sum(1).double().tolist() == stats.tolist()
    return blocked


@pytest.mark.parametrize("k, wide", DESIGNS)
@pytest.mark.parametrize("name", list(SCENES))
def test_split_culled_sweep_is_the_serial_culled_sweep(name, k, wide):
    """Random rays: every design's hits (t bits, index), shadow flags and
    counters equal CulledPrims'."""
    prims = _prims(load_scene(name))
    o, d, t_max = _rays(N_RAYS, *SCENES[name], seed=5)
    t, _ = _assert_closest(prims, _v3(o), _v3(d), k, wide)
    assert bool((t < geom.T_FAR).any())
    blocked = _assert_occluded(prims, _v3(o), _v3(d), torch.from_numpy(t_max),
                               k, wide)
    assert 0 < int(blocked.sum()) < N_RAYS


@pytest.mark.parametrize("k, wide", DESIGNS)
def test_rays_from_inside_spheres(k, wide):
    """Origins just off the stress field's sphere centres: the near root
    lies behind, the far one is taken, blocks entered from inside their
    boxes."""
    scene = load_scene("stress:96:3")
    prims = _prims(scene)
    rs = np.random.RandomState(9)
    centres = np.float32([s.center for s in scene.spheres])
    o = (centres[rs.randint(0, len(centres), N_RAYS)]
         + rs.uniform(-0.05, 0.05, (N_RAYS, 3))).astype(np.float32).T
    d = rs.normal(size=(3, N_RAYS)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    radius = max(s.radius for s in scene.spheres)
    t, idx = _assert_closest(prims, _v3(o), _v3(d), k, wide)
    assert bool((t < radius + 0.1).all())  # the far root it starts inside
    _assert_occluded(prims, _v3(o), _v3(d), torch.full((N_RAYS,), 30.0), k,
                     wide)


def _tied_scene():
    """stress:16 with twelve copies of one sphere, which the blocked scene
    places in two blocks (8 + 4): rays aimed at it tie within a block and
    across blocks."""
    scene = load_scene("stress:16:3")
    copy = scene.spheres[-1]._replace(center=(0.0, 3.0, -12.0), radius=1.0)
    return dataclasses.replace(scene, spheres=scene.spheres + (copy,) * 12)


@pytest.mark.parametrize("k, wide", DESIGNS)
def test_ties_keep_the_earliest_primitive(k, wide):
    scene = _tied_scene()
    prims = _prims(scene)
    sph = prims.tables.sph
    copies = torch.nonzero((sph[:, 0] == 0.0) & (sph[:, 1] == 3.0)
                           & (sph[:, 2] == -12.0)).flatten()
    assert len(copies) == 12
    assert len({int(i) // accel.BLOCK for i in copies}) >= 2
    rs = np.random.RandomState(13)
    o = np.float32([[0.0], [3.0], [0.0]]) + rs.uniform(
        -0.3, 0.3, (3, N_RAYS)).astype(np.float32)
    aim = np.float32([[0.0], [3.0], [-12.0]]) + rs.uniform(
        -0.5, 0.5, (3, N_RAYS)).astype(np.float32)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    t, idx = _assert_closest(prims, _v3(o), _v3(d), k, wide)
    assert bool((idx == int(copies.min())).all())


@pytest.mark.parametrize("k, wide", DESIGNS)
def test_far_shadow_ray_skips_the_phantom_hit(k, wide):
    """The far shadow ray of test_torch_accel: its f32 sphere test reports
    a hit outside the block's padded box; the split sweep skips the block,
    as the serial culled sweep does, and counts what it counts."""
    prims = _prims(load_scene("stress:1024"))
    o = _v3(np.float32([[-4896.11279296875], [0.0010000000474974513],
                        [7828.30908203125]]))
    d = _v3(np.float32([[0.5297151803970337], [0.001034751534461975],
                        [-0.8481749296188354]]))
    t_max = torch.tensor([9240.76953125])
    dense = geom.ScenePrims(prims.tables)
    assert bool(dense.occluded(o, d, geom.RAY_EPS, t_max))
    assert not bool(_assert_occluded(prims, o, d, t_max, k, wide).any())


def _lane_culled_closest(prims, o, d, k):
    """The mutant: GroupSweep's split applied to the culled sweep. Lane j
    visits every group, culls it with its own running closest and tests
    members j, j + k, ... of the groups it enters; the lanes' minima are
    reduced at the end, and the counters are the lead lane's."""
    groups, lo, hi = group._culled_groups(prims)
    tn, tf = accel.slab_interval(geom._lanes(o), geom._lanes(d), lo, hi)
    n = o.x.shape[0]
    lanes = []
    for j in range(k):
        c = torch.full_like(o.x, geom.T_FAR)
        ci = torch.full((n,), group.NONE, dtype=torch.int64)
        swept = skipped = tests = torch.zeros(n, dtype=torch.int64)
        for g, (kind, r0, k0, cnt, guarded) in enumerate(groups):
            entered = torch.ones(n, dtype=torch.bool)
            if guarded:
                entered = ((tn[:, g] <= tf[:, g]) & (tf[:, g] > geom.RAY_EPS)
                           & (tn[:, g] < c))
                swept, skipped = swept + entered, skipped + ~entered
            tests = tests + entered * cnt
            for m in range(j, cnt, k):
                t, hit = group._member_test(prims, kind, r0 + m, o, d,
                                            geom.RAY_EPS, c, False)
                won = entered & hit & (t > 0.0) & (t < c)
                c, ci = torch.where(won, t, c), torch.where(won, k0 + m, ci)
        lanes.append((c, ci, torch.stack([torch.ones_like(swept), swept,
                                          skipped, tests])))
    t, idx, cnt = lanes[0]
    for c, ci, _ in lanes[1:]:
        take = (c < t) | ((c == t) & (ci < idx))
        t, idx = torch.where(take, c, t), torch.where(take, ci, idx)
    return t, idx, cnt


@pytest.mark.parametrize("k", (2, 8, 32))
def test_culling_by_each_lanes_own_closest_fails(k):
    """The mutant makes other cull decisions than the serial sweep: its
    counters differ on the random rays of the stress field."""
    prims = _prims(load_scene("stress:96:3"))
    o, d, _ = _rays(N_RAYS, *SCENES["stress:96:3"], seed=5)
    t, idx, cnt = _lane_culled_closest(prims, _v3(o), _v3(d), k)
    t_s, idx_s, stats = _serial_closest(prims, _v3(o), _v3(d))
    same = (torch.equal(t.view(torch.int32), t_s.view(torch.int32))
            and torch.equal(idx, idx_s)
            and cnt.sum(1).double().tolist() == stats.tolist())
    assert not same
    # The model of the shipped design agrees on the same rays.
    _assert_closest(prims, _v3(o), _v3(d), k, None)


def test_split_culled_hits_match_the_jax_oracle():
    """Near the scene culling skips no hit: the split sweep's hits equal
    the JAX package's CulledPrims (the dense sweep over the blocked
    scene), t bit for bit. (JAX is imported here: the card's machine,
    which runs this file's `cuda` tests, has none.)"""
    jnp = pytest.importorskip("jax.numpy")
    from terminal_raytracer_tpu.models import load_scene as jload_scene
    from terminal_raytracer_tpu.ops import accel as jaccel
    from terminal_raytracer_tpu.ops.vecmath import V3 as JV3

    name = "stress:96:3"
    prims = _prims(load_scene(name))
    jprims = jaccel.CulledPrims(jload_scene(name))
    o, d, t_max = _rays(N_RAYS, *SCENES[name], seed=17)
    t, _, _ = group.split_culled_closest(prims, _v3(o), _v3(d), 16)
    want = jprims.closest_hit(JV3(*map(jnp.asarray, o)),
                              JV3(*map(jnp.asarray, d)))
    found = np.asarray(want.found)
    assert found.any()
    np.testing.assert_array_equal((t < geom.T_FAR).numpy(), found)
    np.testing.assert_array_equal(t.numpy()[found], np.asarray(want.t)[found])
    blocked, _ = group.split_culled_occluded(
        prims, _v3(o), _v3(d), geom.RAY_EPS, torch.from_numpy(t_max), 16)
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(jprims.occluded(
            JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
            geom.RAY_EPS, jnp.asarray(t_max))))


def test_culled_lanes_of_each_design():
    assert [group.culled_lanes(k) for k in KS] == [
        (1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (8, 4)]
    assert group.culled_lanes(32, wide=False) == (32, 1)
    assert group.culled_lanes(4, wide=True) == (4, 1)
    with pytest.raises(ValueError, match="power of two"):
        group.culled_lanes(12)


# ------------------------------------------------------------------ dispatch


def _scene(name, **over):
    return load_scene(name).with_overrides(width=16, height=8,
                                           samples_per_pixel=8, max_depth=3,
                                           **over)


def _fog(name):
    return _scene(name, fog=Fog(density=0.15))


@pytest.mark.parametrize("scene, accel_, want", [
    (lambda: _fog("Cornell_Box"), "auto", "extra_kernel_xt_grouped"),
    (lambda: _fog("stress:1024"), "auto", "extra_kernel_xt_grouped"),
    (lambda: _fog("icosphere:4"), "auto", "extra_kernel_xt_grouped"),
    (lambda: _scene("stress:96"), "grid", "extra_kernel_grid_grouped"),
    (lambda: _scene("stress:1024"), "grid", "extra_kernel_grid_grouped"),
    (lambda: _scene("icosphere:3"), "grid", "extra_kernel_grid_grouped"),
    (lambda: _scene("icosphere:4"), "grid", "extra_kernel_grid_grouped"),
    (lambda: _scene("showcase"), "auto", "extra_kernel_ext_grouped"),
    (lambda: _scene("stress:96"), "gathered",
     "extra_kernel_gathered_grouped"),
    (lambda: _scene("Cornell_Box"), "auto", "extra_kernel_grouped")])
def test_kernel_b_dispatch(scene, accel_, want):
    """Kernel B's entry by instantiation and table size: XT tracers take
    their grouped entry at every size (over the budget it passes them on to
    its GroupSpill form), and so do grid tracers (what they stage counts
    the grid's group table; over the budget the entry passes them on to
    its GroupCulledSpill form); EXT and gathered tracers take theirs at
    every size (tests/test_torch_group_walk.py); the chunked kernel A's
    grouped entry serves the reference, XT and EXT gates over the table
    sweep, the culled sweep and the grid walk."""
    tr = PathTracer(scene(), "cpu", accel=accel_)
    kind = kernels._kind(tr)
    table = tr.tables.acc.numel() if kind == "grid" else 0
    assert kernels.group_smem_bytes(tr) == (kernels.group_rows_bytes(tr)
                                            + 4 * table)
    grouped = kernels.takes_grouped(tr)
    assert grouped == (want.endswith("grouped"))
    got = kernels.GROUPED_EXTRA[kind].__name__ if grouped else (
        "extra_kernel" + ("" if kind == "ref" else f"_{kind}"))
    assert got == want
    assert kernels.takes_grouped(tr, "chunked") == (
        kind in ("ref", "xt", "ext", "grid", "gathered") and grouped)


def _stream(tr, budget=2.0):
    x, y = tr.pixel_grid()
    s = kernels.sorted_stream(tr, tr.seed_lanes(x, y, SEED, 0),
                              torch.full((tr.height, tr.width), budget))
    return s.xs, s.ys, s.state, s.add, s.samp0


def test_new_grouped_wrappers_refuse_what_they_do_not_serve():
    ext = PathTracer(_scene("showcase"), "cpu")
    grid_big = PathTracer(_scene("icosphere:4"), "cpu", accel="grid")
    ref = PathTracer(_scene("Cornell_Box"), "cpu")
    xt = PathTracer(_fog("Cornell_Box"), "cpu")
    gathered = PathTracer(_scene("stress:96"), "cpu", accel="gathered")
    # The grid's over-budget table is served: extra_kernel_grid_grouped
    # passes it on to its GroupCulledSpill form.
    assert kernels._over_budget(grid_big) and kernels.takes_grouped(grid_big)
    for fn, cases in ((kernels.extra_kernel_xt_grouped,
                       ((ext, "instantiation"), (ref, "instantiation"),
                        (grid_big, "instantiation"))),
                      (kernels.extra_kernel_grid_grouped,
                       ((gathered, "instantiation"), (xt, "instantiation"),
                        (ref, "instantiation")))):
        for tr, match in cases:
            with pytest.raises(ValueError, match=match):
                fn(tr, POSE, *_stream(tr))


@pytest.mark.parametrize("fn, scene, accel_", [
    (kernels.extra_kernel_xt_grouped, lambda: _fog("Cornell_Box"), "auto"),
    (kernels.extra_kernel_grid_grouped, lambda: _scene("stress:48:3"),
     "grid")])
def test_new_grouped_wrappers_take_the_plain_versions_on_the_cpu(
        fn, scene, accel_):
    tr = PathTracer(scene(), "cpu", accel=accel_)
    n0 = fn.launches
    args = (tr, POSE, *_stream(tr))
    got, want = fn(*args), kernels.extra_kernel_plain(*args)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert float(got[1].sum()) > 0 and fn.launches == n0


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_scene(name, **over):
    return load_scene(name).with_overrides(width=64, height=16,
                                           samples_per_pixel=16, max_depth=8,
                                           **over)


def _held_on_the_card(tr, wrapper, k_name):
    """Kernel B through extra_kernel (the grouped `wrapper`) and the
    thread-per-entry entry against the plain version, bit for bit, with
    the counters; returns both entries' traversal counters and the plain
    version's (grid), else None."""
    a = kernels.base_kernel(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a.state, a.additional)
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    assert int((s.add > 0).sum()) > 0
    grid = tr.traversal == "grid"
    counts = []

    def counted(fn):
        if not grid:
            return fn()
        tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
        out = fn()
        torch.cuda.synchronize()
        counts.append(tr.accel_stats.cpu())
        tr.accel_stats = None
        return out

    n0 = wrapper.launches
    ek, rk, ik = counted(lambda: kernels.extra_kernel(*args))
    assert wrapper.launches == n0 + 1
    kind = kernels._kind(tr)
    et, rt, it_t = counted(lambda: kernels._launch_extra(*args, kind))
    if grid:
        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    ep, rp, _ = kernels.extra_kernel_plain(*args)
    if grid:
        counts.append(tr.prims.stats.long().cpu())
        tr.prims.ops = None
    it = kernels.extra_entry_iters(*args)
    for got in ((*ek, rk), (*et, rt)):
        for a_, b_ in zip(got, (*ep, rp)):
            assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))
    assert float(ik) == float(kernels.warp_iters(it, kernels.group_k(k_name)))
    assert float(it_t) == float(kernels.warp_iters(it, 1))
    for c in counts[1:]:
        assert torch.equal(c, counts[0])


@pytest.mark.cuda
def test_grouped_xt_extra_kernel_matches_plain_version(cuda_device):
    tr = PathTracer(_card_scene("Cornell_Box", fog=Fog(density=0.15)),
                    cuda_device, transport="mis")
    _held_on_the_card(tr, kernels.extra_kernel_xt_grouped, "extra_xt")


@pytest.mark.cuda
def test_grouped_grid_extra_kernel_matches_plain_version(cuda_device):
    tr = PathTracer(_card_scene("stress:96:3"), cuda_device, accel="grid")
    _held_on_the_card(tr, kernels.extra_kernel_grid_grouped, "extra_grid")
