"""The grouped kernel B over the grid walk of `--accel gathered`
(csrc/group.cuh GroupWalk) and the grouped kernel B at the EXT gates: the
split walk's plain model, the dispatch and the wrappers on the CPU; the
kernels on the card.

ops/group.py split_walk_closest / split_walk_occluded model the split
walk in plain PyTorch: every lane of a group makes the walk's DDA
decisions, and each cell's bucket is tested in windows of k entries with
the running closest at the window's start, reduced by (t, then position
in the bucket). Held here against the serial walk (ops/gathered.py
GatheredPrims, the plain version of the kernels, and the JAX package's
GatheredPrims oracle) at k in {2, 4, 8, 16}: the hit's t bits and index
and the four traversal counters (walks, tests, advances, capped walks)
equal, on random rays over `stress:64` and `icosphere:1`, on rays from
inside spheres, with the trip cap cut to a few steps, and on ties: two
copies of one sphere spanning several cells keep the walk-order winner,
also with the buckets reversed (a valid grid whose bucket order is not
the primitive order), where a reduction by primitive index across cells
picks the other copy.

The sorted frames of showcase (the grouped EXT kernel B) and of stress:64
under `--accel gathered` (the grouped gathered kernel B) through the
dispatch, their plain versions here, against the JAX oracle.

The `cuda` tests hold each new entry bit for bit against its plain
version at small sizes (esum bits, rays, lane-iterations the plain model's
at its group width, the walk's counters the plain version's), the EXT
GroupSpill form at every split cap of tests/test_torch_group_spill.py and
the walk's staged row sources at caps that split the rows; they skip here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import build, gathered, group  # noqa: E402
from terminal_raytracer_tpu_torch.ops import geometry as geom  # noqa: E402
from terminal_raytracer_tpu_torch.ops import kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from terminal_raytracer_tpu_torch.ops.vecmath import V3  # noqa: E402
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

KS = (2, 4, 8, 16)
N_RAYS = 256
POSE = Camera().pose()
SEED = 42
RTOL, ATOL = 1e-4, 1e-5
# Knife-edge bounds of the frames through the dispatch, by scene: (pixels
# off, their summed error), as the test's seed shows on the CPU: none.
KNIFE = {"showcase": (0, 0.0), "stress:64": (0, 0.0)}
SPLIT_CAPS = (0, 168)  # tests/test_torch_group_spill.py
SCENES = {"stress:64": ((-10, 0.2, -22), (10, 8, 0)),
          "icosphere:1": ((-3, -1, -8), (3, 4, 2))}


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
    return _v3(o), _v3(d), torch.from_numpy(t_max)


def _prims(scene):
    prims = PathTracer(scene, "cpu", accel="gathered").prims
    assert isinstance(prims, gathered.GatheredPrims)
    return prims


def _serial_closest(prims, o, d):
    """GatheredPrims' closest hit: (t, flatten index or -1, counters)."""
    seen = {}
    hit_at = prims.hit_at

    def capture(o_, d_, found, closest, idx):
        seen["idx"] = torch.where(found, idx, -1)
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


def _assert_closest(prims, o, d, k):
    t, idx, cnt = group.split_walk_closest(prims, o, d, k)
    t_s, idx_s, stats = _serial_closest(prims, o, d)
    assert torch.equal(t.view(torch.int32), t_s.view(torch.int32))
    assert torch.equal(idx, idx_s)
    assert cnt.sum(1).double().tolist() == stats.tolist()
    return t, idx, cnt


def _assert_occluded(prims, o, d, t_max, k):
    blocked, cnt = group.split_walk_occluded(prims, o, d, geom.RAY_EPS,
                                             t_max, k)
    want, stats = _serial_occluded(prims, o, d, t_max)
    assert torch.equal(blocked, want)
    assert cnt.sum(1).double().tolist() == stats.tolist()
    return blocked


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(SCENES))
def test_split_walk_is_the_serial_walk(name, k):
    """Random rays: the hits (t bits, index), shadow flags and the four
    counters equal GatheredPrims'; the walks test several entries a cell
    and advance."""
    prims = _prims(load_scene(name))
    o, d, t_max = _rays(N_RAYS, *SCENES[name], seed=5)
    t, _, cnt = _assert_closest(prims, o, d, k)
    assert bool((t < geom.T_FAR).any())
    walks, tests, advances, capped = cnt.sum(1).tolist()
    assert walks == N_RAYS and tests > walks and advances > 0 and capped == 0
    blocked = _assert_occluded(prims, o, d, t_max, k)
    assert 0 < int(blocked.sum()) < N_RAYS


def test_split_walk_matches_the_jax_walk():
    """The model at k = 4 against the JAX package's GatheredPrims oracle
    (the same walk, jnp) on the same rays: found, the winner and the shadow
    flags equal, t within rtol 1e-5 (XLA-CPU contracts multiply-adds in its
    loop, tests/test_torch_gathered.py)."""
    import jax.numpy as jnp

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import gathered as jgathered
    from terminal_raytracer_tpu.ops.vecmath import V3 as JV3

    name = "stress:64"
    prims = _prims(load_scene(name))
    jprims = jgathered.GatheredPrims(jload(name))
    o, d, t_max = _rays(N_RAYS, *SCENES[name], seed=11)
    jo, jd = (JV3(*(jnp.asarray(c.numpy()) for c in v)) for v in (o, d))
    t, idx, _ = group.split_walk_closest(prims, o, d, 4)
    want = jprims.closest_hit(jo, jd)
    found = np.asarray(want.found)
    np.testing.assert_array_equal((idx >= 0).numpy(), found)
    np.testing.assert_allclose(t.numpy()[found], np.asarray(want.t)[found],
                               rtol=1e-5)
    blocked, _ = group.split_walk_occluded(prims, o, d, geom.RAY_EPS, t_max,
                                           4)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(
        jprims.occluded(jo, jd, geom.RAY_EPS, jnp.asarray(t_max.numpy()))))


@pytest.mark.parametrize("k", KS)
def test_rays_from_inside_spheres(k):
    """Origins just off the stress field's sphere centres: the near root
    lies behind, the far one is taken in the first cell."""
    scene = load_scene("stress:64")
    prims = _prims(scene)
    rs = np.random.RandomState(9)
    centres = np.float32([s.center for s in scene.spheres])
    o = (centres[rs.randint(0, len(centres), N_RAYS)]
         + rs.uniform(-0.05, 0.05, (N_RAYS, 3))).astype(np.float32).T
    d = rs.normal(size=(3, N_RAYS)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    radius = max(s.radius for s in scene.spheres)
    t, _, _ = _assert_closest(prims, _v3(o), _v3(d), k)
    assert bool((t < radius + 0.1).all())
    _assert_occluded(prims, _v3(o), _v3(d), torch.full((N_RAYS,), 30.0), k)


@pytest.mark.parametrize("k", KS)
def test_trip_cap_is_replayed(k):
    """With max_trips cut to a few steps the group stops where the serial
    walk stops: a window takes at most the trips left, and the capped walks
    are counted alike."""
    prims = _prims(load_scene("stress:64"))
    o, d, t_max = _rays(N_RAYS, *SCENES["stress:64"], seed=5)
    prims.max_trips = 5
    _, _, cnt = _assert_closest(prims, o, d, k)
    assert cnt[3].sum() > 0
    _assert_occluded(prims, o, d, t_max, k)


def _tied():
    """stress:16 with two copies of one large sphere: rays aimed at it tie
    exactly, and the copies span several cells of the grid."""
    scene = load_scene("stress:16:3")
    copy = scene.spheres[-1]._replace(center=(0.0, 3.0, -12.0), radius=2.5)
    return dataclasses.replace(scene, spheres=scene.spheres + (copy,) * 2)


def _tied_rays():
    rs = np.random.RandomState(13)
    o = np.float32([[0.0], [3.0], [0.0]]) + rs.uniform(
        -0.3, 0.3, (3, N_RAYS)).astype(np.float32)
    aim = np.float32([[0.0], [3.0], [-12.0]]) + rs.uniform(
        -1.5, 1.5, (3, N_RAYS)).astype(np.float32)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    return _v3(o), _v3(d)


def _reverse_buckets(prims):
    """The grid with every cell's bucket in reverse primitive order."""
    off, idx = prims._off, prims._idx.clone()
    for c in range(off.numel() - 1):
        a, b = int(off[c]), int(off[c + 1])
        idx[a:b] = idx[a:b].flip(0)
    prims._idx = idx


def _by_index(prims, o, d, mask=None):
    """The mutant: the walk's candidates reduced by (t, primitive index)
    across cells, an equal t with a lower index taking the hit."""
    active, ic, tm, stp, dt = prims.walk_start(o, d, geom.T_FAR, mask)
    cur, end = prims._cell_range(*ic)
    best = torch.full(o.x.shape, -1, dtype=torch.int64)
    t_best = torch.full_like(o.x, geom.T_FAR)
    while bool(active.any()):
        work = active & (cur < end)
        pid = prims._idx[torch.where(work, cur, 0)]
        t, _ = prims.test_at(pid, o, d, geom.RAY_EPS,
                             torch.nextafter(t_best, t_best + 1.0))
        ok = work & (t > 0.0) & ((t < t_best)
                                 | ((t == t_best) & (pid < best)))
        best, t_best = torch.where(ok, pid, best), torch.where(ok, t, t_best)
        cur = cur + work.long()
        done, move = prims.advance(active & ~work, ic, tm, stp, dt, t_best)
        new_cur, new_end = prims._cell_range(*ic)
        cur, end = torch.where(move, new_cur, cur), torch.where(move, new_end,
                                                                end)
        active = active & ~done
    return best


@pytest.mark.parametrize("k", (2, 8))
@pytest.mark.parametrize("reverse", [False, True])
def test_ties_across_cells_keep_the_walk_order_winner(k, reverse):
    """Two copies of a sphere that spans several cells, every ray hitting
    both at one t: the walk keeps the copy it meets first in walk order
    (the lower index in primitive-ordered buckets, the higher one with the
    buckets reversed), and so does the split walk; reducing by primitive
    index across cells picks the lower index, which the reversed grid
    tells apart."""
    scene = _tied()
    prims = _prims(scene)
    n = len(scene.spheres)
    copies = (n - 2, n - 1)
    spans = [sum(int(c in prims._idx[int(prims._off[i]):
                                     int(prims._off[i + 1])].tolist())
                 for i in range(prims._off.numel() - 1)) for c in copies]
    assert min(spans) >= 2
    if reverse:
        _reverse_buckets(prims)
    o, d = _tied_rays()
    _, idx, _ = _assert_closest(prims, o, d, k)
    hit = (idx == copies[0]) | (idx == copies[1])
    assert int(hit.sum()) > N_RAYS // 2
    want = copies[1] if reverse else copies[0]
    assert bool((idx[hit] == want).all())
    mutant = _by_index(prims, o, d)
    assert bool((mutant[hit] == copies[0]).all())
    assert torch.equal(mutant[hit] == idx[hit],
                       torch.full_like(idx[hit], not reverse,
                                       dtype=torch.bool))


def test_split_walk_refuses_a_width_that_is_no_power_of_two():
    prims = _prims(load_scene("stress:16:3"))
    o, d, _ = _rays(4, *SCENES["stress:64"], seed=1)
    with pytest.raises(ValueError, match="power of two"):
        group.split_walk_closest(prims, o, d, 3)


# ------------------------------------------------------------------ dispatch


def _scene(name, **over):
    return load_scene(name).with_overrides(width=16, height=8,
                                           samples_per_pixel=8, max_depth=3,
                                           **over)


def _checker(scene):
    """`scene` with a checker floor: an extension scene (its first plane
    checkered, as chip_smoke.py's checker stress:1024)."""
    floor = scene.planes[0]
    mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                  checker_scale=1.0)
    return dataclasses.replace(scene, planes=(floor._replace(material=mat),))


@pytest.mark.parametrize("scene, accel_, want, spill", [
    (lambda: _scene("showcase"), "auto", "extra_kernel_ext_grouped", False),
    (lambda: _checker(_scene("stress:1024")), "auto", "extra_kernel_ext_grouped",
     False),
    (lambda: _checker(_scene("icosphere:4")), "auto", "extra_kernel_ext_grouped",
     True),
    (lambda: _scene("stress:64"), "gathered",
     "extra_kernel_gathered_grouped", False),
    (lambda: _scene("icosphere:4"), "gathered",
     "extra_kernel_gathered_grouped", False)])
def test_new_kernel_b_dispatch(scene, accel_, want, spill):
    """EXT tracers take the grouped EXT kernel B at every size (over the
    budget it passes them on to its GroupSpill form), gathered tracers the
    grouped walk at every size; the chunked kernel A is grouped at the EXT
    gates (tests/test_torch_group_a2.py) and over the walk
    (tests/test_torch_group_walk_chunked.py), at every size too."""
    tr = PathTracer(scene(), "cpu", accel=accel_)
    assert kernels.takes_grouped(tr)
    assert kernels.GROUPED_EXTRA[kernels._kind(tr)].__name__ == want
    assert (kernels._kind(tr) in kernels.SPILL_EXTRA
            and kernels._over_budget(tr)) is spill
    assert kernels.takes_grouped(tr, "chunked") is (kernels._kind(tr)
                                                    in ("ext", "gathered"))


def _stream(tr, budget=2.0):
    x, y = tr.pixel_grid()
    s = kernels.sorted_stream(tr, tr.seed_lanes(x, y, SEED, 0),
                              torch.full((tr.height, tr.width), budget))
    return s.xs, s.ys, s.state, s.add, s.samp0


def test_new_wrappers_refuse_other_instantiations():
    ext = PathTracer(_scene("showcase"), "cpu")
    ref = PathTracer(_scene("Cornell_Box"), "cpu")
    gath = PathTracer(_scene("stress:64"), "cpu", accel="gathered")
    grid = PathTracer(_scene("stress:64"), "cpu", accel="grid")
    xt = PathTracer(_scene("Cornell_Box", fog=Fog(density=0.15)), "cpu")
    for fn, trs in ((kernels.extra_kernel_ext_grouped, (ref, gath, grid, xt)),
                    (kernels.extra_kernel_ext_grouped_spill,
                     (ref, gath, grid, xt)),
                    (kernels.extra_kernel_gathered_grouped,
                     (ext, ref, grid, xt))):
        for tr in trs:
            with pytest.raises(ValueError, match="instantiation"):
                fn(tr, POSE, *_stream(tr))


@pytest.mark.parametrize("fn, scene, accel_", [
    (kernels.extra_kernel_ext_grouped, lambda: _scene("showcase"), "auto"),
    (kernels.extra_kernel_ext_grouped_spill, lambda: _scene("showcase"),
     "auto"),
    (kernels.extra_kernel_gathered_grouped, lambda: _scene("stress:48:3"),
     "gathered")])
def test_new_wrappers_take_the_plain_versions_on_the_cpu(fn, scene, accel_):
    tr = PathTracer(scene(), "cpu", accel=accel_)
    counts = (fn.launches, kernels.extra_kernel_ext_grouped_spill.launches)
    args = (tr, POSE, *_stream(tr))
    got, want = fn(*args), kernels.extra_kernel_plain(*args)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert float(got[1].sum()) > 0
    assert (fn.launches,
            kernels.extra_kernel_ext_grouped_spill.launches) == counts


@pytest.mark.parametrize("name, accel_, wrapper", [
    ("showcase", "auto", "extra_kernel_ext_grouped"),
    ("stress:64", "gathered", "extra_kernel_gathered_grouped")])
def test_frame_through_the_new_dispatch_matches_jax_oracle(name, accel_,
                                                           wrapper):
    """The sorted frame (16x8, 8 spp, depth 3) through base_kernel and
    extra_kernel as the card dispatches them (the grouped wrappers, their
    plain versions here), against the JAX package's render_frame: rays and
    samples exact, radiance within the tolerance but for knife edges."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import tracer as jtracer

    size = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
    jt = jtracer.PathTracer(jload(name).with_overrides(**size), accel=accel_)
    jcur, _jvar, jtot, jrays = jax.device_get(jax.jit(jt.render_frame)(
        POSE, np.uint32(SEED), np.int32(0)))
    tr = PathTracer(_scene(name), "cpu", accel=accel_)
    assert kernels.GROUPED_EXTRA[kernels._kind(tr)].__name__ == wrapper
    assert kernels.takes_grouped(tr)
    cur, _var, tot, rays, _ = kernels.make_sorted_render_frame(tr)(
        POSE, SEED, 0)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    assert (jtot > tr.base_samples).any()
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               np.stack(jcur)).check(KNIFE[name])


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


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _held_b(tr, kind, name, lib=None):
    """Kernel B's grouped form `kind` ('ext_grouped', 'ext_grouped_spill'
    or 'gathered_grouped'; from `lib`, else through extra_kernel, which
    must launch it) and the thread-per-entry entry against the plain
    version, bit for bit, the lane-iterations the plain model's at the
    group width of `name`, the walk's counters the plain version's."""
    a = kernels.base_phase(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a[2], a[7])
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    assert int((s.add > 0).sum()) > 0
    walk = tr.traversal == "gathered"
    counts = []

    def counted(fn):
        if not walk:
            return fn()
        tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
        out = fn()
        torch.cuda.synchronize()
        counts.append(tr.accel_stats.cpu())
        tr.accel_stats = None
        return out

    if lib is None:
        wrapper = getattr(kernels, f"extra_kernel_{kind}")
        n0 = wrapper.launches
        g = counted(lambda: kernels.extra_kernel(*args))
        assert wrapper.launches == n0 + 1
    else:
        g = counted(lambda: kernels._launch_extra(*args, kind, lib))
    th = counted(lambda: kernels._launch_extra(*args, kernels._kind(tr)))
    if walk:
        tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    p = kernels.extra_kernel_plain(*args)
    if walk:
        plain = tr.prims.stats.long().cpu()
        tr.prims.ops = None
        assert torch.equal(counts[0], plain) and torch.equal(counts[1],
                                                             plain)
        assert int(plain[3]) == 0 and int(plain[1]) > 0
    it = kernels.extra_entry_iters(*args)
    for got in (g, th):
        for x, y in zip((*got[0], got[1]), (*p[0], p[1])):
            assert torch.equal(_bits(x), _bits(y))
    assert float(g[2]) == float(kernels.warp_iters(
        it, kernels.group_k(name, lib)))
    assert float(th[2]) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["showcase", "cornell_glass", "textured"])
def test_ext_grouped_entry_matches_plain_version(cuda_device, name):
    tr = PathTracer(_card_scene(name), cuda_device)
    _held_b(tr, "ext_grouped", "extra_ext")


@pytest.mark.cuda
def test_ext_spill_entry_matches_plain_version_over_the_budget(cuda_device):
    tr = PathTracer(_checker(_card_scene("icosphere:4")), cuda_device)
    assert kernels._over_budget(tr) and tr.ext and not tr.xt
    _held_b(tr, "ext_grouped_spill", "extra_ext_spill")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stress:64", "icosphere:1", "showcase",
                                  "icosphere:4"])
def test_gathered_grouped_entry_matches_plain_version(cuda_device, name):
    tr = PathTracer(_card_scene(name), cuda_device, accel="gathered")
    _held_b(tr, "gathered_grouped", "extra_gathered")


@pytest.fixture(scope="module")
def walk_libs():
    """group_tune.cu libraries (K = 8, 128 lanes a block): the SPLIT_CAPS
    stage caps with the EXT GroupSpill form, and GroupWalk's staged row
    sources at caps that split the rows (168 bytes) and the CSR (2 KB:
    stress:64's CSR does not fit, its rows do in part), built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    srcs = {(walk, cap): (build.TUNE_SOURCE, (
        "TRT_TUNE_K=8", "TRT_TUNE_THREADS=128", f"TRT_TUNE_STAGE_CAP={cap}",
        f"TRT_TUNE_WALK={walk}"))
        for walk, cap in ((0, 0), (0, 168), (1, 168), (2, 168), (1, 2048),
                          (2, 2048), (2, 65536))}
    build.library_paths(tuple(srcs.values()))
    return {key: build.load_kernels((src,)) for key, src in srcs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cap", SPLIT_CAPS)
@pytest.mark.parametrize("name", ["showcase", "textured"])
def test_ext_spill_at_every_split_point(cuda_device, walk_libs, name, cap):
    lib = walk_libs[0, cap]
    assert kernels.group_cap("extra_ext_spill", lib) == cap
    _held_b(PathTracer(_card_scene(name), cuda_device), "ext_grouped_spill",
            "extra_ext_spill", lib)


@pytest.mark.cuda
@pytest.mark.parametrize("walk, cap", [(1, 168), (2, 168), (1, 2048),
                                       (2, 2048), (2, 65536)])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:1"])
def test_walk_row_sources_match_plain_version(cuda_device, walk_libs, name,
                                              walk, cap):
    tr = PathTracer(_card_scene(name), cuda_device, accel="gathered")
    _held_b(tr, "gathered_grouped", "extra_gathered", walk_libs[walk, cap])
