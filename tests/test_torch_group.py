"""The grouped kernels' split sweep (csrc/group.cuh GroupSweep) and their
dispatch, on the CPU; the grouped kernels themselves on the card.

ops/group.py models the split sweep in plain PyTorch: k interleaved shares
of the table, each lane with its own running closest fed forward as t_max,
reduced by (t, then primitive index) over the shuffle butterfly, and the
shadow sweep as an OR over the shares. Held here bit for bit against the
serial sweep (the model at k = 1, which is csrc/trace.cuh closest_hit's
loop, and ops/geometry.py ScenePrims, which tests every primitive against
T_FAR and takes the first minimum) over seeded random rays, on
Cornell_Box, stress:64 and a table built for the edge cases: exact ties (a
primitive duplicated at several indices), rays that start inside a sphere,
rays parallel to a plane and to triangles, and primitives parked at 1e30
(the sphere test overflows to NaN there).

The `cuda` tests hold each grouped kernel against its plain version at
64x16 on the card (rays, sums, end states and totals equal bit for bit,
the counter equal to the plain model at the kernel's group width) and
skip here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.ops import geometry as geom
from terminal_raytracer_tpu_torch.ops import group, kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

KS = (1, 2, 4, 8, 32)
N_RAYS = 2048
POSE = Camera().pose()
SEED = 42


def _rays(seed: int, n: int = N_RAYS, box: float = 3.0):
    """Seeded rays: origins in [-box, box]^3, unit directions; a third of
    them with d.y = 0 (parallel to y-normal planes), a third with d.z = 0
    (parallel to z-normal triangles)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-box, box, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d[: n // 3, 1] = 0.0
    d[n // 3: 2 * n // 3, 2] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rs.uniform(0.01, 40.0, n).astype(np.float32)

    def v3(a):
        return V3(*(torch.from_numpy(a[:, c].copy()) for c in range(3)))

    return v3(o), v3(d), torch.from_numpy(t_max)


def _sph(c, r):
    return (*c, np.float32(r) * np.float32(r), np.float32(1.0) / np.float32(r))


def _tri(v0, e1, e2, n):
    return (*v0, *e1, *e2, *n)


PAD = (1e30, 1e30, 1e30)


def _edge_tables():
    """Spheres: a unit sphere at z = -20, the same sphere again at indices
    1 and 4, a sphere of radius 2 at the origin (rays start inside it), a
    sphere parked at 1e30. Planes: y = -1 twice, one parked. Triangles: a
    z = 3 triangle twice, one parked, one in y = -1.5."""
    sph = np.array([_sph((0, 0, -20), 1), _sph((0, 0, -20), 1),
                    _sph((0, 0, 0), 2), _sph(PAD, 1),
                    _sph((0, 0, -20), 1)], np.float32)
    pln = np.array([(0, -1, 0, 0, 1, 0, 0, 1, 0)] * 2
                   + [(*PAD, 0, 1, 0, 0, 1, 0)], np.float32)
    t0 = _tri((-1, -1, 3), (2, 0, 0), (0, 2, 0), (0, 0, 1))
    tri = np.array([t0, t0, _tri(PAD, (2, 0, 0), (0, 2, 0), (0, 0, 1)),
                    _tri((-2, -1.5, -2), (4, 0, 0), (0, 0, 4), (0, -1, 0))],
                   np.float32)
    n = len(sph) + len(pln) + len(tri)
    mat = np.zeros((n, geom.MAT_W), np.float32)
    lights = np.zeros((0, geom.LIGHT_W), np.float32)
    return geom.tables_from_parts(
        [torch.from_numpy(a) for a in (sph, pln, tri, mat, lights)], "cpu")


def _prims(name):
    if name == "edges":
        return geom.ScenePrims(_edge_tables())
    return PathTracer(load_scene(name), "cpu").prims


def _origins(name):
    """Rays for `name`: the edge table's from inside the origin sphere, from
    around it, and from behind the tied spheres aiming at them."""
    if name != "edges":
        return _rays(7)
    o, d, t_max = _rays(11)
    behind = slice(0, N_RAYS // 4)
    o.z[behind] = -30.0
    o.x[behind] = o.x[behind] * 0.1
    o.y[behind] = o.y[behind] * 0.1
    d.x[behind], d.y[behind], d.z[behind] = 0.0, 0.0, 1.0
    return o, d, t_max


SCENES = ("Cornell_Box", "stress:64", "edges")


def _first_minimum(prims, o, d):
    """ScenePrims.closest_hit's winner: every primitive tested against
    T_FAR at once, the first minimum."""
    t = prims._tests(o, d, geom.RAY_EPS, geom.T_FAR, False)
    t = torch.where((t > 0.0) & (t < geom.T_FAR), t, float("inf"))
    return torch.min(t, -1)[1]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", SCENES)
def test_split_closest_is_the_serial_sweep(name, k):
    """Every lane of the group ends with the serial sweep's winner: the same
    t and primitive index, bit for bit, as the model at k = 1 and as
    ScenePrims' closest hit."""
    prims = _prims(name)
    o, d, _ = _origins(name)
    lanes = group.split_closest(prims, o, d, k)
    t, idx = lanes[0]
    for tj, ij in lanes[1:]:
        assert torch.equal(tj, t) and torch.equal(ij, idx)
    t1, i1 = group.split_closest(prims, o, d, 1)[0]
    assert torch.equal(t, t1) and torch.equal(idx, i1)
    hit = prims.closest_hit(o, d)
    found = t < geom.T_FAR
    assert torch.equal(found, hit.found) and bool(found.any())
    assert torch.equal(t[found], hit.t[found])
    assert torch.equal(idx[found], _first_minimum(prims, o, d)[found])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", SCENES)
def test_split_occluded_is_the_shadow_or(name, k):
    prims = _prims(name)
    o, d, t_max = _origins(name)
    got = group.split_occluded(prims, o, d, geom.RAY_EPS, t_max, k)
    want = prims.occluded(o, d, geom.RAY_EPS, t_max)
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("k", (2, 4, 8))
def test_tied_primitives_resolve_to_the_lowest_index(k):
    """The three copies of the sphere at z = -20 (indices 0, 1 and 4) meet
    the rays aimed at it at one t, each copy in another lane for k >= 2 (4
    in lane 0 again for k = 2 and 4): the butterfly hands every lane index
    0."""
    prims = _prims("edges")
    o, d, _ = _origins("edges")
    aimed = slice(0, N_RAYS // 4)
    t0, i0 = group.lane_closest(prims, o, d, 0, k)
    t1, i1 = group.lane_closest(prims, o, d, 1, k)
    assert bool((i0[aimed] == 0).all()) and bool((i1[aimed] == 1).all())
    assert torch.equal(t0[aimed], t1[aimed])
    for t, idx in group.split_closest(prims, o, d, k):
        assert bool((idx[aimed] == 0).all())
        assert torch.equal(t[aimed], t0[aimed])


def test_edge_table_meets_its_cases():
    """The edge rays do reach each case: starts inside the origin sphere,
    parallel to the planes and to the z = 3 triangles, and a NaN in the
    parked sphere's test."""
    prims = _prims("edges")
    o, d, _ = _origins("edges")
    inside = (o.x * o.x + o.y * o.y + o.z * o.z) < 4.0
    assert int(inside.sum()) > 100
    assert int((d.y == 0.0).sum()) > 100 and int((d.z == 0.0).sum()) > 100
    pad = prims.tables.sph[3]
    oc = V3(pad[0] - o.x, pad[1] - o.y, pad[2] - o.z)
    h = d.x * oc.x + d.y * oc.y + d.z * oc.z
    disc = h * h - ((oc.x * oc.x + oc.y * oc.y + oc.z * oc.z) - pad[3])
    assert bool(torch.isnan(disc).any())
    t, idx = group.split_closest(prims, o, d, 4)[0]
    assert bool((idx[inside & (t < geom.T_FAR)] == 2).any())


def test_split_model_refuses_a_width_that_does_not_divide_a_warp():
    prims = _prims("Cornell_Box")
    o, d, t_max = _rays(3, 8)
    for k in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            group.split_closest(prims, o, d, k)
        with pytest.raises(ValueError, match="power of two"):
            group.split_occluded(prims, o, d, geom.RAY_EPS, t_max, k)


# ------------------------------------------------------- counter and dispatch


def test_warp_iters_counts_the_path_slots_of_a_warp():
    """A warp of k-lane groups spends 32 / k slots for its longest entry's
    iterations (trace.cuh count_slot_iters); k = 1 is 32 x each warp's
    longest thread."""
    it = torch.arange(70, dtype=torch.int64) % 9
    want1 = sum(32 * int(it[i:i + 32].max()) for i in range(0, 70, 32))
    assert float(kernels.warp_iters(it)) == want1
    assert float(kernels.warp_iters(it, 1)) == want1
    want8 = sum(4 * int(it[i:i + 4].max()) for i in range(0, 70, 4))
    assert float(kernels.warp_iters(it, 8)) == want8
    assert float(kernels.warp_iters(it, 32)) == float(it.sum())
    with pytest.raises(ValueError, match="divide"):
        kernels.warp_iters(it, 3)
    lone = torch.zeros(70, dtype=torch.int64)
    lone[[3, 40]] = 5
    assert [kernels.working_warps(lone, k) for k in (1, 8, 32)] == [2, 2, 2]
    assert float(kernels.warp_iters(lone, 8)) == 2 * 4 * 5


def _scene(name, **over):
    return load_scene(name).with_overrides(width=16, height=8,
                                           samples_per_pixel=8, max_depth=3,
                                           **over)


@pytest.mark.parametrize("name, accel, grouped, chunked", [
    ("Cornell_Box", "auto", True, True), ("stress:1024", "auto", True, True),
    ("icosphere:3", "auto", True, True), ("icosphere:4", "auto", True, True),
    ("showcase", "auto", True, True), ("stress:96", "grid", True, True),
    ("stress:96", "gathered", True, True)])
def test_grouped_dispatch_by_the_table_size(name, accel, grouped, chunked):
    """The grouped entries serve the reference gates over the table sweep
    (kernel B also the XT and EXT gates, the culled sweep, whose group
    table is staged too, and the grid walk; the chunked kernel A also the
    XT and EXT gates, the culled sweep and the grid walk): 1024 spheres
    take 20 KB of rows, 1280 triangles 60 KB,
    within the shared-memory budget; 5120 triangles take 240 KB, over it,
    where the grouped entries of kernel B and the chunked kernel A pass the
    tracer on to their GroupSpill forms (tests/test_torch_group_spill.py)."""
    tr = PathTracer(_scene(name), "cpu", accel=accel)
    n_sph, n_pln, n_tri, _ = tr.tables.counts
    assert kernels.group_rows_bytes(tr) == 4 * (5 * n_sph + 9 * n_pln
                                                + 12 * n_tri)
    assert kernels.takes_grouped(tr) is grouped
    assert kernels.takes_grouped(tr, "chunked") is chunked


def test_grouped_wrappers_refuse_what_they_do_not_serve():
    grid_big = PathTracer(_scene("icosphere:4"), "cpu", accel="grid")
    ext = PathTracer(_scene("showcase"), "cpu")
    for tr, match in ((grid_big, "instantiation"), (ext, "instantiation")):
        with pytest.raises(ValueError, match=match):
            kernels.base_kernel_chunked_grouped(tr, POSE, SEED, 0)
        with pytest.raises(ValueError, match=match):
            kernels.extra_kernel_grouped(tr, POSE, *_stream(tr))


def _stream(tr, budget=2.0):
    """Kernel B's sorted stream with `budget` extra samples a pixel,
    continuing from the pixels' seeds."""
    x, y = tr.pixel_grid()
    s = kernels.sorted_stream(tr, tr.seed_lanes(x, y, SEED, 0),
                              torch.full((tr.height, tr.width), budget))
    return s.xs, s.ys, s.state, s.add, s.samp0


def test_grouped_wrappers_take_the_plain_versions_on_the_cpu():
    tr = PathTracer(_scene("Cornell_Box"), "cpu")
    n_b, n_a = (kernels.extra_kernel_grouped.launches,
                kernels.base_kernel_chunked_grouped.launches)
    args = (tr, POSE, *_stream(tr))
    got, want = (kernels.extra_kernel_grouped(*args),
                 kernels.extra_kernel_plain(*args))
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    got = kernels.base_kernel_chunked_grouped(tr, POSE, SEED, 0)
    want = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    assert torch.equal(got.state, want.state)
    assert (kernels.extra_kernel_grouped.launches,
            kernels.base_kernel_chunked_grouped.launches) == (n_b, n_a)


def test_entry_iterations_match_the_plain_scheduler():
    """Per-entry iterations (the kernels' counter's input): a lone path a
    warp (k = 32) counts each entry's own iterations, whose sum over the
    entries is the plain scheduler's executed iterations."""
    tr = PathTracer(_scene("stress:64"), "cpu", chunk_base=2, chunk_extra=2)
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0)
    assert it.shape == (tr.n_base_chunks, tr.height, tr.width)
    assert float(kernels.warp_iters(it, 32)) == float(it.sum())
    assert bool((it > 0).all())
    args = (tr, POSE, *_stream(tr))
    it_b = kernels.extra_entry_iters(*args)
    assert it_b.shape == args[2].shape
    assert bool(((it_b > 0) == (args[5] > 0)).all())


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_scene(name):
    return load_scene(name).with_overrides(width=64, height=16,
                                           samples_per_pixel=16, max_depth=8)


@pytest.mark.cuda
def test_grouped_extra_kernel_matches_plain_version(cuda_device):
    """Kernel B's grouped entry at 64x16 against its plain version and the
    thread-per-entry entry: rays and esum bits equal, the counter equal to
    the plain model at each entry's group width."""
    tr = PathTracer(_card_scene("Cornell_Box"), cuda_device)
    a = kernels.base_kernel(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a.state, a.additional)
    args = (tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    assert int((s.add > 0).sum()) > 0
    n0 = kernels.extra_kernel_grouped.launches
    ek, rk, ik = kernels.extra_kernel(*args)
    assert kernels.extra_kernel_grouped.launches == n0 + 1
    ep, rp, _ = kernels.extra_kernel_plain(*args)
    et, rt, it_t = kernels._launch_extra(*args, "ref")
    it = kernels.extra_entry_iters(*args)
    for got in ((*ek, rk), (*et, rt)):
        for a_, b_ in zip(got, (*ep, rp)):
            assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))
    assert float(ik) == float(kernels.warp_iters(it, kernels.group_k("extra")))
    assert float(it_t) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
def test_grouped_chunked_kernel_matches_plain_version(cuda_device):
    """The chunked kernel A's grouped entry at 64x16 (stress:120:7, chunks
    of 2) against its plain version and the thread-per-entry entry: rays,
    sums, end states and per-pixel totals equal bit for bit."""
    tr = PathTracer(_card_scene("stress:120:7"), cuda_device, chunk_base=2,
                    chunk_extra=2)
    n0 = kernels.base_kernel_chunked_grouped.launches
    k = kernels.base_kernel_chunked(tr, POSE, SEED, 0)
    assert kernels.base_kernel_chunked_grouped.launches == n0 + 1
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    t = kernels._launch_chunked(tr, POSE, SEED, 0, 0, None, "ref")
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0)
    for got in (k, t):
        assert torch.equal(got.rays, p.rays)
        assert torch.equal(got.state, p.state)
        for a_, b_ in zip((*got.csum, *got.csumsq), (*p.csum, *p.csumsq)):
            assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))
            assert torch.equal(tr.chunk_total(a_), tr.chunk_total(b_))
    assert float(k.iters) == float(kernels.warp_iters(
        it, kernels.group_k("chunked")))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))


@pytest.mark.cuda
def test_a_table_over_the_budget_takes_the_thread_per_entry_kernels(
        cuda_device):
    """icosphere:4 (5120 triangles, 240 KB of rows, over the budget)
    renders through the GroupSpill forms of the grouped kernel B and
    chunked kernel A, no longer the thread-per-entry entries."""
    tr = PathTracer(_card_scene("icosphere:4"), cuda_device, chunk_base=2,
                    chunk_extra=2)
    assert kernels.takes_grouped(tr)
    names = ("base_kernel_chunked", "extra_kernel",
             "base_kernel_chunked_grouped", "extra_kernel_grouped",
             "base_kernel_chunked_grouped_spill",
             "extra_kernel_grouped_spill")
    counts = [getattr(kernels, n).launches for n in names]
    render = kernels.make_sorted_render_frame(tr)
    cur, var, tot, rays, _ = render(POSE, SEED, 0)
    assert [getattr(kernels, n).launches for n in names] == [
        *counts[:4], counts[4] + 1, counts[5] + 1]
    pcur, pvar, ptot, prays, _ = tr.render_frame(POSE, SEED, 0)
    assert float(rays) == float(prays)
    for a_, b_ in zip((*cur, var, tot), (*pcur, pvar, ptot)):
        assert torch.equal(a_, b_)
