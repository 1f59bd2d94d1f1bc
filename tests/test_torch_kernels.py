"""The port's kernel modules (ops/kernels.py) against the JAX package's
Pallas kernels, run in interpret mode as the JAX package's own tests run
them on the CPU.

Here the wrappers take their plain PyTorch versions (the tensors lie on the
CPU). Decisions must agree exactly: owed rays, adaptive budgets, end RNG
states. Sums within rtol 1e-4 / atol 1e-5, which covers the ulp-level
sin/cos/rsqrt and multiply-add contraction differences between XLA-CPU and
PyTorch-CPU. Depth 3 keeps every decision below Russian roulette's start
(RR_START_BOUNCE), and Cornell_Box's lights are triangles, whose NEE shadow
rays have no self-shadowing knife edge (see test_torch_slice.py).

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera, load_scene
from terminal_raytracer_tpu.ops import pallas_kernel as pk
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer, cam_from_pose
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 42
RTOL, ATOL = 1e-4, 1e-5


def _cornell(w=128, h=8, spp=16, depth=3):
    return load_scene("Cornell_Box").with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shard", [None, (4, 4)], ids=["full", "rows4-8"])
def test_kernel_a_plain_matches_pallas_kernel_a(shard):
    """Kernel A with the fold_budget epilogue, per pixel; `shard` renders a
    row block (h_out rows at offset y0) as the JAX sharded path does."""
    scene = _cornell()
    h_out, y0 = shard if shard else (scene.height, 0)
    base_fn, _tracer, _pair = pk.make_base_kernel(
        scene, interpret=True, fold_budget=True,
        shard_rows=h_out if shard else None)
    j = jax.device_get(jax.jit(base_fn)(POSE, np.uint32(SEED), np.int32(0),
                                        np.int32(y0)))
    jcsum, jcsq, jstate, jrays, _it, jvar, jadd = j
    t = kernels.base_kernel(PathTracer(scene, "cpu"), POSE, SEED, 0, y0=y0,
                            h_out=h_out)
    np.testing.assert_array_equal(t.rays.numpy(), jrays)
    np.testing.assert_array_equal(t.additional.numpy(), jadd)
    np.testing.assert_array_equal(t.state.numpy(), jstate.astype(np.int64))
    assert (jadd > 0).any()  # the budget epilogue is exercised
    for a, b in zip(list(t.csum) + list(t.csumsq), list(jcsum) + list(jcsq)):
        _close(a, b)
    _close(t.var, jvar)


def _stream(rows=8, cols=128, seed=0):
    """A numpy-made kernel-B stream: random pixels, states (incl. >= 2**31)
    and budgets, a third of them zero."""
    rs = np.random.RandomState(seed)
    xs = rs.randint(0, 128, (rows, cols)).astype(np.int32)
    ys = rs.randint(0, 8, (rows, cols)).astype(np.int32)
    st = rs.randint(0, 2**32, (rows, cols), dtype=np.uint64).astype(np.uint32)
    add = np.where(rs.rand(rows, cols) < 0.66,
                   rs.randint(1, 13, (rows, cols)), 0).astype(np.float32)
    s0 = np.full((rows, cols), 4, np.int32)
    return xs, ys, st, add, s0


def test_kernel_b_plain_matches_pallas_kernel_b():
    scene = _cornell()
    xs, ys, st, add, s0 = _stream()
    extra = pk.make_extra_kernel(scene, 8, 128, max_quota=12, tile_h=8,
                                 tile_w=128, interpret=True)
    jesum, jrays, _it = jax.device_get(
        jax.jit(extra)(POSE, xs, ys, st, add, s0))
    tesum, trays, _ = kernels.extra_kernel(
        PathTracer(scene, "cpu"), POSE, torch.from_numpy(xs),
        torch.from_numpy(ys), torch.from_numpy(st.astype(np.int64)),
        torch.from_numpy(add), torch.from_numpy(s0))
    np.testing.assert_array_equal(trays.numpy(), jrays)
    assert (trays.numpy()[add == 0] == 0).all()
    for a, b in zip(tesum, jesum):
        _close(a, b)


def test_sorted_stream_layout_and_unsort():
    """The glue: descending budgets, zero-padded (16k, 512) stream, and an
    unsort that inverts the sort; kernel B over the sorted stream equals the
    extra phase over the image in place, bit for bit."""
    scene = _cornell(w=96, h=20)
    tr = PathTracer(scene, "cpu")
    a = kernels.base_kernel(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a.state, a.additional)
    assert s.xs.shape[1] == 512 and s.xs.shape[0] % 16 == 0
    add = s.add.reshape(-1)
    assert bool((add[:-1] >= add[1:]).all())
    assert float(add[96 * 20:].abs().sum()) == 0.0  # padding owes nothing
    pix = s.ys * 96 + s.xs
    np.testing.assert_array_equal(
        kernels.unsort(s, pix, (20, 96)).numpy(),
        np.arange(96 * 20).reshape(20, 96))
    esum, rays, _ = kernels.make_sorted_extra_phase(tr)(POSE, a.state,
                                                         a.additional)
    x, y = tr.pixel_grid()
    want, want_rays, _ = tr.extra_phase(
        cam_from_pose(POSE), x.float(), y.float(), a.state, a.additional,
        torch.full_like(a.state, tr.base_samples))
    for g, w in zip(esum, want):
        assert torch.equal(g, w)
    assert float(rays) == float(want_rays.sum())


def test_sorted_pipeline_matches_pallas_sorted_pipeline():
    scene = _cornell()
    jrender = jax.jit(pk.make_sorted_render_frame(scene, interpret=True))
    jcur, jvar, jtot, jrays, _occ = jax.device_get(
        jrender(POSE, np.uint32(SEED), np.int32(1)))
    render = kernels.make_sorted_render_frame(PathTracer(scene, "cpu"))
    cur, var, tot, rays, occ = render(POSE, SEED, 1)
    assert float(rays) == float(jrays)
    np.testing.assert_array_equal(tot.numpy(), jtot)
    assert (jtot > 4).any()  # some pixels took extra samples (base is 4)
    for a, b in zip(cur, jcur):
        _close(a, b)
    _close(var, jvar)
    assert 0.0 < float(occ) <= 1.0


def test_wrappers_take_plain_versions_on_cpu_only():
    scene = _cornell(w=16, h=4)
    tr = PathTracer(scene, "cpu")
    before = (kernels.base_kernel.launches, kernels.extra_kernel.launches)
    a = kernels.base_kernel(tr, POSE, SEED, 0)
    s = kernels.sorted_stream(tr, a.state, a.additional)
    kernels.extra_kernel(tr, POSE, s.xs, s.ys, s.state, s.add, s.samp0)
    # The plain versions ran: no kernel was launched.
    assert (kernels.base_kernel.launches,
            kernels.extra_kernel.launches) == before
    meta = [t.to("meta") for t in (s.xs, s.ys, s.state, s.add, s.samp0)]
    with pytest.raises(ValueError, match="one device"):
        kernels.extra_kernel(tr, POSE, *meta)
