"""Kernel A's thread per pixel on the regeneration schedule (csrc/trace.cuh
run_samples_regen: one bounce a loop trip, a lane starting its next sample
as soon as its path ends) beside its nested twins (trt_kernel_base_nested,
trt_kernel_base_ext_nested, trt_kernel_base_xt_nested,
trt_kernel_base_grid_nested, trt_kernel_base_gathered_nested: the sample
loop around the bounce loop), at the reference, EXT and XT gates and over
the culled sweep (`--accel grid`) and the grid walk (`--accel gathered`),
both at the XT gate set.

On the CPU: the per-sample iteration model (ops/kernels.py
base_sample_iters, from the plain scheduler) against the per-pixel one
(base_entry_iters) at Cornell_Box, showcase, Cornell_Box at the XT gates
(fog, DOF, the stratified sampler and --mis), lights:16 with one-light NEE,
and Cornell_Box under grid and gathered (the latter also with those XT
gates) 64x16, the nested loops' executed count (nested_iters) against the
regeneration schedule's (warp_iters) warp by warp and on a hand-built
two-warp example, and the entries that _launch_base calls for each kind,
with the launch stood in for. The `cuda` tests hold the shipped entries,
their nested twins and csrc/group_tune.cu's loops at every residency bound
against the plain version bit for bit (planes, end states; under grid and
gathered the traversal counters, under grid nonzero) at 128x16, whole and
at runtime quotas of 2 and 0, with their counters equal to warp_iters of
the per-pixel model, and the gathered, XT and grid entries at max_depth 0;
they skip here.
"""

import ctypes

import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import build, kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 42
# (scene, overrides, PathTracer keywords): Cornell_Box at depth 8 (16 spp:
# 4 base samples), showcase at its own spp and depth (32 spp, 8 base
# samples, depth 8), Cornell_Box at depth 8 at the XT gates that change a
# sample's draws (--mis: a fresh emit value of -1; the stratified cell; the
# two DOF draws; fog), lights:16 (57 primitives) with one-light NEE at
# depth 8, and Cornell_Box at depth 8 over the culled sweep and over the
# grid walk, the latter also with those XT gates.
CORNELL = dict(samples_per_pixel=16, max_depth=8)
XT = dict(CORNELL, fog=Fog(density=0.15), aperture=0.1, focus_distance=3.0,
          sampler="stratified")
SCENES = {"cornell": ("Cornell_Box", CORNELL, {}),
          "showcase": ("showcase", {}, {}),
          "xt": ("Cornell_Box", XT, dict(transport="mis")),
          "xt_one": ("lights:16", dict(CORNELL, light_sample="power"), {}),
          "grid": ("Cornell_Box", CORNELL, dict(accel="grid")),
          "gathered": ("Cornell_Box", CORNELL, dict(accel="gathered")),
          "gathered_xt": ("Cornell_Box", XT, dict(accel="gathered",
                                                  transport="mis"))}
# Each key's wrapper (through base_kernel, below GROUP_BASE_MIN_PRIMS
# primitives; the XT kernel A at any count), nested twin and kind of
# csrc/group_tune.cu's loop.
SHIPPED = {"cornell": ("base_kernel", "base_kernel_nested", "loop"),
           "showcase": ("base_kernel_ext", "base_kernel_ext_nested",
                        "ext_loop"),
           "xt": ("base_kernel_xt", "base_kernel_xt_nested", "xt_loop"),
           "grid": ("base_kernel_grid", "base_kernel_grid_nested",
                    "grid_loop"),
           "gathered": ("base_kernel_gathered", "base_kernel_gathered_nested",
                        "gathered_loop")}
SHIPPED["xt_one"] = SHIPPED["xt"]
SHIPPED["gathered_xt"] = SHIPPED["gathered"]
# The residency bounds of csrc/group_tune.cu's loops (-DTRT_TUNE_MIN_BLOCKS;
# 0: unbound), as tools/group_k.py --only regen sweeps them.
BOUNDS = (0, 4, 5, 6)


def _tracer(key, device="cpu", width=64, height=16):
    name, over, kw = SCENES[key]
    scene = load_scene(name).with_overrides(width=width, height=height,
                                            **over)
    return PathTracer(scene, device, **kw)


def _bits(out):
    return [t.view(torch.int32) if t.is_floating_point() else t
            for t in (*out.csum, *out.csumsq, out.rays, out.var,
                      out.additional, out.state)]


def _per_warp(lane_iters):
    """Each warp's longest count: [warps]."""
    return kernels._warps(lane_iters, 1).amax(1)


@pytest.mark.parametrize("q", [None, 2, 0], ids=["base", "quota2", "quota0"])
@pytest.mark.parametrize("key", list(SCENES))
def test_sample_iters_sum_to_the_pixel_model(key, q):
    """Summed over samples, base_sample_iters is base_entry_iters, with one
    row a sample of the quota; the nested loops execute at least the
    regeneration schedule's count on every warp, and nested_iters is 32 x
    the warps' summed longest paths."""
    tr = _tracer(key)
    si = kernels.base_sample_iters(tr, POSE, SEED, 0, base_q=q)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, base_q=q)
    quota = tr.base_samples if q is None else q
    assert si.shape == (quota, tr.height, tr.width)
    assert si.dtype == torch.int64
    assert torch.equal(si.sum(0), it)
    assert bool((si <= tr.max_depth).all())
    nested = sum((_per_warp(row) for row in si),
                 torch.zeros_like(_per_warp(it)))
    assert bool((nested >= _per_warp(it)).all())
    assert float(kernels.nested_iters(si)) == 32.0 * float(nested.sum())
    assert float(kernels.nested_iters(si)) >= float(kernels.warp_iters(it))
    if quota:
        assert bool((si[0] >= 1).all())  # every sample bounces at least once
        assert float(kernels.nested_iters(si)) > float(kernels.warp_iters(it))


def test_nested_and_regeneration_counts_by_hand():
    """Two warps of 32 lanes, two samples. Warp 0: lane 0's paths take 5
    and 1 bounces, lane 1's 1 and 5, the others none; the nested loops
    wait 5 + 5 trips, the regeneration schedule max(6, 6). Warp 1: every
    lane 2 and 2, 4 trips either way."""
    si = torch.zeros((2, 64), dtype=torch.int64)
    si[:, 0] = torch.tensor([5, 1])
    si[:, 1] = torch.tensor([1, 5])
    si[:, 32:] = 2
    assert float(kernels.nested_iters(si)) == 32 * (10 + 4)
    assert float(kernels.warp_iters(si.sum(0))) == 32 * (6 + 4)
    assert float(kernels.nested_iters(si[:, :32])) == 320
    assert float(kernels.nested_iters(si[:0])) == 0


@pytest.mark.parametrize("kind, entry, n_args", [
    ("ref", "trt_kernel_base", 6),
    ("nested", "trt_kernel_base_nested", 6),
    ("ext", "trt_kernel_base_ext", 7),
    ("ext_nested", "trt_kernel_base_ext_nested", 7),
    ("loop", "trt_kernel_base_loop", 7),
    ("ext_loop", "trt_kernel_base_ext_loop", 8),
    ("xt", "trt_kernel_base_xt", 8),
    ("xt_nested", "trt_kernel_base_xt_nested", 8),
    ("xt_loop", "trt_kernel_base_xt_loop", 9),
    ("grid", "trt_kernel_base_grid", 9),
    ("grid_nested", "trt_kernel_base_grid_nested", 9),
    ("grid_loop", "trt_kernel_base_grid_loop", 10),
    ("gathered", "trt_kernel_base_gathered", 9),
    ("gathered_nested", "trt_kernel_base_gathered_nested", 9),
    ("gathered_loop", "trt_kernel_base_gathered_loop", 10)])
def test_launch_base_calls_the_entry_of_each_kind(monkeypatch, kind, entry,
                                                  n_args):
    """_launch_base calls the entry of each thread-per-pixel kind with the
    arguments its C signature takes (ops/build.py): the texture constants
    at the EXT gates, also the gates at the XT gates, and the traversal's
    argument over the culled sweep and the grid walk, the zeroed pixel
    counter for group_tune.cu's loops; the launch is stood in for."""
    tr = _tracer({"ext": "showcase", "xt": "xt", "grid": "grid",
                  "gathered": "gathered"}.get(kind.split("_")[0], "cornell"),
                 width=8, height=4)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "_stream", lambda device: ctypes.c_void_p(0))
    kernels._launch_base(tr, POSE, SEED, 0, 0, None, None, kind, Lib())
    assert [name for name, _ in calls] == [entry]
    assert len(calls[0][1]) == n_args
    declared = dict(build.ENTRY_POINTS["kernel_base.cu"]
                    + build.ENTRY_POINTS["kernel_accel.cu"]
                    + build.TUNE_ONLY_ENTRY_POINTS)
    assert declared[entry] == n_args


@pytest.mark.parametrize("key", list(SCENES))
def test_nested_wrappers_take_the_plain_version_on_the_cpu(key):
    """The nested twins' wrappers give the plain version for CPU tensors and
    refuse a tracer of the other gates or traversal."""
    tr = _tracer(key, width=16, height=4)
    fn = getattr(kernels, SHIPPED[key][1])
    n0 = fn.launches
    got = fn(tr, POSE, SEED, 0, base_q=2)
    want = kernels.base_kernel_plain(tr, POSE, SEED, 0, base_q=2)
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)
    assert fn.launches == n0
    for other in {twin for _, twin, _ in SHIPPED.values()} - {fn.__name__}:
        with pytest.raises(ValueError):
            getattr(kernels, other)(tr, POSE, SEED, 0)


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _launched(tr, fn):
    """fn() and, over the culled sweep or the grid walk, the traversal
    counters it added (tracer.accel_stats on for the call)."""
    if tr.traversal is None:
        return fn(), None
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device=tr.device)
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


def _plain(tr, q):
    """The plain version and, over the culled sweep or the grid walk, its
    traversal counters (CulledPrims.STATS, GatheredPrims.STATS, counted
    while prims.ops is on)."""
    if tr.traversal is None:
        return kernels.base_kernel_plain(tr, POSE, SEED, 0, base_q=q), None
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device=tr.device)
    try:
        out = kernels.base_kernel_plain(tr, POSE, SEED, 0, base_q=q)
        return out, tr.prims.stats.to(torch.int64).cpu()
    finally:
        tr.prims.ops = None


@pytest.mark.cuda
@pytest.mark.parametrize("q", [None, 2, 0], ids=["base", "quota2", "quota0"])
@pytest.mark.parametrize("key", list(SCENES))
def test_shipped_and_nested_entries_match_plain_version(cuda_device, key, q):
    """The shipped thread-per-pixel entry (through the wrapper, which takes
    it below GROUP_BASE_MIN_PRIMS primitives, at the XT gates at any count)
    and its nested twin against the plain version bit for bit at 128x16,
    whole and at quotas of 2 and 0 (over the culled sweep and the grid walk
    also the traversal counters, which the culled sweep flushes once a
    thread after the loop: nonzero where a sample is rendered); both
    counters are warp_iters of the per-pixel model."""
    tr = _tracer(key, cuda_device, width=128)
    wrapper, twin = (getattr(kernels, name) for name in SHIPPED[key][:2])
    n0 = wrapper.launches
    got, got_c = _launched(
        tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0, base_q=q))
    assert wrapper.launches == n0 + 1
    n1 = twin.launches
    nested, nested_c = _launched(
        tr, lambda: twin(tr, POSE, SEED, 0, base_q=q))
    assert twin.launches == n1 + 1
    want, want_c = _plain(tr, q)
    for a, b, c in zip(_bits(got), _bits(nested), _bits(want)):
        assert torch.equal(a, c) and torch.equal(b, c)
    if want_c is not None:
        assert torch.equal(got_c, want_c) and torch.equal(nested_c, want_c)
        if tr.traversal == "gathered":
            assert int(want_c[3]) == 0  # no walk at the trip cap
        else:  # sweeps, blocks swept and skipped, tests
            assert bool((want_c > 0).all()) == (q != 0)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0, base_q=q)
    assert float(got.iters) == float(kernels.warp_iters(it))
    assert float(nested.iters) == float(kernels.warp_iters(it))


def _bounces_once_at_depth_0(key, device):
    """At max_depth 0 (a tracer's value set below the scene's floor of 1)
    key's shipped entry (through the wrapper) bounces each path once, as the
    plain scheduler and the reference-gate entry do, and equals the plain
    version bit for bit with its traversal counters and count; the nested
    twin's loops bounce none (no ray, zero radiance, count 0)."""
    tr = _tracer(key, device, width=128)
    tr.max_depth = 0
    wrapper, twin = (getattr(kernels, name) for name in SHIPPED[key][:2])
    n0 = wrapper.launches
    got, got_c = _launched(
        tr, lambda: kernels.base_kernel(tr, POSE, SEED, 0))
    assert wrapper.launches == n0 + 1
    want, want_c = _plain(tr, None)
    for a, c in zip(_bits(got), _bits(want)):
        assert torch.equal(a, c)
    if want_c is not None:
        assert torch.equal(got_c, want_c)
    it = kernels.base_entry_iters(tr, POSE, SEED, 0)
    assert bool((it == tr.base_samples).all())
    assert float(got.iters) == float(kernels.warp_iters(it))
    nested = twin(tr, POSE, SEED, 0)
    assert float(nested.iters) == 0.0
    assert not bool(nested.rays.any())
    assert not any(bool(c.any()) for c in nested.csum)


@pytest.mark.cuda
def test_gathered_entry_bounces_once_at_depth_0(cuda_device):
    """_bounces_once_at_depth_0 under gathered."""
    _bounces_once_at_depth_0("gathered", cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["xt", "xt_one", "grid"])
def test_xt_and_grid_entries_bounce_once_at_depth_0(cuda_device, key):
    """_bounces_once_at_depth_0 at the XT gates (with one-light NEE too)
    and under grid: no special case for depth 0 in either entry."""
    _bounces_once_at_depth_0(key, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [0, 1, 2], ids=["nested", "regen", "refill"])
def test_tune_loops_match_plain_version(cuda_device, loop):
    """csrc/group_tune.cu's loops (built with them alone), unbound and held
    to each bound the sweep weighs (BOUNDS), at every gate set against the
    plain version bit for bit at 128x16 and a quota of 2 (over the culled
    sweep and the grid walk with their counters); the counters warp_iters
    of the per-pixel model, the refill form's at least the pixels' sum."""
    build.library_paths(tuple((build.TUNE_SOURCE, (
        build.LOOP_ONLY, f"TRT_TUNE_LOOP={loop}",
        f"TRT_TUNE_MIN_BLOCKS={minb}")) for minb in BOUNDS))
    for minb in BOUNDS:
        lib = build.load_kernels(((build.TUNE_SOURCE, (
            build.LOOP_ONLY, f"TRT_TUNE_LOOP={loop}",
            f"TRT_TUNE_MIN_BLOCKS={minb}")),))
        assert lib.trt_kernel_base_loop_kind() == loop
        for key in SCENES:
            tr = _tracer(key, cuda_device, width=128)
            kind = SHIPPED[key][2]
            for q in (None, 2):
                got, got_c = _launched(tr, lambda: kernels._launch_base(
                    tr, POSE, SEED, 0, 0, None, q, kind, lib))
                want, want_c = _plain(tr, q)
                for a, c in zip(_bits(got), _bits(want)):
                    assert torch.equal(a, c)
                if want_c is not None:
                    assert torch.equal(got_c, want_c)
                it = kernels.base_entry_iters(tr, POSE, SEED, 0, base_q=q)
                if loop == 2:
                    assert float(got.iters) >= float(it.sum())
                else:
                    assert float(got.iters) == float(kernels.warp_iters(it))
