"""The grouped chunked kernel A over the grid walk of `--accel gathered`
(csrc/group.cuh kernel_base_chunked_grouped over GroupWalk): its dispatch,
the wrappers' refusals and plain versions on the CPU, and the slot-count
model of the chunk-major stream at the shipped group width; the kernel on
the card.

base_kernel_chunked_gathered passes every `--accel gathered` tracer on to
base_kernel_chunked_gathered_grouped, whatever its table size or primitive
count: the walk reads its rows through L1 (or stages what fits and reads
the rest), so it serves every size. Here the wrappers take their plain
PyTorch versions (the tensors lie on the CPU); the dispatch tests stand in
for the launch by monkeypatching `_on_cuda` and `_launch_chunked`. The
plain chunked gathered kernel A stays held against the JAX package by
tests/test_torch_accel.py test_explicit_base_chunks_match_jax_oracle and
tests/test_torch_schedulers.py ('gathered-chunked').

The `cuda` tests hold the grouped entry bit for bit against its plain
version on the card (planes, end states, rays), with the walk's four
counters equal to the plain version's and the thread per entry's and the
lane-iterations the plain model's at each group width: on the whole image
and a row block, with the trip cap cut so that walks stop at it, and over
the staged row sources of csrc/group_tune.cu at caps that split the rows
and the CSR. They skip here.
"""

import re

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
SIZE = dict(width=16, height=8, samples_per_pixel=8, max_depth=3)
CHUNKED_GATHERED = (kernels.base_kernel_chunked_gathered,
                    kernels.base_kernel_chunked_gathered_grouped)


def _scene(name, **over):
    return load_scene(name).with_overrides(**{**SIZE, **over})


def _gathered(name, chunk_base=2, **over):
    return PathTracer(_scene(name, **over), "cpu", accel="gathered",
                      chunk_base=chunk_base)


def _equal(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def _shipped(name):
    """The value of the constant `name` in csrc/kernel_accel.cu."""
    text = (build.CSRC / "kernel_accel.cu").read_text()
    return re.search(rf"constexpr int {name} = ([\w:]+);", text).group(1)


@pytest.fixture
def recorded(monkeypatch):
    """The launches the wrappers would make on the card, recorded instead:
    _on_cuda says yes, and _launch_chunked notes its `kind` and returns the
    plain version's outputs."""
    kinds = []
    monkeypatch.setattr(kernels, "_on_cuda", lambda device, name: True)

    def chunked(tracer, pose, seed, frame_number, y0, h_out, kind, lib=None):
        kinds.append(kind)
        return kernels.base_kernel_chunked_plain(tracer, pose, seed,
                                                 frame_number, y0, h_out)

    monkeypatch.setattr(kernels, "_launch_chunked", chunked)
    return kinds


# ----------------------------------------------------------------- dispatch


@pytest.mark.parametrize("name, chunk_base", [
    ("stress:1024", 2), ("icosphere:4", 2), ("Cornell_Box", 2),
    ("icosphere:1", 3), ("stress:64", None)])
def test_chunked_gathered_a_dispatch(name, chunk_base, recorded):
    """base_kernel_chunked -> base_kernel_chunked_gathered ->
    base_kernel_chunked_gathered_grouped at every table size and primitive
    count (icosphere:4's 240 KB of rows, Cornell_Box's 11 primitives), and
    for a tracer without a chunk split (one chunk an entry); only the
    grouped entry counts the launch."""
    tr = _gathered(name, chunk_base)
    assert tr.traversal == "gathered" and tr.chunk_base == chunk_base
    assert kernels.takes_grouped(tr, "chunked")
    assert "gathered" in kernels.ANY_SIZE["chunked"]
    assert (kernels.GROUPED_CHUNKED["gathered"]
            is kernels.base_kernel_chunked_gathered_grouped)
    n0 = [w.launches for w in CHUNKED_GATHERED]
    out = kernels.base_kernel_chunked(tr, POSE, SEED, 0, 2, 4)
    assert out.rays.shape == (tr.n_base_chunks, 4, tr.width)
    assert float(out.rays.sum()) > 0
    assert recorded == ["gathered_grouped"]
    assert [w.launches - n for w, n in zip(CHUNKED_GATHERED, n0)] == [0, 1]


def test_grouped_wrapper_refuses_other_instantiations():
    """The grouped chunked gathered entry serves the walk alone: chunked
    tracers of the reference, EXT and XT gates and of the culled sweep are
    refused by instantiation, and so is the thread-per-entry wrapper's
    other traversal."""
    ref = PathTracer(_scene("stress:64"), "cpu", chunk_base=2)
    ext = PathTracer(_scene("showcase"), "cpu", chunk_base=2)
    xt = PathTracer(_scene("stress:64", fog=Fog(density=0.15)), "cpu",
                    chunk_base=2)
    grid = PathTracer(_scene("stress:64"), "cpu", accel="grid",
                      chunk_base=2)
    assert [kernels._kind(t) for t in (ref, ext, xt, grid)] == [
        "ref", "ext", "xt", "grid"]
    for tr in (ref, ext, xt, grid):
        with pytest.raises(ValueError, match="instantiation"):
            kernels.base_kernel_chunked_gathered_grouped(tr, POSE, SEED, 0)
        with pytest.raises(ValueError, match="traversal"):
            kernels.base_kernel_chunked_gathered(tr, POSE, SEED, 0)


@pytest.mark.parametrize("name", ["stress:64", "icosphere:4"])
def test_wrappers_take_the_plain_version_on_the_cpu(name):
    """Both chunked gathered wrappers and the dispatch return the plain
    version's outputs for CPU tensors, within the budget and over it, and
    count no launch."""
    tr = _gathered(name)
    want = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, 2, 4)
    n0 = [w.launches for w in CHUNKED_GATHERED]
    for fn in CHUNKED_GATHERED:
        _equal(fn(tr, POSE, SEED, 0, 2, 4), want)
    _equal(kernels.base_kernel_chunked(tr, POSE, SEED, 0, 2, 4), want)
    assert want.rays.shape == (tr.n_base_chunks, 4, tr.width)
    assert tr.n_base_chunks > 1 and float(want.rays.sum()) > 0
    assert [w.launches for w in CHUNKED_GATHERED] == n0


# ------------------------------------------------------- iteration model


def test_slot_model_of_the_chunked_stream_at_the_shipped_k():
    """The chunked stream of a 7x5 image in 2 chunks (70 entries, chunk
    0's pixels first) at the shipped group width: K divides 32, so a warp
    holds 32 / K whole groups and no group straddles the last entry; the
    grouped entry's count is 32 / K slots times each warp's longest entry,
    a partial last warp's missing groups adding 0; the plain version
    counts its own lockstep loop."""
    k = int(_shipped("GROUP_K_CHUNKED_GATHERED"))
    assert _shipped("GROUP_SRC_CHUNKED_GATHERED") in (
        "trt::WALK_L1", "trt::WALK_ROWS", "trt::WALK_CSR")
    assert 1 <= k <= 32 and 32 % k == 0
    tr = _gathered("stress:64", width=7, height=5, max_depth=4)
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0)
    p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0)
    assert it.shape == (2, 5, 7) and it.dtype == torch.int64
    assert float(p.iters) == float(it.max()) * it.numel()
    flat = it.reshape(-1).tolist()
    slots = 32 // k
    want = sum(slots * max(flat[w0:w0 + slots])
               for w0 in range(0, len(flat), slots))
    got = float(kernels.warp_iters(it, k))
    assert got == want and got >= sum(flat)
    assert kernels.working_warps(it, k) == -(-len(flat) // slots)


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_tracer(name, device):
    return PathTracer(load_scene(name).with_overrides(
        width=64, height=16, samples_per_pixel=16, max_depth=8), device,
        accel="gathered", chunk_base=2, chunk_extra=2)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _chunked_equal(k, p):
    for a, b in zip((*k.csum, *k.csumsq, k.rays, k.state),
                    (*p.csum, *p.csumsq, p.rays, p.state)):
        assert torch.equal(_bits(a), _bits(b))


def _counted(tr, fn):
    """fn() and the kernels' walk counters."""
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.cpu()
    finally:
        tr.accel_stats = None


def _plain(tr, *region):
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device="cuda")
    try:
        p = kernels.base_kernel_chunked_plain(tr, POSE, SEED, 0, *region)
        return p, tr.prims.stats.long().cpu()
    finally:
        tr.prims.ops = None


def _held(tr, region=(0, None), lib=None):
    """The grouped entry (through the dispatch, or from `lib` launched
    directly) and the thread per entry against the plain version: bit for
    bit, the counters equal, the lane-iterations the plain model's.
    Returns the plain counters."""
    fn = kernels.base_kernel_chunked_gathered_grouped
    n0 = fn.launches
    if lib is None:
        g, gc = _counted(tr, lambda: kernels.base_kernel_chunked(
            tr, POSE, SEED, 0, *region))
        assert fn.launches == n0 + 1
    else:
        g, gc = _counted(tr, lambda: kernels._launch_chunked(
            tr, POSE, SEED, 0, *region, "gathered_grouped", lib))
    t, tc = _counted(tr, lambda: kernels._launch_chunked(
        tr, POSE, SEED, 0, *region, "gathered"))
    p, pc = _plain(tr, *region)
    _chunked_equal(g, p)
    _chunked_equal(t, p)
    assert torch.equal(gc, pc) and torch.equal(tc, pc), (gc, tc, pc)
    assert int(pc[0]) > 0 and int(pc[1]) > 0
    it = kernels.chunked_entry_iters(tr, POSE, SEED, 0, *region)
    assert float(g.iters) == float(kernels.warp_iters(
        it, kernels.group_k("chunked_gathered", lib)))
    assert float(t.iters) == float(kernels.warp_iters(it, 1))
    return pc


@pytest.mark.cuda
@pytest.mark.parametrize("region", [(0, None), (8, 8)],
                         ids=["whole", "rows8-16"])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:1", "showcase"])
def test_chunked_gathered_grouped_matches_plain_version(cuda_device, name,
                                                        region):
    """base_kernel_chunked through the grouped chunked gathered entry and
    the thread per entry against the plain version at chunks of 2, bit for
    bit, the walk counters the plain version's (no walk at the trip
    cap)."""
    tr = _card_tracer(name, cuda_device)
    assert tr.n_base_chunks == 2 and kernels.takes_grouped(tr, "chunked")
    assert int(_held(tr, region)[3]) == 0


@pytest.mark.cuda
def test_chunked_gathered_grouped_replays_the_trip_cap(cuda_device):
    """With the walk's trip cap cut to 5 steps (the plain version's and the
    launch argument's) walks stop at it, and the group stops where the
    serial walk stops: the same planes and the same four counters."""
    tr = _card_tracer("stress:64", cuda_device)
    tr.prims.max_trips = 5
    kernels.accel_args(tr).max_trips = 5
    assert int(_held(tr)[3]) > 0


@pytest.fixture(scope="module")
def source_libs():
    """csrc/group_tune.cu at the shipped K, 128 lanes a block, over the
    staged row sources (rows; CSR and rows) at caps that split the rows
    (168 bytes) and the CSR (2 KB), built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    k = kernels.group_k("chunked_gathered")
    srcs = {(walk, cap): (build.TUNE_SOURCE, (
        f"TRT_TUNE_K={k}", "TRT_TUNE_THREADS=128",
        f"TRT_TUNE_STAGE_CAP={cap}", f"TRT_TUNE_WALK={walk}"))
        for walk in (1, 2) for cap in (168, 2048)}
    build.library_paths(tuple(srcs.values()))
    return {key: build.load_kernels((src,)) for key, src in srcs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("walk, cap", [(1, 168), (2, 168), (1, 2048),
                                       (2, 2048)])
@pytest.mark.parametrize("name", ["stress:64", "icosphere:1"])
def test_staged_row_sources_match_plain_version(cuda_device, source_libs,
                                                name, walk, cap):
    """The grouped chunked gathered kernel A over each staged row source,
    the stage waited for by the whole block before the entries past the
    last leave: bit for bit, the counters the plain version's."""
    _held(_card_tracer(name, cuda_device), lib=source_libs[walk, cap])
