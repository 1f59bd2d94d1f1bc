"""Kernels C and D on the queue schedule (csrc/group.cuh
kernel_frame_queue): the item decomposition, the dispatch to the queue
entries, the count model; the entries on the card.

The queue kernels split a frame into base items (pixel, base chunk) and
extra items (pixel, extra chunk), fold each pixel's items in chunk order
and write combine_phases. ops/kernels.frame_items_plain is that
arithmetic in plain PyTorch; here it must equal the whole frame
(PathTracer.render_pixels, which tests/test_torch_schedulers.py holds
against the JAX package) bit for bit, unchunked and chunked, on a row
block and with base >= spp. The dispatch tests stand in for the launch by
monkeypatching `_on_cuda` and `_launch_frame_queue`: each instantiation
takes the thread per item below 16 primitives, its group form within the
96 KB budget and its spill form above it (the walk: the group form at
every size). The group widths are read from csrc/frame_queue.cuh.

The `cuda` tests hold every queue entry against render_frame_plain on the
card (planes bit for bit, traversal counters equal, regen's count between
the items' sum and 32 / K times it, lockstep's the static formula, a
partial last warp and a row block included), and C, D and the sorted
pipeline to one frame. They skip here.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa: E402
from terminal_raytracer_tpu_torch.models.scene import Fog  # noqa: E402
from terminal_raytracer_tpu_torch.ops import kernels  # noqa: E402
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

POSE = Camera().pose()
SEED = 17
SIZE = dict(width=32, height=8, samples_per_pixel=8, max_depth=3)
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
FRAME_SOURCES = {"regen": "kernel_frame.cu",
                 "lockstep": "kernel_frame_lockstep.cu"}

# name: (scene, overrides, PathTracer keywords)
CASES = {
    "cornell": ("Cornell_Box", {}, {}),
    "stress-chunked": ("stress:48", {}, dict(accel="array", chunk_base=2,
                                             chunk_extra=2)),
    "base-covers-spp": ("Cornell_Box", dict(samples_per_pixel=3), {}),
    "stress-extra-chunked": ("stress:48", dict(samples_per_pixel=16),
                             dict(accel="array", chunk_extra=3)),
}


def _tracer(name, device="cpu", **size):
    scene, over, kw = CASES[name]
    scene = load_scene(scene).with_overrides(**{**SIZE, **over, **size})
    return PathTracer(scene, device, **kw)


def _planes(out):
    return (*out.current, out.var, out.total, out.rays)


def _assert_bits(got, want):
    for a, b in zip(_planes(got), _planes(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["regen", "lockstep"])
@pytest.mark.parametrize("name", list(CASES))
def test_item_decomposition_equals_the_whole_frame(name, mode):
    """Per-chunk partial sums added in chunk order, then the variance, the
    budget of each extra chunk and combine_phases: render_pixels bit for
    bit, with render_frame_plain's count."""
    tr = _tracer(name)
    got = kernels.frame_items_plain(tr, mode, POSE, SEED, 0)
    want = kernels.render_frame_plain(tr, mode, POSE, SEED, 0)
    _assert_bits(got, want)
    assert float(got.iters) == float(want.iters)
    if name != "base-covers-spp":
        assert (want.total > tr.base_samples).any()


@pytest.mark.parametrize("name", ["cornell", "stress-chunked"])
def test_item_decomposition_of_a_row_block(name):
    """Rows [3, 6) of the decomposition are those rows of the frame; a row
    block's count is its own."""
    tr = _tracer(name)
    block = kernels.frame_items_plain(tr, "regen", POSE, SEED, 0, 3, 3)
    whole = kernels.render_frame_plain(tr, "regen", POSE, SEED, 0)
    for a, b in zip(_planes(block), _planes(whole)):
        assert torch.equal(a, b[3:6])
    _, _, _, _, lane_iters, _ = tr.render_pixels(POSE, SEED, 0, 3, 3)
    assert float(block.iters) == float(lane_iters.sum())
    lock = kernels.frame_items_plain(tr, "lockstep", POSE, SEED, 0, 3, 3)
    assert float(lock.iters) == kernels.lockstep_iters(tr, 3)


def test_item_decomposition_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown kernel mode"):
        kernels.frame_items_plain(_tracer("cornell"), "sorted", POSE, SEED, 0)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_regen_count_bounds_by_hand(k):
    """The items' sum and 32 / K times it."""
    it = torch.tensor([[3, 0, 7], [5, 1, 0]])
    assert kernels.regen_iters_bounds(it, k) == (16.0, 16.0 * (32 // k))


def test_regen_count_bounds_refuse_a_width_not_dividing_32():
    with pytest.raises(ValueError, match="does not divide"):
        kernels.regen_iters_bounds(torch.tensor([1]), 3)


@pytest.mark.parametrize("name", ["cornell", "stress-chunked"])
def test_plain_regen_count_is_the_items_sum(name):
    """On the CPU the regen wrapper's count is the model's lower bound, the
    items' summed iterations, which lies within lockstep's static count."""
    tr = _tracer(name)
    out = kernels.regen_kernel(tr, POSE, SEED, 0)
    _, _, _, _, lane_iters, _ = tr.render_pixels(POSE, SEED, 0)
    lo, hi = kernels.regen_iters_bounds(lane_iters, 4)
    assert float(out.iters) == lo <= kernels.lockstep_iters(tr) <= hi


@pytest.mark.parametrize("n, nbc, nec, ctl, scratch", [
    (100, 1, 1, 8 + 100 + 200, 600),
    (100, 2, 1, 8 + 100 + 200, 1400 + 600),
    (100, 2, 3, 8 + 300 + 200, 1400 + 1200 + 600),
    (100, 1, 0, 8 + 200, 600),
])
def test_frame_queue_words_by_hand(n, nbc, nec, ctl, scratch):
    """The control words (head, queue, two counters a pixel) and the
    scratch (base chunk planes where split, extra chunk planes where split,
    the folded base and the end state)."""
    assert kernels.frame_queue_words(n, nbc, nec) == (ctl, scratch)


def test_frame_nec_is_zero_when_base_covers_spp():
    assert kernels.frame_nec(_tracer("base-covers-spp")) == 0
    tr = _tracer("stress-extra-chunked")  # 16 spp: 12 extra in chunks of 3
    assert (tr.base_samples, kernels.frame_nec(tr)) == (4, 4)


def _constants():
    """The queue entries' group widths as csrc/frame_queue.cuh ships them
    (the second argument of `tuned`)."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (GROUP_K[BE]_FRAME\w*) = tuned\(TRT_TUNE_K[BE], "
        r"(\d+)\);", (CSRC / "frame_queue.cuh").read_text())}


def test_mirrored_group_widths_are_the_sources():
    c = _constants()
    names = {"group": {"ref": "", "ext": "_EXT", "xt": "_XT",
                       "grid": "_GRID", "gathered": "_GATHERED"},
             "spill": {"ref": "_SPILL", "ext": "_SPILL", "xt": "_XT_SPILL",
                       "grid": "_GRID_SPILL"}}
    assert len(c) == 21
    want = {(kind, form): (c[f"GROUP_KB_FRAME{n}"], c[f"GROUP_KE_FRAME{n}"])
            for form, by_kind in names.items() for kind, n in by_kind.items()}
    want.update({(kind, "solo"): (1, c[f"GROUP_KE_FRAME{n}_SOLO"])
                 for kind, n in names["group"].items()})
    assert want == kernels.FRAME_QUEUE_K
    for pair in kernels.FRAME_QUEUE_K.values():
        for k in pair:
            assert 32 % k == 0


def test_every_queue_entry_is_built_and_declared():
    """Each (mode, kind, form) has a wrapper, an entry point in its mode's
    source (kernel_frame.cu, kernel_frame_lockstep.cu) and its query in
    ops/build.py."""
    from terminal_raytracer_tpu_torch.ops import build

    assert len(kernels.FRAME_QUEUE) == 28
    for (mode, kind, form), wrap in kernels.FRAME_QUEUE.items():
        src = (CSRC / FRAME_SOURCES[mode]).read_text()
        declared = dict(build.ENTRY_POINTS[FRAME_SOURCES[mode]])
        entry = kernels.frame_queue_entry(mode, kind, form)
        assert f'extern "C" int {entry}(' in src
        assert f'extern "C" int {entry}_per_sm(' in src
        n_args = {"ref": 6, "ext": 7, "xt": 8}.get(kind, 9)
        assert declared[entry] == n_args
        assert declared[entry + "_per_sm"] == 2
        sfx = "" if kind == "ref" else f"_{kind}"
        assert wrap.__name__ == (f"{mode}_kernel{sfx}_queue"
                                 + kernels.FRAME_FORMS[form])


# (instantiation, scene, overrides, PathTracer keywords, the form taken)
DISPATCH = [
    ("ref", "Cornell_Box", {}, {}, "solo"),
    ("ref", "stress:48", {}, {}, "group"),
    ("ref", "icosphere:4", {}, {}, "spill"),
    ("ext", "showcase", {}, {}, "solo"),
    ("ext", "checker stress:48", {}, {}, "group"),
    ("ext", "checker icosphere:4", {}, {}, "spill"),
    ("xt", "Cornell_Box", {"fog": Fog(density=0.15)}, {}, "solo"),
    ("xt", "stress:48", {"fog": Fog(density=0.15)}, {}, "group"),
    ("xt", "icosphere:4", {"fog": Fog(density=0.15)}, {}, "spill"),
    ("grid", "Cornell_Box", {}, dict(accel="grid"), "solo"),
    ("grid", "stress:48", {}, dict(accel="grid"), "group"),
    ("grid", "icosphere:4", {}, dict(accel="grid"), "spill"),
    ("gathered", "Cornell_Box", {}, dict(accel="gathered"), "solo"),
    ("gathered", "stress:48", {}, dict(accel="gathered"), "group"),
    ("gathered", "icosphere:4", {}, dict(accel="gathered"), "group"),
]


def _dispatch_tracer(scene, over, kw):
    import dataclasses

    checker = scene.startswith("checker ")
    s = load_scene(scene.removeprefix("checker ")).with_overrides(
        width=8, height=4, samples_per_pixel=4, max_depth=2, **over)
    if checker:
        floor = s.planes[0]
        mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                      checker_scale=1.0)
        s = dataclasses.replace(s, planes=(floor._replace(material=mat),))
    return PathTracer(s, "cpu", **kw)


@pytest.mark.parametrize("mode", ["regen", "lockstep"])
@pytest.mark.parametrize("kind, scene, over, kw, form", DISPATCH,
                         ids=[f"{d[0]}-{d[1]}" for d in DISPATCH])
def test_dispatch_takes_the_form_of_the_scene(monkeypatch, mode, kind, scene,
                                              over, kw, form):
    """make_render_frame's kernel (the 'ref' wrapper, passing the tracer on
    to its instantiation's) launches the queue entry of the tracer's form,
    at that form's K, and counts it on that entry's wrapper alone."""
    tr = _dispatch_tracer(scene, over, kw)
    assert kernels._kind(tr) == kind
    assert kernels.frame_form(tr) == form
    assert (tr.scene.primitive_count < kernels.GROUP_BASE_MIN_PRIMS) == (
        form == "solo")
    assert (kernels.FRAME_QUEUE_K[kind, form][0] == 1) == (form == "solo")
    entry = kernels.frame_queue_entry(mode, kind, form)
    sfx = "" if kind == "ref" else f"_{kind}"
    fsfx = {"solo": "_solo", "group": "", "spill": "_spill"}[form]
    assert entry == f"trt_kernel_{mode}{sfx}_queue{fsfx}"
    calls = []

    def launch(t, m, pose, seed, frame_number, y0, h_out, f, lib=None):
        calls.append((m, f, y0, h_out))
        return "launched"

    monkeypatch.setattr(kernels, "_on_cuda", lambda device, name: True)
    monkeypatch.setattr(kernels, "_launch_frame_queue", launch)
    counts = {w: w.launches for w in kernels.FRAME_QUEUE.values()}
    assert kernels.FRAME_KERNELS[mode, "ref"](tr, POSE, SEED, 0, 1, 2) == \
        "launched"
    assert calls == [(mode, form, 1, 2)]
    for w, n in counts.items():
        taken = w is kernels.FRAME_QUEUE[mode, kind, form]
        assert w.launches == n + taken
    assert kernels.FRAME_KERNELS[mode, kind].launches == 0


def test_queue_wrappers_refuse_another_instantiation_or_form():
    tr = _dispatch_tracer("Cornell_Box", {}, {})
    with pytest.raises(ValueError, match="'ref' instantiation"):
        kernels.regen_kernel_ext_queue_solo(tr, POSE, SEED, 0)
    with pytest.raises(ValueError, match="'solo' form"):
        kernels.lockstep_kernel_queue(tr, POSE, SEED, 0)
    g = _dispatch_tracer("stress:48", {}, dict(accel="gathered"))
    with pytest.raises(ValueError, match="'group' form"):
        kernels.regen_kernel_gathered_queue_solo(g, POSE, SEED, 0)


def test_queue_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors a queue wrapper returns render_frame_plain and counts
    nothing."""
    tr = _tracer("cornell")
    wrap = kernels.regen_kernel_queue_solo
    n0 = wrap.launches
    _assert_bits(wrap(tr, POSE, SEED, 0),
                 kernels.render_frame_plain(tr, "regen", POSE, SEED, 0))
    assert wrap.launches == n0


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# name: (scene, overrides, PathTracer keywords): one per queue entry.
CARD_CASES = {
    "ref-solo": ("Cornell_Box", {}, {}),
    "ref-group": ("stress:120:7", {}, dict(chunk_base=2, chunk_extra=2)),
    "ref-spill": ("icosphere:4", {}, {}),
    "ext-solo": ("showcase", {}, {}),
    "ext-group": ("checker stress:64", {}, {}),
    "ext-spill": ("checker icosphere:4", {}, {}),
    "xt-solo": ("Cornell_Box", {"fog": Fog(density=0.15)}, {}),
    "xt-group": ("stress:64", {"fog": Fog(density=0.15)},
                 dict(transport="mis")),
    "xt-spill": ("icosphere:4", {"fog": Fog(density=0.15)}, {}),
    "grid-solo": ("Cornell_Box", {}, dict(accel="grid")),
    "grid-group": ("stress:96:3", {}, dict(accel="grid", chunk_base=2,
                                           chunk_extra=3)),
    "grid-spill": ("icosphere:4", {}, dict(accel="grid")),
    "gathered-solo": ("Cornell_Box", {}, dict(accel="gathered")),
    "gathered-group": ("stress:96:3", {}, dict(accel="gathered",
                                               chunk_base=2)),
}


def _card_tracer(device, name, w=64, h=16, spp=16, depth=6):
    import dataclasses

    scene, over, kw = CARD_CASES[name]
    checker = scene.startswith("checker ")
    s = load_scene(scene.removeprefix("checker ")).with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, **over)
    if checker:
        floor = s.planes[0]
        mat = floor.material._replace(checker_color=(0.2, 0.2, 0.25),
                                      checker_scale=1.0)
        s = dataclasses.replace(s, planes=(floor._replace(material=mat),))
    return PathTracer(s, device, **kw)


def _counted(tr, fn):
    """fn() with the kernels' traversal counters on: (out, counters)."""
    if not tr.traversal:
        return fn(), None
    tr.accel_stats = torch.zeros(4, dtype=torch.int64, device=tr.device)
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tr.accel_stats.double().cpu()
    finally:
        tr.accel_stats = None


def _plain_counted(tr, fn):
    if not tr.traversal:
        return fn(), None
    tr.prims.ops = torch.zeros((), dtype=torch.float64, device=tr.device)
    try:
        return fn(), tr.prims.stats.clone().double().cpu()
    finally:
        tr.prims.ops = None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["regen", "lockstep"])
@pytest.mark.parametrize("name", list(CARD_CASES))
@pytest.mark.parametrize("rows", [None, (5, 7)], ids=["frame", "rows"])
def test_queue_entry_matches_plain_version(cuda_device, name, mode, rows):
    """Each queue entry on the card, through its instantiation's wrapper:
    the planes bit for bit the plain frame's, the traversal counters the
    plain version's, regen's count within the model, lockstep's the
    static formula; one launch."""
    tr = _card_tracer(cuda_device, name)
    kind, form = name.split("-")
    assert kernels._kind(tr) == kind and kernels.frame_form(tr) == form
    y0, h_out = rows or (0, None)
    wrap = kernels.FRAME_QUEUE[mode, kind, form]
    n0 = wrap.launches
    k, kc = _counted(tr, lambda: kernels.FRAME_KERNELS[mode, kind](
        tr, POSE, SEED, 0, y0, h_out))
    p, pc = _plain_counted(tr, lambda: kernels.render_frame_plain(
        tr, mode, POSE, SEED, 0, y0, h_out))
    assert wrap.launches == n0 + 1
    _assert_bits(k, p)
    if kc is not None:
        assert torch.equal(kc, pc), (kc, pc)
    if rows is None:  # the whole frame has budgeted pixels
        assert (p.total > tr.base_samples).any()
    if mode == "lockstep":
        assert float(k.iters) == kernels.lockstep_iters(tr, h_out)
    else:
        _, _, _, _, it, _ = tr.render_pixels(POSE, SEED, 0, y0, h_out)
        lo, hi = kernels.regen_iters_bounds(
            it, min(kernels.FRAME_QUEUE_K[kind, form]))
        assert float(p.iters) == lo <= float(k.iters) <= hi


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["regen", "lockstep"])
@pytest.mark.parametrize("name", ["ref-solo", "ref-group", "grid-group"])
def test_queue_entry_equals_the_thread_per_pixel(cuda_device, name, mode):
    """The queue entry and the thread-per-pixel entry (launched directly)
    give the same planes; lockstep's counts are equal."""
    tr = _card_tracer(cuda_device, name)
    kind = kernels._kind(tr)
    q = kernels.FRAME_KERNELS[mode, kind](tr, POSE, SEED, 0)
    t = kernels._launch_frame(tr, POSE, SEED, 0, 0, None,
                              f"trt_kernel_{mode}", kind)
    _assert_bits(q, t)
    if mode == "lockstep":
        assert float(q.iters) == float(t.iters)


@pytest.mark.cuda
@pytest.mark.parametrize("w, h, spp", [(50, 7, 16), (64, 16, 3)])
@pytest.mark.parametrize("name", ["ref-solo", "ref-group"])
def test_lockstep_queue_count_is_the_static_formula(cuda_device, name, w, h,
                                                    spp):
    """Kernel D's count on the queue schedule: the static formula over
    ceil(h * w / 32) * 32 lanes, a partial last warp included and with
    base >= spp; a row block counts its own lanes."""
    tr = _card_tracer(cuda_device, name, w, h, spp, 5)
    k = kernels.lockstep_kernel(tr, POSE, SEED, 0)
    assert float(k.iters) == kernels.lockstep_iters(tr)
    k = kernels.lockstep_kernel(tr, POSE, SEED, 0, y0=2, h_out=3)
    assert float(k.iters) == kernels.lockstep_iters(tr, 3)
    _assert_bits(k, kernels.render_frame_plain(tr, "lockstep", POSE, SEED, 0,
                                               2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_schedulers_render_one_frame_on_the_card(cuda_device, name):
    """C, D and the sorted pipeline through make_render_frame: one frame,
    bit for bit."""
    tr = _card_tracer(cuda_device, name)
    outs = {mode: kernels.make_render_frame(tr, mode)(POSE, SEED, 2)
            for mode in kernels.MODES}
    for mode in ("regen", "lockstep"):
        assert float(outs[mode][3]) == float(outs["sorted"][3])
        for a, b in zip((*outs[mode][0], *outs[mode][1:3]),
                        (*outs["sorted"][0], *outs["sorted"][1:3])):
            assert torch.equal(a, b), mode
