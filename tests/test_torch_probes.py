"""The port's probes (terminal_raytracer_tpu_torch/tools/) against the JAX
package's Mosaic probes (tools/*.py), at the probes' shapes and a small
loop count (ITERS = 16; K = 16 for the branch probes).

The gather probes' JAX kernels run as the JAX scripts run them on the CPU:
loaded by path and built with interpret=True (perf_probe21.py build,
perf_probe21b.py build, perf_probe21c.py build). The branch probes' kernels
are nested in the scripts' main() and use TPU memory spaces, so their
reference is a numpy float32 transcription of the kernel body, cited by
line, the divergent form's per-lane predicate at seed + lane included.

Tolerances:
- perf_probe21 none, ldg, global, shared, selectacc and perf_probe21b
  none and every home of tala1, tala0 and rowsel: bit for bit (exact terms
  added in loop order on both sides).
- onehotmm (TF32) and onehot_hi (3xTF32) against the JAX products, which
  are exact in f32 on the CPU: within tools._probe.gap_bound, half an ulp
  of each term at 10 (21) mantissa bits plus an f32 rounding of each
  running sum; and at least one lane off, so the rounding is real.
- perf_probe21c none and f2i: bit for bit. atan2f (torch.atan2) against
  jnp.arctan2: rtol 1e-6 (libm and XLA-CPU differ by an ulp or two a term;
  2.2e-7 measured). atan2_poly against jnp.arctan2: ITERS x 2e-5 absolute,
  the polynomial's error a term (tests/test_torch_materials.py
  test_atan2_matches_jax). packed: rtol 4e-6 (XLA-CPU contracts acc + r * s
  into one multiply-add; 5.7e-7 measured).
- probe_when, probe_cond: the numpy transcription bit for bit.

The branch kernels take floor(y * s) on the FP32 pipe (csrc/probes.cu
floor_scaled), exact for y * s in [-2^22, 2^22) but -0.0. Every floor
argument of the plain versions at main()'s loop counts is held to that
range, each form's through the unguarded form's (bit for bit at K), and a
numpy model of the rounded-down sum to np.floor, bit for bit, on every
float32 of the binades those arguments touch and at edge values. The file
also holds ops/build.py's probe entries to the source's macros and
tools/sass_ops.py's reading of a SASS listing.

The `cuda` cases hold every C entry of csrc/probes.cu against its plain
version on the card, bit for bit (atan2f within rtol 1e-6 of torch.atan2;
the *_serial baselines bit for bit against the shipped entries), and skip
here. The file imports no jax itself (the JAX probes import it
inside build), so on a GPU machine without jax the `cuda` cases run with
    python -m pytest --noconftest tests/test_torch_probes.py -m cuda
"""

import functools
import importlib.util
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch.tools import (  # noqa: E402
    _probe, probe_cond, probe_when)
from terminal_raytracer_tpu_torch.tools import perf_probe21 as p21  # noqa
from terminal_raytracer_tpu_torch.tools import perf_probe21b as p21b  # noqa
from terminal_raytracer_tpu_torch.tools import perf_probe21c as p21c  # noqa
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

TOOLS = Path(__file__).resolve().parent.parent / "tools"
ITERS = 16
K = 16


def _jax_probe(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J21, J21B, J21C = (_jax_probe(n) for n in
                   ("perf_probe21", "perf_probe21b", "perf_probe21c"))


def _inputs21(n):
    """perf_probe21's inputs at size n: drawn over the default sizes in
    order, as its main() draws them."""
    sizes = p21.SIZES[:p21.SIZES.index(n) + 1]
    return list(p21.inputs(sizes, "cpu"))[-1][1:]


def _gap_ok(got, want, tab, bits):
    gap = np.abs(got.astype(np.float64) - want).max()
    bound = _probe.gap_bound(ITERS, float(np.abs(tab).max()),
                             float(np.abs(want).max()), bits)
    assert 0 < gap <= bound, (gap, bound)


# ------------------------------------------------------ perf_probe21.py

P21_CASES = [(n, form) for n in p21.SIZES for form in p21.FORMS
             if form != "selectacc" or n <= p21.SELECT_MAX]
P21_JAX = {"none": ("none",), "ldg": ("take", "getitem"),
           "global": ("take", "getitem"), "shared": ("take", "getitem"),
           "onehotmm": ("onehotmm",), "selectacc": ("selectacc",)}


@pytest.mark.parametrize("n, form", P21_CASES)
def test_probe21_plain_matches_jax(n, form):
    tab, idx = _inputs21(n)
    got = p21.gather(form, tab, idx, ITERS).numpy()
    for variant in P21_JAX[form]:
        want = np.asarray(J21.build(variant, n, ITERS, interpret=True)(
            tab.numpy(), idx.numpy()))
        if form == "onehotmm":
            _gap_ok(got, want, tab.numpy(), 10)
        else:
            np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- perf_probe21b.py


@pytest.mark.parametrize("form", p21b.FORMS)
def test_probe21b_plain_matches_jax(form):
    tab, idx = p21b.inputs("cpu")
    got = p21b.gather(form, tab, idx, ITERS).numpy()
    variant = form if form in ("none", "onehot_hi") else form.split("_")[0]
    want = np.asarray(J21B.build(variant, ITERS, interpret=True)(
        tab.numpy(), idx.numpy()))
    if form == "onehot_hi":
        _gap_ok(got, want, tab.numpy(), 21)
    else:
        np.testing.assert_array_equal(got, want)


GATHER_FORMS = [("probe21", f) for f in p21.FORMS] + [
    ("probe21b", f) for f in p21b.FORMS]
# The forms that run on the trip loop (csrc/probes.cu gather_loop): the
# gather probes' and probe21c's.
TRIP_FORMS = GATHER_FORMS + [("probe21c", f) for f in p21c.FORMS]


@functools.lru_cache(maxsize=None)
def _jax_at_zero(probe, variant):
    if probe == "probe21":
        tab, idx = _inputs21(128)
        return np.asarray(J21.build(variant, 128, 0, interpret=True)(
            tab.numpy(), idx.numpy()))
    tab, idx = p21b.inputs("cpu")
    return np.asarray(J21B.build(variant, 0, interpret=True)(
        tab.numpy(), idx.numpy()))


@pytest.mark.parametrize("probe, form", GATHER_FORMS)
def test_gather_at_zero_iterations_is_zero(probe, form):
    """No iteration: the plain version and the JAX probe give the zero
    tile (the kernels' loop then runs no trip)."""
    if probe == "probe21":
        got = p21.gather(form, *_inputs21(128), 0)
        variant = P21_JAX[form][0]
    else:
        got = p21b.gather(form, *p21b.inputs("cpu"), 0)
        variant = (form if form in ("none", "onehot_hi")
                   else form.split("_")[0])
    zero = np.zeros(_probe.SHAPE, np.float32)
    np.testing.assert_array_equal(got.numpy(), zero)
    np.testing.assert_array_equal(_jax_at_zero(probe, variant), zero)


def test_gather_tune_times_every_form():
    """tools/gather_tune.py runs every form of both gather probes and of
    probe21c, the row forms (those with a *_serial entry) first, on
    main()'s inputs; one build a (trip, block) pair."""
    from terminal_raytracer_tpu_torch.tools import gather_tune

    got = gather_tune.cases("cpu")
    rows = [(probe, f) for probe, forms in gather_tune.ROW.items()
            for f in forms]
    assert [(c[0], c[1]) for c in got[:len(rows)]] == rows
    assert set(rows) == {(probe, f.removesuffix("_serial"))
                         for probe, f in TRIPS if not TRIPS[probe, f]}
    assert sorted((c[0], c[1]) for c in got) == sorted(TRIP_FORMS)
    tab, idx = _inputs21(1024)
    assert all(torch.equal(c[3], tab) and torch.equal(c[4], idx)
               for c in got if c[0] == "probe21" and c[1] != "selectacc")
    tab_c, x0_c = p21c.inputs("cpu")
    assert all(c[2] == tab_c.numel() and torch.equal(c[3], tab_c)
               and torch.equal(c[4], x0_c) for c in got if c[0] == "probe21c")
    assert list(gather_tune.variants([4, 16], [32])) == ["U4/B32", "U16/B32"]
    assert gather_tune.clocks(0.003 + 512 / 1980e3, 0.003, 512, 1980.0) \
        == pytest.approx(1.0)


# ----------------------------------------------------- perf_probe21c.py


@pytest.mark.parametrize("form", p21c.FORMS)
def test_probe21c_plain_matches_jax(form):
    tab, x0 = p21c.inputs("cpu")
    got = p21c.block(form, tab, x0, ITERS).numpy()
    variant = "atan2" if form.startswith("atan2") else form
    want = np.asarray(J21C.build(variant, ITERS, interpret=True)(
        tab.numpy(), x0.numpy()))
    if form in ("none", "f2i"):
        np.testing.assert_array_equal(got, want)
    elif form == "atan2f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    elif form == "atan2_poly":
        np.testing.assert_allclose(got, want, rtol=0, atol=ITERS * 2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)


# ------------------------------------------- probe_when.py, probe_cond.py


def _np_pred(i, seed, thresh, form):
    lane = np.arange(_probe.TILE).reshape(_probe.SHAPE)
    if form == "divergent":
        return (i * 40503 + seed + lane) % 1000 < thresh
    return np.full(_probe.SHAPE, form == "unguarded"
                   or (i * 40503 + seed) % 1000 < thresh)


def _np_when(form, seed, frac, iters):
    """probe_when.py:30-52, one grid step, in numpy float32: acc = x, then
    per iteration the 48-step heavy body where pred holds (pl.when), or
    always (unguarded); divergent takes pred at seed + lane."""
    acc = np.random.RandomState(0).rand(*_probe.SHAPE).astype(np.float32)
    mul, add, quarter = (np.float32(1.0000001), np.float32(0.3),
                         np.float32(0.25))
    for i in range(iters):
        y = acc
        for _ in range(48):
            y = y * mul + add
            y = y - np.floor(y * quarter)
        acc = np.where(_np_pred(i, seed, int(frac * 1000), form), y, acc)
    return acc


def _np_cond(form, seed, frac, iters):
    """probe_cond.py:32-56, one grid step, in numpy float32: x = iota(axis
    1) * 0.01, then per iteration heavy(x) where pred holds, else x + 0.0
    (lax.cond); unguarded is where(pred, 1, 0) * 0 + heavy(x); divergent
    takes pred at seed + lane."""
    x = (np.arange(_probe.TILE).reshape(_probe.SHAPE) % 128).astype(
        np.float32) * np.float32(0.01)
    mul, add, half = (np.float32(1.000001), np.float32(0.5),
                      np.float32(0.5))
    for i in range(iters):
        y = x
        for _ in range(40):
            y = y * mul + add
            y = y - np.floor(y * half)
        if form == "unguarded":
            x = np.float32(0.0) + y
        else:
            x = np.where(_np_pred(i, seed, int(frac * 1000), form), y,
                         x + np.float32(0.0))
    return x


@pytest.mark.parametrize("form, frac", [(f, fr) for f in probe_when.FORMS
                                        for fr in probe_when.FRACS])
def test_probe_when_plain_matches_numpy(form, frac):
    x = probe_when.inputs("cpu")
    out = probe_when.branch(form, x, probe_when.SEED, frac, K)
    assert out.shape == (probe_when.STEPS, *_probe.SHAPE)
    want = _np_when(form, probe_when.SEED, frac, K)
    for copy in (0, probe_when.STEPS - 1):
        np.testing.assert_array_equal(out[copy].numpy(), want)


@pytest.mark.parametrize("form, frac", [(f, fr) for f in probe_cond.FORMS
                                        for fr in probe_cond.FRACS])
def test_probe_cond_plain_matches_numpy(form, frac):
    out = probe_cond.branch(form, probe_cond.SEED, frac, K, "cpu")
    assert out.shape == (probe_cond.STEPS, *_probe.SHAPE)
    want = _np_cond(form, probe_cond.SEED, frac, K)
    for copy in (0, probe_cond.STEPS - 1):
        np.testing.assert_array_equal(out[copy].numpy(), want)


def test_branch_forms_differ_where_the_predicate_does():
    """At frac 0.5 the guarded, unguarded and divergent bodies run on
    different iterations, so the three tiles differ; at frac 1 they agree."""
    x = probe_when.inputs("cpu")
    outs = {f: probe_when.branch(f, x, 7, 0.5, K)[0] for f in
            probe_when.FORMS}
    assert not torch.equal(outs["guarded"], outs["unguarded"])
    assert not torch.equal(outs["guarded"], outs["divergent"])
    full = [probe_when.branch(f, x, 7, 1.0, K)[0] for f in probe_when.FORMS]
    assert all(torch.equal(full[0], t) for t in full[1:])


# ------------------------------ the branch kernels' floor on the FP32 pipe
#
# csrc/probes.cu floor_scaled takes floor(a), a = y * s, as
# __fmaf_rd(y, s, C) - C with C = 1.5 * 2^23: equal to floorf(a) bit for bit
# for a in [-2^22, 2^22), a not -0.0. The tests below hold every floor
# argument of the plain versions at main()'s loop counts to that range, and
# a numpy model of the rounded-down sum to np.floor.

FLOOR_C = 1.5 * 2.0 ** 23
FLOOR_LIMIT = 2.0 ** 22
BRANCH = {"cond": probe_cond, "when": probe_when}
BRANCH_CASES = [(name, form, frac) for name, mod in BRANCH.items()
                for form, frac in _probe.branch_cases(mod.FORMS, mod.FRACS)]


def _floor_model(a):
    """The kernel's floor of float32 `a`: the sum with C in float64 (exact
    here, asserted), rounded down to an integer (float32's spacing in [2^23,
    2^24)), less C, in float32."""
    s = a.astype(np.float64) + FLOOR_C
    assert np.array_equal(s - FLOOR_C, a.astype(np.float64))
    assert ((s >= 2.0 ** 23) & (s < 2.0 ** 24)).all()
    return (np.floor(s) - FLOOR_C).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model_exact_on_binade(bits0):
    """_floor_model equals np.floor bit for bit on every float32 whose bits
    share bits0's sign and exponent (2^23 values, in chunks)."""
    step = 1 << 21
    for lo in range(bits0, bits0 + (1 << 23), step):
        a = np.arange(lo, lo + step, dtype=np.uint32).view(np.float32)
        if not np.array_equal(_floor_model(a).view(np.uint32),
                              np.floor(a).view(np.uint32)):
            return False
    return True


def _binades(lo, hi):
    """The first bits of every float32 binade that [lo, hi] touches; lo > 0."""
    first = np.float32(lo).view(np.uint32) & 0xff800000
    last = np.float32(hi).view(np.uint32) & 0xff800000
    return range(int(first), int(last) + 1, 1 << 23)


def _run_recording(mod, run):
    """run() with torch.floor recording its arguments: returns run()'s
    floor arguments as a list of heavy bodies, each a float32 array
    [HEAVY, 16, 128] in call order."""
    calls, floor = [], torch.floor

    def rec(a):
        calls.append(a.numpy().copy())
        return floor(a)

    with mock.patch.object(torch, "floor", rec):
        run()
    assert len(calls) % mod.HEAVY == 0
    return [np.stack(calls[i:i + mod.HEAVY])
            for i in range(0, len(calls), mod.HEAVY)]


def _plain_run(name, form, frac, iters):
    mod = BRANCH[name]
    if name == "cond":
        return lambda: mod.plain(form, mod.SEED, frac, iters, "cpu")
    return lambda: mod.plain(form, mod.inputs("cpu"), mod.SEED, frac, iters)


def _body_states(name, form, frac, iters):
    """[bodies, 16, 128]: for each heavy body that the form's plain version
    runs, in order, lane by lane, how many bodies the unguarded form had
    run on that lane before it reached the same input state. An untaken
    iteration leaves the state as it is (x + 0.0 on x >= 0; nothing), so a
    guarded body's input is the unguarded input of its taken count, and a
    divergent body (run every iteration, kept where the lane takes it) that
    of the lane's taken count so far."""
    mod = BRANCH[name]
    thresh, i = int(frac * 1000), np.arange(iters)
    lane = np.arange(_probe.TILE).reshape(_probe.SHAPE)
    if form == "divergent":
        take = (i[:, None, None] * 40503 + mod.SEED + lane) % 1000 < thresh
        return np.cumsum(take, 0) - take
    n = iters if form == "unguarded" else int(
        ((i * 40503 + mod.SEED) % 1000 < thresh).sum())
    return np.broadcast_to(np.arange(n)[:, None, None], (n, *_probe.SHAPE))


@functools.lru_cache(maxsize=None)
def _unguarded_bodies(name):
    """[K, HEAVY, 16, 128]: the unguarded form's floor arguments at K."""
    return np.stack(_run_recording(BRANCH[name],
                                   _plain_run(name, "unguarded", 1.0, K)))


@functools.lru_cache(maxsize=None)
def _unguarded_floor_ranges(name):
    """Per unguarded heavy body at main()'s loop count, lane by lane: the
    least and greatest floor argument and whether one was -0.0 (run once a
    process; the bodies are reduced as they come)."""
    mod = BRANCH[name]
    lo, hi, nz, calls, floor = [], [], [], [], torch.floor

    def rec(a):
        calls.append(a)
        if len(calls) == mod.HEAVY:
            t = torch.stack(calls)
            calls.clear()
            lo.append(t.amin(0))
            hi.append(t.amax(0))
            nz.append((t.view(torch.int32) == -2 ** 31).any(0))
        return floor(a)

    with mock.patch.object(torch, "floor", rec):
        _plain_run(name, "unguarded", 1.0, mod.ITERS)()
    return tuple(torch.stack(v).numpy() for v in (lo, hi, nz))


@pytest.mark.parametrize("name, form, frac", BRANCH_CASES)
def test_plain_floor_arguments_are_unguarded_states(name, form, frac):
    """At K iterations, each heavy body of the form's plain version takes
    floor of exactly the arguments the unguarded form's plain version took
    at _body_states' index, lane by lane, bit for bit."""
    got = _run_recording(BRANCH[name], _plain_run(name, form, frac, K))
    base = _unguarded_bodies(name)
    states = _body_states(name, form, frac, K)
    assert len(got) == len(states)
    for body, k in zip(got, states):
        want = np.take_along_axis(base, k[None, None], 0)[0]
        assert np.array_equal(body.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name, form, frac", BRANCH_CASES)
def test_plain_floor_arguments_stay_where_the_fp32_floor_is_exact(
        name, form, frac):
    """Every floor argument the form's plain version reaches at main()'s
    loop count (the unguarded form's at _body_states, as the test above
    holds) lies in [-2^22, 2^22) and is never -0.0, and the model equals
    np.floor on every float32 of each binade that their range touches."""
    mod = BRANCH[name]
    lo, hi, nz = _unguarded_floor_ranges(name)
    k = _body_states(name, form, frac, mod.ITERS)
    at = np.arange(_probe.TILE).reshape(_probe.SHAPE)
    a_lo = float(lo.reshape(mod.ITERS, -1)[k.reshape(len(k), -1),
                                            at.reshape(-1)].min())
    a_hi = float(hi.reshape(mod.ITERS, -1)[k.reshape(len(k), -1),
                                            at.reshape(-1)].max())
    assert -FLOOR_LIMIT <= a_lo and a_hi < FLOOR_LIMIT
    assert not nz.reshape(mod.ITERS, -1)[k.reshape(len(k), -1),
                                         at.reshape(-1)].any()
    assert 0.0 < a_lo, "a range through 0 needs its subnormals checked"
    assert all(_model_exact_on_binade(b) for b in _binades(a_lo, a_hi))


def test_floor_model_on_edge_values():
    """The model against np.floor at integers, the floats just below them,
    halves, negatives and the ends of [-2^22, 2^22); at -0.0 it gives +0.0,
    the one difference (hence no -0.0 argument above)."""
    n = np.array([-FLOOR_LIMIT, -FLOOR_LIMIT + 1, -3, -2, -1, 1, 2, 3,
                  FLOOR_LIMIT - 1], np.float32)
    a = np.concatenate([n, np.nextafter(n, np.float32(-np.inf)), n + 0.5,
                        np.array([0.0, 0.25, -0.25, 0.075, 1.25,
                                  FLOOR_LIMIT - 0.25], np.float32)])
    a = a[a >= -FLOOR_LIMIT]
    assert np.array_equal(_floor_model(a).view(np.uint32),
                          np.floor(a).view(np.uint32))
    z = np.array([-0.0], np.float32)
    assert _floor_model(z).view(np.uint32)[0] == 0
    assert np.floor(z).view(np.uint32)[0] == 0x80000000


# ------------------------------------------------------------- helpers


def test_tf32_round_is_round_to_nearest_ties_away():
    base = np.float32(1.0).view(np.int32)
    bits = np.array([base, base + 0x0fff, base + 0x1000, base + 0x1fff,
                     base + 0x2000, base + 0x3000], np.int32)
    for sign in (0, np.int32(-2**31)):
        x = torch.from_numpy((bits | sign).view(np.float32))
        got = _probe.tf32_round(x).numpy().view(np.int32) & 0x7fffffff
        assert list(got - base) == [0, 0, 0x2000, 0x2000, 0x2000, 0x4000]
    x = torch.from_numpy(np.random.RandomState(0).rand(4096).astype(
        np.float32))
    t = _probe.tf32_round(x)
    assert not (t.numpy().view(np.int32) & 0x1fff).any()
    assert float((t - x).abs().max()) <= 2.0 ** -11 * float(x.abs().max())


@pytest.mark.parametrize("mod, argv", [
    (p21, ["--sizes", "128,1024"]), (p21b, []), (p21c, []),
    (probe_when, []), (probe_cond, [])])
def test_main_on_the_cpu_prints_values(mod, argv, capsys):
    rows = mod.main(argv + ["--device", "cpu", "--iters", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(rows) > 0
    assert all(r["ms"] is None for r in rows)
    assert not any("ms" in line.split() or "MISMATCH" in line
                   or "DIFFER" in line or "False" in line for line in lines)


def test_main_on_cuda_without_a_gpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(SystemExit) as e:
        p21.main(["--iters", "4"])
    assert e.value.code == 2
    assert "needs a CUDA GPU" in capsys.readouterr().err


def test_wrappers_refuse_bad_inputs():
    tab, idx = _inputs21(128)
    with pytest.raises(ValueError, match="unknown form"):
        p21.gather("take", tab, idx, 4)
    with pytest.raises(ValueError, match="power of two"):
        p21.gather("ldg", tab[:100], idx, 4)
    with pytest.raises(ValueError, match="int32"):
        p21.gather("ldg", tab, idx.long(), 4)
    with pytest.raises(ValueError, match="iters"):
        p21b.gather("rowsel_ldg", *p21b.inputs("cpu"), -1)
    with pytest.raises(ValueError, match="frac"):
        probe_cond.branch("cond", 7, 1.5, 4, "cpu")
    with pytest.raises(ValueError, match="seed"):
        probe_when.branch("guarded", probe_when.inputs("cpu"), 2**31, 0.5, 4)


def test_render_sources_leave_out_the_probe_library():
    """load_kernels() by default (every render) loads no probe entry; a
    probe launch asks for probes.cu alone."""
    from terminal_raytracer_tpu_torch.ops import build

    assert set(build.ENTRY_POINTS) - set(build.RENDER_SOURCES) == {
        "probes.cu"}
    assert all(name.startswith("trt_probe")
               for name, _ in build.ENTRY_POINTS["probes.cu"])
    assert not any(name.startswith("trt_probe")
                   for src in build.RENDER_SOURCES
                   for name, _ in build.ENTRY_POINTS[src])


def test_probe_entries_match_the_source():
    """ops/build.py declares exactly the entries that csrc/probes.cu's
    macros define, with the pointer count of their macro's signature: the
    FRND baselines of the branch probes and the serial baselines of the
    gather probes and of probe21c included."""
    import re

    from terminal_raytracer_tpu_torch.ops import build

    text = (build.CSRC / "probes.cu").read_text()
    n_ptr = {"PROBE21": 5, "PROBE21B": 5, "PROBE21C": 5, "PROBE_WHEN": 4,
             "PROBE_COND": 3}
    prefix = {"PROBE21": "probe21", "PROBE21B": "probe21b",
              "PROBE21C": "probe21c", "PROBE_WHEN": "probe_when",
              "PROBE_COND": "probe_cond"}
    defined = {f"trt_{prefix[m]}_{form}": n_ptr[m] for m, form in
               re.findall(r"^(PROBE\w+)\((\w+),", text, re.M)}
    assert defined == dict(build.ENTRY_POINTS["probes.cu"])
    assert {"trt_probe_when_guarded_frnd", "trt_probe_cond_cond_frnd",
            "trt_probe21_none_serial", "trt_probe21_ldg_serial",
            "trt_probe21b_none_serial",
            "trt_probe21b_rowsel_ldg_serial", "trt_probe21c_atan2f_serial",
            "trt_probe21c_packed_serial"} <= set(defined)


def _trip_widths():
    """{(probe, form): iterations a trip} of csrc/probes.cu's gather and
    probe21c entries (TRIP(u) in their macro; 0 for the serial loop)."""
    import re

    from terminal_raytracer_tpu_torch.ops import build

    text = (build.CSRC / "probes.cu").read_text()
    return {("probe" + m.lower(), form): int(u or 0)
            for m, form, u in re.findall(
                r"^PROBE(21[BC]?)\((\w+), [\w, ]*?(?:TRIP\((\d+)\)|0)\)$",
                text, re.M)}


TRIPS = _trip_widths()


def test_gather_trip_widths_cover_every_form():
    """Every gather and probe21c form has a trip width of 4, 8, 16 or 32 in
    the source; the serial baselines run the serial loop."""
    forms = set(TRIP_FORMS)
    assert {k for k, u in TRIPS.items() if u} == forms
    assert all(TRIPS[k] in (4, 8, 16, 32) for k in forms)
    assert {k for k, u in TRIPS.items() if not u} == {
        ("probe21", "none_serial"), ("probe21", "ldg_serial"),
        ("probe21b", "none_serial"), ("probe21b", "rowsel_ldg_serial"),
        ("probe21c", "atan2f_serial"), ("probe21c", "packed_serial")}


SASS = """\
\t\tFunction : _ZN41_GLOBAL__N__a9_probes_cu_29b410probe_condILi0ELb1EEEv11ProbeBranchPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                       /* 0x000e220000000800 */
        /*01b0*/                   @!UP0 UIADD3 UR5, UR5, 0x3e8, URZ ; /* 0x000003e805058890 */
        /*01c0*/                   FMUL R3, R2, 1.0000009536743164062 ;
        /*01d0*/                   FADD R3, R3, 0.5 ;
        /*01e0*/                   FMUL R4, R3, 0.5 ;
        /*01f0*/                   FRND.FLOOR R4, R4 ;
        /*0200*/               @P1 FADD R2, R3, -R4 ;
        /*0210*/                   ISETP.GE.AND P0, PT, R3, UR6, PT ;
\t\tFunction : _ZN41_GLOBAL__N__a9_probes_cu_29b410probe_condILi0ELb0EEEv11ProbeBranchPf
        /*0000*/                   FMUL R3, R2, 1.0000009536743164062 ;
        /*0010*/                   FADD R3, R3, 0.5 ;
        /*0020*/                   FFMA.RM R4, R3, 0.5, 12582912 ;
        /*0030*/                   FADD R4, R4, -12582912 ;
        /*0040*/                   FADD R2, R3, -R4 ;
"""


def test_sass_ops_counts_a_heavy_step():
    """tools/sass_ops.py reads a cuobjdump -sass listing: opcodes with
    their modifiers, guards dropped, encoding lines skipped; a step is one
    floor, FRND or FFMA.RM."""
    from terminal_raytracer_tpu_torch.tools import sass_ops

    found = sass_ops.functions(SASS)
    frnd, fp32 = (found[k] for k in sorted(found, key=lambda k: "Lb0E" in k))
    assert dict(frnd) == {"LDC": 1, "UIADD3": 1, "FMUL": 2, "FADD": 2,
                          "FRND.FLOOR": 1, "ISETP.GE.AND": 1}
    assert sass_ops.steps(frnd) == sass_ops.steps(fp32) == 1
    assert sass_ops.per_step(fp32) == "FADD 3.00, FFMA.RM 1.00, FMUL 1.00"
    assert sass_ops.per_step(frnd) == "FADD 2.00, FMUL 2.00, FRND.FLOOR 1.00"
    assert sass_ops.uniform_share(frnd) == "uniform 1, vector integer 1"


GATHER_SASS = """\
\t\tFunction : _ZN41_GLOBAL__N__a9_probes_cu_29b47probe21ILi2ELb1EEEv11ProbeGatherPKfPKiPf
        /*0140*/                   LDG.E R7, desc[UR6][R4.64] ;
        /*01b0*/                   LOP3.LUT R11, R10, UR5, RZ, 0xc0, !PT ;
        /*01c0*/                   LDG.E.CONSTANT R11, desc[UR6][R10.64] ;
        /*01d0*/                   LDG.E.CONSTANT R13, desc[UR6][R12.64] ;
        /*01e0*/                   FADD R6, R11, R6 ;
        /*01f0*/                   FADD R6, R6, R13 ;
        /*0200*/               @P1 BRA 0x1b0 ;
        /*0210*/                   STG.E desc[UR6][R2.64], R6 ;
        /*0220*/                   BRA 0x220;
\t\tFunction : _ZN41_GLOBAL__N__a9_probes_cu_29b47probe21ILi2ELb0EEEv11ProbeGatherPKfPKiPf
        /*0300*/                   FADD R6, R20, R6 ;
        /*0310*/                   LDG.E.CONSTANT R11, desc[UR6][R10.64] ;
        /*0320*/                   LDG.E.CONSTANT R13, desc[UR6][R12.64] ;
        /*0330*/                   FADD R6, R6, R21 ;
        /*0340*/                   IMAD.MOV.U32 R20, RZ, RZ, R11 ;
        /*0350*/                   MOV R21, R13 ;
        /*0360*/               @P0 BRA 0x300 ;
"""


def test_sass_ops_reads_a_gather_loop():
    """tools/sass_ops.py finds each loop of a gather kernel by its backward
    branch and counts its loads that an FADD reads only on a later pass:
    none in the parent's trip (its loads added at once), both in a trip
    that adds the loads of the pass before (through MOV copies)."""
    from terminal_raytracer_tpu_torch.tools import sass_ops

    insns = sass_ops.instructions(GATHER_SASS)
    serial, shipped = (insns[k] for k in sorted(insns,
                                               key=lambda k: "Lb0E" in k))
    (lp,) = sass_ops.loops(serial)
    assert (lp["start"], lp["end"], lp["order"]) == (0x1b0, 0x200, "L2 A2")
    assert (lp["loads"], lp["later"]) == (2, 0)
    (lp,) = sass_ops.loops(shipped)
    assert (lp["order"], lp["loads"], lp["later"]) == ("A1 L2 A1", 2, 2)
    assert sass_ops.loop_line(lp) == (
        "loop 0x0300-0x0360: LDG.E.CONSTANT 2; FADD 2; order A1 L2 A1; 2 of "
        "2 loads added on a later pass")
    assert sass_ops.functions(GATHER_SASS) == {
        k: Counter(op for _, op, _ in v) for k, v in insns.items()}


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _same(got, want, form):
    if form == "atan2f":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want), form


@pytest.mark.cuda
@pytest.mark.parametrize("n, form", P21_CASES)
def test_probe21_kernel_matches_plain(cuda_device, n, form):
    tab, idx = (t.to(cuda_device) for t in _inputs21(n))
    n0 = p21.gather.launches[form]
    got = p21.gather(form, tab, idx, 64)
    assert p21.gather.launches[form] == n0 + 1
    _same(got, p21.plain(form, tab, idx, 64), form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", p21b.FORMS)
def test_probe21b_kernel_matches_plain(cuda_device, form):
    tab, idx = p21b.inputs(cuda_device)
    n0 = p21b.gather.launches[form]
    got = p21b.gather(form, tab, idx, 64)
    assert p21b.gather.launches[form] == n0 + 1
    _same(got, p21b.plain(form, tab, idx, 64), form)


@pytest.mark.cuda
@pytest.mark.parametrize("probe, form, iters", [
    (probe, form, iters) for probe, form in TRIP_FORMS
    for iters in (0, 1, TRIPS[probe, form] - 1, TRIPS[probe, form] + 1, 13)])
def test_gather_kernels_match_plain_at_any_loop_count(cuda_device, probe,
                                                      form, iters):
    """The trip loop's edges at the form's trip width U: no trip, the
    remainder trip alone (short by one or more), a whole trip before it;
    probe21 at n = 128; probe21c atan2f within rtol 1e-6 of torch.atan2."""
    if probe == "probe21":
        tab, idx = (t.to(cuda_device) for t in _inputs21(128))
        mod, fn = p21, p21.gather
    elif probe == "probe21b":
        tab, idx = p21b.inputs(cuda_device)
        mod, fn = p21b, p21b.gather
    else:
        tab, idx = p21c.inputs(cuda_device)
        mod, fn = p21c, p21c.block
    got = fn(form, tab, idx, iters)
    _same(got, mod.plain(form, tab, idx, iters), form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", p21c.FORMS)
def test_probe21c_kernel_matches_plain(cuda_device, form):
    """Each form against its plain version at main()'s 512 iterations and
    at 64; where the parent's loop is kept (*_serial), the shipped entry
    against it bit for bit, launched directly."""
    tab, x0 = p21c.inputs(cuda_device)
    for iters in (p21c.ITERS, 64):
        n0 = p21c.block.launches[form]
        got = p21c.block(form, tab, x0, iters)
        assert p21c.block.launches[form] == n0 + 1
        _same(got, p21c.plain(form, tab, x0, iters), form)
        if ("probe21c", f"{form}_serial") in TRIPS:
            serial = torch.empty_like(got)
            _probe.launch(f"trt_probe21c_{form}_serial",
                          _probe.GatherArgs(tab.numel(), iters), tab, x0,
                          serial)
            torch.cuda.synchronize()
            assert torch.equal(serial, got), (form, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("form", probe_when.FORMS)
def test_probe_when_kernel_matches_plain(cuda_device, form):
    x = probe_when.inputs(cuda_device)
    n0 = probe_when.branch.launches[form]
    got = probe_when.branch(form, x, 7, 0.5, K)
    assert probe_when.branch.launches[form] == n0 + 1
    want = probe_when.plain(form, x, 7, 0.5, K)
    assert torch.equal(got, want.expand_as(got))


@pytest.mark.cuda
@pytest.mark.parametrize("form", probe_cond.FORMS)
def test_probe_cond_kernel_matches_plain(cuda_device, form):
    n0 = probe_cond.branch.launches[form]
    got = probe_cond.branch(form, 7, 0.25, K, cuda_device)
    assert probe_cond.branch.launches[form] == n0 + 1
    want = probe_cond.plain(form, 7, 0.25, K, cuda_device)
    assert torch.equal(got, want.expand_as(got))


@pytest.mark.cuda
@pytest.mark.parametrize("iters, seed", [(1, 7), (7, -12345), (13, 999)])
@pytest.mark.parametrize("name", ["when", "cond"])
def test_branch_kernels_match_plain_at_any_loop_count(cuda_device, name,
                                                      iters, seed):
    """The unrolled loop's remainder trips and the carried residue from a
    negative seed: every form at frac 0.5 against its plain version."""
    mod = BRANCH[name]
    for form in mod.FORMS:
        if name == "when":
            x = mod.inputs(cuda_device)
            got = mod.branch(form, x, seed, 0.5, iters)
            want = mod.plain(form, x, seed, 0.5, iters)
        else:
            got = mod.branch(form, seed, 0.5, iters, cuda_device)
            want = mod.plain(form, seed, 0.5, iters, cuda_device)
        assert torch.equal(got, want.expand_as(got)), form
