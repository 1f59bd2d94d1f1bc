"""The metric arithmetic on synthetic timestamps, the traffic generator,
and the per-layer readers on a synthetic context."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from harness import runner, spec as spec_mod, stats, traffic
from harness.devtrace import Timeline


def test_window_rate_is_all_work_over_all_time():
    assert stats.window_rate(3e9, 10.0, 12.5) == pytest.approx(1.2e9)
    with pytest.raises(ValueError):
        stats.window_rate(1.0, 2.0, 2.0)


@pytest.mark.parametrize("n", [1, 2, 7, 300, 301])
def test_percentile_matches_numpy(n):
    vals = np.random.RandomState(n).exponential(5.0, n).tolist()
    assert stats.percentile(vals, 95.0) == pytest.approx(
        float(np.percentile(vals, 95.0)))


def test_move_p95_over_every_press():
    # Presses every 33 ms; the frame after each shows 4 ms later, except
    # every 20th, which waits 30 ms: the tail is the tail of all presses.
    presses, displays = [], []
    for i in range(300):
        due = i * 0.033
        presses.append((due, 3 * i))
        late = 0.030 if i % 20 == 0 else 0.004
        displays.append((due + 0.001, 3 * i - 1))  # a frame from before
        displays.append((due + late, 3 * i))
    lat = stats.move_latencies(presses, sorted(displays))
    assert len(lat) == 300
    assert sorted(Counter(round(x, 6) for x in lat).items()) == [
        (0.004, 285), (0.03, 15)]
    assert stats.percentile(lat, 95.0) == pytest.approx(
        float(np.percentile(lat, 95.0)))


def test_move_latency_skips_frames_dispatched_before_the_press():
    lat = stats.move_latencies([(1.0, 5)], [(1.002, 4), (1.004, None),
                                            (1.009, 5)])
    assert lat == [pytest.approx(0.009)]
    assert stats.move_latencies([(1.0, 5)], [(1.002, 4)]) == []


def test_union_busy_and_idle():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (10.0, 11.0)]
    assert stats.union(ivs, 0.5, 3.5) == [(0.5, 2.0), (3.0, 3.5)]
    assert stats.busy_seconds(ivs, 0.0, 5.0) == pytest.approx(3.0)
    assert stats.idle_intervals(ivs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_idle_attributed_to_host_spans():
    gaps = [(2.0, 3.0), (4.0, 5.0)]
    spans = {"poll": [(1.5, 2.25)], "enqueue": [(2.25, 2.5), (4.0, 4.5)]}
    got = stats.attribute(gaps, spans)
    assert got == pytest.approx({"poll": 0.25, "enqueue": 0.75,
                                 "other": 1.0})


def _view_mix():
    return spec_mod.load_mix("view")


def test_key_script_same_presses_every_seed():
    mix = _view_mix()
    cycle = (2 * sum(s for _, s in mix["pairs"]) + sum(mix["pause_s"]))
    scripts = [traffic.key_script(mix, s, cycle) for s in (1, 2, 2**31 + 5)]
    counts = [Counter(p.key for p in s) for s in scripts]
    assert counts[0] == counts[1] == counts[2]
    assert [p.due for p in scripts[0]] != [p.due for p in scripts[1]]
    assert scripts[1] == traffic.key_script(mix, 2, cycle)
    for s in scripts:
        dues = [p.due for p in s]
        assert dues == sorted(dues) and dues[-1] < cycle - mix["tail_s"]
        # Each pair's opposite bursts bring the camera back.
        c = Counter(p.key for p in s)
        for k, opp in traffic.OPPOSITE.items():
            assert c[k] == c[opp]


def test_key_script_rate_and_length():
    mix = _view_mix()
    s = traffic.key_script(mix, 7, 20.0)
    assert len(s) == 300
    gaps = np.diff([p.due for p in s])
    assert gaps.min() == pytest.approx(1.0 / mix["key_rate_hz"])


def test_bad_mixes_refused():
    with pytest.raises(ValueError):
        traffic.check_mix({"driver": "batch"})
    mix = dict(_view_mix(), pairs=[["q", 1.0]])
    with pytest.raises(ValueError):
        traffic.check_mix(mix)


def test_engine_options_the_reference_cannot_follow_refused():
    for key, value in (("denoise", 1.0), ("accel", "grid"), ("exposure", 2)):
        mix = _view_mix()
        mix["engine"] = dict(mix["engine"], **{key: value})
        with pytest.raises(ValueError, match="not run"):
            traffic.check_mix(mix)
    traffic.check_mix(spec_mod.load_mix("headless"))


def test_mix_with_no_pairs_sends_no_keys():
    mix = dict(_view_mix(), pairs=[], pause_s=[])
    traffic.check_mix(mix)
    assert traffic.key_script(mix, 2**31 + 9, 20.0) == []
    assert traffic.warmup_script(mix) == []


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::kernel_extra_grouped<false, false, "
     "(anonymous namespace)::GroupSweep<16> >(ExtraArgs)",
     "kernel_extra_grouped<false, false, GroupSweep<16> >"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<double, "
     "at::native::func_wrapper_t<double, at::native::sum_functor<double, "
     "double, double>::operator()(double, double) const::{lambda(double, "
     "double)#1}>, unsigned int, double, 4, 4> >(at::native::ReduceOp<"
     "double, unsigned int, double, 4, 4>)",
     "at::native::reduce_kernel<512, 1, at::native::ReduceOp<double, "
     "at::native::func_wrapper_t<double, at::native::sum_functor<double, "
     "double, double>::operator()(double, double) const::{lambda(double, "
     "double)#1}>, unsigned int, double, 4, 4> >"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
    ("Memset", "Memset"),
])
def test_breakdown_names_keep_the_kernel(name, short):
    assert runner.kernel_name(name) == short


def _ctx(**kw):
    tl = Timeline([("void trt::kernel_base_regen_resident<false>(x)", 0.0,
                    0.002),
                   ("void trt::kernel_extra_grouped<false>(x)", 0.002, 0.005),
                   ("Memcpy DtoH", 0.006, 0.007)], 0.0, 0.010)
    base = dict(spans={"poll": [(0, 0.001), (1, 1.003)],
                       "encode": [(0, 0.0005)], "enqueue": [(0, 0.002)]},
                timeline=tl, traced_rays=1e6, ops_per_sweep=233,
                peak_fp32=67e12, move_latencies=[0.001 * (i + 1)
                                                 for i in range(100)])
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_on_a_synthetic_run():
    ctx = _ctx()
    read = spec_mod.load_reader
    assert read("poll_ms.view")(ctx) == pytest.approx(2.0)
    assert read("blit_ms.view")(ctx) == pytest.approx(0.5)
    assert read("enqueue_ms.headless")(ctx) == pytest.approx(2.0)
    assert read("device_idle.view")(ctx) == pytest.approx(40.0)
    ops = 1e6 * 233
    assert read("kernel_roofline.view")(ctx) == pytest.approx(
        100 * ops / (67e12 * 0.005))
    assert read("move_p95_ms.view")(ctx) == pytest.approx(
        float(np.percentile(ctx.move_latencies, 95.0)) * 1e3)


def test_readers_with_nothing_to_read_give_nothing():
    ctx = _ctx(timeline=None, spans=None, peak_fp32=None, move_latencies=[])
    for m in spec_mod.load_spec()["per_layer"]:
        assert spec_mod.load_reader(m["name"])(ctx) is None
