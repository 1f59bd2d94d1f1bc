"""The comparison fails what it has to: the control (the reference with
bfloat16 accumulators in the program's place), and a run of the harness
on the CPU at a tiny size with the timed path broken underneath, once for
each fault a one-card renderer can have: a step that returns its state
unchanged, half of each pixel's base samples left out with the mean taken
over the rest, and an answer (the image) altered where it is produced.
(The exchange between cards does not exist on one card.) On the card, the
control runs at each configuration's own size."""

import time

import pytest

from harness import check, runner, spec as spec_mod
from test_harness_line import SPEC, tiny_run


def _wrap_step(eng, after=None, after_finalize=None):
    step = eng.step

    def call(state, *a, **k):
        before = state.acc.clone()
        out = step(state, *a, **k)
        if after is not None:
            after(before, out.state, out.rgb)
        return out

    def accumulate(state, *a, **k):
        before = state.acc.clone()
        st, rays, occ = step.accumulate(state, *a, **k)
        if after is not None:
            after(before, st, None)
        return st, rays, occ

    def finalize(state, fn):
        rgb, glyphs = step.finalize(state, fn)
        if after_finalize is not None:
            after_finalize(rgb)
        return rgb, glyphs

    call.accumulate, call.finalize, call.tracer = (accumulate, finalize,
                                                   step.tracer)
    eng.step = call


def state_unchanged(eng, monkeypatch):
    _wrap_step(eng, after=lambda before, st, rgb: st.acc.copy_(before))


def half_batch(eng, monkeypatch):
    from terminal_raytracer_tpu_torch.ops import kernels

    def base_kernel(tracer, pose, seed, fn, y0=0, h_out=None, base_q=None):
        q = tracer.base_samples // 2
        a = kernels.base_kernel_plain(tracer, pose, seed, fn, y0, h_out, q)
        k = tracer.base_samples / q
        return a._replace(csum=a.csum * k, csumsq=a.csumsq * k)

    monkeypatch.setattr(kernels, "base_kernel", base_kernel)


def _alter(rgb):
    rgb[0, 0, 0] += 1


def altered_answer(eng, monkeypatch):
    _wrap_step(eng, after=lambda before, st, rgb: rgb is not None
               and _alter(rgb), after_finalize=_alter)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("workload", ["cornell.view", "cornell.headless",
                                      "northstar.headless"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(workload, fault, monkeypatch):
    run = tiny_run(workload, 2**31 + 11, 2.0, max_depth=4)
    out = runner.run_cell(run, time.perf_counter(), log=lambda m: None,
                          patch=lambda eng: FAULTS[fault](eng, monkeypatch))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("config", ["cornell_box", "northstar"])
def test_control_fails_at_a_tiny_size(config):
    cfg = dict(spec_mod.load_config(SPEC, config), width=16, height=8,
               samples_per_pixel=16)
    nums = check.control_numbers(cfg, "cpu", 2**31 + 21)
    limits = spec_mod.load_limits(config)
    assert any(v > limits[k] for k, v in nums.items()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cornell_box", "northstar"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_control_fails_at_the_cell_size(cuda, config, seed):
    cfg = spec_mod.load_config(SPEC, config)
    nums = check.control_numbers(cfg, cuda, seed)
    limits = spec_mod.load_limits(config)
    print(config, seed, {k: v for k, v in sorted(nums.items())})
    assert any(v > limits[k] for k, v in nums.items()), nums
