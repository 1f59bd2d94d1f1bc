"""The (16, 128) table's gathers on the H100: the Hopper counterpart of
tools/perf_probe21b.py (its Pallas kernel, :88).

out = sum over i < iters of g(tab, (idx0 + i) & 2047), in loop order, for
a per-lane (16, 128) int32 index and a (16, 128) f32 table. What each
gather reads, for the lane at (row, col):

  tala1      tab[row, idx & 127]            (the TPU's lane gather)
  tala0      tab[idx & 15, col]             (its sublane gather)
  rowsel     tab[idx >> 7, idx & 127]       (all 2048 texels)

each with the table in three homes (csrc/probes.cu): _ldg (__ldg, the
port's texel fetch), _shared (a copy in shared memory) and _shfl (in the
warp's registers: 4 shuffles for tala1's row, a select on the thread's own
16 registers for tala0's column, 64 shuffles for rowsel's table); `none`,
the loop baseline (acc += float(idx)); and onehot_hi, the full gather as a
3xTF32 one-hot product on the tensor cores (mma.sync), off rowsel by at
most the split's rounding (printed beside its bound).

The kernels (csrc/probes.cu gather_loop) run the loop in trips of U
iterations, U per form: a trip's fetches are issued before the previous
trip's adds, and every add stays in loop order, so a warp waits on its
adds and its fetches' rate, not on each iteration's whole chain; one warp
on each of 64 SMs (blocks of 32).

    python -m terminal_raytracer_tpu_torch.tools.perf_probe21b \\
        [--iters 512] [--reps 5] [--device cpu]

Each line: the kernel's ms (CUDA events, least of --reps), µs a gather
over the loop baseline, and [match] / [MISMATCH] against the same gather
through _ldg. With --device cpu the plain versions run and the lines carry
values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _probe
from ._probe import SHAPE, TILE

ITERS = 512  # the JAX script's default --iters
GATHERS = ("tala1", "tala0", "rowsel")
HOMES = ("ldg", "shared", "shfl")
FORMS = ("none",) + tuple(f"{g}_{h}" for g in GATHERS for h in HOMES) + (
    "onehot_hi",)


def inputs(device):
    """(tab, idx0) as the JAX probe draws them (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    tab = rng.random(SHAPE, dtype=np.float32)
    idx = rng.integers(0, TILE, size=SHAPE).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def _check(form, tab, idx0, iters):
    name = "perf_probe21b.gather"
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")
    _probe.check(tab, SHAPE, torch.float32, name)
    _probe.check(idx0, SHAPE, torch.int32, name)
    _probe.check_iters(iters, name)


def split3(tab):
    """tab as 3xTF32 rounds it: big = tf32(tab), small = tf32(tab - big),
    the sum big + small (exact in f32)."""
    big = _probe.tf32_round(tab)
    return big + _probe.tf32_round(tab - big)


def plain(form, tab, idx0, iters):
    """The form in plain PyTorch, a loop over iters in the kernel's order
    (every home of a gather computes the same values)."""
    op = form.split("_")[0]
    table = split3(tab) if form == "onehot_hi" else tab
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=tab.device)
    for i in range(iters):
        idx = (idx0 + i) & (TILE - 1)
        if op == "none":
            g = idx.to(torch.float32)
        elif op == "tala1":
            g = torch.gather(table, 1, (idx & 127).long())
        elif op == "tala0":
            g = torch.gather(table, 0, (idx & 15).long())
        else:  # rowsel, onehot: tab[idx >> 7, idx & 127]
            g = table.reshape(-1)[idx]
        acc = acc + g
    return acc


def gather(form, tab, idx0, iters):
    """Form `form` on the device of `tab`: its kernel on the card (counted
    in gather.launches[form]), its plain version for CPU tensors."""
    _check(form, tab, idx0, iters)
    if not _probe.on_cuda(tab.device, "perf_probe21b.gather"):
        return plain(form, tab, idx0, iters)
    _probe.check_aligned(tab, "perf_probe21b.gather")
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    _probe.launch(f"trt_probe21b_{form}", _probe.GatherArgs(TILE, iters),
                  tab, idx0, out)
    gather.launches[form] += 1
    return out


gather.launches = dict.fromkeys(FORMS, 0)


def run(iters=ITERS, reps=5, device="cuda"):
    """Every form; prints the JAX probe's lines. Returns a list of {form,
    out, ms, us} (ms and us None on the CPU)."""
    tab, idx0 = inputs(torch.device(device))
    refs = {}

    def tag(form, out):
        if form == "none":
            return "loop baseline"
        op = "rowsel" if form == "onehot_hi" else form.split("_")[0]
        if op not in refs:
            refs[op] = out
            return "ref"
        if form == "onehot_hi":
            ref = refs[op]
            gap = float((out.double() - ref.double()).abs().max())
            bound = _probe.gap_bound(iters, float(tab.abs().max()),
                                     float(ref.abs().max()), 21)
            return (f"3xtf32 gap vs rowsel {gap:.2e} <= {bound:.2e}: "
                    f"{gap <= bound}")
        return ("match " if torch.equal(out, refs[op]) else
                "MISMATCH vs ") + f"{op}_ldg"

    return _probe.loop_table(lambda form: gather(form, tab, idx0, iters),
                             FORMS, iters, reps, tag,
                             lambda form: f"{form:14s}", "gather")


def main(argv=None):
    ap = _probe.parser(__doc__, iters=ITERS)
    args = ap.parse_args(argv)
    return run(args.iters, args.reps, _probe.device_of(ap, args))


if __name__ == "__main__":
    main()
