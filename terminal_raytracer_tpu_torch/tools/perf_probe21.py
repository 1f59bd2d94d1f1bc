"""Per-lane texel gather from a 1-D table on the H100: the Hopper
counterpart of tools/perf_probe21.py (its Pallas kernel, :73).

out = sum over i < iters of g(tab, (idx0 + i) & (n - 1)), in loop order,
for a per-lane (16, 128) int32 index and a table of n f32 texels. Forms
(csrc/probes.cu):

  none       the loop baseline, acc += float(idx)
  ldg        tab[idx] through __ldg (the port's texel fetch)
  global     tab[idx] as a plain global load
  shared     tab[idx] from a copy of the table in shared memory
  onehotmm   the one-hot product on the tensor cores (mma.sync TF32): the
             TF32-rounded tab[idx], off the exact gather by at most that
             rounding (printed beside its bound)
  selectacc  the O(n) compare-select loop (n <= 512, as the JAX probe)

The kernels (csrc/probes.cu gather_loop) run the loop in trips of U
iterations, U per form: a trip's fetches are issued before the previous
trip's adds, and every add stays in loop order, so a warp waits on its
adds and its fetches' rate, not on each iteration's whole chain; one warp
on each of 64 SMs (blocks of 32).

    python -m terminal_raytracer_tpu_torch.tools.perf_probe21 \\
        [--sizes 128,256,1024,4096] [--iters 512] [--reps 5] [--device cpu]

Each line: the kernel's ms (CUDA events, least of --reps), µs a gather
over the loop baseline, and [match] / [MISMATCH] against ldg. With
--device cpu the plain versions run and the lines carry values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _probe
from ._probe import SHAPE

ITERS = 512  # the JAX script's default --iters
FORMS = ("none", "ldg", "global", "shared", "onehotmm", "selectacc")
SIZES = (128, 256, 1024, 4096)
SELECT_MAX = 512  # selectacc's largest table, as the JAX probe
MAX_N = 8192  # the shared forms stage the table in 32 KB


def inputs(sizes, device):
    """(n, tab, idx0) per size, drawn as the JAX probe draws them: one
    numpy generator, seed 0, over the sizes in order."""
    rng = np.random.default_rng(0)
    for n in sizes:
        tab = rng.random(n, dtype=np.float32)
        idx = rng.integers(0, n, size=SHAPE).astype(np.int32)
        yield n, torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(
            device)


def _check(form, tab, idx0, iters):
    name = "perf_probe21.gather"
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")
    n = tab.numel()
    if n < 8 or n > MAX_N or n & (n - 1):
        raise ValueError(f"{name}: table size {n} is not a power of two in "
                         f"[8, {MAX_N}]")
    _probe.check(tab, (n,), torch.float32, name)
    _probe.check(idx0, SHAPE, torch.int32, name)
    _probe.check_iters(iters, name)


def plain(form, tab, idx0, iters):
    """The form in plain PyTorch, a loop over iters in the kernel's order."""
    n = tab.numel()
    table = _probe.tf32_round(tab) if form == "onehotmm" else tab
    keys = torch.arange(n, dtype=torch.int32, device=tab.device)
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=tab.device)
    for i in range(iters):
        idx = (idx0 + i) & (n - 1)
        if form == "none":
            g = idx.to(torch.float32)
        elif form == "selectacc":
            # One term is tab[idx], the rest +0: exact in any order.
            g = torch.where(idx[..., None] == keys, table, 0.0).sum(-1)
        else:
            g = table[idx]
        acc = acc + g
    return acc


def gather(form, tab, idx0, iters):
    """Form `form` on the device of `tab`: its kernel on the card (counted
    in gather.launches[form]), its plain version for CPU tensors."""
    _check(form, tab, idx0, iters)
    if not _probe.on_cuda(tab.device, "perf_probe21.gather"):
        return plain(form, tab, idx0, iters)
    _probe.check_aligned(tab, "perf_probe21.gather")
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    _probe.launch(f"trt_probe21_{form}",
                  _probe.GatherArgs(tab.numel(), iters), tab, idx0, out)
    gather.launches[form] += 1
    return out


gather.launches = dict.fromkeys(FORMS, 0)


def run(sizes=SIZES, iters=ITERS, reps=5, device="cuda"):
    """Every form at every size; prints the JAX probe's lines. Returns a
    list of {n, form, out, ms, us} (ms and us None on the CPU)."""
    rows = []
    for n, tab, idx0 in inputs(sizes, torch.device(device)):
        ref = {}

        def tag(form, out):
            if form == "none":
                return "loop baseline"
            if not ref:
                ref["ldg"] = out
                return "ref"
            if form == "onehotmm":
                gap = float((out.double() - ref["ldg"].double()).abs().max())
                bound = _probe.gap_bound(iters, float(tab.abs().max()),
                                         float(ref["ldg"].abs().max()), 10)
                return f"tf32 gap {gap:.2e} <= {bound:.2e}: {gap <= bound}"
            return "match" if torch.equal(out, ref["ldg"]) else "MISMATCH"

        forms = [f for f in FORMS if f != "selectacc" or n <= SELECT_MAX]
        rows += [dict(r, n=n) for r in _probe.loop_table(
            lambda form: gather(form, tab, idx0, iters), forms, iters, reps,
            tag, lambda form: f"N={n:5d} {form:10s}", "gather")]
    return rows


def main(argv=None):
    ap = _probe.parser(__doc__, iters=ITERS)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    args = ap.parse_args(argv)
    device = _probe.device_of(ap, args)
    return run([int(s) for s in args.sizes.split(",")], args.iters,
               args.reps, device)


if __name__ == "__main__":
    main()
