"""The gather probes' and probe21c's trip and block widths on the H100:
builds csrc/probes.cu once for each (TRT_GATHER_U, TRT_GATHER_BLOCK) pair
(every form at that trip width), all at once, and times the forms of
perf_probe21, perf_probe21b and perf_probe21c through every build in turns
(the builds in order, then in reverse), beside the shipped build's entries
(each form at its own trip width) and its *_serial entries (the loop the
shipped one replaced). Every output is held against its plain version on
the card, bit for bit (probe21c atan2f: the shipped entry within rtol 1e-6
of torch.atan2, every other entry bit for bit against the shipped one).

    python -m terminal_raytracer_tpu_torch.tools.gather_tune \\
        [--unroll 4,8,16] [--block 16,32,128] [--iters 0,512,8192] [--reps 5]

The row forms (perf_probe21 none and ldg at n = 1024, perf_probe21b none
and rowsel_ldg, perf_probe21c packed and atan2f: the forms with a *_serial
entry) run at each loop count of --iters, every other form at 512
(perf_probe21 at n = 1024, selectacc at 256; perf_probe21c on its (8, 128)
packed table). Each line: the form, its
loop count and n, then the ms of each build (least of --reps in each of
the two turns); a row form's last lines give the loop's clocks an
iteration, (t - t at 0 iterations) / iterations at --mhz. Needs a CUDA
GPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import build
from . import _probe
from . import perf_probe21 as p21
from . import perf_probe21b as p21b
from . import perf_probe21c as p21c

ROW = {"probe21": ("none", "ldg"), "probe21b": ("none", "rowsel_ldg"),
       "probe21c": ("packed", "atan2f")}
MODS = {"probe21": p21, "probe21b": p21b, "probe21c": p21c}
N21 = 1024
N_SELECT = 256  # selectacc's largest size of perf_probe21.SIZES


def variants(unrolls, blocks) -> dict:
    """{label: load_kernels sources} of each (trip, block) width."""
    return {f"U{u}/B{b}": (("probes.cu", (f"TRT_GATHER_U={u}",
                                          f"TRT_GATHER_BLOCK={b}")),)
            for u in unrolls for b in blocks}


def cases(device) -> list:
    """(probe, form, n, tab, idx0) of every form timed, the row forms
    first; perf_probe21's inputs drawn as its main() draws them, probe21c's
    idx0 its x0 and n its table's size."""
    ins = {n: (tab, idx) for n, tab, idx in p21.inputs(
        p21.SIZES[:p21.SIZES.index(N21) + 1], device)}
    tab_b, idx_b = p21b.inputs(device)
    tab_c, x0_c = p21c.inputs(device)
    args = {"probe21b": (_probe.TILE, tab_b, idx_b),
            "probe21c": (tab_c.numel(), tab_c, x0_c)}

    def case(probe, f):
        if probe != "probe21":
            return (probe, f, *args[probe])
        n = N21 if f != "selectacc" else N_SELECT
        return (probe, f, n, *ins[n])

    rows = [case(probe, f) for probe, forms in ROW.items() for f in forms]
    rest = [case(probe, f) for probe, mod in MODS.items()
            for f in mod.FORMS if f not in ROW[probe]]
    return rows + rest


def run_case(probe, form, n, tab, idx0, iters, libs, reps) -> dict:
    """{label: [ms in the first turn, ms in the second]} of one form: the
    shipped entry, the serial entry (a row form's) and every build's, each
    output bit for bit against the plain version on the card (probe21c
    atan2f: the shipped entry within rtol 1e-6 of it, the others bit for
    bit against the shipped entry)."""
    want = MODS[probe].plain(form, tab, idx0, iters)
    calls = {"shipped": (f"trt_{probe}_{form}", _probe.PROBES)}
    if form in ROW[probe]:
        calls["serial"] = (f"trt_{probe}_{form}_serial", _probe.PROBES)
    calls.update({label: (f"trt_{probe}_{form}", srcs)
                  for label, srcs in libs.items()})
    out = torch.empty_like(want)
    args = _probe.GatherArgs(n, iters)

    def call(entry, srcs):
        return lambda: _probe.launch(entry, args, tab, idx0, out,
                                     sources=srcs)

    for label, (entry, srcs) in calls.items():
        out.fill_(float("nan"))
        call(entry, srcs)()
        torch.cuda.synchronize()
        if form == "atan2f" and label == "shipped":
            torch.testing.assert_close(out, want, rtol=1e-6, atol=0)
            want = out.clone()
        if not torch.equal(out, want):
            err = float((out.double() - want.double()).abs().max())
            raise RuntimeError(f"{entry} ({label}) at {iters} iterations, "
                               f"n = {n}: off its plain version by {err:.3e}")
    order = list(calls)
    times = {label: [] for label in order}
    for turn in (order, order[::-1]):
        for label in turn:
            times[label].append(_probe.time_ms(call(*calls[label]), reps))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unroll", default="4,8,16")
    ap.add_argument("--block", default="16,32,128")
    ap.add_argument("--iters", default="0,512,8192")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mhz", type=float, default=1980.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA GPU (torch.cuda.is_available() is False)")
    libs = variants([int(u) for u in args.unroll.split(",")],
                    [int(b) for b in args.block.split(",")])
    build.library_paths(_probe.PROBES + tuple(
        src for srcs in libs.values() for src in srcs))
    loop_counts = [int(i) for i in args.iters.split(",")]
    print(f"[gather_tune] {torch.cuda.get_device_name(0)}; builds "
          f"{', '.join(libs)}; ms least of {args.reps}, two turns",
          flush=True)
    for probe, form, n, tab, idx0 in cases(torch.device("cuda")):
        counts = loop_counts if form in ROW[probe] else [p21.ITERS]
        best = {}
        for iters in counts:
            times = run_case(probe, form, n, tab, idx0, iters, libs,
                             args.reps)
            best[iters] = {k: min(v) for k, v in times.items()}
            print(f"[gather_tune] {probe} {form} n={n} iters={iters}: "
                  + " | ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                               for k, v in times.items()), flush=True)
        if 0 in best:
            for iters in (i for i in counts if i):
                print(f"[gather_tune] {probe} {form} clocks an iteration "
                      f"at {iters}: " + " | ".join(
                          f"{k} {clocks(t, best[0][k], iters, args.mhz):.2f}"
                          for k, t in best[iters].items()), flush=True)
    return 0


def clocks(ms: float, ms0: float, iters: int, mhz: float) -> float:
    """The loop's clocks an iteration: (ms - ms at 0 iterations) / iters
    at `mhz`."""
    return (ms - ms0) * 1e3 * mhz / iters


if __name__ == "__main__":
    sys.exit(main())
