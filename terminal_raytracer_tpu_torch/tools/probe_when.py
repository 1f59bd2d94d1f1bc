"""Is an untaken branch skipped on the H100? The Hopper counterpart of
tools/probe_when.py (its Pallas kernel, :54; body :30-52).

64 copies of the (16, 128) tile (the TPU probe's grid steps), each: acc =
x, then K iterations, where iteration i runs the heavy body (48 times y =
y * 1.0000001 + 0.3; y = y - floor(y * 0.25)) on acc when pred = ((i *
40503 + seed) mod 1000) < int(frac * 1000). Forms (csrc/probes.cu):

  guarded    pred as the probe's scalar: the same in every thread, so a
             warp skips the body as a whole (pl.when's counterpart)
  unguarded  the body every iteration
  divergent  each lane's own pred at seed + lane (the flat lane index of
             the tile): a warp runs the body when any of its lanes does

The kernels take floor(y * 0.25) on the FP32 pipe, as __fmaf_rd(y, 0.25,
1.5 * 2^23) - 1.5 * 2^23: equal to floorf bit for bit wherever y * 0.25 lies
in [-2^22, 2^22) and is not -0.0 (this module's floor arguments lie in
[0.0751, 1.0750001] at K = 256); the plain version keeps torch.floor. The
design it replaced (floorf, the predicate's residue by division each
iteration) stays as the entry trt_probe_when_guarded_frnd, which only
chip_smoke.py launches.

    python -m terminal_raytracer_tpu_torch.tools.probe_when \\
        [--iters 256] [--reps 5] [--device cpu]

Prints the unguarded time, then each form's time at each frac with its
ratio to unguarded (CUDA events, least of --reps), and whether the 64
copies are equal. With --device cpu the plain versions run and the lines
carry values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _probe
from ._probe import SHAPE, TILE

FORMS = ("guarded", "unguarded", "divergent")
FRACS = (1.0, 0.5, 0.1, 0.02)
ITERS = 256  # K, the JAX script's loop count
STEPS = 64  # the TPU probe's grid
HEAVY = 48
SEED = 7


def inputs(device):
    """x as the JAX probe draws it (numpy RandomState(0))."""
    x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(device)


def heavy(y):
    for _ in range(HEAVY):
        y = y * 1.0000001 + 0.3
        y = y - torch.floor(y * 0.25)
    return y


def plain(form, x, seed, frac, iters):
    """One tile of the form in plain PyTorch, a loop over iters in the
    kernel's order."""
    thresh = int(frac * 1000)
    lane = torch.arange(TILE, device=x.device).reshape(SHAPE)
    acc = x
    for i in range(iters):
        if form == "divergent":
            take = (i * 40503 + seed + lane) % 1000 < thresh
            acc = torch.where(take, heavy(acc), acc)
        elif form == "unguarded" or (i * 40503 + seed) % 1000 < thresh:
            acc = heavy(acc)
    return acc


def branch(form, x, seed, frac, iters):
    """[STEPS, 16, 128]: form `form` on the device of `x`, its kernel on
    the card (counted in branch.launches[form]), its plain version (one
    tile, repeated) for a CPU tensor."""
    name = "probe_when.branch"
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")
    _probe.check(x, SHAPE, torch.float32, name)
    _probe.check_branch(seed, frac, iters, name)
    if not _probe.on_cuda(x.device, name):
        return plain(form, x, seed, frac, iters).expand(STEPS, *SHAPE)
    out = torch.empty((STEPS, *SHAPE), dtype=torch.float32, device=x.device)
    _probe.launch(f"trt_probe_when_{form}",
                  _probe.BranchArgs(iters, seed, int(frac * 1000), STEPS),
                  x, out)
    branch.launches[form] += 1
    return out


branch.launches = dict.fromkeys(FORMS, 0)


def run(iters=ITERS, reps=5, device="cuda"):
    """Unguarded, then the guarded and divergent forms at every frac;
    prints the JAX probe's lines. Returns a list of {form, frac, out, ms}
    (ms None on the CPU)."""
    x = inputs(torch.device(device))
    return _probe.branch_table(
        "when", lambda form, frac: branch(form, x, SEED, frac, iters),
        FORMS, FRACS, reps)


def main(argv=None):
    ap = _probe.parser(__doc__, iters=ITERS)
    args = ap.parse_args(argv)
    return run(args.iters, args.reps, _probe.device_of(ap, args))


if __name__ == "__main__":
    main()
