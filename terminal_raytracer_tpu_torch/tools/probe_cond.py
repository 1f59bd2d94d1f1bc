"""Is an untaken branch skipped when it carries a value? The Hopper
counterpart of tools/probe_cond.py (its Pallas kernel, :58; heavy :32-37,
body :40-56).

256 copies of the (16, 128) tile (the TPU probe's grid steps), each: x =
col * 0.01, then K iterations of x = heavy(x) when pred = ((i * 40503 +
seed) mod 1000) < int(frac * 1000), else x + 0.0; heavy is 40 times y =
y * 1.000001 + 0.5; y = y - floor(y * 0.5). Forms (csrc/probes.cu):

  cond       pred as the probe's scalar: the same in every thread, so a
             warp takes one side as a whole (lax.cond's counterpart)
  unguarded  where(pred, 1, 0) * 0 + heavy(x) every iteration
  divergent  each lane's own pred at seed + lane (the flat lane index of
             the tile): a warp runs heavy when any of its lanes does

The kernels take floor(y * 0.5) on the FP32 pipe, as __fmaf_rd(y, 0.5,
1.5 * 2^23) - 1.5 * 2^23: equal to floorf bit for bit wherever y * 0.5 lies
in [-2^22, 2^22) and is not -0.0 (this module's floor arguments lie in
[0.25, 1.2500009] at K = 400); the plain version keeps torch.floor. The
design it replaced (floorf, the predicate's residue by division each
iteration) stays as the entry trt_probe_cond_cond_frnd, which only
chip_smoke.py launches.

    python -m terminal_raytracer_tpu_torch.tools.probe_cond \\
        [--iters 400] [--reps 5] [--device cpu]

Prints the unguarded time, then each form's time at each frac with its
ratio to unguarded (CUDA events, least of --reps), and whether the 256
copies are equal. With --device cpu the plain versions run and the lines
carry values.
"""

from __future__ import annotations

import torch

from . import _probe
from ._probe import SHAPE, TILE

FORMS = ("cond", "unguarded", "divergent")
FRACS = (1.0, 0.25, 0.05)
ITERS = 400  # K, the JAX script's loop count
STEPS = 256  # the TPU probe's grid
HEAVY = 40
SEED = 7


def heavy(y):
    for _ in range(HEAVY):
        y = y * 1.000001 + 0.5
        y = y - torch.floor(y * 0.5)
    return y


def plain(form, seed, frac, iters, device):
    """One tile of the form in plain PyTorch, a loop over iters in the
    kernel's order."""
    thresh = int(frac * 1000)
    lane = torch.arange(TILE, device=device).reshape(SHAPE)
    x = (lane % SHAPE[1]).to(torch.float32) * 0.01
    for i in range(iters):
        if form == "divergent":
            take = (i * 40503 + seed + lane) % 1000 < thresh
            x = torch.where(take, heavy(x), x + 0.0)
        elif form == "unguarded":
            x = 0.0 + heavy(x)  # where(pred, 1, 0) * 0 is +0
        elif (i * 40503 + seed) % 1000 < thresh:
            x = heavy(x)
        else:
            x = x + 0.0
    return x


def branch(form, seed, frac, iters, device):
    """[STEPS, 16, 128]: form `form` on `device`, its kernel on the card
    (counted in branch.launches[form]), its plain version (one tile,
    repeated) on the CPU."""
    name = "probe_cond.branch"
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")
    _probe.check_branch(seed, frac, iters, name)
    if not _probe.on_cuda(device, name):
        return plain(form, seed, frac, iters, device).expand(STEPS, *SHAPE)
    out = torch.empty((STEPS, *SHAPE), dtype=torch.float32, device=device)
    _probe.launch(f"trt_probe_cond_{form}",
                  _probe.BranchArgs(iters, seed, int(frac * 1000), STEPS),
                  out)
    branch.launches[form] += 1
    return out


branch.launches = dict.fromkeys(FORMS, 0)


def run(iters=ITERS, reps=5, device="cuda"):
    """Unguarded, then the cond and divergent forms at every frac; prints
    the JAX probe's lines. Returns a list of {form, frac, out, ms} (ms None
    on the CPU)."""
    device = torch.device(device)
    return _probe.branch_table(
        "cond", lambda form, frac: branch(form, SEED, frac, iters, device),
        FORMS, FRACS, reps, ratio="skip-ratio")


def main(argv=None):
    ap = _probe.parser(__doc__, iters=ITERS)
    args = ap.parse_args(argv)
    return run(args.iters, args.reps, _probe.device_of(ap, args))


if __name__ == "__main__":
    main()
