"""The texture channel's building blocks on the H100: the Hopper
counterpart of tools/perf_probe21c.py (its Pallas kernel, :65).

Per iteration x = x0 + 0.001 i (f32) on a (16, 128) f32 tile, then, added
to the tile's sum in loop order (csrc/probes.cu):

  none        x (the loop baseline)
  f2i         the texel index of uv on a 32x32 texture: u = x - floor(x),
              v = 1.7x - floor(1.7x), floor(32v) * 32 + floor(32u)
  atan2f      atan2(x, 1 - x) with CUDA's atan2f (jnp.arctan2's
              counterpart)
  atan2_poly  atan2(x, 1 - x) with the port's polynomial (trace.cuh
              atan2_poly, ops/sampling.py atan2), what the kernels run
  packed      the texel at that index from an (8, 128) int32 table of
              packed rgb through __ldg, unpacked as trace.cuh unpack_texel:
              r/255 + g/255 + b/255

    python -m terminal_raytracer_tpu_torch.tools.perf_probe21c \\
        [--iters 512] [--reps 5] [--device cpu]

Each line: the kernel's ms (CUDA events, least of --reps), µs an
iteration over the loop baseline, and whether the sum is finite; atan2_poly
also its largest distance from atan2f. With --device cpu the plain
versions run and the lines carry values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _probe
from ..ops import sampling
from ._probe import SHAPE

ITERS = 512  # the JAX script's default --iters
FORMS = ("none", "f2i", "atan2f", "atan2_poly", "packed")
TAB_SHAPE = (8, 128)  # one 32x32 texture of packed rgb
INV_255 = 1.0 / 255.0  # the JAX probe's s, rounded to f32 where it is used


def inputs(device):
    """(tab, x0) as the JAX probe draws them (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 24, size=TAB_SHAPE).astype(np.int32)
    x0 = rng.random(SHAPE, dtype=np.float32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(x0).to(device)


def _check(form, tab, x0, iters):
    name = "perf_probe21c.block"
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")
    _probe.check(tab, TAB_SHAPE, torch.int32, name)
    _probe.check(x0, SHAPE, torch.float32, name)
    _probe.check_iters(iters, name)


def plain(form, tab, x0, iters):
    """The form in plain PyTorch, a loop over iters in the kernel's order.
    x0 must be non-negative (as the probe's draws are), so u, v < 1."""
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=x0.device)
    flat = tab.reshape(-1)
    for i in range(iters):
        x = x0 + float(np.float32(0.001) * np.float32(i))
        if form == "none":
            acc = acc + x
        elif form == "atan2f":
            acc = acc + torch.atan2(x, 1.0 - x)
        elif form == "atan2_poly":
            acc = acc + sampling.atan2(x, 1.0 - x)
        else:
            x17 = x * 1.7
            u, v = x - torch.floor(x), x17 - torch.floor(x17)
            idx = (torch.floor(v * 32.0).to(torch.int32) * 32
                   + torch.floor(u * 32.0).to(torch.int32))
            if form == "f2i":
                acc = acc + idx.to(torch.float32)
                continue
            g = flat[idx]  # below 2^24: >> is the probe's logical shift
            acc = acc + (g >> 16).to(torch.float32) * INV_255
            acc = acc + ((g >> 8) & 255).to(torch.float32) * INV_255
            acc = acc + (g & 255).to(torch.float32) * INV_255
    return acc


def block(form, tab, x0, iters):
    """Form `form` on the device of `x0`: its kernel on the card (counted
    in block.launches[form]), its plain version for CPU tensors."""
    _check(form, tab, x0, iters)
    if not _probe.on_cuda(x0.device, "perf_probe21c.block"):
        return plain(form, tab, x0, iters)
    out = torch.empty(SHAPE, dtype=torch.float32, device=x0.device)
    _probe.launch(f"trt_probe21c_{form}", _probe.GatherArgs(tab.numel(),
                                                            iters),
                  tab, x0, out)
    block.launches[form] += 1
    return out


block.launches = dict.fromkeys(FORMS, 0)


def run(iters=ITERS, reps=5, device="cuda"):
    """Every form; prints the JAX probe's lines. Returns a list of {form,
    out, ms, us} (ms and us None on the CPU)."""
    tab, x0 = inputs(torch.device(device))
    outs = {}

    def tag(form, out):
        outs[form] = out
        t = f"finite={bool(torch.isfinite(out).all())}"
        if form == "atan2_poly":
            gap = float((out.double() - outs["atan2f"].double()).abs().max())
            t += f", max |poly - atan2f| {gap:.3e}"
        return ("baseline, " if form == "none" else "") + t

    return _probe.loop_table(lambda form: block(form, tab, x0, iters),
                             FORMS, iters, reps, tag,
                             lambda form: f"{form:10s}", "iter")


def main(argv=None):
    ap = _probe.parser(__doc__, iters=ITERS)
    args = ap.parse_args(argv)
    return run(args.iters, args.reps, _probe.device_of(ap, args))


if __name__ == "__main__":
    main()
