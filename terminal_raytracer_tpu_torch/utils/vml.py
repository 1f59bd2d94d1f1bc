"""The first call of PyTorch-CPU's vector math in a process.

On the CPU, torch.sqrt, exp, log, log2, tan, tanh, atan and erf of float32
are calls into MKL's vector math (VML), which ATen splits into one chunk
an intra-op thread. A process's first VML call, made from two threads at
once, now and then computes one chunk with a low-accuracy kernel (up to
3.1e-4 relative off); every later call is right. A CPU render on several
intra-op threads would meet that in its first frame.

:func:`warm_vml` makes the first call of each of those functions on one
intra-op thread, once a process, and restores the thread count. Every CPU
tracer (ops/tracer.py PathTracer, and so Engine, the CLI with --device
cpu, render_frame and the render step) calls it before it renders.
"""

from __future__ import annotations

import torch

FNS = ("sqrt", "exp", "log", "log2", "tan", "tanh", "atan", "erf")
LANES = 8192  # one chunk of 4096 a thread on two threads

_warm = False


def warm_vml() -> bool:
    """Call each VML function on one intra-op thread, the first time a
    process asks; the thread count is restored. Returns whether this call
    made the warm-up."""
    global _warm
    if _warm:
        return False
    x = torch.linspace(0.05, 0.95, LANES)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for fn in FNS:
            getattr(torch, fn)(x)
    finally:
        torch.set_num_threads(n)
    _warm = True
    return True
