"""PyTorch-CPU's vector math and the first call of a process.

On the CPU, torch.sqrt, exp, log, log2, tan, tanh, atan and erf of float32
are calls into MKL's vector math (VML), which ATen splits into chunks over
its intra-op threads. The first VML call of a process, made by two threads
at once, now and then computes one chunk with a low-accuracy kernel, up to
3.1e-4 relative off; every later call is right. A port test that holds its
lane math to JAX at rtol 1e-5 and happens to make its worker's first VML
call then fails for no fault of either package (test_torch_materials.py's
sampler test did).

warm_vml() makes the first call of each of those functions on one
intra-op thread, where no two calls can meet. Every port test file that
runs the port's math on the CPU calls it just after setting its thread
count.

Run as a script, the file reproduces the fault:

    python tests/test_torch_vml.py [--procs 96] [--jobs 8]

It starts --procs fresh processes without the warm-up and as many with
it; each takes the eight functions of 8192 lanes on two threads, in a
given order, against float64 numpy, and the script counts the processes
with a value more than 4e-7 relative off (a few ulps) and prints each such
process's first bad function.
"""

import argparse
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

FNS = ("sqrt", "exp", "log", "log2", "tan", "tanh", "atan", "erf")
LANES = 8192  # one chunk of 4096 a thread on two threads
RTOL = 4e-7


def warm_vml():
    """Call each VML function on one thread, so that the process's first
    call is made there; the thread count is restored."""
    import torch

    x = torch.linspace(0.05, 0.95, LANES)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for fn in FNS:
            getattr(torch, fn)(x)
    finally:
        torch.set_num_threads(n)


def _reference(fn, x):
    if fn == "erf":
        return np.vectorize(math.erf)(x)
    return getattr(np, {"atan": "arctan"}.get(fn, fn))(x)


def _child(warm: bool, seed: int, order) -> str:
    """One fresh process's check: 'OK', or 'BAD fn lanes maxrel' for the
    first function that came out off."""
    import torch

    torch.set_num_threads(2)
    if warm:
        warm_vml()
    rs = np.random.RandomState(seed)
    x = rs.rand(LANES).astype(np.float32) * 0.9 + 0.05
    for fn in order:
        got = getattr(torch, fn)(torch.from_numpy(x)).numpy()
        want = _reference(fn, x.astype(np.float64))
        rel = np.abs(got - want) / np.abs(want)
        if rel.max() > RTOL:
            return f"BAD {fn} {(rel > RTOL).sum()} {rel.max():.3g}"
    return "OK"


def _spawn(warm: bool, seed: int, order=FNS) -> str:
    cmd = [sys.executable, __file__, "--child", "warm" if warm else "none",
           "--seed", str(seed), "--order", ",".join(order)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd} failed:\n{out.stderr}")
    return out.stdout.strip().splitlines()[-1]


def _spawn_many(warm: bool, procs: int, jobs: int, order=FNS) -> list:
    with ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(lambda s: _spawn(warm, s, order), range(procs)))


def test_warm_vml_restores_the_thread_count():
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    warm_vml()
    assert torch.get_num_threads() == n


@pytest.mark.parametrize("order", [FNS, FNS[::-1]],
                         ids=["sqrt_first", "erf_first"])
def test_fresh_processes_after_warm_up_are_exact(order):
    """Fresh processes whose first VML call is the warm-up: every lane of
    every function on two threads within a few ulps of float64."""
    pytest.importorskip("torch")
    assert _spawn_many(True, 4, 4, order) == ["OK"] * 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=96)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--order", default=",".join(FNS),
                    help="the functions, in the order a process calls them")
    ap.add_argument("--child", choices=("none", "warm"), help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    order = tuple(args.order.split(","))
    if args.child:
        print(_child(args.child == "warm", args.seed, order))
        return
    for warm in (False, True):
        res = _spawn_many(warm, args.procs, args.jobs, order)
        bad = [r for r in res if r != "OK"]
        print(f"{'with' if warm else 'without'} the warm-up: {len(bad)} of "
              f"{args.procs} fresh processes off", flush=True)
        for r in bad:
            print(f"  {r}", flush=True)


if __name__ == "__main__":
    main()
