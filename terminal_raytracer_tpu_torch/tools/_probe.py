"""What the probes share: the launch structs and the launch of a probe
kernel (csrc/probes.cu, built by ops/build.py), CUDA-event timing, the loop
baseline, TF32 rounding and the command line."""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..ops.build import load_kernels

SHAPE = (16, 128)  # the TPU probes' tile
TILE = SHAPE[0] * SHAPE[1]
PROBES = ("probes.cu",)  # the probes' library, as load_kernels takes it
# A spin queued ahead of each timed call (~0.25 ms at 1.98 GHz): the card is
# busy while the host enqueues the call, so the events time the kernel and
# not the host's launch path.
SPIN_CYCLES = 500_000


class GatherArgs(ctypes.Structure):
    """ProbeGather of csrc/probes.cu."""

    _fields_ = [("n", ctypes.c_int), ("iters", ctypes.c_int)]


class BranchArgs(ctypes.Structure):
    """ProbeBranch of csrc/probes.cu."""

    _fields_ = [("iters", ctypes.c_int), ("seed", ctypes.c_int),
                ("thresh", ctypes.c_int), ("copies", ctypes.c_int)]


def on_cuda(device, name: str) -> bool:
    """False for the CPU (the plain version runs), True for CUDA."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device.type == "cuda"


def check(t: torch.Tensor, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")


def check_iters(iters: int, name: str) -> None:
    if not 0 <= iters <= 1 << 20:
        raise ValueError(f"{name}: iters={iters} outside [0, 2^20]")


def check_branch(seed: int, frac: float, iters: int, name: str) -> None:
    """The branch probes' int32 arithmetic (i * 40503 + seed + lane) must
    not overflow."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"{name}: frac={frac} outside [0, 1]")
    if not 0 <= iters <= 1 << 14 or not -(1 << 30) < seed < 1 << 30:
        raise ValueError(f"{name}: iters={iters} outside [0, 2^14] or "
                         f"seed={seed} outside (-2^30, 2^30)")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """A table the kernels stage with one bulk copy: 16-byte aligned."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start 16-byte aligned")


def launch(entry: str, args, *tensors: torch.Tensor,
           sources: tuple = PROBES) -> None:
    """Launch the probe kernel `entry` of the library of `sources` (a
    load_kernels argument: probes.cu, or it with nvcc defines) on the
    current stream of the tensors' device; raise on a launch error."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{entry}: the tensors lie on different devices")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(load_kernels(sources), entry)(
        ctypes.byref(args), *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def time_ms(fn, reps: int) -> float:
    """One call of `fn` on the card in ms: a warm-up call, then the least of
    `reps` calls, each between two CUDA events behind a queued spin."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def per_op_us(ms: float, base_ms: float, iters: int) -> float:
    """µs an iteration over the loop baseline, as the JAX probes print."""
    return (ms - base_ms) / iters * 1e3


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
    zero, 10 mantissa bits), the 13 bits below cleared; finite inputs."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gap_bound(iters: int, g_max: float, acc_max: float, bits: int) -> float:
    """The most a sum of `iters` terms, each rounded to `bits` mantissa
    bits (10 for TF32, 21 for 3xTF32), can move from the exact terms' sum:
    half an ulp of each term, and an f32 rounding of each of the two
    running sums."""
    return iters * (2.0 ** -(bits + 1) * g_max + 2.0 ** -23 * acc_max)


def parser(doc: str, iters: int, reps: int = 5) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels, timed; cpu: the plain PyTorch "
                         "versions, their values")
    return ap


def device_of(ap: argparse.ArgumentParser, args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA GPU (torch.cuda.is_available() "
                 "is False); --device cpu runs the plain versions")
    return torch.device(args.device)


def loop_table(fn, forms, iters: int, reps: int, tag, head, unit: str
               ) -> list:
    """The gather probes' table: fn(form) runs a form, forms[0] being the
    loop baseline. Each line: head(form), the time (or on the CPU a
    value), µs a `unit` over the baseline, and tag(form, out). Returns a
    list of {form, out, ms, us} (ms and us None off the card)."""
    rows, base_ms = [], None
    for form in forms:
        out = fn(form)
        ms = time_ms(lambda: fn(form), reps) if out.is_cuda else None
        us = None
        if ms is None:
            value = checksum(out)
        elif form == forms[0]:
            base_ms, value = ms, f"{ms:8.3f} ms"
        else:
            us = per_op_us(ms, base_ms, iters)
            value = f"{ms:8.3f} ms  {us:7.3f} us/{unit} "
        print(f"{head(form)} {value} [{tag(form, out)}]", flush=True)
        rows.append(dict(form=form, out=out, ms=ms, us=us))
    return rows


def branch_cases(forms, fracs) -> list:
    """The (form, frac) a branch probe's table runs, in order: unguarded
    (always heavy), then forms[0] and 'divergent' at each frac."""
    return [("unguarded", 1.0)] + [
        (f, fr) for f in (forms[0], "divergent") for fr in fracs]


def branch_table(tag: str, fn, forms, fracs, reps: int,
                 ratio: str = "ratio") -> list:
    """The branch probes' table: fn(form, frac) runs each of
    branch_cases(forms, fracs), with its time over unguarded's and whether
    its copies of the tile are equal. Returns a list of {form, frac, out,
    ms} (ms None off the card)."""
    rows = []
    full = None
    for form, frac in branch_cases(forms, fracs):
        out = fn(form, frac)
        same = "copies equal" if torch.equal(
            out, out[:1].expand_as(out)) else "COPIES DIFFER"
        ms = time_ms(lambda: fn(form, frac), reps) if out.is_cuda else None
        rows.append(dict(form=form, frac=frac, out=out, ms=ms))
        what = (f"{form} always-heavy" if form == "unguarded" else
                f"{form} frac_true={frac}")
        if ms is None:
            print(f"[{tag}] {what}: {checksum(out[0])} [{same}]", flush=True)
        elif form == "unguarded":
            full = ms
            print(f"[{tag}] {what}: {ms:.3f} ms [{same}]", flush=True)
        else:
            print(f"[{tag}] {what}: {ms:.3f} ms ({ratio} {ms / full:.2f}) "
                  f"[{same}]", flush=True)
    return rows


def checksum(t: torch.Tensor) -> str:
    """A printable value of a probe's output (the --device cpu runs)."""
    return f"sum {float(t.double().sum()):.6f}"
