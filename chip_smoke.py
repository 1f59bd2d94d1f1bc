#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (terminal_raytracer_tpu_torch) on
one NVIDIA GPU. Run from the repository root:  python3 chip_smoke.py

Phases, each reported on lines starting with its tag:

  [device]  torch must see a CUDA GPU; nvidia-smi's name and power limit
  [build]   both CUDA kernels built from csrc/ with nvcc (seconds, ptxas)
  [kernel_base]   kernel A against its plain PyTorch version on the card:
            Cornell_Box 128x16, 16 spp, seed 42, frame 0, depth 8 and 3.
            Owed rays, adaptive budgets and end RNG states must be equal;
            csum, csumsq and variance within max relative error 5e-3
            (|k - p| / max(|p|, 1e-3), the kernel-vs-oracle gate of the
            JAX package's bench.py)
  [kernel_extra]  kernel B against its plain version on the budget-sorted
            stream built from the depth-8 output: rays equal, esum within
            5e-3; then both kernels timed against their plain versions at
            the north-star shapes
  [main]    the main path through Engine at Cornell_Box 400x200: 16 spp
            depth 32 (north star), 128 spp depth 3 (shipped), and 80x40
            1 spp depth 4 in ASCII (the base >= spp path), plus one
            cli.main run. Launch counters must show every kernel of the
            path launched once per frame; the accumulation must be finite
            and the image not flat; the north-star frame must agree with
            the plain version (rays, samples, radiance within 5e-3).
            Prints ms/frame and Mray/s (owed traversal sweeps per second)
            for the kernel path and for the plain version on the card.

Then one JSON line with each kernel's result, the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. A failed phase raises or exits
non-zero and prints no result; nothing falls back to the plain version or
to the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

TOL = 5e-3
SEED = 42


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def maxrel(k, p) -> float:
    k, p = k.double(), p.double()
    return float(((k - p).abs() / p.abs().clamp(min=1e-3)).max())


def maxabs(k, p) -> float:
    return float((k.double() - p.double()).abs().max())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("[device] torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"[device] nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | {smi_line}", flush=True)
    return smi_line


def phase_build():
    from terminal_raytracer_tpu_torch.ops import build

    t0 = time.perf_counter()
    so = build.library_path()
    build.load_kernels()
    dt = time.perf_counter() - t0
    print(f"[build] {so.name} in {dt:.1f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)


def _cornell(w, h, spp, depth):
    from terminal_raytracer_tpu.models import load_scene

    return load_scene("Cornell_Box").with_overrides(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth)


def phase_kernel_base():
    """Returns (max abs error, the depth-8 tracer and kernel output)."""
    import torch

    from terminal_raytracer_tpu.models import Camera
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = Camera().pose()
    worst_abs, keep = 0.0, None
    for depth in (8, 3):
        tr = PathTracer(_cornell(128, 16, 16, depth), "cuda")
        k = kernels.base_kernel(tr, pose, SEED, 0)
        p = kernels.base_kernel_plain(tr, pose, SEED, 0)
        torch.cuda.synchronize()
        eq = {name: bool(torch.equal(getattr(k, name), getattr(p, name)))
              for name in ("rays", "additional", "state")}
        pairs = list(zip(k.csum, p.csum)) + list(zip(k.csumsq, p.csumsq))
        pairs.append((k.var, p.var))
        rel = max(maxrel(a, b) for a, b in pairs)
        worst_abs = max(worst_abs, max(maxabs(a, b) for a, b in pairs))
        n_needy = int((p.additional > 0).sum())
        print(f"[kernel_base] depth {depth}: rays {float(k.rays.sum()):.0f}, "
              f"equal {eq}, maxrel {rel:.3e}, budgeted pixels {n_needy}",
              flush=True)
        if not all(eq.values()) or not rel < TOL:
            fail(f"[kernel_base] depth {depth} disagrees with the plain "
                 "version")
        if depth == 8:
            keep = (tr, k)
    return worst_abs, keep


def _time_cuda(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_extra(tr, a):
    """Kernel B vs plain on the stream of kernel A's output `a`; then
    both kernels timed against their plain versions at the north star."""
    import torch

    from terminal_raytracer_tpu.models import Camera
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    pose = Camera().pose()
    s = kernels.sorted_stream(tr, a.state, a.additional)
    ek, rk, _ = kernels.extra_kernel(tr, pose, s.xs, s.ys, s.state, s.add,
                                     s.samp0)
    ep, rp, _ = kernels.extra_kernel_plain(tr, pose, s.xs, s.ys, s.state,
                                           s.add, s.samp0)
    torch.cuda.synchronize()
    rays_eq = bool(torch.equal(rk, rp))
    rel = max(maxrel(x, y) for x, y in zip(ek, ep))
    err = max(maxabs(x, y) for x, y in zip(ek, ep))
    n_work = int((s.add > 0).sum())
    print(f"[kernel_extra] stream {tuple(s.xs.shape)}, {n_work} budgeted "
          f"entries, rays {float(rk.sum()):.0f} equal {rays_eq}, maxrel "
          f"{rel:.3e}", flush=True)
    if n_work == 0:
        fail("[kernel_extra] the test stream has no budgeted entry")
    if not rays_eq or not rel < TOL:
        fail("[kernel_extra] disagrees with the plain version")

    # Timings at the north-star shapes (outside the counted main path).
    ns = PathTracer(_cornell(400, 200, 16, 32), "cuda")
    ms_a = _time_cuda(lambda: kernels.base_kernel(ns, pose, SEED, 0), 5)
    plain_a = _time_cuda(lambda: kernels.base_kernel_plain(ns, pose, SEED, 0),
                         1)
    a_ns = kernels.base_kernel(ns, pose, SEED, 0)
    s_ns = kernels.sorted_stream(ns, a_ns.state, a_ns.additional)
    args = (ns, pose, s_ns.xs, s_ns.ys, s_ns.state, s_ns.add, s_ns.samp0)
    ms_b = _time_cuda(lambda: kernels.extra_kernel(*args), 5)
    plain_b = _time_cuda(lambda: kernels.extra_kernel_plain(*args), 1)
    print(f"[kernel_extra] north-star shapes: kernel_base {ms_a:.3f} ms "
          f"(plain {plain_a:.1f} ms), kernel_extra {ms_b:.3f} ms on "
          f"{int((s_ns.add > 0).sum())} budgeted of {s_ns.add.numel()} "
          f"entries (plain {plain_b:.1f} ms)", flush=True)
    return err, (ms_a, plain_a, ms_b, plain_b)


def _run_engine(label, scene, full_color, frames):
    """Drive `frames` frames (after one warm-up) through Engine with the
    launch counters reset first. Returns (launches A, launches B)."""
    import torch

    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    eng = Engine(scene, full_color=full_color, device="cuda",
                 deterministic=SEED)
    kernels.base_kernel.launches = 0
    kernels.extra_kernel.launches = 0
    out = eng.render_one(eng.frame_count)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = []
    for _ in range(frames):
        out = eng.render_one(eng.frame_count)
        rays.append(out.rays)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    la, lb = kernels.base_kernel.launches, kernels.extra_kernel.launches
    base = max(4, scene.samples_per_pixel // 4)
    want_b = frames + 1 if base < scene.samples_per_pixel else 0
    total_rays = sum(float(r) for r in rays)
    rgb = out.rgb
    finite = bool(torch.isfinite(eng.state.acc).all())
    flat = bool(rgb.max() == rgb.min())
    print(f"[main] {label}: {scene.width}x{scene.height} spp "
          f"{scene.samples_per_pixel} depth {scene.max_depth}, {frames} "
          f"frames: {1e3 * dt / frames:.2f} ms/frame, "
          f"{total_rays / dt / 1e6:.1f} Mray/s, occupancy "
          f"{float(out.occupancy):.3f}, launches A {la} B {lb}, finite "
          f"{finite}, rgb range [{int(rgb.min())}, {int(rgb.max())}]",
          flush=True)
    if la != frames + 1 or lb != want_b:
        fail(f"[main] {label}: launch counts A {la} B {lb}, expected "
             f"{frames + 1} and {want_b}")
    if not finite or flat:
        fail(f"[main] {label}: accumulation not finite or image flat")
    return la, lb


def phase_main():
    import torch

    from terminal_raytracer_tpu.models import Camera
    from terminal_raytracer_tpu_torch import cli
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    ns_scene = _cornell(400, 200, 16, 32)
    la, lb = _run_engine("north star", ns_scene, True, 8)
    a2, b2 = _run_engine("shipped", _cornell(400, 200, 128, 3), True, 4)
    a3, b3 = _run_engine("ascii 80x40", _cornell(80, 40, 1, 4), False, 4)
    la, lb = la + a2 + a3, lb + b2 + b3

    kernels.base_kernel.launches = 0
    kernels.extra_kernel.launches = 0
    rc = cli.main(["--device", "cuda", "--full-color", "--scene",
                   "Cornell_Box", "--width", "128", "--height", "32",
                   "--spp", "16", "--depth", "8", "--frames", "2"])
    ca, cb = kernels.base_kernel.launches, kernels.extra_kernel.launches
    print(f"[main] cli.main rc {rc}, launches A {ca} B {cb}", flush=True)
    if rc != 0 or ca != 2 or cb != 2:
        fail("[main] cli.main run failed")
    la, lb = la + ca, lb + cb

    # The north-star frame against the plain version on the card, and the
    # plain version's speed.
    pose = Camera().pose()
    ns = PathTracer(ns_scene, "cuda")
    render = kernels.make_sorted_render_frame(ns)
    cur_k, _, tot_k, rays_k, _ = render(pose, 7, 0)
    times, plain = [], None
    for f in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ns.render_frame(pose, 7, f)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if f == 0:
            plain = out
    cur_p, _, tot_p, rays_p, _ = plain
    rel = max(maxrel(a, b) for a, b in zip(cur_k, cur_p))
    same = float(rays_k) == float(rays_p) and bool(torch.equal(tot_k, tot_p))
    dt = sum(times) / len(times)
    print(f"[main] north star, plain PyTorch on the card: {1e3 * dt:.1f} "
          f"ms/frame, {float(rays_p) / dt / 1e6:.2f} Mray/s; kernel path vs "
          f"plain: rays {float(rays_k):.0f} vs {float(rays_p):.0f}, samples "
          f"equal {bool(torch.equal(tot_k, tot_p))}, maxrel {rel:.3e}",
          flush=True)
    if not same or not rel < TOL:
        fail("[main] north-star frame disagrees with the plain version")
    return la, lb


def main() -> int:
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("torch is not installed")
    smi_line = phase_device()
    try:
        import terminal_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    import torch

    phase_build()
    err_a, (tr, a) = phase_kernel_base()
    err_b, (ms_a, plain_a, ms_b, plain_b) = phase_kernel_extra(tr, a)
    la, lb = phase_main()
    src = "terminal_raytracer_tpu_torch/csrc/"
    ref = "terminal_raytracer_tpu/ops/pallas_kernel.py:"
    print(json.dumps({"kernels": [
        {"name": "kernel_base", "route": "cuda", "source": src + "kernel_base.cu",
         "replaces": ref + "796", "launches": la, "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_a},
        {"name": "kernel_extra", "route": "cuda",
         "source": src + "kernel_extra.cu", "replaces": ref + "1028",
         "launches": lb, "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b},
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
