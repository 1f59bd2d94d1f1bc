"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the comparison, and the result line's object."""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import check as check_mod
from . import drive, spec as spec_mod, stats, traffic
from .devtrace import DeviceTrace
from .peaks import ops_per_sweep, peak

# The traced sub-window of a --trace 1 run: it opens this far into the
# window and lasts at most TRACE_S seconds, then closes at the next frame.
TRACE_OFFSET = 0.25
TRACE_MAX_S = 2.0
BANNED = ("jax", "jaxlib", "flax", "terminal_raytracer_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def _libraries() -> set:
    """The program's built libraries (its kernels and its blitter)."""
    return set((spec_mod.ROOT / "terminal_raytracer_tpu_torch" / "_build")
               .glob("*.so"))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return got.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Run:
    """The pieces of one run, found by name."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device="cuda", spec=None):
        self.spec = spec or spec_mod.load_spec()
        self.wl = spec_mod.workload(self.spec, workload)
        self.cfg = spec_mod.load_config(self.spec, self.wl["config"])
        self.mix = spec_mod.load_mix(self.wl["traffic"])
        traffic.check_mix(self.mix)
        self.limits = spec_mod.load_limits(self.wl["config"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.name = workload

    def engine(self):
        from terminal_raytracer_tpu_torch.models import scene_from_dict
        from terminal_raytracer_tpu_torch.runtime import engine as engine_mod

        eng = engine_mod.Engine(scene_from_dict(self.cfg), device=self.device,
                                deterministic=self.seed & 0xFFFFFFFF,
                                **self.mix.get("engine", {}))
        return eng, engine_mod


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _view(run: Run, eng, mod, rec: drive.Recorder, tracer):
    """The viewer loop: a warm-up session, then the measured one."""
    mix = run.mix
    warm = traffic.warmup_script(mix)
    t = time.perf_counter()
    session = drive.ScriptedSession(rec, warm, t,
                                    t + float(mix.get("warmup_s", 1.0)))
    _viewer(eng, mod, session)
    if tracer is not None:  # CUPTI's first start is slow: not in the window
        tracer.warm()
    presses = traffic.key_script(mix, run.seed, run.seconds)
    rec.stratum = lambda idx, fn: "start" if fn == 0 else "later"
    _sync(run.device)
    t_open = time.perf_counter()
    hooks = () if tracer is None else (_trace_hook(rec, tracer, t_open),)
    session = drive.ScriptedSession(rec, presses, t_open,
                                    t_open + run.seconds, hooks)
    rec.in_window = True
    _viewer(eng, mod, session)
    rec.in_window = False
    _close_trace(rec, tracer)
    t_close = session.t_close
    rec.stratum = None
    shown = [d for d in rec.displays if t_open <= d[0] <= t_close]
    lat = stats.move_latencies(rec.presses, rec.displays)
    rec.move_latencies = lat
    e2e = {"frame_ms": (t_close - t_open) * 1e3 / max(len(shown), 1)}
    counts = {"attempted": len(rec.rays), "presses": len(rec.presses),
              "answered": len(lat), "shown": len(shown)}
    return t_open, t_close, e2e, counts


def _viewer(eng, mod, session) -> None:
    saved = mod.TerminalSession
    mod.TerminalSession = lambda *a, **k: session
    try:
        eng.run_interactive()
    finally:
        mod.TerminalSession = saved


def _trace_hook(rec, tracer, t_open: float):
    """A poll hook that opens the traced sub-window TRACE_OFFSET seconds
    into the window and closes it TRACE_MAX_S later."""

    def hook(now):
        if tracer.t0 is None:
            if now >= t_open + TRACE_OFFSET:
                tracer.start()
                rec.in_trace = True
        elif tracer.t1 is None and now >= tracer.t0 + TRACE_MAX_S:
            rec.in_trace = False
            tracer.stop()

    return hook


def _close_trace(rec, tracer) -> None:
    """Close a traced sub-window that the window's end cut short."""
    if tracer is not None and tracer.t0 is not None and tracer.t1 is None:
        rec.in_trace = False
        tracer.stop()


def _headless(run: Run, eng, mod, rec: drive.Recorder, tracer):
    """Images of `frames_per_image` accumulated frames, back to back; the
    warm-up makes one."""
    n = int(run.mix["frames_per_image"])
    rec.stratum = lambda idx, fn: "first" if idx == 0 else None
    eng.run_headless(n)
    if tracer is not None:
        tracer.warm()
    rec.sampler.slots.pop("first", None)
    first = len(rec.frames)
    rec.stratum = (lambda idx, fn:
                   "last" if (idx - first) % n == n - 1 else None)
    _sync(run.device)
    t_open = time.perf_counter()
    t_end = t_open + run.seconds
    rec.in_window = True
    images = 0
    while time.perf_counter() < t_end:
        if (tracer is not None and tracer.t0 is None
                and time.perf_counter() >= t_open + TRACE_OFFSET):
            tracer.start()
            rec.in_trace = True
        k = len(rec.frames)
        rgb, *_ = eng.run_headless(n)
        images += 1
        cap = rec.sampler.by_idx(k + n - 1)
        if cap is not None:
            cap.image = rgb
        if (tracer is not None and rec.in_trace
                and time.perf_counter() >= tracer.t0 + TRACE_MAX_S):
            rec.in_trace = False
            tracer.stop()
    t_close = time.perf_counter()
    rec.in_window = False
    _close_trace(rec, tracer)
    rays = float(torch.stack(rec.rays).sum()) if rec.rays else 0.0
    e2e = {"Mray_s": stats.window_rate(rays, t_open, t_close) / 1e6}
    counts = {"attempted": len(rec.rays), "images": images}
    return t_open, t_close, e2e, counts


DRIVERS = {"view": _view, "headless": _headless}
# Frames each run compares, by stratum: the reference takes 5-7 s a frame
# on an H100 at these sizes, and the comparison has to end well inside the
# window.
SLOTS = {"view": {"start": 1, "later": 2},
         "headless": {"first": 1, "last": 1}}


def kernel_name(name: str) -> str:
    """A device activity's name without its parameter list, return type
    and anonymous namespaces: the kernel and its template arguments."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n.removeprefix("void ").strip()


def _breakdown(tl, spans) -> dict:
    by_name = {}
    for name, a, b in tl.events:
        if tl.t0 <= a < tl.t1:
            short = kernel_name(name)
            by_name[short] = by_name.get(short, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = stats.idle_intervals([(a, b) for _, a, b in tl.events], tl.t0,
                                tl.t1)
    inside = {k: [(a, b) for a, b in v if b > tl.t0 and a < tl.t1]
              for k, v in (spans or {}).items()}
    idle = sorted(stats.attribute(gaps, inside).items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(run: Run, t_process: float, log=print, patch=None) -> dict:
    """Run one cell once; returns the result line's object (see run.py).
    `patch(engine)`, where given, changes the engine before the run (the
    tests plant faults with it)."""
    dev = run.device
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    libraries = _libraries()
    eng, mod = run.engine()
    if patch is not None:
        patch(eng)
    driver = run.mix["driver"]
    sampler = drive.Sampler(run.seed ^ 0x5EED, SLOTS[driver])
    rec = drive.Recorder(eng, mod, sampler, spans=run.trace)
    rec.install()
    tracer = DeviceTrace() if (run.trace and on_cuda) else None
    try:
        t_open, t_close, e2e, counts = DRIVERS[driver](run, eng, mod, rec,
                                                       tracer)
    finally:
        rec.uninstall()
    _sync(dev)
    setup_s = t_open - t_process
    device = {"platform": "gpu" if on_cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                    if on_cuda else 0),
              # This run built libraries: its setup_s holds the build.
              "built": _libraries() != libraries}
    out = {"device": device}
    if on_cuda:
        device["power"] = power_limit()
    # Per-layer metrics, from the spans and the traced sub-window.
    ctx = None
    if run.trace:
        tl = tracer.timeline(log) if tracer is not None else None
        traced_rays = (float(torch.stack(rec.trace_rays).sum())
                       if rec.trace_rays else 0.0)
        pk = peak(device["kind"]) if on_cuda else None
        ctx = SimpleNamespace(
            spans=rec.spans, timeline=tl, traced_rays=traced_rays,
            move_latencies=rec.move_latencies,
            ops_per_sweep=ops_per_sweep(run.cfg),
            peak_fp32=pk["fp32_flops"] if pk else None)
        if tl is not None:
            device["busy_s"] = stats.busy_seconds(
                [(a, b) for _, a, b in tl.events], tl.t0, tl.t1)
            device["window_s"] = tl.window_s
            out["breakdown"] = _breakdown(tl, rec.spans)
    metrics = {}
    if run.trace:
        for m in spec_mod.metrics_for(run.spec, run.name, "per_layer"):
            value = spec_mod.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in spec_mod.metrics_for(run.spec, run.name, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    # The comparison, once the program's state is freed.
    captures = sampler.captures()
    shown = rec.shown.kept["shown"] if driver == "view" else []
    inputs = _inputs(run, rec)
    del eng, rec
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    require = list(check_mod.NUMBERS[:5])
    if driver == "view":
        require.append("rows_px")
    t0 = time.perf_counter()
    correct, table, failed = check_mod.check(captures, inputs, run.cfg, dev,
                                             run.limits, require, shown)
    log(f"compared {len(captures)} frames in "
        f"{time.perf_counter() - t0:.1f} s; window {t_close - t_open:.3f} s, "
        f"{counts}")
    out.update({"correct": bool(correct), "attempted": counts["attempted"],
                "failed": int(failed), "metrics": metrics,
                "checks": {k: {"value": v, "limit": lim}
                           for k, (v, lim) in table.items()}})
    return out


def _inputs(run: Run, rec: drive.Recorder) -> list:
    from reference import viewer

    return viewer.frame_inputs(run.seed, rec.keys_before())
