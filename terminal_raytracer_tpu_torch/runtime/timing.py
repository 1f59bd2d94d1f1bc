"""Per-frame phase timers and rolling FPS — a copy of
``terminal_raytracer_tpu/runtime/timing.py`` (whose package imports jax),
with the device-wait phase named 'gpu'."""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

FPS_WINDOW = 30  # 30-frame rolling average (lib.rs:364)
MRAY_EMA_ALPHA = 0.2  # smoothing of the per-frame ray-throughput rate


class FrameTimers:
    def __init__(self):
        self._phases: Dict[str, float] = {}
        self._t0 = None
        self._frame_start = None
        self._frame_times = deque(maxlen=FPS_WINDOW)
        self._last_frame = None
        self._ray_rate_ema = None
        self._last_fetch_t = None

    def start_frame(self):
        self._frame_start = time.perf_counter()
        now = self._frame_start
        if self._last_frame is not None:
            self._frame_times.append(now - self._last_frame)
        self._last_frame = now
        self._phases = {}

    def phase(self, name: str):
        """Context manager timing one phase of the frame."""
        timers = self

        class _P:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timers._phases[name] = timers._phases.get(name, 0.0) + (
                    time.perf_counter() - self.t0
                )
                return False

        return _P()

    @property
    def fps(self) -> float:
        """Rolling FPS over the window, robust to one-off stalls (first-use
        compiles of the heat-map view etc.): median frame time."""
        if not self._frame_times:
            return 0.0
        times = sorted(self._frame_times)
        return 1.0 / max(times[len(times) // 2], 1e-9)

    def update_ray_rate(self, rays: float, fetched_at: float = None) -> float:
        """Fold one frame's ray count into an exponential moving average of
        throughput (rays/s) and return it. Adaptive scenes draw different
        budgets per frame, so the instantaneous quotient jitters; the EMA
        tracks a shifting rate faster than a median over the FPS window
        while still damping single-frame spikes.

        `fetched_at`: perf_counter timestamp taken right after this frame's
        device fetch completed. The rate pairs the fetched frame's ray
        count with the interval between consecutive fetch completions —
        under the pipelined engine the device computes exactly one frame
        per such interval, so count and duration belong to the SAME frame
        (the raw _frame_times entries are offset by one there)."""
        now = time.perf_counter() if fetched_at is None else fetched_at
        if self._last_fetch_t is not None:
            rate = rays / max(now - self._last_fetch_t, 1e-9)
            if self._ray_rate_ema is None:
                self._ray_rate_ema = rate
            else:
                self._ray_rate_ema += MRAY_EMA_ALPHA * (
                    rate - self._ray_rate_ema
                )
        self._last_fetch_t = now
        return self._ray_rate_ema or 0.0

    @property
    def median_frame_time(self) -> float:
        if not self._frame_times:
            return 0.0
        times = sorted(self._frame_times)
        return times[len(times) // 2]

    def status_line(self, frame_count: int, frames_to_accumulate: int,
                    mray_s: float = 0.0, samples: float = 0.0,
                    occupancy: float = -1.0) -> str:
        """Same fields as lib.rs:551-558 ('GPU' is the device wait),
        plus Mray/s, the adaptive sampler's mean samples/pixel, and — when
        the sorted pipeline surfaces it — the measured lane
        occupancy (owed sweeps / executed lane-iteration sweeps)."""
        total_ms = (time.perf_counter() - self._frame_start) * 1e3
        p = {k: v * 1e3 for k, v in self._phases.items()}
        other = total_ms - sum(p.values())
        occ = f" | occ: {occupancy * 100.0:.0f}%" if occupancy >= 0.0 else ""
        return (
            f"Frame: {frame_count}/{frames_to_accumulate} | FPS: {self.fps:.1f} | "
            f"GPU: {p.get('gpu', 0):.0f}ms | CPU: {p.get('cpu', 0):.0f}ms | "
            f"IO: {p.get('io', 0):.0f}ms | Other: {other:.0f}ms | "
            f"Total: {total_ms:.0f}ms | {mray_s:.0f} Mray/s | "
            f"spp: {samples:.1f}{occ}"
        )
