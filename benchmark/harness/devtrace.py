"""The device's timeline over a traced sub-window, from torch.profiler's
CUDA activity (CUPTI), on the host's clock.

Two marker kernels (`torch.cuda._sleep`, named spin_kernel in the trace)
go to a side stream at the sub-window's start and stop, where nothing
queues ahead of them, so each starts within microseconds of its launch:
their device start less the host time of their launch is the offset that
puts device activity on the host's perf_counter clock."""

from __future__ import annotations

import time
from typing import NamedTuple

MARKER = "spin_kernel"


class Timeline(NamedTuple):
    events: list  # (name, start, end) on the host clock, seconds
    t0: float  # the traced sub-window on the host clock
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class DeviceTrace:
    """Start and stop a CUDA-activity profile around a stretch of a run."""

    def __init__(self):
        import torch

        self.torch = torch
        self.side = torch.cuda.Stream()
        self.prof = None
        self.marks = []  # host launch times of the markers
        self.t0 = self.t1 = None

    def warm(self) -> None:
        """Start and stop once, outside the window (CUPTI's first start is
        slow), and forget it."""
        self.start()
        self.stop()
        self.prof, self.marks, self.t0, self.t1 = None, [], None, None

    def _mark(self) -> None:
        torch = self.torch
        with torch.cuda.stream(self.side):
            self.marks.append(time.perf_counter())
            torch.cuda._sleep(100)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark()
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def timeline(self, log=None) -> Timeline:
        """Every device activity of the sub-window but the markers, on the
        host clock. Where the profile lost a marker, the first device
        activity is taken to start at the sub-window's start (`log` says
        so)."""
        torch = self.torch
        events, marks = [], []
        for ev in self.prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if MARKER in ev.name:
                marks.append(a)
            else:
                events.append((ev.name, a, b))
        marks.sort()
        if len(marks) == len(self.marks):
            offset = min(m - h for m, h in zip(marks, self.marks))
        elif events:
            offset = min(a for _, a, _ in events) - self.t0
            if log is not None:
                log(f"devtrace: {len(marks)} of {len(self.marks)} markers "
                    "in the profile; aligned on the first activity")
        else:
            offset = 0.0
        events = [(n, a - offset, b - offset) for n, a, b in events]
        return Timeline(events, self.t0, self.t1)
