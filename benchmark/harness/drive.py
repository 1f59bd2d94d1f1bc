"""Driving the program: a scripted terminal for its viewer loop, the
headless loop, and the records a run keeps of both.

The viewer runs as users run it, through `Engine.run_interactive`; only its
terminal is replaced (the engine module's `TerminalSession`) by a session
that delivers the mix's key presses at their due times and discards each
frame's bytes. The harness wraps the engine's entry points on the instance
(`render_one`, `_fetch`, the blitter's `encode`) to time them and to keep,
for a sample of frames drawn from the seed, what the comparison needs.
"""

from __future__ import annotations

import random
import select
import time
from typing import Optional

import numpy as np

TRACE_LABELS = ("poll", "enqueue", "fetch_wait", "encode", "write")


class Capture:
    """What the comparison needs of one frame: the running mean before it,
    the state after it, its owed rays and its image."""

    def __init__(self, idx: int, pre_acc):
        self.idx, self.pre_acc = idx, pre_acc
        self.acc = self.variance = self.samples = self.rays = None
        self.rgb = None  # the step's image (device u8 [H, W, 3])
        self.image = None  # the image handed to the user (host u8)
        self.payload = None  # the frame's bytes as the terminal got them


class Sampler:
    """Reservoirs of frames to compare, one per stratum, drawn from a
    seed: each stratum keeps a uniform sample of `slots` of its frames."""

    def __init__(self, seed: int, slots: dict):
        self.rng = random.Random(seed)
        self.slots = dict(slots)
        self.seen = {s: 0 for s in slots}
        self.kept = {s: [] for s in slots}

    def slot(self, stratum: str) -> Optional[int]:
        """The slot a new frame of `stratum` takes, or None."""
        if stratum not in self.slots:
            return None
        self.seen[stratum] += 1
        n, k = self.seen[stratum], self.slots[stratum]
        if n <= k:
            return n - 1
        j = self.rng.randrange(n)
        return j if j < k else None

    def keep(self, stratum: str, slot: int, cap: Capture) -> None:
        kept = self.kept[stratum]
        if slot == len(kept):
            kept.append(cap)
        else:
            kept[slot] = cap

    def captures(self) -> list:
        return sorted((c for caps in self.kept.values() for c in caps),
                      key=lambda c: c.idx)

    def by_idx(self, idx) -> Optional[Capture]:
        for caps in self.kept.values():
            for c in caps:
                if c.idx == idx:
                    return c
        return None


class Recorder:
    """The run's records, fed by the wrappers around one Engine."""

    def __init__(self, engine, engine_mod, sampler: Sampler, spans: bool):
        self.engine, self.mod, self.sampler = engine, engine_mod, sampler
        # Frames that reached the terminal, a sample drawn like `sampler`'s:
        # (the image encoded, its bytes).
        self.shown = Sampler(sampler.rng.randrange(2**32), {"shown": 2})
        self.spans = {k: [] for k in TRACE_LABELS} if spans else None
        self.frames = []  # of every dispatch since the engine began: the
        # number of key presses delivered before it
        self.keys = []  # keys in delivery order
        self.presses = []  # (due time, dispatches before delivery), window
        self.displays = []  # (time, dispatch index shown), window
        self.move_latencies = []  # seconds from each press to its answer
        self.rays = []  # owed rays (device scalars) of the window's frames
        self.trace_rays = []  # ... of the frames of the traced sub-window
        self.in_window = self.in_trace = False
        self.stratum = None  # f(frame index, frame number) -> stratum
        self.showing = None
        self._last_out = (None, None)
        self._orig = {}

    # -- spans -----------------------------------------------------------

    def span(self, label: str, t0: float, t1: float) -> None:
        if self.spans is not None and self.in_window:
            self.spans[label].append((t0, t1))

    # -- wrappers ----------------------------------------------------------

    def install(self) -> None:
        eng = self.engine
        self._orig = {"render_one": eng.render_one, "_fetch": eng._fetch,
                      "encode": eng.blitter.encode, "Fetch": self.mod._Fetch}
        eng.render_one = self._render_one
        eng._fetch = self._fetch
        eng.blitter.encode = self._encode
        self.mod._Fetch = self._make_fetch

    def uninstall(self) -> None:
        eng = self.engine
        for name in ("render_one", "_fetch"):
            eng.__dict__.pop(name, None)
        eng.blitter.__dict__.pop("encode", None)
        self.mod._Fetch = self._orig["Fetch"]

    def _render_one(self, frame_number, image=True):
        idx = len(self.frames)
        stratum = self.stratum(idx, frame_number) if self.stratum else None
        slot = self.sampler.slot(stratum) if stratum else None
        cap = None
        if slot is not None:
            cap = Capture(idx, self.engine.state.acc.clone())
        t0 = time.perf_counter()
        out = self._orig["render_one"](frame_number, image)
        t1 = time.perf_counter()
        self.frames.append(len(self.keys))
        self._last_out = (id(out), idx)
        if self.in_window:
            self.rays.append(out.rays)
            self.span("enqueue", t0, t1)
        if self.in_trace:
            self.trace_rays.append(out.rays)
        if cap is not None:
            st = out.state
            cap.acc, cap.variance, cap.samples = (st.acc.clone(), st.variance,
                                                  st.samples)
            cap.rays, cap.rgb = out.rays, out.rgb
            self.sampler.keep(stratum, slot, cap)
        return out

    def _make_fetch(self, out, *args, **kwargs):
        fetch = self._orig["Fetch"](out, *args, **kwargs)
        last_id, idx = self._last_out
        fetch.bench_idx = idx if id(out) == last_id else None
        return fetch

    def _fetch(self, pending):
        self.showing = getattr(pending, "bench_idx", None)
        t0 = time.perf_counter()
        got = self._orig["_fetch"](pending)
        self.span("fetch_wait", t0, time.perf_counter())
        return got

    def _encode(self, rgb, glyphs):
        t0 = time.perf_counter()
        payload = self._orig["encode"](rgb, glyphs)
        self.span("encode", t0, time.perf_counter())
        slot = self.shown.slot("shown") if self.in_window else None
        if slot is not None:
            self.shown.keep("shown", slot, (np.array(rgb), payload))
        return payload

    # -- the terminal's side ---------------------------------------------

    def delivered(self, key: str, due: Optional[float]) -> None:
        if due is not None and self.in_window:
            self.presses.append((due, len(self.frames)))
        self.keys.append(key)

    def displayed(self, payload: bytes) -> None:
        t = time.perf_counter()
        if self.in_window:
            self.displays.append((t, self.showing))
        cap = self.sampler.by_idx(self.showing)
        if cap is not None:
            cap.payload = payload
        self.span("write", t, time.perf_counter())

    def keys_before(self) -> list:
        """The keys delivered between one dispatch and the next, for every
        dispatch."""
        out, prev = [], 0
        for n in self.frames:
            out.append(self.keys[prev:n])
            prev = n
        return out


class ScriptedSession:
    """The viewer's terminal: delivers `presses` (due times relative to
    `t_open`) like a raw-mode tty read with a timeout, answers 'esc' once
    `t_close` has passed, and discards frames into the recorder. `hooks`
    are called with the time at each poll (the traced sub-window's start
    and stop)."""

    def __init__(self, rec: Recorder, presses, t_open: float, t_close: float,
                 hooks=()):
        self.rec, self.presses = rec, list(presses)
        self.t_open, self.t_close = t_open, t_close
        self.hooks = hooks
        self.i = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll_key(self, timeout: float = 0.001):
        for hook in self.hooks:
            hook(time.perf_counter())
        t0 = time.perf_counter()
        key, due = None, None
        if t0 >= self.t_close:
            key = "esc"
        elif self.i < len(self.presses):
            due = self.t_open + self.presses[self.i].due
            wait = min(timeout, due - t0)
            if wait > 0:
                select.select([], [], [], wait)
            if time.perf_counter() >= due:
                key = self.presses[self.i].key
                self.i += 1
            else:
                due = None
        else:
            select.select([], [], [], min(timeout, self.t_close - t0))
        if key is not None and key != "esc":
            self.rec.delivered(key, due)
        self.rec.span("poll", t0, time.perf_counter())
        return key

    def write_frame(self, payload: bytes, status: str, height: int):
        self.rec.displayed(payload)
