"""The frame-loop engine — ``terminal_raytracer_tpu/runtime/engine.py``:
the pipelined interactive loop and the headless runner.

The interactive loop dispatches frame N+1 before it fetches frame N, so
host encode and terminal IO overlap device compute. Right after each
dispatch the frame's outputs are queued for copy into pinned host memory
behind a CUDA event; fetching frame N waits for that event only, not for
frame N+1. WASD/arrows move the camera and reset accumulation
(frame_number = 0); rendering stops at frames_to_accumulate; ESC exits.

The headless runner drives the step once per frame. (The JAX package folds
8 frames into one dispatch; a CUDA graph is the counterpart, still to come.)

With `animate`, an animator (models/animate.py) maps the scene's packed
arrays to the values of the animation clock's current frame; the clock
advances once per render, and every frame renders fresh (frame_number 0,
no accumulation), as in the JAX package.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from ..models import Camera, scene as scene_mod
from ..models.animate import ANIMATORS
from ..ops.dynamic import pack_scene
from .blit import Blitter
from .state import init_state, make_render_step
from .terminal import TerminalSession
from .timing import FrameTimers

IDLE_SLEEP = 0.010  # accumulation finished


class _Fetch:
    """A dispatched frame's outputs on their way to the host."""

    def __init__(self, out, full_color: bool):
        items = [out.rgb, out.rays, out.occupancy, out.state.samples.mean()]
        if not full_color:
            items.append(out.glyphs)
        self.event = None
        if out.rgb.device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in items]
            for h, t in zip(host, items):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            items = host
        self.items = items

    def wait(self):
        """(rgb u8 [H,W,3], glyphs u8 [H,W] or None, rays, mean samples,
        occupancy) as numpy / Python values."""
        if self.event is not None:
            self.event.synchronize()
        rgb, rays, occ, mean_samples = self.items[:4]
        glyphs = self.items[4].numpy() if len(self.items) > 4 else None
        return (rgb.numpy(), glyphs, float(rays), float(mean_samples),
                float(occ))


class Engine:
    def __init__(
        self,
        scene: scene_mod.Scene,
        full_color: bool = False,
        device="cuda",
        threads: int = 0,
        verbose: bool = False,
        deterministic: Optional[int] = None,
        accel: str = "auto",
        animate: Optional[str] = None,
        transport: str = "reference",
    ):
        """`deterministic`: seed of the per-frame seed draws (None draws
        from OS entropy, like the reference). `accel`: the traversal
        (ops/tracer.py). `animate`: an animator name of
        models/animate.ANIMATORS, or None for a static scene. `transport`:
        'reference', 'unbiased' or 'mis' (ops/tracer.py)."""
        self.scene = scene
        self.full_color = full_color
        self.device = torch.device(device)
        self.camera = Camera()
        self.animate = animate
        if animate is not None:
            if animate not in ANIMATORS:
                raise ValueError(f"unknown animator {animate!r}; have "
                                 f"{sorted(ANIMATORS)}")
            self._animator = ANIMATORS[animate]
            self._arrays0 = pack_scene(scene)
            self._anim_t = 0
        self.step = make_render_step(scene, full_color=full_color,
                                     device=self.device, accel=accel,
                                     dynamic=animate is not None,
                                     transport=transport)
        self.state = init_state(scene, self.device)
        self.blitter = Blitter(scene.height, scene.width, full_color, threads)
        self.timers = FrameTimers()
        self.frame_count = 0
        self._rng = np.random.RandomState(deterministic)
        self._fetched_at = None
        self._last_occ = -1.0
        if verbose:
            name = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
            print(
                f"device: {self.device} {name} | blitter="
                f"{'native' if self.blitter.native else 'python'} "
                f"({self.blitter.threads} threads) | "
                f"{scene.width}x{scene.height} spp={scene.samples_per_pixel} "
                f"depth={scene.max_depth} | "
                f"{scene.primitive_count} primitives, {len(scene.lights)} lights",
                file=sys.stderr,
            )

    # ------------------------------------------------------------------

    def _seed(self) -> int:
        # rand::random::<u32>() + frame_count, wrapping (the JAX recipe).
        return int(
            (self._rng.randint(0, 2**32, dtype=np.uint64) + self.frame_count)
            & 0xFFFFFFFF
        )

    def render_one(self, frame_number: int):
        """Dispatch one step and advance the state; returns the step's
        FrameOutput. An animated engine renders the animation clock's next
        frame fresh and leaves frame_count (and so the seed offset) at 0."""
        if self.animate is not None:
            arrays = self._animator(self._arrays0, self._anim_t)
            self._anim_t += 1
            out = self.step(self.state, self.camera.pose(), self._seed(), 0,
                            arrays)
            self.state = out.state
            return out
        out = self.step(self.state, self.camera.pose(), self._seed(),
                        frame_number)
        self.state = out.state
        self.frame_count += 1
        return out

    def _fetch(self, pending: _Fetch):
        rgb, glyphs, rays, mean_samples, occ = pending.wait()
        self._fetched_at = time.perf_counter()
        self._last_occ = occ
        return rgb, glyphs, rays, mean_samples

    # ------------------------------------------------------------------

    def run_interactive(self):
        scene = self.scene
        cam_moved = self.frame_count == 0
        pending = None  # dispatched-but-not-displayed frame
        with TerminalSession() as term:
            while True:
                self.timers.start_frame()
                key = term.poll_key(0.001)
                if key == "esc":
                    break
                moved = self.camera.apply_key(key) if key else False
                if moved:
                    cam_moved = True
                    self.frame_count = 0
                    pending = None  # stale frame: don't display pre-move pixels

                if self.frame_count < scene.frames_to_accumulate:
                    out = self.render_one(0 if cam_moved else self.frame_count)
                    cam_moved = False
                    fetch = _Fetch(out, self.full_color)
                    if pending is not None:
                        # Waiting for frame N overlaps frame N+1's compute.
                        with self.timers.phase("gpu"):
                            fetched = self._fetch(pending)
                        self._display(term, fetched)
                    pending = fetch
                else:
                    if pending is not None:
                        self._display(term, self._fetch(pending))
                        pending = None
                    time.sleep(IDLE_SLEEP)
        print("Exiting.")

    def _display(self, term, fetched):
        rgb, glyphs, rays, mean_samples = fetched
        with self.timers.phase("cpu"):
            payload = self.blitter.encode(rgb, glyphs)
        mray = self.timers.update_ray_rate(rays, fetched_at=self._fetched_at) / 1e6
        status = self.timers.status_line(
            self.frame_count, self.scene.frames_to_accumulate, mray_s=mray,
            samples=mean_samples, occupancy=self._last_occ,
        )
        with self.timers.phase("io"):
            term.write_frame(payload, status, self.scene.height)

    # ------------------------------------------------------------------

    def run_headless(self, n_frames: int):
        """Render n accumulated frames without a terminal; returns the last
        frame's (rgb, glyphs, rays, mean_samples). Frame numbering
        continues from self.frame_count."""
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        out = None
        for _ in range(n_frames):
            out = self.render_one(self.frame_count)
        return self._fetch(_Fetch(out, self.full_color))
