"""The frame-loop engine — ``terminal_raytracer_tpu/runtime/engine.py``:
the pipelined interactive loop and the headless runner.

The interactive loop dispatches frame N+1 before it fetches frame N, so
host encode and terminal IO overlap device compute. Right after each
dispatch the frame's outputs are queued for copy into pinned host memory
behind a CUDA event; fetching frame N waits for that event only, not for
frame N+1. WASD/arrows move the camera and reset accumulation
(frame_number = 0); rendering stops at frames_to_accumulate; ESC exits;
'v' toggles the variance heat map, 'p' writes a screenshot PNG of the
accumulation into the working directory. `pipeline=False` fetches and
shows each frame before the next is dispatched, as the reference does.

The headless runner accumulates frame after frame through the step's
`accumulate` half and makes one image, from the last frame, with its
`finalize` half: bit-identical to per-frame driving. With `until_noise` it
stops once the accumulation's estimated noise drops below a threshold,
reading that one scalar every `chunk` frames.

With `animate`, an animator (models/animate.py) maps the scene's packed
arrays to the values of the animation clock's current frame; the clock
advances once per render, and every frame renders fresh (frame_number 0,
no accumulation), as in the JAX package.

With `shard`, every rank of the caller's process group runs an Engine on
its row block of a ('px', 'sp') mesh (parallel/mesh.py). Rank 0 owns the
camera, the seeds and the terminal: each frame's control (pose, seed,
frame number, the variance view, and render, idle, screenshot or stop) is
broadcast from it, and it gathers the row blocks of sample share 0 to
display the frame or to write the screenshot.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from ..models import Camera, scene as scene_mod
from ..models.animate import ANIMATORS
from ..ops import tonemap as tm
from ..ops.dynamic import pack_scene
from .blit import Blitter
from .state import FrameOutput, finalize, init_state, make_render_step
from .terminal import TerminalSession
from .timing import FrameTimers

IDLE_SLEEP = 0.010  # accumulation finished
RENDER, IDLE, STOP, SHOT = 0, 1, 2, 3  # the sharded engine's commands


def _parse_shard(spec: str):
    """--shard spec -> (n_px, n_sp). Accepted forms: "N" (N-way pixel-row
    data parallelism), "px:N", "sp:N", "px:N,sp:M" (axes in either order,
    each at most once); px * sp must be at least 2."""
    seen = {}
    try:
        parts = [p.strip() for p in str(spec).split(",")]
        for part in parts:
            if ":" in part:
                axis, _, n = part.partition(":")
                if axis not in ("px", "sp"):
                    raise ValueError(axis)
                if axis in seen:
                    raise ValueError(f"duplicate {axis}")
                seen[axis] = int(n)
            else:
                # A bare N stands alone (mixed with axis forms it would
                # silently override one).
                if len(parts) > 1:
                    raise ValueError("bare N must stand alone")
                seen["px"] = int(part)
    except (ValueError, TypeError):
        raise ValueError(
            f"bad --shard spec {spec!r}; expected N, px:N, sp:N, or "
            f"px:N,sp:M (each axis at most once)") from None
    n_px, n_sp = seen.get("px", 1), seen.get("sp", 1)
    if n_px < 1 or n_sp < 1 or n_px * n_sp < 2:
        raise ValueError(
            f"--shard {spec!r} must name at least 2 devices (px * sp >= 2)")
    return n_px, n_sp


class _Fetch:
    """A dispatched frame's outputs on their way to the host: its image, or
    with `heatmap` the variance heat map (shown in full colour)."""

    def __init__(self, out, full_color: bool, heatmap: bool = False):
        self.heatmap = heatmap
        rgb = tm.variance_heatmap(out.state.variance) if heatmap else out.rgb
        items = [rgb, out.rays, out.occupancy, out.state.samples.mean()]
        if not (full_color or heatmap):
            items.append(out.glyphs)
        self.event = None
        if rgb.device.type == "cuda":
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
        shard=None,
        denoise: float = 0.0,
        denoise_passes: int = 3,
        pipeline: bool = True,
        tonemap="reference",
        exposure: float = 0.0,
    ):
        """`deterministic`: seed of the per-frame seed draws (None draws
        from OS entropy, like the reference). `accel`: the traversal
        (ops/tracer.py). `animate`: an animator name of
        models/animate.ANIMATORS, or None for a static scene. `transport`:
        'reference', 'unbiased' or 'mis' (ops/tracer.py). `shard`: a
        --shard spec (_parse_shard), or (n_px, n_sp) (which may be (1, 1)),
        to render on a mesh over the caller's process group (module
        docstring); it refuses the 'unbiased' transport and an explicit
        `accel`. `denoise` > 0: the à-trous filter (ops/denoise.py) over
        the displayed accumulation, `denoise_passes` rounds. `pipeline`:
        False shows each frame before dispatching the next. `tonemap` (an
        ops/tonemap.parse_mode spec) and `exposure` (stops): the display
        transform."""
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
        self.mesh = None
        if shard is not None:
            n_px, n_sp = (shard if isinstance(shard, tuple)
                          else _parse_shard(shard))
            if transport == "unbiased":
                raise ValueError("--shard does not support --unbiased")
            if accel != "auto":
                raise ValueError("--shard picks the traversal itself; "
                                 "drop --accel")
            from ..parallel import make_mesh, make_sharded_render_step

            self.mesh = make_mesh(n_px, n_sp, self.device)
            self.device = self.mesh.device
            self.step, sharded_init = make_sharded_render_step(
                scene, self.mesh, full_color=full_color, transport=transport,
                dynamic=animate is not None, denoise=denoise,
                denoise_passes=denoise_passes, tonemap=tonemap,
                exposure=exposure)
            self.state = sharded_init()
        else:
            self.step = make_render_step(scene, full_color=full_color,
                                         device=self.device, accel=accel,
                                         dynamic=animate is not None,
                                         transport=transport,
                                         denoise=denoise,
                                         denoise_passes=denoise_passes,
                                         tonemap=tonemap, exposure=exposure)
            self.state = init_state(scene, self.device)
        # Kept for the screenshot ('p'), which shows the accumulation as
        # the step does, in full colour.
        self.denoise, self.denoise_passes = float(denoise), int(denoise_passes)
        self.mode, self.scale = tm.parse_mode(tonemap), 2.0 ** float(exposure)
        self.pipeline = pipeline
        self.blitter = Blitter(scene.height, scene.width, full_color, threads)
        # The variance heat map is drawn as truecolor blocks.
        self._fc_blitter = (self.blitter if full_color else
                            Blitter(scene.height, scene.width, True, threads))
        self.variance_view = False
        self._shot_idx = 0
        self.timers = FrameTimers()
        self.frame_count = 0
        self._rng = np.random.RandomState(deterministic)
        self._fetched_at = None
        self._last_occ = -1.0
        if verbose and self.is_root:
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

    @property
    def is_root(self) -> bool:
        """True where this engine displays: unsharded, or on rank 0."""
        return self.mesh is None or self.mesh.rank_of(
            self.mesh.px_i, self.mesh.sp_i) == 0

    def _control(self, pose, seed: int, frame_number: int, cmd: int):
        """Sharded: rank 0's (pose, seed, frame_number, cmd) on every rank
        (a broadcast over the world group; the others' arguments are
        ignored), with rank 0's variance view, which every rank adopts.
        Unsharded: the arguments."""
        if self.mesh is None:
            return pose, seed, frame_number, cmd
        import torch.distributed as dist

        msg = torch.tensor([*np.asarray(pose, np.float64)[:16], seed,
                            frame_number, cmd, float(self.variance_view)],
                           dtype=torch.float64, device=self.device)
        dist.broadcast(msg, src=0)
        got = msg.cpu().numpy()
        self.variance_view = bool(got[19])
        return (got[:16].astype(np.float32), int(got[16]), int(got[17]),
                int(got[18]))

    def _seed(self) -> int:
        # rand::random::<u32>() + frame_count, wrapping (the JAX recipe).
        return int(
            (self._rng.randint(0, 2**32, dtype=np.uint64) + self.frame_count)
            & 0xFFFFFFFF
        )

    def render_one(self, frame_number: int, image: bool = True):
        """Dispatch one step and advance the state; returns the step's
        FrameOutput (with `image` False, unsharded only: the frame
        accumulated through ``step.accumulate``, rgb and glyphs None). An
        animated engine renders the animation clock's next frame fresh and
        leaves frame_count (and so the seed offset) at 0. Sharded, every
        rank calls it together and renders rank 0's pose, seed and frame
        number."""
        if self.animate is not None:
            frame_number = 0
        pose, seed, frame_number, _ = self._control(
            self.camera.pose(), self._seed(), frame_number, RENDER)
        arrays = ()
        if self.animate is not None:
            arrays = (self._animator(self._arrays0, self._anim_t),)
            self._anim_t += 1
        else:
            self.frame_count += 1
        if image:
            out = self.step(self.state, pose, seed, frame_number, *arrays)
        else:
            state, rays, occ = self.step.accumulate(self.state, pose, seed,
                                                    frame_number, *arrays)
            out = FrameOutput(state, None, None, rays, occ)
        self.state = out.state
        return out

    def _fetch(self, pending: _Fetch):
        rgb, glyphs, rays, mean_samples, occ = pending.wait()
        self._fetched_at = time.perf_counter()
        self._last_occ = occ
        return rgb, glyphs, rays, mean_samples

    def _fetch_sharded(self, out):
        """Rank 0 gathers the frame (parallel/mesh.gather_frame), or its
        variance heat map in the variance view: (rgb, glyphs or None, rays,
        mean samples) on rank 0, None elsewhere."""
        from ..parallel.mesh import gather_frame

        heatmap = self.variance_view
        if heatmap:
            out = out._replace(rgb=tm.variance_heatmap(out.state.variance))
        got = gather_frame(self.mesh, out)
        self._last_occ = float(out.occupancy)
        if got is None:
            return None
        rgb, glyphs, mean_samples = got
        self._fetched_at = time.perf_counter()
        return (rgb.cpu().numpy(),
                None if self.full_color or heatmap else glyphs.cpu().numpy(),
                float(out.rays), float(mean_samples))

    # ------------------------------------------------------------------
    # Checkpoints

    def restore(self, state, frame_count: int, camera) -> None:
        """Continue from a checkpoint (utils/statefile.load_state): the
        whole image's FrameState (sharded: each rank takes its row block),
        the frame counter and the camera."""
        if self.mesh is not None:
            from ..parallel.mesh import state_rows

            state = state_rows(self.mesh, state)
        self.state = type(state)(*(t.to(self.device) for t in state))
        self.frame_count = int(frame_count)
        self.camera = camera

    def whole_state(self):
        """The whole image's FrameState (sharded: gathered on rank 0, None
        on every other rank; every rank calls it together)."""
        if self.mesh is None:
            return self.state
        from ..parallel.mesh import gather_state

        return gather_state(self.mesh, self.state)

    def _screenshot(self):
        """'p': write the accumulation as a PNG into the working directory,
        through the step's denoiser and display transform, in full colour
        (sharded: every rank calls it, rank 0 writes)."""
        from ..utils import imageio

        state = self.whole_state()
        if state is None:
            return
        rgb, _ = finalize(state, max(self.frame_count - 1, 0), True,
                          self.denoise, self.denoise_passes, self.mode,
                          self.scale)
        path = f"screenshot_{self._shot_idx}.png"
        self._shot_idx += 1
        imageio.write_png(path, rgb.cpu().numpy())

    # ------------------------------------------------------------------

    def run_interactive(self):
        if self.mesh is not None:
            return self._run_interactive_sharded()
        scene = self.scene
        cam_moved = self.frame_count == 0
        pending = None  # dispatched-but-not-displayed frame
        with TerminalSession() as term:
            while True:
                self.timers.start_frame()
                key = term.poll_key(0.001)
                if key == "esc":
                    break
                if key == "v":
                    self.variance_view = not self.variance_view
                if key == "p":
                    self._screenshot()
                moved = self.camera.apply_key(key) if key else False
                if moved:
                    cam_moved = True
                    self.frame_count = 0
                    pending = None  # stale frame: don't display pre-move pixels

                if self.frame_count < scene.frames_to_accumulate:
                    out = self.render_one(0 if cam_moved else self.frame_count)
                    cam_moved = False
                    fetch = _Fetch(out, self.full_color, self.variance_view)
                    if not self.pipeline:
                        with self.timers.phase("gpu"):
                            fetched = self._fetch(fetch)
                        self._display(term, fetched, fetch.heatmap)
                        continue
                    if pending is not None:
                        # Waiting for frame N overlaps frame N+1's compute.
                        with self.timers.phase("gpu"):
                            fetched = self._fetch(pending)
                        self._display(term, fetched, pending.heatmap)
                    pending = fetch
                else:
                    if pending is not None:
                        self._display(term, self._fetch(pending),
                                      pending.heatmap)
                        pending = None
                    time.sleep(IDLE_SLEEP)
        print("Exiting.")

    def cancel_viewer(self):
        """Sharded, on rank 0: stop the other ranks' viewer loops (their
        run_interactive) when rank 0 cannot run its own."""
        if self.mesh is not None:
            self._control(self.camera.pose(), 0, 0, STOP)

    def _run_interactive_sharded(self):
        """The viewer on a mesh, one frame at a time: rank 0 reads the keys
        and broadcasts each frame's command; every rank renders, and rank 0
        gathers and displays the frame ('v': the heat map of every rank's
        rows; 'p': the screenshot of the gathered accumulation)."""
        if not self.is_root:
            while True:
                _, _, _, cmd = self._control(self.camera.pose(), 0, 0, IDLE)
                if cmd == STOP:
                    return
                if cmd == SHOT:
                    self._screenshot()
                if cmd == RENDER:  # rank 0's pose, seed and frame follow
                    self._fetch_sharded(self.render_one(0))
        cam_moved = self.frame_count == 0
        with TerminalSession() as term:
            while True:
                self.timers.start_frame()
                key = term.poll_key(0.001)
                if key == "esc":
                    self._control(self.camera.pose(), 0, 0, STOP)
                    break
                if key == "v":
                    self.variance_view = not self.variance_view
                if key == "p":
                    self._control(self.camera.pose(), 0, 0, SHOT)
                    self._screenshot()
                if key and self.camera.apply_key(key):
                    cam_moved = True
                    self.frame_count = 0
                if self.frame_count < self.scene.frames_to_accumulate:
                    self._control(self.camera.pose(), 0, 0, RENDER)
                    out = self.render_one(0 if cam_moved
                                          else self.frame_count)
                    cam_moved = False
                    with self.timers.phase("gpu"):
                        fetched = self._fetch_sharded(out)
                    self._display(term, fetched, self.variance_view)
                else:
                    self._control(self.camera.pose(), 0, 0, IDLE)
                    time.sleep(IDLE_SLEEP)
        print("Exiting.")

    def _display(self, term, fetched, heatmap: bool = False):
        rgb, glyphs, rays, mean_samples = fetched
        with self.timers.phase("cpu"):
            blitter = self._fc_blitter if heatmap else self.blitter
            payload = blitter.encode(rgb, glyphs)
        mray = self.timers.update_ray_rate(rays, fetched_at=self._fetched_at) / 1e6
        status = self.timers.status_line(
            self.frame_count, self.scene.frames_to_accumulate, mray_s=mray,
            samples=mean_samples, occupancy=self._last_occ,
        )
        with self.timers.phase("io"):
            term.write_frame(payload, status, self.scene.height)

    # ------------------------------------------------------------------

    def run_headless(self, n_frames: int, until_noise: float = None,
                     chunk: "int | str" = "auto"):
        """Render n accumulated frames without a terminal; returns the last
        frame's (rgb, glyphs, rays, mean_samples) (sharded: on rank 0, and
        None on every other rank). Frame numbering continues from
        self.frame_count, so a restored checkpoint keeps accumulating.

        Unsharded, each frame only accumulates and the image is made once,
        from the last frame (the step's two halves), so the result is
        bit-identical to per-frame driving; on a mesh the sharded step
        runs once a frame.

        `until_noise`: stop once the estimated noise of the accumulated
        mean (mean per-pixel sample variance over the total samples
        accumulated) drops below it, or after n_frames; checked every
        `chunk` frames ('auto' = every frame; an explicit chunk > 1 is
        refused on a mesh)."""
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        if until_noise is not None and self.animate is not None:
            # Animated frames render fresh, so the estimate never advances.
            raise ValueError("until_noise is incompatible with an animated "
                             "engine: animation never accumulates, so the "
                             "noise estimate cannot converge")
        chunk = 1 if chunk == "auto" else max(int(chunk), 1)
        if chunk > 1 and self.mesh is not None:
            raise ValueError("explicit chunking is not supported with "
                             "--shard (per-frame driving only)")

        out = None
        for i in range(1, n_frames + 1):
            out = self.render_one(self.frame_count,
                                  image=self.mesh is not None)
            if (until_noise is not None and i % chunk == 0
                    and self._noise_estimate(out.state) < until_noise):
                break
        if self.mesh is not None:
            return self._fetch_sharded(out)  # None on all but rank 0
        rgb, glyphs = self.step.finalize(
            out.state, 0 if self.animate is not None else self.frame_count - 1)
        return self._fetch(_Fetch(out._replace(rgb=rgb, glyphs=glyphs),
                                  self.full_color))

    def _noise_estimate(self, state) -> float:
        """Estimated noise of the accumulated mean: mean per-pixel sample
        variance over the total samples accumulated (the scalar the --scan
        noise loop checks, offline.make_noise_scan_renderer). Sharded, the
        sums of every row block (the same on every rank)."""
        planes = torch.stack([state.variance, state.samples])
        if self.mesh is None:
            var_mean, spp_mean = (float(v) for v in planes.mean((1, 2)).cpu())
        else:
            import torch.distributed as dist

            sums = planes.double().sum((1, 2))
            dist.all_reduce(sums, group=self.mesh.px_group)
            n = self.scene.height * self.scene.width
            var_mean, spp_mean = (float(v) / n for v in sums.cpu())
        return var_mean / max(spp_mean * self.frame_count, 1e-9)
