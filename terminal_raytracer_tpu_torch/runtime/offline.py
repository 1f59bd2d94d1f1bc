"""Offline rendering: frames folded on the device with one image at the end
— ``terminal_raytracer_tpu/runtime/offline.py``.

The JAX package compiles a frame sequence into one XLA program (a
``lax.scan`` over the render step). Here a "scan" is the render step's
accumulate half (``step.accumulate``, runtime/state.py) called frame after
frame on the device, with the display transform (``step.finalize``: the
denoiser, --tonemap, --exposure) run once, on the last frame, as the JAX
package's ``_finalize`` does. Nothing is read back to the host inside a
chunk: the frames queue on the stream, and only the until-noise loop reads
one scalar a chunk, where JAX's ``while_loop`` evaluates its condition.
Frame numbering, seeds and the accumulation are those of per-frame driving,
so every mode is bit-identical to calling the step once a frame. Each
renderer takes `step=`, a render step of runtime/state.make_render_step
built with its options, to share that step's tracer (the CLI passes the
engine's); without one it builds its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import scene as scene_mod
from .state import FrameOutput, FrameState, init_state, make_render_step


def _step(step, scene, full_color, device, accel, transport, denoise,
          denoise_passes, tonemap, exposure, dynamic=False):
    """`step`, or a render step built with these options."""
    if step is not None:
        return step
    return make_render_step(scene, full_color=full_color, device=device,
                            accel=accel, dynamic=dynamic,
                            transport=transport, denoise=denoise,
                            denoise_passes=denoise_passes, tonemap=tonemap,
                            exposure=exposure)


def _fold(step, state: FrameState, pose, seeds, frames):
    """Accumulate one frame per (seed, frame number) pair; returns (state,
    [rays], last occupancy)."""
    rays, occ = [], None
    for seed, fn in zip(seeds, frames):
        state, r, occ = step.accumulate(state, pose, int(seed), int(fn))
        rays.append(r)
    return state, rays, occ


def make_chunk_renderer(scene: scene_mod.Scene, k: int,
                        full_color: bool = True, device="cuda",
                        accel: str = "auto", transport: str = "reference",
                        denoise: float = 0.0, denoise_passes: int = 3,
                        tonemap="reference", exposure: float = 0.0,
                        step=None):
    """k accumulation frames, tonemapped once from the final accumulation.

    Returns ``chunk(state, pose, seeds_k, frame0=0) -> (FrameOutput,
    rays_per_frame)``: the FrameOutput holds the state after the chunk, the
    image of its last frame and that frame's rays and occupancy (what
    per-frame driving would show); ``rays_per_frame`` is the (k,) tensor of
    each frame's rays. Frames are numbered frame0 .. frame0 + k - 1, so a
    chunk is bit-identical to k steps on the same seeds.
    """
    step = _step(step, scene, full_color, device, accel, transport, denoise,
                 denoise_passes, tonemap, exposure)

    def chunk(state: FrameState, pose, seeds, frame0=0):
        frame0 = int(frame0)
        state, rays, occ = _fold(step, state, pose, list(seeds)[:k],
                                 range(frame0, frame0 + k))
        rgb, glyphs = step.finalize(state, frame0 + k - 1)
        return (FrameOutput(state, rgb, glyphs, rays[-1], occ),
                torch.stack(rays))

    chunk.step = step
    return chunk


def make_noise_scan_renderer(scene: scene_mod.Scene, n_frames: int,
                             threshold: float, chunk: int = 8,
                             full_color: bool = True, device="cuda",
                             accel: str = "auto",
                             transport: str = "reference",
                             denoise: float = 0.0, denoise_passes: int = 3,
                             tonemap="reference", exposure: float = 0.0,
                             step=None):
    """--until-noise with --scan: chunks of frames until the estimated noise
    of the accumulated mean (mean per-pixel sample variance over the total
    samples accumulated, Engine._noise_estimate's scalar) drops below
    `threshold`, or n_frames. The stop is chunk-granular; `chunk` is
    halved until it divides n_frames, so the cap is exact.

    Returns ``render(state, pose, seeds, frame0=0) -> (state, rgb, glyphs,
    rays_total, frames_done)`` with ``seeds`` the (n_frames,) seeds and
    ``frames_done`` the number of frames rendered (an int).
    """
    while chunk > 1 and n_frames % chunk:
        chunk //= 2
    n_chunks = n_frames // chunk
    step = _step(step, scene, full_color, device, accel, transport, denoise,
                 denoise_passes, tonemap, exposure)
    thr = float(threshold)

    def noise_of(state: FrameState, frames_done: int) -> float:
        var_mean = torch.mean(state.variance)
        total = torch.mean(state.samples) * float(np.float32(frames_done))
        return float(var_mean / torch.clamp(total, min=1e-9))

    def render(state: FrameState, pose, seeds, frame0=0):
        frame0 = int(frame0)
        seeds = list(seeds)
        rays = []
        ci = 0
        while ci < n_chunks:
            if ci > 0 and noise_of(state, frame0 + ci * chunk) < thr:
                break
            lo = ci * chunk
            state, r, _ = _fold(step, state, pose, seeds[lo:lo + chunk],
                                range(frame0 + lo, frame0 + lo + chunk))
            rays += r
            ci += 1
        rgb, glyphs = step.finalize(state, frame0 + ci * chunk - 1)
        return state, rgb, glyphs, torch.stack(rays).sum(), ci * chunk

    return render


def make_scan_renderer(scene: scene_mod.Scene, n_frames: int,
                       full_color: bool = True, device="cuda",
                       accel: str = "auto", transport: str = "reference",
                       denoise: float = 0.0, denoise_passes: int = 3,
                       tonemap="reference", exposure: float = 0.0,
                       step=None):
    """``render(state, pose, seeds, frame0=0) -> (state, rgb, glyphs,
    rays_total)``: n_frames accumulation frames numbered frame0 ..
    frame0 + n_frames - 1 (frame0 > 0 continues a restored accumulation,
    --load-state), one seed a frame."""
    chunk = make_chunk_renderer(scene, n_frames, full_color, device, accel,
                                transport, denoise, denoise_passes, tonemap,
                                exposure, step)

    def render(state: FrameState, pose, seeds, frame0=0):
        out, rays = chunk(state, pose, seeds, frame0)
        return out.state, out.rgb, out.glyphs, rays.sum()

    return render


def make_orbit_scan_renderer(scene: scene_mod.Scene, n_poses: int,
                             frames_per_pose: int, full_color: bool = True,
                             device="cuda", accel: str = "auto",
                             transport: str = "reference",
                             denoise: float = 0.0, denoise_passes: int = 3,
                             tonemap="reference", exposure: float = 0.0,
                             step=None):
    """The whole turntable: for each pose, frames_per_pose accumulation
    frames from a fresh state (frame numbers 0 ..), then its image.

    Returns ``render(poses, seeds) -> (rgb u8 [n_poses, H, W, 3], glyphs
    u8 [n_poses, H, W], rays_total)`` with ``poses`` (n_poses, 16) and
    ``seeds`` (n_poses, frames_per_pose).
    """
    step = _step(step, scene, full_color, device, accel, transport, denoise,
                 denoise_passes, tonemap, exposure)

    def render(poses, seeds):
        rgbs, glyphss, rays = [], [], []
        for pose, pose_seeds in zip(np.asarray(poses), np.asarray(seeds)):
            # A state of its own: the step accumulates in place.
            state, r, _ = _fold(step, init_state(scene, step.tracer.device),
                                pose, pose_seeds[:frames_per_pose],
                                range(frames_per_pose))
            rgb, glyphs = step.finalize(state, frames_per_pose - 1)
            rgbs.append(rgb)
            glyphss.append(glyphs)
            rays += r
        return torch.stack(rgbs), torch.stack(glyphss), torch.stack(rays).sum()

    return render


def make_animation_scan_renderer(scene: scene_mod.Scene, n_frames: int,
                                 full_color: bool = True, device="cuda",
                                 transport: str = "reference",
                                 denoise: float = 0.0,
                                 denoise_passes: int = 3,
                                 tonemap="reference", exposure: float = 0.0,
                                 step=None):
    """An animation through the dynamic step: frame i renders the scene
    values ``arrays_seq`` holds at i (the ops/dynamic.pack_scene layout,
    stacked to [n_frames, ...]), fresh at frame number 0.

    Returns ``render(pose, arrays_seq, seeds) -> (rgb u8 [n, H, W, 3],
    glyphs u8 [n, H, W], rays_total)``.
    """
    step = _step(step, scene, full_color, device, "auto", transport,
                 denoise, denoise_passes, tonemap, exposure, dynamic=True)

    def render(pose, arrays_seq, seeds):
        rgbs, glyphss, rays = [], [], []
        for i in range(n_frames):
            arrays = {key: v[i] for key, v in arrays_seq.items()}
            out = step(init_state(scene, step.tracer.device), pose,
                       int(seeds[i]), 0, arrays)
            rgbs.append(out.rgb)
            glyphss.append(out.glyphs)
            rays.append(out.rays)
        return torch.stack(rgbs), torch.stack(glyphss), torch.stack(rays).sum()

    return render


def render_accumulated(scene: scene_mod.Scene, pose, n_frames: int,
                       seed: Optional[int] = None, full_color: bool = True,
                       device="cuda", transport: str = "reference"):
    """One-call offline render of n accumulated frames: (state, rgb u8,
    glyphs u8 as numpy, rays as a float), on the seeds --scan draws."""
    rng = np.random.RandomState(seed)
    seeds = (rng.randint(0, 2**32, size=n_frames, dtype=np.uint64)
             + np.arange(n_frames, dtype=np.uint64)).astype(np.uint32)
    render = make_scan_renderer(scene, n_frames, full_color, device,
                                transport=transport)
    state, rgb, glyphs, rays = render(init_state(scene, device), pose, seeds)
    return state, rgb.cpu().numpy(), glyphs.cpu().numpy(), float(rays)
