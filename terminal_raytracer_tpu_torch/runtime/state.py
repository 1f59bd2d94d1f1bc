"""Frame state and the render step — ``terminal_raytracer_tpu/runtime/state.py``.

Temporal accumulation is a running mean with alpha = 1/(frame_number+1),
overwritten when frame_number == 0 (which the host sets on camera
movement). Between frames only (camera pose, seed, frame_number) change,
and in animated mode the scene's values (the step's trailing `arrays`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import scene as scene_mod
from ..ops import denoise as dn
from ..ops import kernels
from ..ops import tonemap as tm
from ..ops.tracer import PathTracer
from ..ops.vecmath import V3


class FrameState(NamedTuple):
    """Per-frame state on the device: `acc` is [3, H, W] running-mean
    radiance; `variance` / `samples` are [H, W], last frame's."""

    acc: torch.Tensor
    variance: torch.Tensor
    samples: torch.Tensor


class FrameOutput(NamedTuple):
    state: FrameState
    rgb: torch.Tensor  # [H, W, 3] u8
    glyphs: torch.Tensor  # [H, W] u8 (zeros in full-colour mode)
    rays: torch.Tensor  # 0-dim f64: owed traversal sweeps this frame
    occupancy: torch.Tensor  # 0-dim f64: owed / executed lane sweeps


def init_state(scene: scene_mod.Scene, device) -> FrameState:
    h, w = scene.height, scene.width
    return FrameState(
        acc=torch.zeros((3, h, w), dtype=torch.float32, device=device),
        variance=torch.zeros((h, w), dtype=torch.float32, device=device),
        samples=torch.zeros((h, w), dtype=torch.float32, device=device),
    )


def state_from_numpy(acc, variance, samples, device) -> FrameState:
    """A FrameState from host arrays — e.g. the JAX package's FrameState
    after ``jax.device_get`` — so accumulation carries between packages."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return FrameState(t(acc), t(variance), t(samples))


def state_to_numpy(state: FrameState):
    """(acc, variance, samples) as numpy f32 arrays."""
    return tuple(t.detach().cpu().numpy() for t in state)


def accumulate(acc: torch.Tensor, current: V3, frame_number: int) -> V3:
    """Fold this frame's `current` into the running mean `acc` IN PLACE
    (alpha in f32, as the JAX step computes it); returns acc as a V3."""
    fn = np.float32(frame_number)
    alpha = (np.float32(1.0) if fn == 0.0
             else np.float32(1.0) / (fn + np.float32(1.0)))
    acc.mul_(float(np.float32(1.0) - alpha))
    acc.add_(torch.stack(list(current)) * float(alpha))
    return V3(acc[0], acc[1], acc[2])


def display(acc_v: V3, full_color: bool, mode="reference",
            scale: float = 1.0):
    """(rgb u8 [H, W, 3], glyphs u8 [H, W]; zeros in full colour) through
    the display transform `mode` at exposure `scale` (ops/tonemap.py)."""
    if full_color:
        rgb = tm.tonemap_fullcolor(acc_v, mode, scale)
        return rgb, torch.zeros(rgb.shape[:2], dtype=torch.uint8,
                                device=rgb.device)
    return tm.tonemap_ascii(acc_v, mode, scale)


def finalize(state: FrameState, frame_number: int, full_color: bool,
             denoise: float = 0.0, denoise_passes: int = 3,
             mode="reference", scale: float = 1.0):
    """The image of an accumulation as the render step shows it on frame
    `frame_number` (the last frame folded into `state`): the optional
    denoiser over it, guided by the state's variance and samples planes,
    then the display transform (`mode` as ops/tonemap.parse_mode returns
    it, `scale` the exposure's 2**stops). Returns (rgb, glyphs)."""
    acc_v = dn.denoise_acc(V3(*state.acc), state.variance, state.samples,
                           int(frame_number), denoise, denoise_passes)
    return display(acc_v, full_color, mode, scale)


def make_render_step(scene: scene_mod.Scene, full_color: bool = True,
                     device="cuda", accel: str = "auto",
                     dynamic: bool = False, transport: str = "reference",
                     denoise: float = 0.0, denoise_passes: int = 3,
                     tonemap="reference", exposure: float = 0.0):
    """Build ``step(state, pose16, seed, frame_number[, arrays]) ->
    FrameOutput``.

    The step runs the sorted two-kernel pipeline (ops/kernels.py): the CUDA
    kernels on a CUDA device, their plain PyTorch versions on the CPU.
    `accel` picks the traversal and with it the chunk split
    (ops/tracer.py); `transport` the light-transport estimator
    ('reference', 'unbiased' or 'mis'). With `dynamic`, the step takes the
    frame's scene values as a trailing ops/dynamic.pack_scene `arrays` (the
    --animate mode). `denoise` > 0 runs the à-trous filter of
    ops/denoise.py (`denoise_passes` rounds) over the accumulation before
    tonemapping, for display only. `tonemap` (an ops/tonemap.parse_mode
    spec) and `exposure` (stops: the radiance is scaled by 2**exposure) are
    the display transform; the defaults are the reference tonemap. It
    updates ``state.acc`` IN PLACE and returns that same tensor in the new
    state; pass the previous output's state back in.

    The step carries its tracer as ``step.tracer`` (its gates, kernels and
    counts), and its two halves: ``step.accumulate(state, pose, seed,
    frame_number[, arrays]) -> (state, rays, occupancy)`` renders a frame
    into the accumulation without an image, and ``step.finalize(state,
    frame_number) -> (rgb, glyphs)`` makes the image (the headless runner
    and runtime/offline.py fold frames with the first and show the last
    with the second)."""
    tracer = PathTracer(scene, device, accel=accel, dynamic=dynamic,
                        transport=transport)
    render_frame = kernels.make_sorted_render_frame(tracer)
    # Parsed once: a bad spec fails here, not at the first frame.
    mode, scale = tm.parse_mode(tonemap), 2.0 ** float(exposure)

    def accumulate_frame(state: FrameState, pose, seed, frame_number,
                         arrays=None):
        current, variance, samples, rays, occ = render_frame(
            pose, int(seed), int(frame_number), arrays)
        accumulate(state.acc, current, int(frame_number))
        return FrameState(state.acc, variance, samples), rays, occ

    def finalize_frame(state: FrameState, frame_number):
        return finalize(state, frame_number, full_color, denoise,
                        denoise_passes, mode, scale)

    def step(state: FrameState, pose, seed, frame_number,
             arrays=None) -> FrameOutput:
        state, rays, occ = accumulate_frame(state, pose, seed, frame_number,
                                            arrays)
        rgb, glyphs = finalize_frame(state, frame_number)
        return FrameOutput(state, rgb, glyphs, rays, occ)

    step.tracer = tracer
    step.accumulate = accumulate_frame
    step.finalize = finalize_frame
    return step
