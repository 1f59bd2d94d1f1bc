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


def display(acc_v: V3, full_color: bool):
    """(rgb u8 [H, W, 3], glyphs u8 [H, W]; zeros in full colour)."""
    if full_color:
        rgb = tm.tonemap_fullcolor(acc_v)
        return rgb, torch.zeros(rgb.shape[:2], dtype=torch.uint8,
                                device=rgb.device)
    return tm.tonemap_ascii(acc_v)


def make_render_step(scene: scene_mod.Scene, full_color: bool = True,
                     device="cuda", accel: str = "auto",
                     dynamic: bool = False, transport: str = "reference",
                     denoise: float = 0.0, denoise_passes: int = 3):
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
    tonemapping, for display only. It updates ``state.acc`` IN PLACE and
    returns that same tensor in the new state; pass the previous output's
    state back in. The step carries its tracer as ``step.tracer`` (its
    gates, kernels and counts)."""
    tracer = PathTracer(scene, device, accel=accel, dynamic=dynamic,
                        transport=transport)
    render_frame = kernels.make_sorted_render_frame(tracer)

    def step(state: FrameState, pose, seed, frame_number,
             arrays=None) -> FrameOutput:
        current, variance, samples, rays, occ = render_frame(
            pose, int(seed), int(frame_number), arrays)
        acc_v = accumulate(state.acc, current, int(frame_number))
        acc_v = dn.denoise_acc(acc_v, variance, samples, int(frame_number),
                               denoise, denoise_passes)
        rgb, glyphs = display(acc_v, full_color)
        return FrameOutput(FrameState(state.acc, variance, samples), rgb,
                           glyphs, rays, occ)

    step.tracer = tracer
    return step
