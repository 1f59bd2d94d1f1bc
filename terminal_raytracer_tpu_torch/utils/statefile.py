"""Checkpoint / resume of the render state —
``terminal_raytracer_tpu/utils/statefile.py``, without jax.

An npz of the FrameState, the frame counter and the camera, with the JAX
package's keys and dtypes: ``acc`` (3, H, W) f32, ``variance`` and
``samples`` (H, W) f32, ``frame_count`` int64, ``cam_position`` f32,
``cam_yaw`` and ``cam_pitch`` f64. A file written by either package loads
in the other. Resuming continues frame numbering from ``frame_count``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..models.camera import Camera
from ..runtime.state import FrameState, state_from_numpy, state_to_numpy


def save_state(path, state: FrameState, frame_count: int,
               camera: Camera) -> None:
    acc, variance, samples = state_to_numpy(state)
    np.savez_compressed(
        Path(path),
        acc=acc,
        variance=variance,
        samples=samples,
        frame_count=np.int64(frame_count),
        cam_position=np.asarray(camera.position, np.float32),
        cam_yaw=np.float64(camera.yaw),
        cam_pitch=np.float64(camera.pitch),
    )


def load_state(path, expect_shape: Optional[Tuple[int, int]] = None,
               device="cpu") -> Tuple[FrameState, int, Camera]:
    """(state on `device`, frame_count, camera). `expect_shape` (height,
    width): when given, refuse a checkpoint of another resolution than the
    scene that is about to take it."""
    z = np.load(Path(path))
    if expect_shape is not None and tuple(z["acc"].shape[1:]) != tuple(
            expect_shape):
        h, w = z["acc"].shape[1:]
        eh, ew = expect_shape
        raise ValueError(
            f"state file {path} holds a {w}x{h} accumulation but the scene "
            f"renders {ew}x{eh}; pass --width/--height (or --no-clamp) to "
            f"match the checkpoint")
    state = state_from_numpy(z["acc"], z["variance"], z["samples"], device)
    cam = Camera(position=z["cam_position"].astype(np.float32),
                 yaw=float(z["cam_yaw"]), pitch=float(z["cam_pitch"]))
    return state, int(z["frame_count"]), cam
