"""Interactive yaw/pitch fly camera.

Host-side (NumPy): the camera is the *only* per-frame-varying input besides
seed and frame counter, so it is passed to the compiled render step as a
small f32 array — the step never retraces on movement (the jit-stability
contract of SURVEY.md §3.5).

Math matches the reference (reference: src/camera.rs:12-26; key handling
lib.rs:390-411): forward = (cos yaw · cos pitch, sin pitch, sin yaw · cos
pitch), right = (−sin yaw, 0, cos yaw), up = right × forward; WASD moves
±0.1 along forward/right, arrows steer ±0.05 rad, pitch clamped to ±1.5,
initial pose origin with yaw = −π/2 (looking down −z), pitch 0 (lib.rs:118).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

MOVE_STEP = 0.1
TURN_STEP = 0.05
PITCH_CLAMP = 1.5

# Layout of the pose array consumed by the render step:
# [pos.xyz, forward.xyz, right.xyz, up.xyz] = 12 floats, padded to 16
# (pad keeps the array a clean (16,) block; fov/aspect are static scene
# attributes baked into the kernel, unlike the reference's per-frame
# Uniforms re-upload of everything, lib.rs:418-442).
POSE_SIZE = 16


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    yaw: float = -np.pi / 2.0
    pitch: float = 0.0

    def basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(forward, right, up), matching camera.rs:17-26."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        forward = np.array([cy * cp, sp, sy * cp], np.float32)
        right = np.array([-sy, 0.0, cy], np.float32)
        up = np.cross(right, forward).astype(np.float32)
        return forward, right, up

    def pose(self) -> np.ndarray:
        forward, right, up = self.basis()
        out = np.zeros(POSE_SIZE, np.float32)
        out[0:3] = self.position
        out[3:6] = forward
        out[6:9] = right
        out[9:12] = up
        return out

    # ---- pose construction -------------------------------------------------

    @classmethod
    def look_at(cls, position, target) -> "Camera":
        """Camera at `position` facing `target`, in the reference's
        yaw/pitch parameterization (forward = (cos yaw cos pitch, sin
        pitch, sin yaw cos pitch), camera.rs:17-22). Used by the
        --turntable orbit; pitch respects the interactive clamp."""
        position = np.asarray(position, np.float32)
        f = np.asarray(target, np.float32) - position
        norm = float(np.linalg.norm(f))
        if norm < 1e-8:
            return cls(position=position)
        f = f / norm
        pitch = float(np.clip(np.arcsin(np.clip(f[1], -1.0, 1.0)),
                              -PITCH_CLAMP, PITCH_CLAMP))
        yaw = float(np.arctan2(f[2], f[0]))
        return cls(position=position, yaw=yaw, pitch=pitch)

    # ---- input handling (lib.rs:393-405) -----------------------------------

    def apply_key(self, key: str) -> bool:
        """Mutate pose for one key event. Returns True if the camera moved
        (callers reset temporal accumulation on movement, lib.rs:409-412)."""
        forward, right, _ = self.basis()
        moved = True
        if key == "w":
            self.position = self.position + forward * MOVE_STEP
        elif key == "s":
            self.position = self.position - forward * MOVE_STEP
        elif key == "a":
            self.position = self.position - right * MOVE_STEP
        elif key == "d":
            self.position = self.position + right * MOVE_STEP
        elif key == "up":
            self.pitch += TURN_STEP
        elif key == "down":
            self.pitch -= TURN_STEP
        elif key == "left":
            self.yaw -= TURN_STEP
        elif key == "right":
            self.yaw += TURN_STEP
        else:
            moved = False
        self.pitch = float(np.clip(self.pitch, -PITCH_CLAMP, PITCH_CLAMP))
        return moved
