"""The reference viewer around the renderer: the fly camera, the per-frame
seeds, temporal accumulation, the full-colour tonemap and the ANSI frame.

Restated from the reference viewer (Terminal-Raytracer's lib.rs and
camera.rs): WASD moves 0.1 along forward / right, the arrows steer 0.05
rad, pitch is clamped to +-1.5, the camera starts at the origin looking
down -z; each rendered frame takes the seed u32 draw + the frames rendered
since the last camera move (wrapping), and a move restarts the running mean
at frame number 0; the running mean folds frame N with alpha = 1 / (N + 1)
in f32; full colour shows sqrt(radiance) * 255 truncated to u8 as a
truecolor block per cell, rows ending in CR LF.
"""

from __future__ import annotations

import numpy as np
import torch

from .pathtracer import V3

MOVE_STEP = 0.1
TURN_STEP = 0.05
PITCH_CLAMP = 1.5
MASK32 = 0xFFFFFFFF


class FlyCamera:
    """Position, yaw and pitch, moved by key names."""

    def __init__(self):
        self.position = np.zeros(3, np.float32)
        self.yaw = -np.pi / 2.0
        self.pitch = 0.0

    def basis(self):
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        forward = np.array([cy * cp, sp, sy * cp], np.float32)
        right = np.array([-sy, 0.0, cy], np.float32)
        up = np.cross(right, forward).astype(np.float32)
        return forward, right, up

    def apply(self, key: str) -> bool:
        """Move by one key; True where the key moves the camera."""
        forward, right, _ = self.basis()
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
            return False
        self.pitch = float(np.clip(self.pitch, -PITCH_CLAMP, PITCH_CLAMP))
        return True

    def cam(self):
        """(pos, forward, right, up) as V3s of Python floats holding f32."""
        forward, right, up = self.basis()
        return tuple(V3(*(float(c) for c in np.asarray(v, np.float32)))
                     for v in (self.position, forward, right, up))


def frame_inputs(run_seed: int, keys_before: list) -> list:
    """The (camera, seed, frame number) of every frame a session renders.

    `keys_before[k]` is the list of keys delivered after frame k - 1 was
    dispatched and before frame k was (all of them applied before frame k);
    `run_seed` seeds the per-frame seed draws. Returns one (cam, seed,
    frame_number) a frame."""
    rng = np.random.RandomState(run_seed & MASK32)
    camera = FlyCamera()
    out, count = [], 0
    for keys in keys_before:
        moved = False
        for key in keys:
            moved = camera.apply(key) or moved
        if moved:
            count = 0
        seed = int((rng.randint(0, 2**32, dtype=np.uint64) + count) & MASK32)
        out.append((camera.cam(), seed, count))
        count += 1
    return out


def accumulate(prev: torch.Tensor, current: V3, frame_number: int,
               precision: str = "f32") -> torch.Tensor:
    """The running mean [3, H, W] after folding frame `frame_number`'s
    radiance into `prev` (ignored at frame 0)."""
    fn = np.float32(frame_number)
    alpha = (np.float32(1.0) if fn == 0.0
             else np.float32(1.0) / (fn + np.float32(1.0)))
    acc = prev * float(np.float32(1.0) - alpha)
    if precision == "bf16":
        acc = acc.to(torch.bfloat16).to(torch.float32)
    acc = acc + torch.stack(list(current)) * float(alpha)
    if precision == "bf16":
        acc = acc.to(torch.bfloat16).to(torch.float32)
    return acc


def tonemap(acc: torch.Tensor) -> torch.Tensor:
    """[3, H, W] radiance -> [H, W, 3] u8: sqrt, x255, clamp, truncate."""
    return torch.stack([torch.clamp(torch.sqrt(c) * 255.0, 0.0, 255.0)
                        .to(torch.uint8) for c in acc], dim=-1)


_DEC = [str(i).encode() for i in range(256)]
_BLOCK = "█".encode()


def encode(rgb: np.ndarray) -> bytes:
    """The ANSI truecolor-block frame of an [H, W, 3] u8 image."""
    rows = []
    for row in np.asarray(rgb, np.uint8).tolist():
        rows.append(b"".join(
            b"\x1b[38;2;" + _DEC[r] + b";" + _DEC[g] + b";" + _DEC[b] + b"m"
            + _BLOCK + b"\x1b[0m" for r, g, b in row) + b"\r\n")
    return b"".join(rows)
