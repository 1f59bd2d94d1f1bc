"""Counter-based PCG-hash RNG over lanes — ``terminal_raytracer_tpu/ops/rng.py``.

The JAX package carries the state as ``uint32``. PyTorch's CPU ``uint32``
has no add, no ``>>`` and no compare, so here the state is an ``int64``
tensor holding the 32-bit value (0 <= state < 2**32): every product fits in
63 bits before it is masked back to 32, and right shifts of a non-negative
value are logical. Each function is bit-exact against its JAX namesake.

``gate`` (bool lanes, optional) keeps the state of gated-off lanes, exactly
as a scalar thread that branched around the draw would (rng.next_f32 in the
JAX package explains why every draw carries the reference's gate).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MASK32 = 0xFFFFFFFF

# 1 / (2**32 - 1): the reference maps u32 -> f32 by dividing by 4294967295.
_INV_U32_MAX = float(1.0 / 4294967295.0)


def u32_to_f32(v: torch.Tensor) -> torch.Tensor:
    """u32 value -> f32 as the JAX package converts it: wrap to int32, cast,
    add 2**32 where negative (its double rounding differs from a native
    u32 cast by up to one ulp above 2**31, and the draws keep that)."""
    i = torch.where(v >= 2**31, v - 2**32, v)
    f = i.to(torch.float32)
    return torch.where(i < 0, f + 4294967296.0, f)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-XSH-RR style output hash on 32-bit values held in int64."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def seed_pixel(pixel_index: torch.Tensor, seed: int,
               frame_number: int) -> torch.Tensor:
    """Per-pixel initial state ``(y*w + x)*1973 + seed*9277 + frame*12345``
    mod 2**32; ``seed`` and ``frame_number`` are Python ints (their u32 bit
    patterns are taken)."""
    base = ((seed & MASK32) * 9277 + (frame_number & MASK32) * 12345) & MASK32
    return (pixel_index * 1973 + base) & MASK32


def advance_sample(state: torch.Tensor, sample_index,
                   gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample decorrelation re-hash ``pcg_hash(state + i*5096)``."""
    new = pcg_hash((state + sample_index * 5096) & MASK32)
    if gate is not None:
        new = torch.where(gate, new, state)
    return new


def next_f32(state: torch.Tensor, gate: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One uniform draw in [0, 1]: state' = pcg_hash(state), value =
    state' / (2**32 - 1). The value is produced for gated-off lanes too;
    callers mask its use."""
    new = pcg_hash(state)
    value = u32_to_f32(new) * _INV_U32_MAX
    if gate is not None:
        new = torch.where(gate, new, state)
    return new, value


def next_f32_pair(state: torch.Tensor, gate: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    state, a = next_f32(state, gate)
    state, b = next_f32(state, gate)
    return state, a, b
