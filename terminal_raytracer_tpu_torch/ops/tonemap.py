"""Tonemapping, quantisation and glyph selection on the device —
``terminal_raytracer_tpu/ops/tonemap.py``, reference mode only (the aces,
gamma and exposure display transforms are not ported yet).

* full colour: sqrt gamma, x255, clamp, truncate to u8;
* ASCII: pow(0.3) gamma for the colour channels, glyph index =
  trunc(min(luma^0.3 * 67, 67)) of the Rec.709 luma of the linear colour,
  into the 68-glyph ramp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .vecmath import V3

GLYPH_RAMP = (
    " .`^\",:;Il!i><~+_-?][}{1)(|\\tfjrxnuvczXYUJCLQ0OZmwqpdbkhao*#MW&8%B@$"
)
assert len(GLYPH_RAMP) == 68

ASCII_GAMMA = 0.3
LUMA = (0.2126, 0.7152, 0.0722)


def _quant_u8(x: torch.Tensor) -> torch.Tensor:
    """(x * 255).clamp(0, 255) as u8, truncating."""
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def tonemap_fullcolor(acc: V3) -> torch.Tensor:
    """[H, W, 3] uint8."""
    return torch.stack([_quant_u8(torch.sqrt(c)) for c in acc], dim=-1)


def tonemap_ascii(acc: V3) -> Tuple[torch.Tensor, torch.Tensor]:
    """([H, W, 3] uint8 colour, [H, W] uint8 glyph index)."""
    rgb = torch.stack([_quant_u8(torch.pow(c, ASCII_GAMMA)) for c in acc],
                      dim=-1)
    luma = LUMA[0] * acc.x + LUMA[1] * acc.y + LUMA[2] * acc.z
    n = float(len(GLYPH_RAMP) - 1)
    idx = torch.clamp(torch.pow(luma, ASCII_GAMMA) * n, max=n)
    return rgb, idx.to(torch.uint8)
