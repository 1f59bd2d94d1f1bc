"""Tonemapping, quantisation and glyph selection on the device —
``terminal_raytracer_tpu/ops/tonemap.py``.

Reference mode:

* full colour: sqrt gamma, x255, clamp, truncate to u8;
* ASCII: pow(0.3) gamma for the colour channels, glyph index =
  trunc(min(luma^0.3 * 67, 67)) of the Rec.709 luma of the linear colour,
  into the 68-glyph ramp.

Display transforms (statically gated: the defaults run exactly the
reference ops above):

* `mode`: "reference", "aces" (the Narkowicz 2015 fit of the ACES filmic
  curve, then a 1/2.2 display gamma) or ("gamma", G) for a plain 1/G
  power curve; `parse_mode` turns a user spec ("gamma:2.2") into one.
* `scale`: a linear exposure multiplier applied before the curve (the CLI
  takes stops: --exposure E -> scale 2**E). 1.0 adds no op.

In ASCII mode the glyph index comes from the tonemapped luma of the
exposed colour in every mode.
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


def parse_mode(spec) -> "str | tuple":
    """A user tonemap spec -> the `mode` the tonemap functions take:
    "reference", "aces", or "gamma:G" -> ("gamma", G) with G > 0. Raises
    ValueError on anything else (the CLI reports it as a flag error)."""
    if isinstance(spec, tuple):
        spec = f"{spec[0]}:{spec[1]}"
    s = str(spec).strip().lower()
    if s in ("reference", "aces"):
        return s
    if s.startswith("gamma:"):
        try:
            g = float(s.partition(":")[2])
        except ValueError:
            g = float("nan")
        if not g > 0.0:
            raise ValueError(f"bad --tonemap gamma value in {spec!r}; "
                             f"expected gamma:G with G > 0")
        return ("gamma", g)
    raise ValueError(f"unknown --tonemap mode {spec!r}; expected "
                     f"reference, aces, or gamma:G")


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz 2015 fit of the ACES filmic curve, per channel:
    x(2.51x+0.03) / (x(2.43x+0.59)+0.14), clamped to [0, 1]."""
    return torch.clamp(x * (2.51 * x + 0.03) / (x * (2.43 * x + 0.59) + 0.14),
                       0.0, 1.0)


def _curve(x: torch.Tensor, mode, ascii_mode: bool) -> torch.Tensor:
    """Linear radiance (a channel or the luma) -> display value."""
    if mode == "reference":
        return torch.pow(x, ASCII_GAMMA) if ascii_mode else torch.sqrt(x)
    if mode == "aces":
        return torch.pow(aces(x), 1.0 / 2.2)
    if isinstance(mode, tuple) and mode[0] == "gamma":
        return torch.pow(x, 1.0 / float(mode[1]))
    raise ValueError(f"unknown tonemap mode {mode!r} (use parse_mode)")


def _exposed(acc: V3, scale: float) -> V3:
    # A multiply by the scale, never a division (on CUDA a division by a
    # Python scalar is a multiply by its reciprocal, which rounds apart).
    return acc if scale == 1.0 else acc * float(scale)


def tonemap_fullcolor(acc: V3, mode="reference",
                      scale: float = 1.0) -> torch.Tensor:
    """[H, W, 3] uint8."""
    acc = _exposed(acc, scale)
    return torch.stack([_quant_u8(_curve(c, mode, False)) for c in acc],
                       dim=-1)


def tonemap_ascii(acc: V3, mode="reference",
                  scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """([H, W, 3] uint8 colour, [H, W] uint8 glyph index)."""
    acc = _exposed(acc, scale)
    rgb = torch.stack([_quant_u8(_curve(c, mode, True)) for c in acc],
                      dim=-1)
    luma = LUMA[0] * acc.x + LUMA[1] * acc.y + LUMA[2] * acc.z
    n = float(len(GLYPH_RAMP) - 1)
    idx = torch.clamp(_curve(luma, mode, True) * n, max=n)
    return rgb, idx.to(torch.uint8)


def variance_heatmap(variance: torch.Tensor,
                     scale: float = 10.0) -> torch.Tensor:
    """The viewer's debug view: per-pixel sample variance as a blue -> red
    heat map, [H, W, 3] uint8."""
    t = torch.clamp(variance / torch.tensor(scale, dtype=variance.dtype,
                                            device=variance.device), 0.0, 1.0)
    r = _quant_u8(t)
    g = _quant_u8(0.25 * torch.sin(t * 3.14159265) ** 2)
    b = _quant_u8(1.0 - t)
    return torch.stack([r, g, b], dim=-1)
