"""Edge-aware à-trous denoiser over the accumulated radiance —
``terminal_raytracer_tpu/ops/denoise.py``.

A display post-process between temporal accumulation and tonemapping: an
à-trous (holey) B3-spline filter with variance-guided colour edge-stopping
(the SVGF family's spatial pass). The estimator, its RNG chains, ray counts
and the accumulated state are untouched; strength 0 (the default) is the
identity. Weights per tap q around p (the stride s doubles each pass):

    w = h(q) * exp(-||c_p - c_q||^2 / (k^2 * (var_p + var_q + eps)))

with h the separable B3 spline (1/16, 1/4, 3/8, 1/4, 1/16) and k the
strength. The variance plane is re-estimated between passes as
var' = sum(w^2 var_q) / (sum w)^2. Guidance is the variance of the
accumulated mean (the frame's sample variance over the samples taken in
all frames), so the filter backs off as accumulation converges.

Each tap is a shift with edge-replicated borders. Every operation is
elementwise over (H, W) planes in the JAX package's order and rounding
(the Python-float constants meet f32 tensors, divisors are tensors), so a
pixel's result depends only on its neighbourhood: the sharded filter of
parallel/mesh.py, which pads a row block with its neighbours' halo rows,
is bit-identical to this one on the whole image.
"""

from __future__ import annotations

import torch

from .vecmath import V3

# Separable B3-spline taps (Dammertz et al. 2010).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
_VAR_EPS = 1e-4


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """A (H, W) plane shifted by (dy, dx) with clamped (edge-replicate)
    borders: out[y, x] = a[clip(y - dy), clip(x - dx)]."""
    h, w = a.shape
    if dy > 0:
        a = torch.cat([a[:1].expand(dy, w), a[:-dy]])
    elif dy < 0:
        a = torch.cat([a[-dy:], a[-1:].expand(-dy, w)])
    if dx > 0:
        a = torch.cat([a[:, :1].expand(h, dx), a[:, :-dx]], dim=1)
    elif dx < 0:
        a = torch.cat([a[:, -dx:], a[:, -1:].expand(h, -dx)], dim=1)
    return a


def _shift_v3(c: V3, dy: int, dx: int) -> V3:
    return V3(_shift(c.x, dy, dx), _shift(c.y, dy, dx), _shift(c.z, dy, dx))


def atrous_pass(color: V3, var: torch.Tensor, stride: int, k: float):
    """One à-trous round at the given tap stride. Returns (color', var')."""
    inv = 1.0 / (k * k)
    zeros = torch.zeros_like(var)
    wsum, vsum = zeros, zeros
    csum = V3(zeros, zeros, zeros)
    for iy, hy in enumerate(_B3):
        for ix, hx in enumerate(_B3):
            dy = (iy - 2) * stride
            dx = (ix - 2) * stride
            cq = _shift_v3(color, dy, dx)
            vq = _shift(var, dy, dx)
            d2 = ((color.x - cq.x) ** 2 + (color.y - cq.y) ** 2
                  + (color.z - cq.z) ** 2)
            w = (hy * hx) * torch.exp(-d2 * inv / (var + vq + _VAR_EPS))
            wsum = wsum + w
            csum = csum + cq * w
            vsum = vsum + w * w * vq
    inv_w = 1.0 / torch.clamp(wsum, min=1e-12)
    return csum * inv_w, vsum * (inv_w * inv_w)


def denoise(color: V3, var: torch.Tensor, strength: float,
            passes: int = 3) -> V3:
    """Filter the accumulated radiance. `var` is the variance of the
    accumulated per-pixel mean (denoise_acc), clamped at 0 here.
    strength <= 0 or passes <= 0 is the identity."""
    if strength <= 0.0 or passes <= 0:
        return color
    v = torch.clamp(var, min=0.0)
    for p in range(passes):
        color, v = atrous_pass(color, v, 1 << p, float(strength))
    return color


def mean_variance(variance: torch.Tensor, samples: torch.Tensor,
                  frame_number: int) -> torch.Tensor:
    """The variance of the accumulated mean over `frame_number + 1` frames:
    the last frame's per-sample variance over the samples of all frames."""
    total = samples * float(frame_number + 1)
    return variance / torch.clamp(total, min=1.0)


def denoise_acc(acc: V3, variance: torch.Tensor, samples: torch.Tensor,
                frame_number: int, strength: float, passes: int = 3) -> V3:
    """The render step's entry point: filter the accumulated radiance
    guided by the variance of its mean. `variance` / `samples` are the last
    frame's FrameState planes."""
    if strength <= 0.0 or passes <= 0:
        return acc
    return denoise(acc, mean_variance(variance, samples, frame_number),
                   strength, passes)
