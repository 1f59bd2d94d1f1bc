"""Monte-Carlo direction and area sampling over lanes —
``terminal_raytracer_tpu/ops/sampling.py``: the samplers of the reference
transport, the metal fuzz vector (``uniform_sphere_dir``), the polynomial
``atan2`` of the texture and sky uv, the fog's Henyey-Greenstein direction
and phase value, and the fuzz lobe's pdf of the MIS transport.

Per-lane divergent branches (the ONB axis pick) become ``where`` selects;
RNG draws happen in the JAX package's order with its gates. Python-float
constants fold in f64 and round to f32 once, where the JAX package folds
them; every division is by a tensor (a Python-scalar divisor is a
reciprocal multiply on CUDA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import rng as prng
from . import vecmath as vm
from .vecmath import V3

TWO_PI = 2.0 * 3.14159265359  # the shader's literal pi
PI = 3.14159265359


def orthonormal_basis(w: V3) -> Tuple[V3, V3]:
    """(u, v) completing normalized w: u is built from the y-axis when
    |w.x| > 0.1, else from the x-axis."""
    use_y = torch.abs(w.x) > 0.1
    zeros = torch.zeros_like(w.x)
    # cross((0,1,0), w) = (w.z, 0, -w.x); cross((1,0,0), w) = (0, -w.z, w.y)
    u_y = vm.normalize(V3(w.z, zeros, -w.x))
    u_x = vm.normalize(V3(zeros, -w.z, w.y))
    u = vm.where(use_y, u_y, u_x)
    v = vm.cross(w, u)
    return u, v


def cosine_hemisphere(state: torch.Tensor, normal: V3,
                      gate: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, V3]:
    """Cosine-weighted direction about `normal`; 2 gated draws."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = torch.sqrt(r1)
    sin_theta = torch.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    z = cos_theta
    w = vm.normalize(normal)
    u, v = orthonormal_basis(w)
    return state, vm.normalize(u * x + v * y + w * z)


def uniform_sphere_dir(state: torch.Tensor,
                       gate: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, V3]:
    """Uniform direction on the unit sphere (the metal fuzz vector); 2
    gated draws."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = 1.0 - 2.0 * r1
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * r2
    return state, V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta)


def henyey_greenstein_dir(state: torch.Tensor, d: V3, g: float,
                          gate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, V3]:
    """Henyey-Greenstein direction about the incoming unit direction `d`
    for the anisotropy g != 0 (a Python float); 2 gated draws. Inverse CDF
    cos_t = (1 + g^2 - ((1 - g^2) / (1 - g + 2 g u))^2) / (2 g), clipped to
    [-1, 1]; the result is not renormalized."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    sq = torch.full_like(r1, 1.0 - g * g) / ((1.0 - g) + (2.0 * g) * r1)
    cos_t = torch.clamp(((1.0 + g * g) - sq * sq)
                        / torch.full_like(sq, 2.0 * g), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * r2
    w = vm.normalize(d)
    u, v = orthonormal_basis(w)
    return state, (u * (sin_t * torch.cos(phi)) + v * (sin_t * torch.sin(phi))
                   + w * cos_t)


def fuzz_pdf(cos_r: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the metal fuzz lobe normalize(R + f S) about the
    mirror axis R at cos_r = dot(direction, R), roughness f per lane:
    (2 cos_r^2 - c) / (2 pi f sqrt(cos_r^2 - c)), c = 1 - f^2, inside the
    cone cos_r^2 - c > 1e-9 (cos_r > 0, f > 0), else 0; the edge
    singularity floored at 1e-9 and the denominator at 1e-20, as both MIS
    weight sites of the JAX package evaluate it."""
    c = 1.0 - roughness * roughness
    disc = cos_r * cos_r - c
    inside = (cos_r > 0.0) & (disc > 1e-9) & (roughness > 0.0)
    denom = (2.0 * PI) * roughness * torch.sqrt(torch.clamp(disc, min=1e-9))
    return torch.where(
        inside, (2.0 * cos_r * cos_r - c) / torch.clamp(denom, min=1e-20), 0.0)


def hg_phase(cos_t: torch.Tensor, g: float) -> torch.Tensor:
    """The Henyey-Greenstein phase value p(cos_t) for the Python-float g
    (g = 0 gives 1 / 4 pi): (1 - g^2) / (4 pi d sqrt(max(d, 1e-12))),
    d = 1 + g^2 - 2 g cos_t."""
    g2 = g * g
    denom = (1.0 + g2) - (2.0 * g) * cos_t
    return torch.full_like(cos_t, 1.0 - g2) / (
        (4.0 * PI) * denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's branchless polynomial atan2 (texture and sky uv),
    reproduced term for term: a native atan2 would move uv, and with it
    texels. Octant reduction to a = min/max of |x|, |y|, a degree-9 odd
    polynomial for atan(a) (max abs error ~1e-5 rad), then the quadrant
    unfolds; atan2(0, 0) = 0."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi = torch.maximum(ax, ay)
    a = torch.minimum(ax, ay) / torch.where(hi > 0.0, hi, 1.0)
    s = a * a
    r = a * (0.99997726 + s * (-0.33262347 + s * (0.19354346 + s * (
        -0.11643287 + s * (0.05265332 - s * 0.01172120)))))
    r = torch.where(ay > ax, 0.5 * PI - r, r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def sphere_light_point(state: torch.Tensor, center: V3, radius,
                       gate: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, V3, V3]:
    """Uniform point on a sphere light; 2 gated draws. Returns (state',
    point, light normal). The caller supplies the light's area."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = 1.0 - 2.0 * r1
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * r2
    local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
               cos_theta)
    point = center + local * radius
    return state, point, local


def triangle_light_point(state: torch.Tensor, v0: V3, v1: V3, v2: V3,
                         gate: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, V3]:
    """Uniform point on a triangle light; 2 gated draws. The caller
    supplies the (precomputed) normal and area."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    sqrt_r1 = torch.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    point = v0 * (1.0 - u - v) + v1 * u + v2 * v
    return state, point
