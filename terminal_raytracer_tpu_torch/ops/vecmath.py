"""SoA 3-vector math on component triples of tensors.

Counterpart of ``terminal_raytracer_tpu/ops/vecmath.py``: a 3-vector field
over a batch of lanes is three same-shaped tensors (x, y, z), never a
trailing dim-3 axis. Components may also be 0-dim tensors or Python floats
that broadcast (scene constants).

Every expression keeps the JAX package's operation order, so the plain
PyTorch versions round like the reference, operation by operation (the
transcendentals and the JAX package's rsqrt still differ by an ulp or so
between XLA and PyTorch). The JAX package's trace-time 0/±1 folding is
dropped: on finite values it changes no result, only the number of ops
Mosaic emits.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class V3(NamedTuple):
    """A 3-vector (or field of 3-vectors) as three same-shaped components."""

    x: Scalar
    y: Scalar
    z: Scalar

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o: Union["V3", Scalar]) -> "V3":
        if isinstance(o, V3):  # Hadamard product
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, s: torch.Tensor) -> "V3":
        # `s` must be a tensor: on CUDA, PyTorch turns division by a Python
        # scalar into a multiply by its reciprocal, which rounds differently.
        return V3(self.x / s, self.y / s, self.z / s)

    def __neg__(self) -> "V3":
        return V3(-self.x, -self.y, -self.z)


def splat(c: Scalar) -> V3:
    return V3(c, c, c)


def dot(a: V3, b: V3) -> Scalar:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """a * (1 / sqrt(|a|^2)): both steps are IEEE-rounded on every device,
    so the CUDA kernels reproduce it exactly (a hardware rsqrt would not)."""
    return a * (1.0 / torch.sqrt(dot(a, a)))


def reflect(v: V3, n: V3) -> V3:
    return v - n * (2.0 * dot(v, n))


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    """Per-lane select of whole vectors."""
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def max_component(a: V3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def sum_components(a: V3) -> torch.Tensor:
    return a.x + a.y + a.z


def min_components(a: V3, cap: float) -> V3:
    """Per-channel min against a scalar (the NEE clamp)."""
    return V3(
        torch.clamp(a.x, max=cap),
        torch.clamp(a.y, max=cap),
        torch.clamp(a.z, max=cap),
    )
