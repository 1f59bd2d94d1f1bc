"""The yardstick's constants: the card's published peaks and the FP32
operations of the intersection tests a traversal sweep owes."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}

# FP32 adds, subtracts, multiplies, divides and square roots of one
# intersection test (sphere, plane, triangle), as the port's kernels
# compute them (its ops/geometry.py TEST_OPS over csrc/trace.cuh).
TEST_OPS = {"spheres": 19, "planes": 14, "triangles": 46}


def peak(device_name: str):
    """The peaks of a card by its name, or None for a card not listed."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def ops_per_sweep(cfg: dict) -> int:
    """The FP32 operations of one sweep's intersection tests over every
    primitive of a scene configuration: a closest-hit sweep tests each
    primitive once; a shadow sweep is counted as a whole sweep too."""
    return sum(n * len(cfg.get(kind, [])) for kind, n in TEST_OPS.items())
