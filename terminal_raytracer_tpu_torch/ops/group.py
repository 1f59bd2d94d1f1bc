"""The split sweep of the grouped kernels (csrc/group.cuh GroupSweep) in
plain PyTorch: the model that the CPU tests hold to the serial sweep.

A path group of k lanes carries one ray. Lane j tests primitives j, j + k,
j + 2k, ... of each kind (spheres, planes, triangles) in order, feeding
its own running closest forward as each test's t_max, as the serial sweep
(csrc/trace.cuh closest_hit, k = 1) feeds its one; the lanes' results are
then reduced by (t, then primitive index) over the butterfly of
``__shfl_xor_sync`` (offsets k/2, k/4, ..., 1). A shadow sweep is each
lane's OR over its share, stopping at its first blocker, joined over the
group. Every test is ops/geometry.py's, so the model computes what the
kernels compute, over a batch of rays at once.
"""

from __future__ import annotations

import torch

from . import geometry as geom
from .vecmath import V3

WARP = 32
NONE = 2**31 - 1  # a lane that took nothing (INT_MAX in the kernels)


def _row3(row, col: int) -> V3:
    return V3(row[col], row[col + 1], row[col + 2])


def _check_k(k: int) -> None:
    if k < 1 or k > WARP or k & (k - 1):
        raise ValueError(f"group width {k}: a power of two dividing {WARP}")


def lane_closest(prims: geom.ScenePrims, o: V3, d: V3, j: int, k: int):
    """Lane j's closest over its share: (t, index), (T_FAR, NONE) where it
    took nothing; each f32 [rays] / int64 [rays]."""
    tab = prims.tables
    n_sph, n_pln, n_tri, _ = tab.counts
    closest = torch.full_like(o.x, geom.T_FAR)
    idx = torch.full(o.x.shape, NONE, dtype=torch.int64, device=o.x.device)

    def take(t, hit, i):
        nonlocal closest, idx
        t = torch.where(hit, t, geom.MISS)
        won = (t > 0.0) & (t < closest)
        closest = torch.where(won, t, closest)
        idx = torch.where(won, i, idx)

    for i in range(j, n_sph, k):
        s = tab.sph[i]
        take(*geom._sphere_t(o, d, _row3(s, 0), s[3], geom.RAY_EPS, closest),
             i)
    for i in range(j, n_pln, k):
        q = tab.pln[i]
        t, parallel = geom._plane_t(o, d, _row3(q, 0), _row3(q, 3))
        take(t, ~parallel & (t >= geom.RAY_EPS) & (t <= closest), n_sph + i)
    for i in range(j, n_tri, k):
        q = tab.tri[i]
        take(*geom._triangle_t(o, d, _row3(q, 0), _row3(q, 3), _row3(q, 6),
                               geom.RAY_EPS, closest), n_sph + n_pln + i)
    return closest, idx


def split_closest(prims: geom.ScenePrims, o: V3, d: V3, k: int):
    """The group's closest hit as each of its k lanes holds it after the
    butterfly reduction by (t, then index): a list of k (t, primitive
    index) pairs, (T_FAR, NONE) on a miss."""
    _check_k(k)
    lanes = [lane_closest(prims, o, d, j, k) for j in range(k)]
    off = k // 2
    while off:
        nxt = []
        for j, (t, i) in enumerate(lanes):
            t_o, i_o = lanes[j ^ off]
            take = (t_o < t) | ((t_o == t) & (i_o < i))
            nxt.append((torch.where(take, t_o, t), torch.where(take, i_o, i)))
        lanes = nxt
        off //= 2
    return lanes


def split_occluded(prims: geom.ScenePrims, o: V3, d: V3, t_min, t_max,
                   k: int) -> torch.Tensor:
    """The group's shadow sweep: each lane's OR over its share (the kernel
    stops a lane at its first blocker, which leaves the OR as it is),
    joined over the k lanes."""
    _check_k(k)
    tab = prims.tables
    n_sph, n_pln, n_tri, _ = tab.counts
    blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for j in range(k):
        lane = torch.zeros_like(blocked)
        for i in range(j, n_sph, k):
            s = tab.sph[i]
            lane = lane | geom.blocked_sphere(o, d, _row3(s, 0), s[3],
                                              t_min, t_max)
        for i in range(j, n_pln, k):
            q = tab.pln[i]
            lane = lane | geom.blocked_plane(o, d, _row3(q, 0), _row3(q, 3),
                                             t_min, t_max)
        for i in range(j, n_tri, k):
            q = tab.tri[i]
            lane = lane | geom.blocked_triangle(
                o, d, _row3(q, 0), _row3(q, 3), _row3(q, 6), t_min, t_max)
        blocked = blocked | lane
    return blocked
