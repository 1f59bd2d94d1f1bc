"""The block-culled traversal (``--accel grid``) —
``terminal_raytracer_tpu/ops/accel.py``.

:func:`blocked_scene` reorders the scene as the JAX package does: within
each primitive type, emissive primitives first in their original order
(the NEE light list and every RNG gate depend on it), the rest in Morton
order of their AABB centroids; each type padded to a multiple of BLOCK
with primitives parked at 1e30, which can never hit. Each block of BLOCK
gets an AABB over its real members, padded against f32 rounding; the
planes form one unguarded group. The sweep visits the groups in order and
skips a guarded block whose box the ray segment [t_min, closest) misses.
A block's box holds all its primitives, so a skipped block holds no
closer hit, and the culled sweep equals the dense sweep over the blocked
order (the JAX package's oracle) but for far rays, where f32 rounding
moves a test's hit outside the padded box (:class:`CulledPrims`). The
kernels (csrc/traverse.cuh ``Culled``) cull per thread, and so does their
plain version, :class:`CulledPrims`.

The scene buffer (ops/geometry.py scene_tables, accel='grid') holds the
blocked scene, with the baked sweep's f64 r^2, and after its other
sections the group table: per group its kind, first index within its
kind, count, guard flag and the box lo / hi, each bound rounded to f32
once from the f64 value, as the JAX package folds it.

The TPU culls per (16, 128) tile with one ``any()`` over ~2,048 lanes; on
the GPU a thread culls for itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import scene as scene_mod
from . import geometry as geom

BLOCK = 8

# Pad primitives parked far outside every real block AABB: they can never
# hit within T_FAR and never widen a block's box (boxes span real members
# only).
_PAD_POS = 1.0e30

_BIG = 3.0e38  # slab-test sentinel (< f32 inf; avoids inf*0 NaN paths)

# Group table row (csrc/traverse.cuh reads the same layout): kind (0
# sphere, 1 plane, 2 triangle), first index within the kind, count, guarded
# (1) or not (0), box lo xyz, box hi xyz.
GROUP_W = 10

# FP32 subtracts and multiplies of one slab test (csrc/traverse.cuh
# slab_hit), and the three reciprocals of the direction a sweep takes once.
SLAB_OPS = 12
SLAB_SETUP_OPS = 3



def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits: b9..b0 -> every third bit position."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(cx: np.ndarray, cy: np.ndarray, cz: np.ndarray) -> np.ndarray:
    """30-bit Morton code from 10-bit cell coordinates."""
    return _part1by2(cx) | (_part1by2(cy) << 1) | (_part1by2(cz) << 2)


def _centroid_cells(boxes: np.ndarray) -> np.ndarray:
    """Quantize AABB centroids to a 1024^3 lattice over the scene bbox."""
    cen = boxes.mean(axis=1)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-12)
    return np.clip(((cen - lo) / span) * 1023.0, 0.0, 1023.0).astype(
        np.uint64)


@dataclasses.dataclass(frozen=True)
class Group:
    """One sweep unit: its primitives (kind, primitive) in dense order and
    its box ((lo xyz), (hi xyz)) as Python floats, or None: unguarded,
    always swept (the planes)."""

    prims: tuple
    aabb: Optional[Tuple[Tuple[float, float, float],
                         Tuple[float, float, float]]]


def _pad_material() -> scene_mod.Material:
    return scene_mod.Material(color=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
                              reflectivity=0.0)


def _pad_sphere() -> scene_mod.Sphere:
    return scene_mod.Sphere(center=(_PAD_POS, _PAD_POS, _PAD_POS),
                            radius=1.0, material=_pad_material())


def _pad_triangle() -> scene_mod.Triangle:
    p = (_PAD_POS, _PAD_POS, _PAD_POS)
    return scene_mod.Triangle(v0=p, v1=p, v2=p, material=_pad_material())


def _order_group(prims: list) -> list:
    """Emissive primitives first (original relative order), the rest in
    Morton order of their f32 AABB centroids (stable)."""
    lights = [p for p in prims if p.material.is_light]
    rest = [p for p in prims if not p.material.is_light]
    if len(rest) > 1:
        boxes = []
        for p in rest:
            if isinstance(p, scene_mod.Sphere):
                c = np.asarray(p.center, np.float32)
                r = np.float32(p.radius)
                boxes.append((c - r, c + r))
            else:
                v = np.stack([p.v0, p.v1, p.v2]).astype(np.float32)
                boxes.append((v.min(0), v.max(0)))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 2, 3)
        cells = _centroid_cells(boxes)
        codes = morton3(cells[:, 0], cells[:, 1], cells[:, 2])
        order = np.argsort(codes, kind="stable")
        rest = [rest[i] for i in order]
    return lights + rest


def _block_aabb(kind: int, members: list):
    """(lo, hi) Python-float triples over the block's real members, in f64,
    padded by 1e-4 + 1e-5 |x| against f32 rounding in the slab test."""
    boxes = []
    for p in members:
        if kind == scene_mod.SPHERE:
            c = np.asarray(p.center, np.float64)
            boxes.append((c - float(p.radius), c + float(p.radius)))
        else:
            v = np.stack([p.v0, p.v1, p.v2]).astype(np.float64)
            boxes.append((v.min(0), v.max(0)))
    lo = np.min([b[0] for b in boxes], axis=0)
    hi = np.max([b[1] for b in boxes], axis=0)
    eps = 1e-4 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    lo, hi = lo - eps, hi + eps
    return (tuple(float(v) for v in lo), tuple(float(v) for v in hi))


def blocked_scene(scene: scene_mod.Scene, block: int = BLOCK):
    """(blocked scene, groups): the scene with spheres and triangles
    reordered kind by kind (lights first, the rest in Morton order) and
    padded to a multiple of `block`, and its sweep groups in the blocked
    scene's flatten order: guarded sphere blocks, the unguarded planes,
    guarded triangle blocks."""
    spheres = _order_group(list(scene.spheres))
    triangles = _order_group(list(scene.triangles))

    def padded(prims, mk_pad):
        if not prims:
            return prims
        return prims + [mk_pad() for _ in range((-len(prims)) % block)]

    spheres_p = padded(spheres, _pad_sphere)
    triangles_p = padded(triangles, _pad_triangle)
    scene2 = dataclasses.replace(scene, spheres=tuple(spheres_p),
                                 triangles=tuple(triangles_p))

    groups: List[Group] = []
    for i in range(0, len(spheres_p), block):
        members = spheres_p[i:i + block]
        real = [p for p in members if p.center[0] != _PAD_POS]
        groups.append(Group(tuple((scene_mod.SPHERE, p) for p in members),
                            _block_aabb(scene_mod.SPHERE, real)))
    if scene.planes:
        groups.append(Group(tuple((scene_mod.PLANE, p) for p in scene.planes),
                            None))
    for i in range(0, len(triangles_p), block):
        members = triangles_p[i:i + block]
        real = [p for p in members if p.v0[0] != _PAD_POS]
        groups.append(Group(tuple((scene_mod.TRIANGLE, p) for p in members),
                            _block_aabb(scene_mod.TRIANGLE, real)))
    return scene2, groups


def group_table(groups: List[Group]) -> np.ndarray:
    """The f32 group table [n_groups, GROUP_W] (module docstring)."""
    out = np.zeros((len(groups), GROUP_W), np.float32)
    first = {scene_mod.SPHERE: 0, scene_mod.PLANE: 0, scene_mod.TRIANGLE: 0}
    for g, grp in enumerate(groups):
        kind = grp.prims[0][0]
        out[g, :3] = (kind, first[kind], len(grp.prims))
        first[kind] += len(grp.prims)
        if grp.aabb is not None:
            out[g, 3] = 1.0
            out[g, 4:] = (*grp.aabb[0], *grp.aabb[1])
    return out


def slab_interval(o, d, lo, hi):
    """(tn, tf): where each ray's line enters and leaves each box, in the
    kernels' f32 expressions (csrc/traverse.cuh slab_hit): o and d lanes
    with a trailing box axis, lo / hi [n_boxes, 3]. A zero direction
    component is parallel: inside the slab always, outside never. fmin /
    fmax take the number over a NaN, as fminf / fmaxf do. The segment
    [t_min, t_max) meets the box iff tn <= tf, tn < t_max and tf > t_min."""
    tn = torch.full(torch.broadcast_shapes(o.x.shape, lo[:, 0].shape),
                    -_BIG, device=lo.device)
    tf = torch.full_like(tn, _BIG)
    for ax, (oc, dc) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
        par = dc == 0.0
        inv = 1.0 / torch.where(par, 1.0, dc)
        t0 = (lo[:, ax] - oc) * inv
        t1 = (hi[:, ax] - oc) * inv
        inside = (oc >= lo[:, ax]) & (oc <= hi[:, ax])
        a_min = torch.where(par, torch.where(inside, -_BIG, _BIG),
                            torch.fmin(t0, t1))
        a_max = torch.where(par, torch.where(inside, _BIG, -_BIG),
                            torch.fmax(t0, t1))
        tn = torch.fmax(tn, a_min)
        tf = torch.fmin(tf, a_max)
    return tn, tf


class CulledPrims(geom.ScenePrims):
    """The culled sweep in plain PyTorch, over the blocked scene's tables:
    per lane, the groups in order, a guarded block skipped where the lane's
    segment [t_min, closest) (shadow rays: [t_min, t_max)) misses its box,
    as the kernels skip it. The boxes are padded, so the culled sweep
    equals the dense sweep over the blocked order (ScenePrims, the JAX
    package's oracle), but for a ray whose f32 test finds a hit outside the
    padded box: far from the scene (a floor hit near the horizon, |o| in
    the thousands) f32 rounding moves a sphere test's hit by more than the
    pad, and the culled sweep then skips it where the dense one does not.

    The primitives' tests run densely, each group's first minimum taken
    (which picks the winner the kernels' chained tests pick), and the
    groups are then visited in order with the running closest hit. While
    counting (``ops`` set), it adds the gated lanes' box tests, blocks swept
    and skipped and primitive tests (STATS) to ``stats`` and their FP32
    operations (geometry.TEST_OPS, SLAB_OPS, SLAB_SETUP_OPS) to ``ops``."""

    # The kernels' counters (PathTracer.accel_stats) and these: sweeps,
    # guarded blocks swept, guarded blocks skipped, primitive tests.
    STATS = ("sweeps", "blocks swept", "blocks skipped", "tests")

    def __init__(self, tables: geom.SceneTables):
        super().__init__(tables)
        g = tables.acc.view(-1, GROUP_W)
        self._lo, self._hi = g[:, 4:7], g[:, 7:10]
        n_sph, n_pln, n_tri = self._counts
        # The layout of group_table: blocks of BLOCK spheres, the planes,
        # blocks of BLOCK triangles.
        kinds = ([scene_mod.SPHERE] * (n_sph // BLOCK)
                 + [scene_mod.PLANE] * (n_pln > 0)
                 + [scene_mod.TRIANGLE] * (n_tri // BLOCK))
        if (n_sph % BLOCK or n_tri % BLOCK
                or g[:, 0].tolist() != [float(k) for k in kinds]):
            raise ValueError("tables without a blocked scene's group table")
        self._guarded_host = [k != scene_mod.PLANE for k in kinds]
        self._guarded = g[:, 3] != 0.0
        base = torch.tensor([0, n_sph, n_sph + n_pln], device=g.device)
        self._start = base[g[:, 0].long()] + g[:, 1].long()
        self._end = self._start + g[:, 2].long()

    def _group_reduce(self, t, reduce):
        """Per group of the dense per-primitive `t` [..., n_prims]:
        reduce(slice) -> (value, index within the slice), as [..., G]
        tensors with the index made global."""
        n_sph, n_pln, n_tri = self._counts
        vals, idxs = [], []
        for start, n, block in ((0, n_sph, BLOCK), (n_sph, n_pln, n_pln),
                                (n_sph + n_pln, n_tri, BLOCK)):
            if n:
                v, j = reduce(t[..., start:start + n].unflatten(-1, (-1,
                                                                    block)))
                vals.append(v)
                idxs.append(j + start + torch.arange(0, n, block,
                                                     device=t.device))
        return torch.cat(vals, -1), torch.cat(idxs, -1)

    def _count(self, gate, tested, executed, last):
        """Add the gated lanes' counts, from per lane and group: `tested`,
        the guarded groups whose box the lane tests, `executed`, the groups
        whose primitives it tests, and `last`, the end of those tests."""
        swept = executed & self._guarded
        w = gate.to(torch.float64)
        n_tested = (tested.sum(-1) * w).sum()
        n_swept = (swept.sum(-1) * w).sum()
        tests = (executed * (last - self._start)).sum(-1)
        cum = torch.nn.functional.pad(self._cum_ops, (1, 0))
        test_ops = (executed * (cum[last] - cum[self._start])).sum(-1)
        self.stats += torch.stack([w.sum(), n_swept, n_tested - n_swept,
                                   (tests * w).sum()])
        any_guarded = float(any(self._guarded_host))
        self._ops += ((test_ops * w).sum() + SLAB_OPS * n_tested
                      + SLAB_SETUP_OPS * any_guarded * w.sum())

    def closest_hit(self, o, d, t_min=geom.RAY_EPS, t_max=geom.T_FAR,
                    gate=None) -> geom.Hit:
        closest = torch.full_like(o.x, t_max)
        idx = torch.full(o.x.shape, self.n_prims, dtype=torch.int64,
                         device=o.x.device)
        if not self.n_prims:
            return self.hit_at(o, d, closest < t_max, closest, idx)
        t = self._tests(o, d, t_min, t_max, blocked=False)
        t = torch.where((t > 0.0) & (t < t_max), t, float("inf"))
        gmin, garg = self._group_reduce(t, lambda v: v.min(-1))
        tn, tf = slab_interval(geom._lanes(o), geom._lanes(d), self._lo,
                               self._hi)
        entered = (tn <= tf) & (tf > t_min)
        met = []
        for g, guarded in enumerate(self._guarded_host):
            win = gmin[..., g] < closest
            if guarded:
                met.append(entered[..., g] & (tn[..., g] < closest))
                win = win & met[-1]
            closest = torch.where(win, gmin[..., g], closest)
            idx = torch.where(win, garg[..., g], idx)
        if self._ops is not None:
            executed = torch.ones_like(entered)
            if met:
                executed[..., self._guarded] = torch.stack(met, -1)
            self._count(gate, self._guarded.expand_as(executed), executed,
                        self._end)
        return self.hit_at(o, d, closest < t_max, closest, idx)

    def occluded(self, o, d, t_min, t_max, gate=None) -> torch.Tensor:
        if not self.n_prims:
            return torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
        hits = self._tests(o, d, t_min, t_max, blocked=True)
        ghit, gfirst = self._group_reduce(
            hits.to(torch.uint8), lambda v: torch.max(v, -1))
        tn, tf = slab_interval(geom._lanes(o), geom._lanes(d), self._lo,
                               self._hi)
        met = (tn <= tf) & (tn < t_max[..., None]) & (tf > t_min)
        executed = met | ~self._guarded
        blocks = executed & (ghit > 0)
        blocked = blocks.any(-1)
        if self._ops is not None:
            n_groups = blocks.shape[-1]
            g_first = torch.where(blocked, torch.argmax(blocks.to(torch.uint8),
                                                        -1), n_groups)
            group = torch.arange(n_groups, device=o.x.device)
            reached = group <= g_first[..., None]
            last = torch.where(group == g_first[..., None], gfirst + 1,
                               self._end)
            self._count(gate, reached & self._guarded, reached & executed,
                        last)
        return blocked
