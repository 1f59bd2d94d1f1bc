"""Ray-primitive intersections and the scene sweep over lanes —
``terminal_raytracer_tpu/ops/geometry.py``.

The JAX package bakes every primitive into the traced program as Python
float constants (``geometry.ScenePrims``). The port carries the same
numbers as tensors instead: :func:`scene_tables` packs a ``models.Scene``
into one f32 buffer whose derived values (sphere r^2 and 1/r, plane unit
normals, triangle edges, normals and areas, light areas) are computed on
the host exactly as the JAX package computes its constants. The plain sweep
below and both CUDA kernels (csrc/trace.cuh) read that buffer, so all three
compute from the same numbers.

Semantics kept from the JAX package: sweep order spheres, planes,
triangles; "strictly closer wins" with the running `closest` fed forward as
each test's t_max; the winner's index selects the material; sphere normals
are normalize((p - c) * inv_r); the normal is flipped to face the ray.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from terminal_raytracer_tpu.models import scene as scene_mod

from . import vecmath as vm
from .vecmath import V3

PLANE_PARALLEL_EPS = 1e-4
TRI_PARALLEL_EPS = 1e-5
RAY_EPS = 1e-3  # t_min / shadow offset / scatter offset
T_FAR = 1e10

MISS = -1.0

# Row widths of the packed tables (csrc/trace.cuh reads the same layout).
SPH_W = 5  # cx, cy, cz, r*r, 1/r
PLN_W = 9  # point xyz, raw normal xyz, unit normal xyz
TRI_W = 12  # v0 xyz, edge1 xyz, edge2 xyz, unit normal xyz
MAT_W = 7  # color rgb, emission rgb, reflectivity (primitive order)
LIGHT_W = 17  # kind, emission rgb, area, a xyz, b xyz, c xyz, normal xyz
# Light rows: a sphere light keeps its center in `a` and radius in b.x; a
# triangle light keeps v0, v1, v2 in a, b, c and its normal in `normal`.


class SceneTables(NamedTuple):
    """One scene as f32 tensors on a device. `buf` is the packed buffer the
    kernels read; the named tables are views into it."""

    buf: torch.Tensor
    sph: torch.Tensor  # [n_sph, SPH_W]
    pln: torch.Tensor  # [n_pln, PLN_W]
    tri: torch.Tensor  # [n_tri, TRI_W]
    mat: torch.Tensor  # [n_prims, MAT_W]
    lights: torch.Tensor  # [n_lights, LIGHT_W]

    @property
    def counts(self):
        return (self.sph.shape[0], self.pln.shape[0], self.tri.shape[0],
                self.lights.shape[0])


def _tri_edges_f32(tri):
    """Triangle edges, unit normal and area in f32, exactly as the JAX
    package's geometry._tri_edges_f32 computes them."""
    v0 = np.asarray(tri.v0, np.float32)
    e1 = np.asarray(tri.v1, np.float32) - v0
    e2 = np.asarray(tri.v2, np.float32) - v0
    cr = np.cross(e1, e2).astype(np.float32)
    cr_len = np.float32(np.sqrt(np.float32(np.dot(cr, cr))))
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (cr / cr_len).astype(np.float32)
    area = np.float32(0.5) * cr_len
    return e1, e2, normal, area


def scene_tables(scene: scene_mod.Scene, device) -> SceneTables:
    """Pack `scene` into f32 tables on `device` (see the module docstring)."""
    sph = np.zeros((len(scene.spheres), SPH_W), np.float32)
    for i, s in enumerate(scene.spheres):
        r = float(s.radius)
        sph[i] = (*s.center, r * r, np.float32(1.0) / np.float32(r))
    pln = np.zeros((len(scene.planes), PLN_W), np.float32)
    for i, p in enumerate(scene.planes):
        n = np.asarray(p.normal, np.float32)
        pln[i] = (*p.point, *p.normal, *(n / np.sqrt(np.dot(n, n))))
    tri = np.zeros((len(scene.triangles), TRI_W), np.float32)
    for i, t in enumerate(scene.triangles):
        e1, e2, n, _ = _tri_edges_f32(t)
        tri[i] = (*t.v0, *e1, *e2, *n)
    mats = [p.material for _, p in scene.primitives]
    mat = np.zeros((len(mats), MAT_W), np.float32)
    for i, m in enumerate(mats):
        mat[i] = (*m.color, *m.emission, m.reflectivity)
    lights = np.zeros((len(scene.lights), LIGHT_W), np.float32)
    for i, (tag, p) in enumerate(scene.lights):
        e = p.material.emission
        if tag == scene_mod.SPHERE:
            r = float(p.radius)
            lights[i, :8] = (tag, *e, 4.0 * 3.14159265359 * r * r, *p.center)
            lights[i, 8] = r
        else:
            _, _, n, area = _tri_edges_f32(p)
            lights[i] = (tag, *e, area, *p.v0, *p.v1, *p.v2, *n)
    parts = [sph, pln, tri, mat, lights]
    # One trailing pad element keeps the buffer non-empty for an empty scene.
    buf = torch.from_numpy(
        np.concatenate([a.reshape(-1) for a in parts] + [np.zeros(1, np.float32)])
    ).to(device)
    views, off = [], 0
    for a in parts:
        views.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return SceneTables(buf, *views)


# ---------------------------------------------------------------------------
# Exact-t intersections (closest-hit sweep) and their boolean any-hit forms
# (shadow sweep), each in the JAX package's operation order.
# ---------------------------------------------------------------------------


def _sphere_t(o: V3, d: V3, center: V3, rr, t_min, t_max):
    oc = center - o
    h = vm.dot(d, oc)
    c = vm.dot(oc, oc) - rr
    disc = h * h - c
    sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
    near = h - sqrtd
    far = h + sqrtd
    near_ok = (near > t_min) & (near < t_max)
    far_ok = (far > t_min) & (far < t_max)
    root = torch.where(near_ok, near, far)
    return root, (disc >= 0.0) & (near_ok | far_ok)


def intersect_sphere(o: V3, d: V3, center: V3, rr, t_min, t_max):
    """Hit distance, or -1 for a miss; |d| == 1 assumed. `rr` is the
    radius squared."""
    t, hit = _sphere_t(o, d, center, rr, t_min, t_max)
    return torch.where(hit, t, MISS)


def _plane_t(o: V3, d: V3, point: V3, normal: V3):
    denom = vm.dot(normal, d)
    parallel = torch.abs(denom) < PLANE_PARALLEL_EPS
    t = vm.dot(point - o, normal) / torch.where(parallel, 1.0, denom)
    return t, parallel


def intersect_plane(o: V3, d: V3, point: V3, normal: V3, t_min, t_max):
    """Non-strict t bounds, unlike sphere and triangle."""
    t, parallel = _plane_t(o, d, point, normal)
    hit = ~parallel & (t >= t_min) & (t <= t_max)
    return torch.where(hit, t, MISS)


def _triangle_t(o: V3, d: V3, v0: V3, edge1: V3, edge2: V3, t_min, t_max):
    h = vm.cross(d, edge2)
    a = vm.dot(edge1, h)
    parallel = (a > -TRI_PARALLEL_EPS) & (a < TRI_PARALLEL_EPS)
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, edge1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(edge2, q)
    hit = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, hit


def intersect_triangle(o: V3, d: V3, v0: V3, edge1: V3, edge2: V3, t_min,
                       t_max):
    """Möller-Trumbore on precomputed edges."""
    t, hit = _triangle_t(o, d, v0, edge1, edge2, t_min, t_max)
    return torch.where(hit, t, MISS)


def blocked_sphere(o: V3, d: V3, center: V3, rr, t_min, t_max):
    return _sphere_t(o, d, center, rr, t_min, t_max)[1]


def blocked_plane(o: V3, d: V3, point: V3, normal: V3, t_min, t_max):
    """The shadow sweep's strict upper bound on the plane's t."""
    t, parallel = _plane_t(o, d, point, normal)
    return ~parallel & (t >= t_min) & (t < t_max)


def blocked_triangle(o: V3, d: V3, v0: V3, edge1: V3, edge2: V3, t_min,
                     t_max):
    return _triangle_t(o, d, v0, edge1, edge2, t_min, t_max)[1]


class Hit(NamedTuple):
    """Per-lane closest-hit record, reference channels only. `normal` is
    already flipped to face the incoming ray."""

    found: torch.Tensor
    t: torch.Tensor
    p: V3
    normal: V3
    color: V3
    emission: V3
    reflectivity: torch.Tensor


def _row3(t, col):
    return V3(t[..., col], t[..., col + 1], t[..., col + 2])


class ScenePrims:
    """Closest-hit and occlusion sweeps over one scene's tables."""

    def __init__(self, tables: SceneTables):
        self.tables = tables
        n_sph, n_pln, n_tri, _ = tables.counts
        # Per primitive, in sweep order: (intersect, blocked, args).
        self._prims = []
        for r in tables.sph:
            self._prims.append((intersect_sphere, blocked_sphere,
                                (_row3(r, 0), r[3])))
        for r in tables.pln:
            self._prims.append((intersect_plane, blocked_plane,
                                (_row3(r, 0), _row3(r, 3))))
        for r in tables.tri:
            self._prims.append((intersect_triangle, blocked_triangle,
                                (_row3(r, 0), _row3(r, 3), _row3(r, 6))))
        n_prims = n_sph + n_pln + n_tri
        dev = tables.buf.device
        # Gather tables indexed by winner: unit normal (planes, triangles),
        # center and 1/r (spheres), sphere flag. Row n_prims is the miss.
        const_n = torch.zeros((n_prims + 1, 3), dtype=torch.float32,
                              device=dev)
        center = torch.zeros_like(const_n)
        inv_r = torch.zeros((n_prims + 1,), dtype=torch.float32, device=dev)
        is_sph = torch.zeros((n_prims + 1,), dtype=torch.bool, device=dev)
        const_n[n_sph:n_sph + n_pln] = tables.pln[:, 6:9]
        const_n[n_sph + n_pln:n_prims] = tables.tri[:, 9:12]
        center[:n_sph] = tables.sph[:, 0:3]
        inv_r[:n_sph] = tables.sph[:, 4]
        is_sph[:n_sph] = True
        mat = torch.zeros((n_prims + 1, tables.mat.shape[1]),
                          dtype=torch.float32, device=dev)
        mat[:n_prims] = tables.mat
        self._const_n, self._center, self._inv_r = const_n, center, inv_r
        self._is_sph, self._mat = is_sph, mat
        self._miss_idx = n_prims

    def closest_hit(self, o: V3, d: V3, t_min=RAY_EPS, t_max=T_FAR) -> Hit:
        closest = torch.full_like(o.x, t_max)
        idx = torch.full(o.x.shape, self._miss_idx, dtype=torch.int64,
                         device=o.x.device)
        for k, (isect, _, args) in enumerate(self._prims):
            t = isect(o, d, *args, t_min, closest)
            better = (t > 0.0) & (t < closest)
            closest = torch.where(better, t, closest)
            idx = torch.where(better, k, idx)
        found = closest < t_max
        p = o + d * closest
        m = self._mat[idx]
        n_sph = vm.normalize((p - _row3(self._center[idx], 0))
                             * self._inv_r[idx])
        normal = vm.where(self._is_sph[idx], n_sph,
                          _row3(self._const_n[idx], 0))
        front = vm.dot(d, normal) < 0.0
        normal = vm.where(front, normal, -normal)
        return Hit(found, closest, p, normal, _row3(m, 0), _row3(m, 3),
                   m[..., 6])

    def occluded(self, o: V3, d: V3, t_min, t_max) -> torch.Tensor:
        """Any-hit visibility test for shadow rays."""
        blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
        for _, blk, args in self._prims:
            blocked = blocked | blk(o, d, *args, t_min, t_max)
        return blocked
