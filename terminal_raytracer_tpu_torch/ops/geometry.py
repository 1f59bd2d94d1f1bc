"""Ray-primitive intersections and the scene sweep over lanes —
``terminal_raytracer_tpu/ops/geometry.py`` (the baked sweep) and
``ops/arrayscene.py`` (the array sweep).

The JAX package bakes every primitive into the traced program as Python
float constants (``geometry.ScenePrims``), or, above 96 primitives, sweeps
SoA arrays with a loop (``arrayscene.ArrayPrims``) because Mosaic unrolls
the baked sweep's code. The port carries the numbers as tensors in both
cases: :func:`scene_tables` packs a ``models.Scene`` into one f32 buffer
whose derived values (sphere r^2 and 1/r, plane unit normals, triangle
edges, normals and areas, light areas) are computed on the host exactly as
the JAX package computes its constants. The plain sweep below and the CUDA
kernels (csrc/trace.cuh) read that buffer, so all of them compute from the
same numbers, and the array traversal runs through the same code. The one
value the two JAX traversals derive differently is a sphere's r^2: the
baked sweep squares the scene's f64 radius on the host, the array sweep
squares the f32 radius in f32 (``accel`` selects which).

Semantics kept from the JAX package: sweep order spheres, planes,
triangles; "strictly closer wins" (the winner is the first primitive in
sweep order at the smallest valid t); the winner's index selects the
material; sphere normals are normalize((p - c) * inv_r); the normal is
flipped to face the ray. The JAX sweeps and the kernels feed the running
`closest` forward as each test's t_max; the plain sweep tests every
primitive at once against T_FAR and takes the first minimum, which picks
the same winner at the same t: a test whose t_max the chain lowered only
refuses roots at or beyond the current closest, and those never win.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import scene as scene_mod
from . import vecmath as vm
from .vecmath import V3

PLANE_PARALLEL_EPS = 1e-4
TRI_PARALLEL_EPS = 1e-5
RAY_EPS = 1e-3  # t_min / shadow offset / scatter offset
T_FAR = 1e10

MISS = -1.0

# FP32 adds, subtracts, multiplies, divides and square roots of one
# intersection test in csrc/trace.cuh (sphere_t, plane_t, triangle_t):
# the operation count behind chip_smoke.py's bound on the kernels' time.
TEST_OPS = (19, 14, 46)  # sphere, plane, triangle

# Row widths of the packed tables (csrc/trace.cuh reads the same layout).
SPH_W = 5  # cx, cy, cz, r*r, 1/r
PLN_W = 9  # point xyz, raw normal xyz, unit normal xyz
TRI_W = 12  # v0 xyz, edge1 xyz, edge2 xyz, unit normal xyz
MAT_W = 7  # color rgb, emission rgb, reflectivity (primitive order)
LIGHT_W = 17  # kind, emission rgb, area, a xyz, b xyz, c xyz, normal xyz
# Light rows: a sphere light keeps its center in `a` and radius in b.x; a
# triangle light keeps v0, v1, v2 in a, b, c and its normal in `normal`.
# The extension table (primitive order), packed after the light rows only
# for scenes that use a material extension or the texel atlas:
# transparency, ior (0 where transparency is 0), roughness, checker rgb,
# checker scale (0 = unchecked), texture signed id and scale, normal-map
# signed id, scale and strength (models/scene.py texture_channel and
# normal_channel: +id planar, -id spherical, 0 = none).
EXT_W = 12
# ...the same channels as suffixes of the packed layout (ops/dynamic.py).
EXT_KEYS = ("transp", "ior", "rough", "ckr", "ckg", "ckb", "cks", "txi",
            "txs", "nmi", "nmx", "nms")
# The transport and camera extensions (the unbiased and MIS transports,
# fog, depth of field, the stratified sampler, one-light NEE: `xt` tables)
# widen each extension row by the light-inverse-area channel: 1 / area of
# an NEE light (an emissive sphere or triangle), else 0 — the JAX
# package's Hit.light_inv_area, the NEE pdf that the MIS weights compete
# against. With one-light NEE a pick table follows the extension table:
# each light's pick probability, their running sums (the selection
# thresholds) and the reciprocal of the total power (0 for 'uniform').
XT_W = EXT_W + 1
X_LIA = EXT_W
LUM = (0.2126, 0.7152, 0.0722)  # Rec.709 luma, the 'power' pick's weights
FOUR_PI = 4.0 * 3.14159265359


class SceneTables(NamedTuple):
    """One scene as f32 tensors on a device. `buf` is the packed buffer the
    kernels read; the named tables are views into it. `ext` is [0, 0] when
    the buffer carries no extension table (`has_ext`), [n_prims, XT_W]
    for xt tables (`has_xt`); `pick` is [0] without a pick table, else
    [2 * n_lights + 1]; `acc` is the traversal's section, last in the
    buffer (the grid's group table, ops/accel.py, or the gathered walk's
    grid, ops/gathered.py), else [0]. Its offset in `buf` is
    ``acc.storage_offset()``."""

    buf: torch.Tensor
    sph: torch.Tensor  # [n_sph, SPH_W]
    pln: torch.Tensor  # [n_pln, PLN_W]
    tri: torch.Tensor  # [n_tri, TRI_W]
    mat: torch.Tensor  # [n_prims, MAT_W]
    lights: torch.Tensor  # [n_lights, LIGHT_W]
    ext: torch.Tensor  # [n_prims, EXT_W or XT_W]
    pick: torch.Tensor  # probs [n_lights], cums [n_lights], inv_total
    acc: torch.Tensor  # flat f32 (int32 bits where the section says)

    @property
    def counts(self):
        return (self.sph.shape[0], self.pln.shape[0], self.tri.shape[0],
                self.lights.shape[0])

    @property
    def has_ext(self) -> bool:
        return self.ext.shape[1] in (EXT_W, XT_W)

    @property
    def has_xt(self) -> bool:
        return self.ext.shape[1] == XT_W


def uses_extensions(scene: scene_mod.Scene) -> bool:
    """Whether `scene` needs the extension table and the extension kernels:
    a dielectric, a rough metal, a checker, an image texture, a normal map
    or a sky map."""
    return (scene.has_dielectrics or scene.has_rough_metals
            or scene.has_checker or scene.needs_atlas)


def ext_channels(arrays, kind: str):
    """The EXT_KEYS channels of one primitive kind ('sphere', 'plane' or
    'triangle') from models/scene.py Scene.to_arrays()."""
    ckc = arrays[f"{kind}_checker_color"]
    return {"transp": arrays[f"{kind}_transparency"],
            "ior": arrays[f"{kind}_ior"], "rough": arrays[f"{kind}_roughness"],
            "ckr": ckc[:, 0], "ckg": ckc[:, 1], "ckb": ckc[:, 2],
            "cks": arrays[f"{kind}_checker_scale"],
            "txi": arrays[f"{kind}_tex_index"],
            "txs": arrays[f"{kind}_tex_scale"],
            "nmi": arrays[f"{kind}_nm_index"],
            "nmx": arrays[f"{kind}_nm_scale"],
            "nms": arrays[f"{kind}_nm_strength"]}


def ext_table(chans) -> np.ndarray:
    """The extension table [n_prims, EXT_W] from one f32 array per channel
    of EXT_KEYS, in primitive order, with ior zeroed where transparency is
    0 (as the JAX package's baked sweep zeroes it; the tracer reads ior
    only where transparency > 0)."""
    cols = [np.asarray(chans[k], np.float32) for k in EXT_KEYS]
    cols[1] = np.where(cols[0] > 0.0, cols[1], np.float32(0.0))
    return np.stack(cols, 1).astype(np.float32)


def sq_len_f32(v) -> np.float32:
    """|v|^2 of an f32 3-vector as (x*x + y*y) + z*z, each step rounded to
    f32. The JAX package's host constants take np.dot here, whose BLAS
    rounding differs from this by an ulp on some mesh triangles (and from
    machine to machine); the port takes the stepwise sum that its own and
    the JAX package's runtime-value paths take, so a static scene and its
    animated copy at t = 0 share their tables bit for bit."""
    return np.float32(np.float32(v[0] * v[0]) + np.float32(v[1] * v[1])) \
        + np.float32(v[2] * v[2])


def _tri_edges_f32(tri):
    """Triangle edges, unit normal and area in f32 steps, as the JAX
    package's geometry._tri_edges_f32 computes them (but for sq_len_f32)."""
    v0 = np.asarray(tri.v0, np.float32)
    e1 = np.asarray(tri.v1, np.float32) - v0
    e2 = np.asarray(tri.v2, np.float32) - v0
    cr = np.cross(e1, e2).astype(np.float32)
    cr_len = np.sqrt(sq_len_f32(cr))
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (cr / cr_len).astype(np.float32)
    area = np.float32(0.5) * cr_len
    return e1, e2, normal, area


def tables_from_parts(parts, device, acc=None) -> SceneTables:
    """One packed buffer on `device` from the (sph, pln, tri, mat, lights[,
    ext[, pick]]) f32 arrays or tensors and the traversal's section `acc`
    (flat f32, or None), with the named tables as views into it."""
    flat = [torch.as_tensor(a).reshape(-1) for a in parts]
    if acc is not None:
        flat.append(torch.as_tensor(acc).reshape(-1))
    # One trailing pad element keeps the buffer non-empty for an empty scene.
    pad = torch.zeros(1, dtype=torch.float32, device=flat[0].device)
    buf = torch.cat(flat + [pad]).to(device)
    views, off = [], 0
    for a in parts:
        n = int(np.prod(a.shape))
        views.append(buf[off:off + n].view(tuple(a.shape)))
        off += n
    if len(views) == 5:  # no extension table
        views.append(buf[off:off].view(0, 0))
    if len(views) == 6:  # no pick table
        views.append(buf[off:off])
    n_acc = 0 if acc is None else flat[-1].numel()
    return SceneTables(buf, *views, buf[off:off + n_acc])


def pick_table(lights, mode: str, runtime: bool = False) -> np.ndarray:
    """One-light NEE's packed f32 pick table [probs, cums, inv_total] over
    `lights`, a list of (kind, (er, eg, eb), sphere radius or triangle
    area), as the JAX package's PathTracer._light_pick computes it,
    expression for expression: 'uniform' picks 1/L each (inv_total 0);
    'power' picks by Rec.709 luminance x area. A baked scene's values
    (Python floats) fold in f64 as the JAX package folds them, rounded to
    f32 where they are stored; `runtime` values (np.float32, an animated
    scene's) take the f32 steps of its traced scalars."""
    n = len(lights)
    if mode == "uniform":
        probs, inv_total = [1.0 / n] * n, 0.0
    else:
        lw = [np.float32(c) for c in LUM] if runtime else LUM
        four_pi = np.float32(FOUR_PI) if runtime else FOUR_PI
        powers = []
        for kind, (ex, ey, ez), size in lights:
            lum = lw[0] * ex + lw[1] * ey + lw[2] * ez
            area = four_pi * size * size if kind == scene_mod.SPHERE else size
            powers.append(lum * area)
        total = powers[0]
        for pw in powers[1:]:
            total = total + pw
        total = (max(total, 1e-20) if isinstance(total, float)
                 else np.maximum(total, np.float32(1e-20)))
        inv_total = 1.0 / total
        probs = [pw * inv_total for pw in powers]
    cums, acc = [], 0.0
    for pr in probs:
        acc = acc + pr
        cums.append(acc)
    return np.array([*probs, *cums, inv_total], np.float32)


def scene_tables(scene: scene_mod.Scene, device, accel: str = "baked",
                 ext: bool = False, xt: bool = False,
                 pick: str = None) -> SceneTables:
    """Pack `scene` into f32 tables on `device` (see the module docstring).
    accel='array' squares the f32 radius in f32, as the JAX package's array
    sweep does; 'baked' squares the f64 radius. 'grid' packs the blocked
    scene (ops/accel.py blocked_scene) as 'baked' does, with its group
    table; 'gathered' packs the scene as 'array' does (the walk squares
    the f32 radius), with its grid (ops/gathered.py). `ext` packs the
    extension table; `xt` widens it by the light-inverse-area channel;
    `pick` ('uniform' or 'power') adds the pick table of one-light NEE."""
    acc = None
    if accel == "grid":
        from . import accel as accel_mod

        scene, groups = accel_mod.blocked_scene(scene)
        acc = accel_mod.group_table(groups)
    elif accel == "gathered":
        from . import gathered as gathered_mod

        acc = gathered_mod.grid_section(scene)
    sph = np.zeros((len(scene.spheres), SPH_W), np.float32)
    for i, s in enumerate(scene.spheres):
        r = float(s.radius)
        r32 = np.float32(r)
        rr = r32 * r32 if accel in ("array", "gathered") else r * r
        sph[i] = (*s.center, rr, np.float32(1.0) / r32)
    pln = np.zeros((len(scene.planes), PLN_W), np.float32)
    for i, p in enumerate(scene.planes):
        n = np.asarray(p.normal, np.float32)
        pln[i] = (*p.point, *p.normal, *(n / np.sqrt(sq_len_f32(n))))
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
    if ext or xt:
        a = scene.to_arrays()
        chans = [ext_channels(a, kind)
                 for kind in ("sphere", "plane", "triangle")]
        parts.append(ext_table({k: np.concatenate([c[k] for c in chans])
                                for k in EXT_KEYS}))
    if xt:
        parts[-1] = np.concatenate([parts[-1], light_inv_area(scene)[:, None]],
                                   1)
    if pick is not None:
        parts.append(pick_table(
            [(tag, p.material.emission,
              float(p.radius if tag == scene_mod.SPHERE
                    else _tri_edges_f32(p)[3])) for tag, p in scene.lights],
            pick))
    return tables_from_parts([torch.from_numpy(a) for a in parts], device,
                             None if acc is None else torch.from_numpy(acc))


def light_inv_area(scene: scene_mod.Scene) -> np.ndarray:
    """The light-inverse-area channel in primitive order, as the JAX
    package's baked and array sweeps fold it: 1 / (4 pi r^2) in f64 for a
    sphere light, 1 / area (the f32 area) for a triangle light, 0 for
    every other primitive; rounded to f32 once."""
    lia = np.zeros(scene.primitive_count, np.float32)
    for i, (tag, p) in enumerate(scene.primitives):
        if p.material.is_light and tag == scene_mod.SPHERE:
            lia[i] = 1.0 / (FOUR_PI * float(p.radius) ** 2)
        elif p.material.is_light and tag == scene_mod.TRIANGLE:
            lia[i] = 1.0 / _tri_edges_f32(p)[3]
    return lia


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
    """Per-lane closest-hit record. `normal` is already flipped to face the
    incoming ray; `front` says whether it had to be (False = flipped). The
    extension channels (EXT_KEYS) are None unless the tables carry them,
    and `lia` (the light-inverse-area channel, 0 on a back face: NEE never
    reaches one) unless they are xt tables."""

    found: torch.Tensor
    t: torch.Tensor
    p: V3
    normal: V3
    color: V3
    emission: V3
    reflectivity: torch.Tensor
    front: torch.Tensor = None
    transparency: torch.Tensor = None
    ior: torch.Tensor = None
    roughness: torch.Tensor = None
    checker_color: V3 = None
    checker_scale: torch.Tensor = None
    tex_index: torch.Tensor = None
    tex_scale: torch.Tensor = None
    nm_index: torch.Tensor = None
    nm_scale: torch.Tensor = None
    nm_strength: torch.Tensor = None
    lia: torch.Tensor = None


def _row3(t, col):
    return V3(t[..., col], t[..., col + 1], t[..., col + 2])


def _lanes(v: V3) -> V3:
    """A lane field with a trailing primitive axis to broadcast against."""
    return V3(v.x[..., None], v.y[..., None], v.z[..., None])


class ScenePrims:
    """Closest-hit and occlusion sweeps over one scene's tables, every
    primitive of a kind at once along a trailing axis.

    ``ops``: None, or a 0-dim f64 tensor to which each sweep adds the FP32
    operations (``TEST_OPS``) of the intersection tests it owes: every
    primitive for a closest hit, and for a shadow ray the primitives up to
    and including its first blocker in sweep order, where the kernels'
    occlusion loop stops. Only lanes of the sweep's `gate` count. While
    counting, a traversal with counters (STATS, ops/accel.py and
    ops/gathered.py) adds them to ``stats``."""

    STATS: tuple = ()

    def __init__(self, tables: SceneTables):
        self.tables = tables
        n_sph, n_pln, n_tri, _ = tables.counts
        self.n_prims = n_sph + n_pln + n_tri
        self._sph = (_row3(tables.sph, 0), tables.sph[:, 3])
        self._pln = (_row3(tables.pln, 0), _row3(tables.pln, 3))
        self._tri = (_row3(tables.tri, 0), _row3(tables.tri, 3),
                     _row3(tables.tri, 6))
        dev = tables.buf.device
        # Gather tables indexed by winner: unit normal (planes, triangles),
        # center and 1/r (spheres), sphere flag. Row n_prims is the miss.
        const_n = torch.zeros((self.n_prims + 1, 3), dtype=torch.float32,
                              device=dev)
        center = torch.zeros_like(const_n)
        inv_r = torch.zeros((self.n_prims + 1,), dtype=torch.float32,
                            device=dev)
        is_sph = torch.zeros((self.n_prims + 1,), dtype=torch.bool, device=dev)
        const_n[n_sph:n_sph + n_pln] = tables.pln[:, 6:9]
        const_n[n_sph + n_pln:self.n_prims] = tables.tri[:, 9:12]
        center[:n_sph] = tables.sph[:, 0:3]
        inv_r[:n_sph] = tables.sph[:, 4]
        is_sph[:n_sph] = True
        mat = torch.zeros((self.n_prims + 1, tables.mat.shape[1]),
                          dtype=torch.float32, device=dev)
        mat[:self.n_prims] = tables.mat
        self._ext = None
        if tables.has_ext:
            self._ext = torch.zeros((self.n_prims + 1, tables.ext.shape[1]),
                                    dtype=torch.float32, device=dev)
            self._ext[:self.n_prims] = tables.ext
        self._const_n, self._center, self._inv_r = const_n, center, inv_r
        self._is_sph, self._mat = is_sph, mat
        self._counts = (n_sph, n_pln, n_tri)
        self._ops = self.stats = None

    @property
    def ops(self):
        return self._ops

    @ops.setter
    def ops(self, value):
        """Start (a 0-dim f64 tensor) or stop (None) counting."""
        self.stats = None
        if value is not None:
            cost = np.repeat(np.asarray(TEST_OPS, np.float64), self._counts)
            self._cum_ops = torch.from_numpy(np.cumsum(cost)).to(value.device)
            if self.STATS:
                self.stats = torch.zeros(len(self.STATS), dtype=torch.float64,
                                         device=value.device)
        self._ops = value

    def _tests(self, o: V3, d: V3, t_min, t_max, blocked: bool):
        """Per lane and primitive, in sweep order: the hit distance (MISS
        where none) or, for shadow rays, whether it blocks."""
        o, d = _lanes(o), _lanes(d)
        if blocked:
            t_max = t_max[..., None]
        n_sph, n_pln, n_tri = self._counts
        cols = []
        if n_sph:
            t, hit = _sphere_t(o, d, *self._sph, t_min, t_max)
            cols.append(hit if blocked else torch.where(hit, t, MISS))
        if n_pln:
            cols.append(blocked_plane(o, d, *self._pln, t_min, t_max)
                        if blocked else
                        intersect_plane(o, d, *self._pln, t_min, t_max))
        if n_tri:
            t, hit = _triangle_t(o, d, *self._tri, t_min, t_max)
            cols.append(hit if blocked else torch.where(hit, t, MISS))
        return torch.cat(cols, -1)

    def closest_hit(self, o: V3, d: V3, t_min=RAY_EPS, t_max=T_FAR,
                    gate=None) -> Hit:
        if self.n_prims:
            t = self._tests(o, d, t_min, t_max, blocked=False)
            t = torch.where((t > 0.0) & (t < t_max), t, float("inf"))
            closest, idx = torch.min(t, -1)  # the first minimum on ties
        else:
            closest = torch.full_like(o.x, float("inf"))
            idx = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
        found = closest < t_max
        closest = torch.where(found, closest, t_max)
        idx = torch.where(found, idx, self.n_prims)
        if self._ops is not None and self.n_prims:
            self._ops += gate.sum(dtype=torch.float64) * self._cum_ops[-1]
        return self.hit_at(o, d, found, closest, idx)

    def hit_at(self, o: V3, d: V3, found, closest, idx) -> Hit:
        """The hit record of primitive `idx` (n_prims where not `found`) at
        distance `closest` along each ray."""
        p = o + d * closest
        m = self._mat[idx]
        n_sph = vm.normalize((p - _row3(self._center[idx], 0))
                             * self._inv_r[idx])
        normal = vm.where(self._is_sph[idx], n_sph,
                          _row3(self._const_n[idx], 0))
        front = vm.dot(d, normal) < 0.0
        normal = vm.where(front, normal, -normal)
        hit = Hit(found, closest, p, normal, _row3(m, 0), _row3(m, 3),
                  m[..., 6], front)
        if self._ext is None:
            return hit
        e = self._ext[idx]
        hit = hit._replace(
            transparency=e[..., 0], ior=e[..., 1], roughness=e[..., 2],
            checker_color=_row3(e, 3), checker_scale=e[..., 6],
            tex_index=e[..., 7], tex_scale=e[..., 8], nm_index=e[..., 9],
            nm_scale=e[..., 10], nm_strength=e[..., 11])
        if e.shape[-1] == XT_W:
            hit = hit._replace(lia=torch.where(front, e[..., X_LIA], 0.0))
        return hit

    def occluded(self, o: V3, d: V3, t_min, t_max, gate=None) -> torch.Tensor:
        """Any-hit visibility test for shadow rays (`t_max` per lane)."""
        if not self.n_prims:
            return torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
        hits = self._tests(o, d, t_min, t_max, blocked=True)
        blocked = hits.any(-1)
        if self._ops is not None:
            first = torch.argmax(hits.to(torch.uint8), -1)  # first blocker
            ops = torch.where(blocked, self._cum_ops[first],
                              self._cum_ops[-1])
            self._ops += torch.where(gate, ops, 0.0).sum()
        return blocked
