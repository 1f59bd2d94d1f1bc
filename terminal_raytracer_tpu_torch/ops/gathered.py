"""The per-thread grid walk (``--accel gathered``) —
``terminal_raytracer_tpu/ops/gathered.py``.

A uniform grid (ops/grid.py, factor DEFAULT_FACTOR) over the spheres and
triangles; the planes sweep densely first, and their closest hit caps the
walk. Each ray walks the cells its segment crosses with a 3-D DDA and a
flat cursor: one step either tests the next primitive of the current cell
or advances one cell. A ray stops when the next cell starts beyond its
closest hit (or, for a shadow ray, at its first blocker), when it leaves
the grid, or after ``max_trips`` steps, a bound no walk reaches. The
walk records (t, winner); the winner's row is read once after it and the
hit merged with the planes' (a plane wins only where the walk found
nothing closer). A primitive spanning several cells is tested once per
cell and the planes come first, so exact ties may pick another winner
than the flatten order: hold the walk against its own plain version and
the JAX package's walk, never the brute sweep.

The scene buffer (ops/geometry.py scene_tables, accel='gathered') holds
the scene as 'array' packs it (the walk squares the f32 radius) and, after
its other sections, the grid (:func:`grid_section`): a header of HDR_W f32
(grid_min, grid_max, cell, 1 / cell, dims, max_trips, cell count, CSR
entry count) and the CSR offsets and indices as int32 bits. Python floats
of the JAX package's folds are rounded to f32 once: grid_max, cell and
1 / cell (each computed in f64). The walk's primitive ids count spheres,
then triangles; its cell coordinates and cursors are ints here (exact
small integers carried as f32 in the JAX package).

:class:`GatheredPrims` is the plain version: every lane steps at once with
masked tensor ops, as the JAX oracle's vector loop does, so a lane's
trip count is the loop's iteration count. The kernels
(csrc/traverse.cuh ``Walk``) walk one ray per thread with its state in
registers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models import scene as scene_mod
from . import geometry as geom
from . import grid as grid_mod
from .vecmath import V3

DEFAULT_FACTOR = 1.5

_BIG = 3.0e38  # < f32 inf: avoids inf*0 NaNs in the slab/DDA math
_PAR_EPS = 1e-12  # |d| below this is parallel to the axis
_ENTRY_EPS = 1e-5  # the entry point is taken this far past the grid box

# Header of the grid section (csrc/traverse.cuh reads the same layout).
HDR_W = 18
H_LO, H_HI, H_CELL, H_INV, H_DIMS = 0, 3, 6, 9, 12
H_TRIPS, H_CELLS, H_NNZ = 15, 16, 17

# FP32 operations of the walk (csrc/traverse.cuh Walk): the entry slab
# test (a reciprocal, two subtracts and two multiplies an axis), the first
# cell and its boundary distances on an active walk, and one DDA advance
# (a divide and an add).
WALK_SLAB_OPS = 15
WALK_CELL_OPS = 28
DDA_STEP_OPS = 2


class WalkResult(NamedTuple):
    """Per lane: the winner's id (spheres, then triangles; -1 for none),
    the closest hit distance (the cap where none), the sphere and triangle
    tests and the DDA advances made, whether the walk entered the grid,
    and whether it stopped at max_trips."""

    best: torch.Tensor
    t_best: torch.Tensor
    sph_tests: torch.Tensor
    tri_tests: torch.Tensor
    advances: torch.Tensor
    entered: torch.Tensor
    capped: torch.Tensor


def grid_section(scene: scene_mod.Scene) -> np.ndarray:
    """The f32 grid section of `scene` (module docstring)."""
    if len(scene.spheres) + len(scene.triangles) == 0:
        raise ValueError("gathered traversal needs spheres/triangles")
    g = grid_mod.build_uniform_grid(dataclasses.replace(scene, planes=()),
                                    factor=DEFAULT_FACTOR)
    dims = [int(v) for v in g.dims]
    grid_min = [float(v) for v in g.grid_min]
    cell = [float(v) for v in 1.0 / np.asarray(g.inv_cell_size, np.float64)]
    grid_max = [grid_min[i] + cell[i] * dims[i] for i in range(3)]
    # A DDA visits at most nx + ny + nz + 1 cells; the tests are bounded by
    # that many of the largest buckets.
    sizes = np.sort(np.diff(g.offsets))[::-1]
    visits = sum(dims) + 2
    max_trips = int(sizes[:visits].sum()) + visits + 4
    hdr = np.array([*grid_min, *grid_max, *cell, *(1.0 / c for c in cell),
                    *dims, max_trips, len(g.offsets) - 1, len(g.indices)],
                   np.float32)
    ints = np.concatenate([g.offsets, g.indices]).astype(np.int32)
    return np.concatenate([hdr, ints.view(np.float32)])


def grid_header(acc: torch.Tensor) -> dict:
    """The grid section's header as host values (Python floats holding the
    f32 values, ints), read from the section `acc` (a device tensor)."""
    hdr = [float(v) for v in acc[:HDR_W].cpu()]
    return {"lo": hdr[H_LO:H_LO + 3], "hi": hdr[H_HI:H_HI + 3],
            "cell": hdr[H_CELL:H_CELL + 3], "inv_cell": hdr[H_INV:H_INV + 3],
            "dims": [int(v) for v in hdr[H_DIMS:H_DIMS + 3]],
            "max_trips": int(hdr[H_TRIPS]), "n_cells": int(hdr[H_CELLS]),
            "nnz": int(hdr[H_NNZ])}


class GatheredPrims(geom.ScenePrims):
    """The walk's plain version over one scene's tables (the module
    docstring). While counting (``ops`` set) it adds the FP32 operations
    of the plane tests, the walk's setup, primitive tests and advances
    that the kernels make on the same rays to ``ops``, and STATS to
    ``stats``, over the lanes of each call's `gate`."""

    # The kernels' counters (PathTracer.accel_stats) and these: walks,
    # primitive tests, DDA advances, walks stopped at max_trips.
    STATS = ("walks", "tests", "advances", "capped")

    def __init__(self, tables: geom.SceneTables):
        super().__init__(tables)
        acc = tables.acc
        h = grid_header(acc)
        self.lo, self.hi, self.cell, self.inv_cell = (
            h["lo"], h["hi"], h["cell"], h["inv_cell"])
        self.dims, self.max_trips = h["dims"], h["max_trips"]
        n_cells, nnz = h["n_cells"], h["nnz"]
        ints = acc[HDR_W:HDR_W + n_cells + 1 + nnz].view(torch.int32).long()
        self._off, self._idx = ints[:n_cells + 1], ints[n_cells + 1:]
        # The divisor's numerator as a device tensor: cell / d must be an
        # IEEE division on CUDA too.
        self._cell_t = torch.tensor(self.cell, dtype=torch.float32,
                                    device=acc.device)

    # -- the walk -------------------------------------------------------

    def _cell_range(self, ix, iy, iz):
        nx, ny, _ = self.dims
        ci = ix + iy * nx + iz * (nx * ny)
        return self._off[ci], self._off[ci + 1]

    def walk_start(self, o: V3, d: V3, t_cap, mask):
        """The walk's entry for every lane whose `mask` is set (None: all):
        (active: the segment meets the grid before `t_cap`, the first cell
        ic [3] (int64), the boundary distances tm [3], the steps stp [3]
        and the distances a cell dt [3])."""
        zeros = torch.zeros_like(o.x)
        t0, t1 = zeros, zeros + _BIG
        comps = ((o.x, d.x), (o.y, d.y), (o.z, d.z))
        invs, pars = [], []
        for ax, (oc, dc) in enumerate(comps):
            par = torch.abs(dc) < _PAR_EPS
            inv = 1.0 / torch.where(par, 1.0, dc)
            a = (self.lo[ax] - oc) * inv
            b = (self.hi[ax] - oc) * inv
            inside = (oc >= self.lo[ax]) & (oc <= self.hi[ax])
            a_min = torch.where(par, torch.where(inside, 0.0, _BIG),
                                torch.minimum(a, b))
            a_max = torch.where(par, torch.where(inside, _BIG, 0.0),
                                torch.maximum(a, b))
            t0 = torch.maximum(t0, a_min)
            t1 = torch.minimum(t1, a_max)
            invs.append(inv)
            pars.append(par)
        active = (t0 <= t1) & (t0 < t_cap)
        if mask is not None:
            active = active & mask
        t_entry = torch.clamp(t0, min=0.0) + _ENTRY_EPS
        ic, tm, stp, dt = [], [], [], []
        for ax, (oc, dc) in enumerate(comps):
            pos = oc + dc * t_entry
            c = torch.clamp(torch.floor((pos - self.lo[ax])
                                        * self.inv_cell[ax]),
                            0.0, float(self.dims[ax] - 1))
            up = dc >= 0.0
            pos_next = self.lo[ax] + (c + torch.where(up, 1.0, 0.0)) \
                * self.cell[ax]
            t_next = torch.abs((pos_next - oc) * invs[ax])
            ic.append(torch.where(active, c, 0.0).long())
            tm.append(torch.where(pars[ax], _BIG, t_next))
            stp.append(torch.where(up, 1, -1))
            dt.append(torch.abs(self._cell_t[ax]
                                / torch.where(pars[ax], 1.0, dc)))
        return active, ic, tm, stp, dt

    def test_at(self, pid, o: V3, d: V3, t_min, t_max):
        """The test of walk ids `pid` (spheres, then triangles; any valid id
        where a lane tests nothing) in (t_min, t_max): (t where it takes a
        hit, else -1; whether the id is a sphere's)."""
        n_sph, _, n_tri = self._counts
        is_s = pid < n_sph
        t = torch.zeros_like(o.x) - 1.0
        if n_sph:
            s = self.tables.sph[torch.clamp(pid, max=n_sph - 1)]
            ts, hit = geom._sphere_t(o, d, geom._row3(s, 0), s[..., 3],
                                     t_min, t_max)
            t = torch.where(hit & is_s, ts, t)
        if n_tri:
            q = self.tables.tri[torch.clamp(pid - n_sph, 0, n_tri - 1)]
            tt, hit = geom._triangle_t(o, d, geom._row3(q, 0),
                                       geom._row3(q, 3), geom._row3(q, 6),
                                       t_min, t_max)
            t = torch.where(hit & ~is_s, tt, t)
        return t, is_s

    def advance(self, adv, ic, tm, stp, dt, t_best):
        """One DDA advance of the lanes `adv` along the axis of the nearest
        boundary, ic and tm updated in place: (done: the lanes whose walk
        ends, the next cell starting beyond t_best or lying outside the
        grid; moved: the lanes that stepped)."""
        use_x = (tm[0] <= tm[1]) & (tm[0] <= tm[2])
        use_y = ~use_x & (tm[1] <= tm[2])
        use = (use_x, use_y, ~use_x & ~use_y)
        t_exit = torch.where(use_x, tm[0], torch.where(use_y, tm[1], tm[2]))
        done = t_exit > t_best
        nxt = []
        for ax in range(3):
            c2 = ic[ax] + stp[ax]
            done = done | (use[ax] & ((c2 < 0) | (c2 >= self.dims[ax])))
            nxt.append(c2)
        done = adv & done
        move = adv & ~done
        for ax in range(3):
            step = move & use[ax]
            ic[ax] = torch.where(step, nxt[ax], ic[ax])
            tm[ax] = torch.where(step, tm[ax] + dt[ax], tm[ax])
        return done, move

    def walk(self, o: V3, d: V3, t_min, t_cap, mask,
             any_hit: bool) -> WalkResult:
        """Walk every lane whose `mask` is set (None: all), with `t_cap`
        both the exit bound and the strictly-closer bound. With `any_hit`
        a lane stops at its first hit and t_best stays its cap."""
        active, ic, tm, stp, dt = self.walk_start(o, d, t_cap, mask)
        entered = active
        cur, end = self._cell_range(*ic)
        best = torch.full(o.x.shape, -1, dtype=torch.int64, device=o.x.device)
        t_best = t_cap + torch.zeros_like(o.x)
        n_s, n_t, n_adv = (torch.zeros_like(best) for _ in range(3))
        trips = 0
        while trips < self.max_trips and bool(active.any()):
            trips += 1
            work = active & (cur < end)
            pid = self._idx[torch.where(work, cur, 0)]
            t, is_s = self.test_at(pid, o, d, t_min, t_best)
            ok = work & (t > 0.0) & (t < t_best)
            best = torch.where(ok, pid, best)
            if not any_hit:
                t_best = torch.where(ok, t, t_best)
            cur = cur + work.long()
            n_s = n_s + (work & is_s).long()
            n_t = n_t + (work & ~is_s).long()

            adv = active & ~work
            done, move = self.advance(adv, ic, tm, stp, dt, t_best)
            new_cur, new_end = self._cell_range(*ic)
            cur = torch.where(move, new_cur, cur)
            end = torch.where(move, new_end, end)
            n_adv = n_adv + adv.long()
            active = active & ~done
            if any_hit:
                active = active & ~ok
        return WalkResult(best, t_best, n_s, n_t, n_adv, entered, active)

    def _count_walk(self, gate, walked, r: WalkResult) -> None:
        """Add the gated lanes' walk counts (`walked`: a walk started)."""
        w = gate.to(torch.float64)
        self.stats += torch.stack([
            (walked * w).sum(), ((r.sph_tests + r.tri_tests) * w).sum(),
            (r.advances * w).sum(), (r.capped * w).sum()])
        sph_ops, _, tri_ops = geom.TEST_OPS
        self._ops += ((WALK_SLAB_OPS * walked + WALK_CELL_OPS * r.entered
                       + DDA_STEP_OPS * r.advances + sph_ops * r.sph_tests
                       + tri_ops * r.tri_tests) * w).sum()

    # -- the ScenePrims interface --------------------------------------

    def closest_hit(self, o: V3, d: V3, t_min=geom.RAY_EPS, t_max=geom.T_FAR,
                    gate=None) -> geom.Hit:
        """The planes' closest hit caps the walk; the walk's winner, else
        the plane's."""
        n_sph, n_pln, _ = self._counts
        if n_pln:
            t = geom.intersect_plane(geom._lanes(o), geom._lanes(d),
                                     *self._pln, t_min, t_max)
            t = torch.where((t > 0.0) & (t < t_max), t, float("inf"))
            pt, pidx = torch.min(t, -1)
            pfound = pt < t_max
            t_cap = torch.where(pfound, pt, t_max)
        else:
            pfound = torch.zeros(o.x.shape, dtype=torch.bool,
                                 device=o.x.device)
            pidx = torch.zeros_like(pfound, dtype=torch.int64)
            t_cap = torch.full_like(o.x, t_max)
        r = self.walk(o, d, t_min, t_cap, gate, any_hit=False)
        won = r.best >= 0
        idx = torch.where(won, torch.where(won & (r.best < n_sph), r.best,
                                           r.best + n_pln),
                          torch.where(pfound, n_sph + pidx, self.n_prims))
        if self._ops is not None:
            self._ops += (gate.sum(dtype=torch.float64)
                          * (n_pln * geom.TEST_OPS[1]))
            self._count_walk(gate, torch.ones_like(won), r)
        return self.hit_at(o, d, won | pfound, r.t_best, idx)

    def occluded(self, o: V3, d: V3, t_min, t_max, gate=None) -> torch.Tensor:
        """The planes' any-hit first; the walk only where no plane blocks."""
        n_pln = self._counts[1]
        blocked_p = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
        if n_pln:
            hits = geom.blocked_plane(geom._lanes(o), geom._lanes(d),
                                      *self._pln, t_min, t_max[..., None])
            blocked_p = hits.any(-1)
        mask = ~blocked_p if gate is None else gate & ~blocked_p
        r = self.walk(o, d, t_min, t_max, mask, any_hit=True)
        if self._ops is not None:
            n_plane = torch.full_like(r.best, n_pln)
            if n_pln:
                first = torch.argmax(hits.to(torch.uint8), -1)
                n_plane = torch.where(blocked_p, first + 1, n_plane)
            self._ops += (n_plane * gate).sum(dtype=torch.float64) \
                * geom.TEST_OPS[1]
            self._count_walk(gate, ~blocked_p, r)
        return (r.best >= 0) | blocked_p
