"""Runtime scene values (the ``--animate`` mode) —
``terminal_raytracer_tpu/ops/dynamic.py`` (``DynPrims``) and
``ops/arrayscene.py`` (``ArrayDynPrims``).

An animator maps the scene's packed arrays (:func:`pack_scene`, the layout
the JAX package's animators use) to new values every frame; the primitive
counts and the light topology stay those of the template scene. The JAX
package binds the values to its kernels as SMEM operands and derives plane
unit normals, triangle edges and the like inside the kernels. The port
instead rebuilds the scene buffer of ops/geometry.py on the device once per
frame (:func:`tables_from_packed`, O(N) elementwise torch work), and
kernels A and B read it as they read a static scene's.

The derived values take the JAX package's stepwise f32 arithmetic for
runtime values (``DynPrims._plane_unit`` / ``_tri_derived``,
``geometry._tri_edges_f32``): r^2 and 1/r in f32, plane unit normals as
n / sqrt(n . n), triangle edges, cross product, its length, unit normal and
half-length in f32, with n . n summed as (x*x + y*y) + z*z
(geometry.sq_len_f32) and the square root correctly rounded (taken in f64:
PyTorch's vectorised f32 sqrt on the CPU is not). A sphere light's area
4 pi r^2 is taken in f64 from the f32 radius, as ``DynPrims`` takes it for
a radius the animator leaves alone (no built-in animator moves a radius).
The extension table (material channels, ops/geometry.py EXT_KEYS) is
taken from the frame's packed channels as they are. At t = 0 the buffer
equals ``scene_tables(scene, accel='array', ext=...)`` bit for bit
(tests/test_torch_dynamic.py, tests/test_torch_materials.py).

xt tables (the transport and camera extensions) rebuild two more things
per frame, each as ``DynPrims`` derives it from runtime values: the
light-inverse-area channel (1 / (4 pi r^2) in f64 from the f32 radius of
a sphere light, the f32 reciprocal of a triangle light's f32 area), and
with one-light NEE the pick table, in the f32 steps of
``PathTracer._light_pick`` over traced scalars (on the host, from the
frame's values, in the same copy). A baked scene folds the pick in f64
instead (ops/geometry.py scene_tables), so an animated one-light scene at
t = 0 may differ from the static one by an ulp of a pick probability.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import scene as scene_mod
from . import geometry as geom

SPHERE_KEYS = ("s_cx", "s_cy", "s_cz", "s_r")
PLANE_KEYS = ("p_px", "p_py", "p_pz", "p_nx", "p_ny", "p_nz")
TRI_KEYS = ("t_ax", "t_ay", "t_az", "t_bx", "t_by", "t_bz",
            "t_cx", "t_cy", "t_cz")
MAT_KEYS = ("colr", "colg", "colb", "emir", "emig", "emib", "refl")
# Extension material channels: part of the layout only when the template
# scene has the extension; a channel outside the layout reads 0.
GLASS_KEYS = ("transp", "ior")
ROUGH_KEYS = ("rough",)
CHECKER_KEYS = ("ckr", "ckg", "ckb", "cks")
TEXTURE_KEYS = ("txi", "txs")
NORMALMAP_KEYS = ("nmi", "nmx", "nms")


def ext_mat_keys(scene) -> tuple:
    """The extension material-channel suffixes this scene's layout carries."""
    return ((GLASS_KEYS if scene.has_dielectrics else ())
            + (ROUGH_KEYS if scene.has_rough_metals else ())
            + (CHECKER_KEYS if scene.has_checker else ())
            + (TEXTURE_KEYS if scene.has_texture else ())
            + (NORMALMAP_KEYS if scene.has_normal_map else ()))


def scene_keys(scene: scene_mod.Scene) -> List[Tuple[str, int]]:
    """The (key, length) list of the packed layout, in a stable order."""
    ns, np_, nt = (len(scene.spheres), len(scene.planes),
                   len(scene.triangles))
    mat = MAT_KEYS + ext_mat_keys(scene)
    out = [(k, ns) for k in SPHERE_KEYS]
    out += [(f"s_{m}", ns) for m in mat]
    out += [(k, np_) for k in PLANE_KEYS]
    out += [(f"p_{m}", np_) for m in mat]
    out += [(k, nt) for k in TRI_KEYS]
    out += [(f"t_{m}", nt) for m in mat]
    return out


def pack_scene(scene: scene_mod.Scene) -> Dict[str, np.ndarray]:
    """Scene -> the flat scalar-array dict (the animatable state)."""
    a = scene.to_arrays()
    out = {}
    for prefix, kind in (("s", "sphere"), ("p", "plane"), ("t", "triangle")):
        col, emi = a[f"{kind}_color"], a[f"{kind}_emission"]
        chans = {
            "colr": col[:, 0], "colg": col[:, 1], "colb": col[:, 2],
            "emir": emi[:, 0], "emig": emi[:, 1], "emib": emi[:, 2],
            "refl": a[f"{kind}_reflectivity"],
            **geom.ext_channels(a, kind),
        }
        out.update({f"{prefix}_{k}": v for k, v in chans.items()})
    geo = {"s_c": a["sphere_center"], "p_p": a["plane_point"],
           "p_n": a["plane_normal"], "t_a": a["triangle_v0"],
           "t_b": a["triangle_v1"], "t_c": a["triangle_v2"]}
    for stem, v in geo.items():
        for j, axis in enumerate("xyz"):
            out[stem + axis] = v[:, j]
    out["s_r"] = a["sphere_radius"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


class Topology(NamedTuple):
    """What an animated scene keeps from its template: the packed layout's
    core keys and the NEE lights (planes are never sampled) as indices into
    the spheres and the triangles; sphere lights come first, each kind in
    primitive order, as in ``Scene.lights``. `ext_keys` are the extension
    channels of the layout, or None when the buffer has no extension
    table. `xt` widens the extension table by the light-inverse-area
    channel; `pick` ('uniform' or 'power') adds one-light NEE's pick
    table."""

    keys: Tuple[Tuple[str, int], ...]
    sphere_lights: np.ndarray
    tri_lights: np.ndarray
    ext_keys: Optional[Tuple[str, ...]] = None
    xt: bool = False
    pick: Optional[str] = None


def topology(scene: scene_mod.Scene, ext: bool = False, xt: bool = False,
             pick: Optional[str] = None) -> Topology:
    core = (SPHERE_KEYS + PLANE_KEYS + TRI_KEYS
            + tuple(f"{p}_{m}" for p in "spt" for m in MAT_KEYS))
    keys = tuple((k, n) for k, n in scene_keys(scene) if k in core)
    return Topology(
        keys,
        np.array([i for i, s in enumerate(scene.spheres)
                  if s.material.is_light], np.int64),
        np.array([i for i, t in enumerate(scene.triangles)
                  if t.material.is_light], np.int64),
        ext_mat_keys(scene) if ext or xt else None, xt, pick)


# Per-light values the host gathers for the light rows (topology order).
_SPHERE_LIGHT_KEYS = ("s_cx", "s_cy", "s_cz", "s_r", "s_emir", "s_emig",
                      "s_emib")
_TRI_LIGHT_KEYS = TRI_KEYS + ("t_emir", "t_emig", "t_emib")


def _length(v: torch.Tensor) -> torch.Tensor:
    """|v| of [3, n] vectors: (x*x + y*y) + z*z in f32 steps, then a
    correctly rounded square root."""
    sq = v * v
    return torch.sqrt((sq[0] + sq[1] + sq[2]).double()).float()


def _tri_frame(v0, v1, v2):
    """(e1, e2, unit normal, area) of triangles given as [3, n] vertices,
    in the f32 steps of geometry._tri_edges_f32."""
    e1, e2 = v1 - v0, v2 - v0
    # cross(e1, e2), component by component: y*z' - z*y', z*x' - x*z', ...
    cr = (e1.roll(-1, 0) * e2.roll(-2, 0)
          - e1.roll(-2, 0) * e2.roll(-1, 0))
    cr_len = _length(cr)
    return e1, e2, cr / cr_len, 0.5 * cr_len


def tables_from_packed(arrays, topo: Topology, device) -> geom.SceneTables:
    """The scene buffer of ops/geometry.py on `device`, built from the
    packed arrays with the derived values computed there (module
    docstring). The arrays, and the values of the light rows gathered on
    the host, go over in one asynchronous host-to-device copy; the rest is
    a few dozen elementwise ops over [k, n] blocks, whatever n is."""
    sl, tl = topo.sphere_lights, topo.tri_lights
    ns, np_, nt = (len(a) for a in (arrays["s_r"], arrays["p_px"],
                                    arrays["t_ax"]))
    # The extension table is no derived value: it is built on the host and
    # rides in the same copy, and so does the pick table.
    ext = []
    if topo.ext_keys is not None:
        zeros = np.zeros(ns + np_ + nt, np.float32)
        ext = [geom.ext_table({k: np.concatenate(
            [np.asarray(arrays[f"{p}_{k}"], np.float32) for p in "spt"])
            if k in topo.ext_keys else zeros
            for k in geom.EXT_KEYS}).reshape(-1)]
    pick = [] if topo.pick is None else [pick_table(arrays, topo)]
    host = torch.from_numpy(np.concatenate(
        [np.asarray(arrays[k], np.float32) for k, _ in topo.keys]
        + [np.asarray(arrays[k], np.float32)[sl] for k in _SPHERE_LIGHT_KEYS]
        + [np.asarray(arrays[k], np.float32)[tl] for k in _TRI_LIGHT_KEYS]
        + ext + pick))
    device = torch.device(device)
    if device.type == "cuda":
        # From pinned memory the copy is queued behind the previous frame's
        # kernels instead of waiting for them on the host.
        host = host.pin_memory()
    flat = host.to(device, non_blocking=True)
    blocks, off = [], 0
    for rows, n in ((4, ns), (7, ns), (6, np_), (7, np_), (9, nt), (7, nt),
                    (7, len(sl)), (12, len(tl))):
        blocks.append(flat[off:off + rows * n].view(rows, n))
        off += rows * n
    sph, sph_mat, pln, pln_mat, tri, tri_mat, ls, lt = blocks
    if ext:
        n = (ns + np_ + nt) * geom.EXT_W
        ext = [flat[off:off + n].view(ns + np_ + nt, geom.EXT_W)]
        off += n
    if pick:
        pick = [flat[off:]]

    r = sph[3]
    sph = torch.cat([sph[0:3], (r * r)[None], (1.0 / r)[None]])
    n_raw = pln[3:6]
    pln = torch.cat([pln, n_raw / _length(n_raw)])
    e1, e2, unit, area = _tri_frame(tri[0:3], tri[3:6], tri[6:9])
    tri = torch.cat([tri[0:3], e1, e2, unit])
    mat = torch.cat([sph_mat, pln_mat, tri_mat], 1)
    if topo.xt:
        # The light-inverse-area channel: 1 / (4 pi r^2) in f64 from the
        # f32 radius, 1 / area of the f32 area, 0 off the NEE lights.
        r64 = r.double()
        s_idx, t_idx = (torch.from_numpy(i).to(device) for i in (sl, tl))
        s_lia = torch.zeros_like(r)
        s_lia[s_idx] = (1.0 / ((geom.FOUR_PI * r64) * r64)).float()[s_idx]
        t_lia = torch.zeros_like(area)
        t_lia[t_idx] = (1.0 / area)[t_idx]
        lia = torch.cat([s_lia, torch.zeros_like(pln[0]), t_lia])
        ext = [torch.cat([ext[0], lia[:, None]], 1)]

    # Light rows (geometry.LIGHT_W): a sphere light's area 4 pi r^2 in f64.
    r64 = ls[3].double()
    s_rows = torch.cat([
        torch.full_like(ls[0:1], float(scene_mod.SPHERE)), ls[4:7],
        ((geom.FOUR_PI * r64) * r64).float()[None], ls[0:4],
        torch.zeros_like(ls[0:1]).expand(8, -1)])
    _, _, t_unit, t_area = _tri_frame(lt[0:3], lt[3:6], lt[6:9])
    t_rows = torch.cat([
        torch.full_like(lt[0:1], float(scene_mod.TRIANGLE)), lt[9:12],
        t_area[None], lt[0:9], t_unit])
    lights = torch.cat([s_rows, t_rows], 1)
    return geom.tables_from_parts([sph.T, pln.T, tri.T, mat.T, lights.T]
                                  + ext + pick, device)


def pick_table(arrays, topo: Topology) -> np.ndarray:
    """One-light NEE's pick table of the frame's values, in the f32 steps
    of the JAX package's _light_pick over traced scalars: a sphere light's
    area (f32(4 pi) r) r, a triangle light's half cross-product length
    (stepwise f32, as _tri_frame computes it on the device)."""
    a = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    lights = [(scene_mod.SPHERE,
               tuple(a[f"s_emi{c}"][i] for c in "rgb"), a["s_r"][i])
              for i in topo.sphere_lights]
    for i in topo.tri_lights:
        v0, v1, v2 = (np.array([a[f"t_{v}{c}"][i] for c in "xyz"], np.float32)
                      for v in "abc")
        e1, e2 = v1 - v0, v2 - v0
        cr = np.array([e1[1] * e2[2] - e1[2] * e2[1],
                       e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]], np.float32)
        area = np.float32(0.5) * np.sqrt(geom.sq_len_f32(cr))
        lights.append((scene_mod.TRIANGLE,
                       tuple(a[f"t_emi{c}"][i] for c in "rgb"), area))
    return geom.pick_table(lights, topo.pick, runtime=True)
