"""Wavefront OBJ mesh loading — triangle geometry at framework scale.

The reference supports triangles only as hand-authored JSON entries
(reference: src/lib.rs:62-63 `#[serde(default)] triangles`, intersected at
src/shader.wgsl:192-223); its shipped scenes top out at two of them. This
module is the capability extension that makes triangle *meshes* usable:
it parses OBJ geometry and expands each mesh into ordinary
``Scene.triangles`` entries at load time, so every downstream consumer —
the baked constant sweep, the array-resident `fori_loop` sweep
(ops/arrayscene.py, which exists precisely for primitive counts like
these), the jnp oracle, dynamic mode, and the parity tests — sees plain
triangles with the reference's exact semantics (flat shading from the
geometric normal, shader.wgsl:215-218; strictly-closer hit resolution).

Scope: geometry only. ``v`` and ``f`` records are honored (all ``f``
index forms: ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``, and negative
relative indices; polygons are fan-triangulated). Normals, texcoords,
materials, groups, and object records are ignored — the renderer computes
its own flat normals like the reference, and materials come from the
scene JSON (one material per mesh, matching the reference's
material-per-primitive model, src/lib.rs:86-98).

All vertex transforms run in float64 and narrow to f32 only at
``Triangle`` construction — the same f64-parse / f32-narrow discipline as
the JSON loader (models/scene.py `_f32v`, mirroring vec3.rs:15-17), so a
mesh baked from an OBJ is bit-identical to the same triangles written
out longhand in JSON.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from . import scene as scene_mod

__all__ = [
    "parse_obj",
    "load_obj",
    "mesh_triangles",
    "triangles_from_spec",
    "icosahedron",
    "icosphere",
]


def parse_obj(text: str, name: str = "<obj>"):
    """Parse OBJ source -> ``(vertices, faces)``: vertices as a list of
    float64 ``(x, y, z)`` tuples, faces as 0-based vertex-index triples
    (polygons fan-triangulated, like every renderer's OBJ importer).
    Raises ValueError on malformed records or out-of-range indices."""
    verts: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    for ln, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            if len(parts) < 4:
                raise ValueError(
                    f"{name}:{ln}: vertex record needs 3 coordinates: {raw!r}"
                )
            try:
                # Extra fields (w, vertex colors) are legal OBJ; ignored.
                verts.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            except ValueError:
                raise ValueError(
                    f"{name}:{ln}: bad vertex coordinate in {raw!r}"
                ) from None
        elif tag == "f":
            if len(parts) < 4:
                raise ValueError(
                    f"{name}:{ln}: face record needs >= 3 vertices: {raw!r}"
                )
            idx = []
            for tok in parts[1:]:
                v_tok = tok.split("/", 1)[0]
                try:
                    i = int(v_tok)
                except ValueError:
                    raise ValueError(
                        f"{name}:{ln}: bad face index {tok!r}"
                    ) from None
                if i == 0:
                    raise ValueError(
                        f"{name}:{ln}: OBJ indices are 1-based; 0 is invalid"
                    )
                # Negative indices are relative to the vertices parsed so far.
                j = len(verts) + i if i < 0 else i - 1
                if not (0 <= j < len(verts)):
                    raise ValueError(
                        f"{name}:{ln}: face index {i} out of range "
                        f"(have {len(verts)} vertices)"
                    )
                idx.append(j)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append((idx[0], idx[k], idx[k + 1]))
        # vn / vt / vp / mtllib / usemtl / o / g / s / l: ignored (scope
        # note in the module docstring).
    return verts, faces


def load_obj(path):
    """Read and parse an OBJ file."""
    p = Path(path)
    return parse_obj(p.read_text(), name=str(p))


def _transform(verts, scale, translate, rotate_y_degrees):
    """scale -> rotate about +Y -> translate, in float64."""
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    s = np.asarray(scale, np.float64)
    if s.ndim == 0:
        s = np.full((3,), float(s))
    if s.shape != (3,):
        raise ValueError(f"mesh scale must be a scalar or 3-vector, got "
                         f"{scale!r}")
    v = v * s
    if rotate_y_degrees:
        a = math.radians(float(rotate_y_degrees))
        c, sn = math.cos(a), math.sin(a)
        # Right-handed rotation about +Y (the scene's up axis).
        x, y, z = v[:, 0].copy(), v[:, 1], v[:, 2].copy()
        v = np.stack([c * x + sn * z, y, -sn * x + c * z], axis=1)
    t = np.asarray(translate, np.float64)
    if t.shape != (3,):
        raise ValueError(f"mesh translate must be a 3-vector, got "
                         f"{translate!r}")
    return v + t


def mesh_triangles(
    verts: Sequence[Tuple[float, float, float]],
    faces: Sequence[Tuple[int, int, int]],
    material: scene_mod.Material,
    scale=1.0,
    translate=(0.0, 0.0, 0.0),
    rotate_y_degrees: float = 0.0,
) -> Tuple[scene_mod.Triangle, ...]:
    """Transformed mesh -> ``Triangle`` tuple (f32-narrowed vertices).
    Zero-area faces are dropped: the traversal precomputes each triangle's
    unit normal and (for lights) 1/area (ops/geometry._tri_edges_f32),
    which a degenerate face would turn into NaNs; real-world OBJ exports
    routinely contain a few."""
    v = _transform(verts, scale, translate, rotate_y_degrees)
    out = []
    for (i, j, k) in faces:
        v0, v1, v2 = v[i], v[j], v[k]
        # Degeneracy test in f32 — what the traversal's precompute sees.
        a0 = v0.astype(np.float32)
        cr = np.cross(v1.astype(np.float32) - a0, v2.astype(np.float32) - a0)
        if float(np.dot(cr, cr)) == 0.0:
            continue
        out.append(scene_mod.Triangle(
            scene_mod._f32v(v0), scene_mod._f32v(v1), scene_mod._f32v(v2),
            material,
        ))
    return tuple(out)


def triangles_from_spec(spec: dict, base_dir=None):
    """Expand one scene-JSON ``meshes[]`` entry into triangles.

    Spec keys: ``obj`` (path, resolved against the scene file's directory
    when relative), the material fields ``color`` / ``emission`` /
    ``reflectivity`` (required, exactly like the other primitive records),
    and optional ``scale`` (scalar or 3-vector, default 1), ``translate``
    (default origin), ``rotate_y_degrees`` (default 0)."""
    if "obj" not in spec:
        raise ValueError("mesh entry needs an 'obj' path")
    path = Path(spec["obj"])
    if not path.is_absolute() and base_dir is not None:
        path = Path(base_dir) / path
    if not path.exists():
        raise FileNotFoundError(f"mesh OBJ not found: {path}")
    material = scene_mod._material(spec)
    verts, faces = load_obj(path)
    return mesh_triangles(
        verts, faces, material,
        scale=spec.get("scale", 1.0),
        translate=spec.get("translate", (0.0, 0.0, 0.0)),
        rotate_y_degrees=spec.get("rotate_y_degrees", 0.0),
    )


# ---------------------------------------------------------------------------
# Procedural meshes (tests, benchmarks, and the packaged demo scene)
# ---------------------------------------------------------------------------


def icosahedron():
    """Unit icosahedron: 12 vertices, 20 faces, outward-wound."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    inv = 1.0 / math.sqrt(1.0 + phi * phi)
    a, b = inv, phi * inv
    verts = [
        (-a, b, 0.0), (a, b, 0.0), (-a, -b, 0.0), (a, -b, 0.0),
        (0.0, -a, b), (0.0, a, b), (0.0, -a, -b), (0.0, a, -b),
        (b, 0.0, -a), (b, 0.0, a), (-b, 0.0, -a), (-b, 0.0, a),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    return verts, faces


def icosphere(subdivisions: int = 0):
    """Icosahedron subdivided ``subdivisions`` times, vertices projected to
    the unit sphere: 20 * 4**s faces (s=3 -> 1280 triangles) — the
    many-triangle benchmark mesh (``--scene icosphere:S``)."""
    verts, faces = icosahedron()
    verts = [np.asarray(v, np.float64) for v in verts]
    for _ in range(int(subdivisions)):
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts[i] + verts[j]) / 2.0
                m = m / np.sqrt(np.dot(m, m))
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        new_faces = []
        for (i, j, k) in faces:
            ij, jk, ki = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            new_faces += [(i, ij, ki), (j, jk, ij), (k, ki, jk),
                          (ij, jk, ki)]
        faces = new_faces
    return [tuple(map(float, v)) for v in verts], faces
