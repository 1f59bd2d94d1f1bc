"""Scene schema, JSON loader, and the two scene representations.

The JSON schema is identical to the reference's serde structs
(reference: src/lib.rs:52-98): global ``width / height / samples_per_pixel /
max_depth / frames_to_accumulate``, ``camera{fov_degrees, char_aspect_ratio}``,
and arrays ``spheres[{center, radius, color, emission, reflectivity}]``,
``planes[{point, normal, ...}]``, ``triangles[{v0, v1, v2, ...}]`` — with
``triangles`` optional (lib.rs:62-63). All scalars are parsed as f64 and
narrowed to f32 (lib.rs:73-98, vec3.rs:15-17); we replicate the narrowing so
baked constants match the reference bit-for-bit.

Two representations, both SoA — never the reference's 180-byte tagged-union
AoS record (src/primitive.rs:7-33), which exists only for WGSL struct ABI:

* :class:`Scene` — a frozen, hashable pytree-of-Python-floats. Because scene
  geometry is static for the process lifetime (reference uploads it once,
  lib.rs:301-305, and never mutates it), the renderer *bakes* primitives into
  the compiled kernel as constants: XLA folds them into the instruction
  stream and the hot loop does zero geometry memory traffic. ``Scene`` is a
  valid ``jax.jit`` static argument.
* :func:`Scene.to_arrays` — packed ``float32`` SoA device arrays (centers
  ``[N,3]``, radii ``[N]``, ...), for build-time tooling (uniform grid,
  dynamic-scene variants) that wants data, not constants.

Primitive iteration order is preserved exactly as the reference flattens it
— spheres, then planes, then triangles (lib.rs:120-154) — because closest-hit
resolves ties by "strictly closer wins" (shader.wgsl:279), making order
observable.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from .texture import (DEFAULT_SIZE as _TEX_DEFAULT_SIZE, MAX_ATLAS_ROWS,
                      Texture, build_atlas, texture_from_spec)

_SCENES_DIR = Path(__file__).parent / "scenes"
DEFAULT_SCENE = "Cornell_Box"

# Primitive type tags, matching primitive.rs:7.
SPHERE, PLANE, TRIANGLE = 0, 1, 2

# A primitive is emissive (a light) iff emission.x+y+z > 0.001
# (shader.wgsl:346-347).
LIGHT_POWER_EPS = 1e-3


def _f32(v: float) -> float:
    """f64 -> f32 narrowing as in vec3.rs:15-17 (then back to Python float)."""
    return float(np.float32(v))


def _f32v(v) -> Tuple[float, float, float]:
    return (_f32(v[0]), _f32(v[1]), _f32(v[2]))


class Material(NamedTuple):
    color: Tuple[float, float, float]
    emission: Tuple[float, float, float]
    reflectivity: float
    # Dielectric extension (capability superset — the reference's schema
    # ends at reflectivity, lib.rs:73-98): `transparency` is the
    # probability the scatter takes the refractive glass branch
    # (Fresnel-weighted reflect-or-refract, ops/tracer.py); 0 keeps the
    # material reference-exact (diffuse/mirror only, no extra ops or RNG
    # draws anywhere). `ior` is that branch's index of refraction.
    transparency: float = 0.0
    ior: float = 1.5
    # Metal roughness (extension): fuzz radius of the mirror branch —
    # reflect + roughness * uniform-sphere vector, re-normalized; a fuzzed
    # direction below the surface absorbs the path. 0 keeps the mirror
    # reference-exact. The reference's own dead random_in_unit_sphere
    # (shader.wgsl:117-124) gestures at exactly this feature. NOTE:
    # roughness only takes effect where the MIRROR branch can fire — with
    # reflectivity 0 it is a silent no-op (kept legal rather than
    # rejected because dynamic scenes may animate reflectivity up from
    # the template's 0).
    roughness: float = 0.0
    # Procedural checker texture (extension): when set, the hit color
    # alternates between `color` and `checker_color` on a world-space
    # 3-D checkerboard with cell edge 1/checker_scale (the TPU-sane
    # texture — pure lane math, no per-lane gathers). None = untextured
    # (reference-exact).
    checker_color: Optional[Tuple[float, float, float]] = None
    checker_scale: float = 1.0
    # Image texture (extension, models/texture.py): the name of a
    # scene-level texture whose texels REPLACE `color` at hits (mapping
    # by primitive kind — spherical for spheres, dominant-axis planar
    # for planes/triangles; ops/tracer.py). `texture_scale` tiles the uv
    # mapping. None = untextured (reference-exact).
    texture: Optional[str] = None
    texture_scale: float = 1.0
    # Normal map (extension): the name of a scene-level texture read as a
    # TANGENT-SPACE normal map (rgb -> [-1,1] xyz, z up) perturbing the
    # shading normal at hits — same uv mapping as `texture` (spherical on
    # spheres, dominant-axis planar on planes/triangles), tiled by
    # `normal_scale`; `normal_strength` scales the tangential deflection
    # (1 = the map as authored). None = flat (reference-exact).
    normal_map: Optional[str] = None
    normal_scale: float = 1.0
    normal_strength: float = 1.0

    @property
    def is_light(self) -> bool:
        return sum(self.emission) > LIGHT_POWER_EPS

    @property
    def is_dielectric(self) -> bool:
        return self.transparency > 0.0

    @property
    def is_rough(self) -> bool:
        return self.roughness > 0.0

    @property
    def is_checker(self) -> bool:
        return self.checker_color is not None

    @property
    def is_textured(self) -> bool:
        return self.texture is not None

    @property
    def is_normal_mapped(self) -> bool:
        return self.normal_map is not None


class Sphere(NamedTuple):
    center: Tuple[float, float, float]
    radius: float
    material: Material


class Plane(NamedTuple):
    point: Tuple[float, float, float]
    normal: Tuple[float, float, float]
    material: Material


class Triangle(NamedTuple):
    v0: Tuple[float, float, float]
    v1: Tuple[float, float, float]
    v2: Tuple[float, float, float]
    material: Material


@dataclasses.dataclass(frozen=True)
class Fog:
    """Homogeneous participating medium (extension — the reference renders
    in vacuum). `density` is the extinction coefficient sigma per world
    unit; `albedo` the single-scattering albedo (fraction of extinction
    that scatters rather than absorbs; (1,1,1) = pure scattering fog,
    (0,0,0) = pure absorption). The tracer samples scatter distances
    analytically (ops/tracer.py), so the medium costs one extra gated RNG
    draw per bounce plus two per scatter event."""

    density: float
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Henyey-Greenstein anisotropy: 0 = isotropic (bit-exact with the
    # pre-anisotropy code), g > 0 forward-scattering (real fog ~0.6-0.9 —
    # halos become beams), g < 0 back-scattering.
    g: float = 0.0


@dataclasses.dataclass(frozen=True)
class Sky:
    """Environment-map sky (extension — the reference's miss shading is
    the fixed two-color gradient, shader.wgsl:297-304). `texture` names an
    entry in the scene's `textures` registry; rays that miss all geometry
    sample it by direction (spherical latitude/longitude — the same
    mapping textured spheres use) instead of the gradient, scaled by
    `intensity`. Compile-time constants like Fog (static even in dynamic
    mode); scenes without a sky block compile the exact gradient code."""

    texture: str
    intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class Camera_Config:
    fov_degrees: float
    char_aspect_ratio: float
    # Thin-lens depth of field (capability extension; the reference is a
    # pinhole camera). aperture = lens radius in world units (0 = pinhole,
    # bit-exact reference rays); focus_distance = distance of the sharp
    # plane along the camera forward axis.
    aperture: float = 0.0
    focus_distance: float = 1.0


@dataclasses.dataclass(frozen=True)
class Scene:
    """Immutable, hashable scene — safe to pass as a jit static argument."""

    width: int
    height: int
    samples_per_pixel: int
    max_depth: int
    frames_to_accumulate: int
    camera: Camera_Config
    spheres: Tuple[Sphere, ...]
    planes: Tuple[Plane, ...]
    triangles: Tuple[Triangle, ...]
    # Optional homogeneous medium (extension; None = the reference's
    # vacuum — the fog code is statically absent).
    fog: Optional[Fog] = None
    # Optional environment-map sky (extension; None = the reference's
    # gradient — the sky-texture code is statically absent).
    sky: Optional[Sky] = None
    # Texture magnification filter (extension): 'nearest' (default —
    # scenes compile the exact one-gather fetch) or 'bilinear' (a
    # 2x2-texel lerp at every fetch site: smooth close-ups for ~3x the
    # gather cost; texel coordinates wrap on all edges, matching the
    # fract() tiling of the nearest path — at the spherical mapping's
    # poles the blend wraps to the opposite row, a documented artifact).
    texture_filter: str = "nearest"
    # Pixel-jitter sampler (extension): 'reference' (default — each
    # sample's sub-pixel offset is an independent uniform draw,
    # shader.wgsl:519-520, bit-exact) or 'stratified' (base-phase sample i
    # lands in cell i mod g^2 of a g x g sub-pixel grid, jittered within
    # the cell; g is the largest power of two whose square divides the
    # base sample count, so cells are covered exactly evenly — unbiased,
    # with lower jitter-variance at geometric edges; adaptive extras keep
    # independent jitter). Same draws, affinely remapped — RNG chains and
    # gate structure unchanged. Scene-level static like texture_filter:
    # 'reference' compiles the exact reference program. See
    # ops/tracer.py PathTracer.__init__ / stratify_jitter.
    sampler: str = "reference"
    # NEE light-sampling strategy (extension): 'all' (default — every
    # bounce casts one shadow ray per light, the reference's NEE loop,
    # shader.wgsl:338-436, bit-exact) or single-light sampling: 'uniform'
    # (pick one light per NEE event uniformly) / 'power' (pick
    # proportionally to emitted power = Rec.709 luminance x area). Both
    # weight the one estimate by 1/p(pick), so the estimator's
    # expectation equals the full loop — unbiased by construction — while
    # the per-bounce occlusion cost drops from n_lights primitive sweeps
    # to ONE, the difference between O(L) and O(1) scaling in the light
    # count. Scene-level static like `sampler`: 'all' compiles the exact
    # reference program; scenes with <= 1 NEE light ignore the mode (the
    # loop is already one sweep). See ops/tracer.py _one_light_nee.
    light_sample: str = "all"
    # Image textures (extension, models/texture.py): the scene-level
    # registry materials reference by name. Hashable Texture tuples —
    # Scene stays a valid jit static argument; the packed VMEM atlas is
    # derived on demand (texture_atlas()). () = no textures (the texture
    # code is statically absent).
    textures: Tuple["Texture", ...] = ()

    def __post_init__(self):
        """Validate on every construction (incl. with_overrides / CLI
        overrides). The reference accepts anything serde parses and then
        misbehaves silently; here bad configs fail loudly. width/height must
        be >= 2 because ray gen divides by (width-1)/(height-1)
        (shader.wgsl:524-527; ops/tracer.py gen_ray)."""
        for name, lo in (("width", 2), ("height", 2), ("samples_per_pixel", 1),
                         ("max_depth", 1), ("frames_to_accumulate", 1)):
            v = getattr(self, name)
            if not isinstance(v, int) or v < lo:
                raise ValueError(
                    f"scene {name} must be an integer >= {lo}, got {v!r}"
                )
        if not (0.0 < self.camera.fov_degrees < 180.0):
            raise ValueError(
                f"camera fov_degrees must be in (0, 180), got "
                f"{self.camera.fov_degrees!r}"
            )
        if self.camera.aperture < 0.0:
            raise ValueError(
                f"camera aperture must be >= 0, got {self.camera.aperture!r}"
            )
        if self.camera.aperture > 0.0 and not self.camera.focus_distance > 0.0:
            raise ValueError(
                f"camera focus_distance must be > 0 when aperture > 0, got "
                f"{self.camera.focus_distance!r}"
            )
        if not self.camera.char_aspect_ratio > 0.0:
            raise ValueError(
                f"camera char_aspect_ratio must be > 0, got "
                f"{self.camera.char_aspect_ratio!r}"
            )
        for i, p in enumerate(self.planes):
            if sum(c * c for c in p.normal) == 0.0:
                raise ValueError(
                    f"planes[{i}] normal must be nonzero, got {p.normal!r}"
                )
        if self.fog is not None:
            if not self.fog.density > 0.0:
                raise ValueError(
                    f"fog density must be > 0, got {self.fog.density!r} "
                    f"(omit the fog block for a vacuum)"
                )
            if any(not (0.0 <= c <= 1.0) for c in self.fog.albedo):
                raise ValueError(
                    f"fog albedo components must be in [0, 1] (the "
                    f"fraction of extinction that scatters), got "
                    f"{self.fog.albedo!r}"
                )
            if not (-1.0 < self.fog.g < 1.0):
                raise ValueError(
                    f"fog anisotropy g must be in (-1, 1), got "
                    f"{self.fog.g!r}"
                )
        for i, s in enumerate(self.spheres):
            if not s.radius > 0.0:
                raise ValueError(
                    f"spheres[{i}] radius must be > 0, got {s.radius!r}"
                )
        tex_names = set()
        for i, t in enumerate(self.textures):
            if not isinstance(t, Texture):
                raise ValueError(
                    f"textures[{i}] must be a models.texture.Texture, got "
                    f"{type(t).__name__}"
                )
            if t.name in tex_names:
                raise ValueError(f"duplicate texture name {t.name!r}")
            tex_names.add(t.name)
            if t.size != self.textures[0].size:
                raise ValueError(
                    f"all textures in a scene share one size (they pack "
                    f"into one atlas); got {t.size} for {t.name!r} vs "
                    f"{self.textures[0].size} for "
                    f"{self.textures[0].name!r}"
                )
            if len(t.texels) != t.size * t.size:
                raise ValueError(
                    f"texture {t.name!r} has {len(t.texels)} texels for "
                    f"size {t.size} (want {t.size * t.size})"
                )
        if sum(t.rows for t in self.textures) > MAX_ATLAS_ROWS:
            raise ValueError(
                f"texture atlas exceeds {MAX_ATLAS_ROWS} rows (the trace "
                f"cost of the per-lane gather is O(rows)); use fewer or "
                f"smaller textures"
            )
        if self.texture_filter not in ("nearest", "bilinear"):
            raise ValueError(
                f"texture_filter must be 'nearest' or 'bilinear', got "
                f"{self.texture_filter!r}"
            )
        if self.light_sample not in ("all", "uniform", "power"):
            raise ValueError(
                f"light_sample must be 'all', 'uniform', or 'power', got "
                f"{self.light_sample!r}"
            )
        if self.sampler not in ("reference", "stratified"):
            raise ValueError(
                f"sampler must be 'reference' or 'stratified', got "
                f"{self.sampler!r}"
            )
        if self.sky is not None:
            if self.sky.texture not in tex_names:
                raise ValueError(
                    f"sky references texture {self.sky.texture!r}, not in "
                    f"the scene's textures {sorted(tex_names)!r}"
                )
            if not self.sky.intensity > 0.0:
                raise ValueError(
                    f"sky intensity must be > 0, got {self.sky.intensity!r} "
                    f"(omit the sky block for the gradient sky)"
                )
        for tag_name, prims in (("spheres", self.spheres),
                                ("planes", self.planes),
                                ("triangles", self.triangles)):
            for i, p in enumerate(prims):
                m = p.material
                if not (0.0 <= m.transparency <= 1.0):
                    raise ValueError(
                        f"{tag_name}[{i}] transparency must be in [0, 1], "
                        f"got {m.transparency!r}"
                    )
                if not (0.0 <= m.roughness <= 1.0):
                    raise ValueError(
                        f"{tag_name}[{i}] roughness must be in [0, 1], "
                        f"got {m.roughness!r}"
                    )
                if m.checker_color is not None and not m.checker_scale > 0.0:
                    raise ValueError(
                        f"{tag_name}[{i}] checker_scale must be > 0 on a "
                        f"checkered material, got {m.checker_scale!r}"
                    )
                if m.texture is not None:
                    if m.texture not in tex_names:
                        raise ValueError(
                            f"{tag_name}[{i}] references texture "
                            f"{m.texture!r}, not in the scene's textures "
                            f"{sorted(tex_names)!r}"
                        )
                    if not m.texture_scale > 0.0:
                        raise ValueError(
                            f"{tag_name}[{i}] texture_scale must be > 0 on "
                            f"a textured material, got {m.texture_scale!r}"
                        )
                if m.normal_map is not None:
                    if m.normal_map not in tex_names:
                        raise ValueError(
                            f"{tag_name}[{i}] references normal_map "
                            f"{m.normal_map!r}, not in the scene's textures "
                            f"{sorted(tex_names)!r}"
                        )
                    if not m.normal_scale > 0.0:
                        raise ValueError(
                            f"{tag_name}[{i}] normal_scale must be > 0 on "
                            f"a normal-mapped material, got "
                            f"{m.normal_scale!r}"
                        )
                    if not m.normal_strength > 0.0:
                        raise ValueError(
                            f"{tag_name}[{i}] normal_strength must be > 0 "
                            f"on a normal-mapped material, got "
                            f"{m.normal_strength!r} (omit normal_map for a "
                            f"flat surface)"
                        )
                if m.transparency > 0.0:
                    if not m.ior > 0.0:
                        raise ValueError(
                            f"{tag_name}[{i}] ior must be > 0 on a "
                            f"dielectric, got {m.ior!r}"
                        )
                    # Epsilon: the fields are f32-narrowed, so legal
                    # decimal pairs like 0.6 + 0.4 sum to 1.0000000298 in
                    # f64 — the renderer sums them in f32 (where such
                    # pairs are exactly 1), so validation must not be
                    # stricter than the math it guards.
                    if m.reflectivity + m.transparency > 1.0 + 1e-6:
                        raise ValueError(
                            f"{tag_name}[{i}] reflectivity + transparency "
                            f"must be <= 1 (branch probabilities), got "
                            f"{m.reflectivity!r} + {m.transparency!r}"
                        )

    # ---- derived views ----------------------------------------------------

    @property
    def primitives(self):
        """(type_tag, primitive) in the reference's flatten order
        (lib.rs:120-154): spheres, planes, triangles."""
        out = [(SPHERE, s) for s in self.spheres]
        out += [(PLANE, p) for p in self.planes]
        out += [(TRIANGLE, t) for t in self.triangles]
        return tuple(out)

    @property
    def lights(self):
        """Emissive primitives in primitive order. Planes are never sampled
        as lights (shader.wgsl:390-391) but *do* occupy a slot in the
        reference's NEE loop; excluding them here only skips a `continue`."""
        return tuple(
            (tag, p)
            for tag, p in self.primitives
            if p.material.is_light and tag != PLANE
        )

    @property
    def primitive_count(self) -> int:
        return len(self.spheres) + len(self.planes) + len(self.triangles)

    @property
    def has_dielectrics(self) -> bool:
        """True iff any primitive takes the refractive glass branch —
        the static gate for the dielectric scatter code (ops/tracer.py):
        scenes without it compile to the exact reference program."""
        return any(p.material.is_dielectric for _, p in self.primitives)

    @property
    def has_rough_metals(self) -> bool:
        """True iff any primitive fuzzes its mirror branch — the static
        gate for the roughness scatter code (ops/tracer.py), exactly like
        has_dielectrics."""
        return any(p.material.is_rough for _, p in self.primitives)

    @property
    def has_checker(self) -> bool:
        """True iff any primitive carries a checker texture — the static
        gate for the hit-recolor code (ops/tracer.py), exactly like
        has_dielectrics."""
        return any(p.material.is_checker for _, p in self.primitives)

    @property
    def has_texture(self) -> bool:
        """True iff any primitive samples an image texture — the static
        gate for the texel-gather code (ops/tracer.py), exactly like
        has_dielectrics."""
        return any(p.material.is_textured for _, p in self.primitives)

    @property
    def has_normal_map(self) -> bool:
        """True iff any primitive perturbs its shading normal from a
        normal-map texture — the static gate for the tangent-frame +
        perturbation code (ops/tracer.py), exactly like has_texture."""
        return any(p.material.is_normal_mapped for _, p in self.primitives)

    @property
    def has_sky_texture(self) -> bool:
        """True iff miss shading samples an environment texture — the
        static gate for the sky-fetch code (ops/tracer.py), exactly like
        has_fog. Scene-level: no per-primitive channel exists."""
        return self.sky is not None

    @property
    def needs_atlas(self) -> bool:
        """True iff the trace reads the texel atlas at all — primitive
        textures, normal maps, or a sky texture. Gates the atlas operand
        in the Pallas builders (pallas_kernel._tex_ops)."""
        return self.has_texture or self.has_sky_texture or self.has_normal_map

    @property
    def tex_bilinear(self) -> bool:
        """True iff texel fetches bilinearly blend the 2x2 neighborhood —
        the static gate for the filtered fetch (ops/tracer.py); 'nearest'
        scenes compile the exact one-gather program."""
        return self.texture_filter == "bilinear"

    def texture_index(self, name: Optional[str]) -> int:
        """1-based atlas id of a texture name; 0 for None (untextured).
        Ids are positional in the `textures` tuple."""
        if name is None:
            return 0
        for i, t in enumerate(self.textures):
            if t.name == name:
                return i + 1
        raise KeyError(name)  # unreachable: __post_init__ validated

    def texture_channel(self, tag: int, m: "Material") -> Tuple[float,
                                                                float]:
        """The two per-primitive texture channel values: a SIGNED id
        (+id = planar mapping for planes/triangles, -id = spherical for
        spheres, 0 = untextured) and the uv tiling scale (0 marks
        untextured in the numeric channels, like checker_scale)."""
        tid = self.texture_index(m.texture)
        if tid == 0:
            return 0.0, 0.0
        return (float(-tid) if tag == SPHERE else float(tid),
                _f32(m.texture_scale))

    def normal_channel(self, tag: int, m: "Material") -> Tuple[float, float,
                                                               float]:
        """The three per-primitive normal-map channel values: a SIGNED id
        (same mapping convention as texture_channel: +planar / -spherical,
        0 = unmapped), the uv tiling scale, and the tangential deflection
        strength (0 marks unmapped in the numeric channels)."""
        nid = self.texture_index(m.normal_map)
        if nid == 0:
            return 0.0, 0.0, 0.0
        return (float(-nid) if tag == SPHERE else float(nid),
                _f32(m.normal_scale), _f32(m.normal_strength))

    @property
    def texture_size(self) -> int:
        """The shared texel resolution S (all textures resample to one
        size at load; validated)."""
        return self.textures[0].size if self.textures else _TEX_DEFAULT_SIZE

    @property
    def texture_rows(self) -> int:
        """Aligned atlas rows per texture (id stride / 128)."""
        return max(1, (self.texture_size * self.texture_size) // 128)

    def texture_atlas(self) -> np.ndarray:
        """The packed (rows, 128) i32 texel atlas (models/texture.py) the
        tracer gathers from — derived, not stored (Scene stays hashable)."""
        return build_atlas(self.textures)

    @property
    def has_fog(self) -> bool:
        """True iff the scene carries a participating medium — the static
        gate for the volumetric code (ops/tracer.py). Fog parameters are
        compile-time constants even in dynamic mode (like the light
        topology)."""
        return self.fog is not None

    def centroid(self) -> np.ndarray:
        """Mean position of the finite geometry (sphere centers, triangle
        vertices; infinite planes excluded) — the default orbit target of
        the --turntable mode. Falls back to a point ahead of the default
        camera for all-plane/empty scenes."""
        pts = [np.asarray(s.center, np.float32) for s in self.spheres]
        for t in self.triangles:
            pts += [np.asarray(v, np.float32) for v in (t.v0, t.v1, t.v2)]
        if not pts:
            return np.array([0.0, 0.0, -3.0], np.float32)
        return np.mean(pts, axis=0).astype(np.float32)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def fov_rad(self) -> float:
        return float(np.radians(np.float32(self.camera.fov_degrees)))

    def with_overrides(
        self,
        width: Optional[int] = None,
        height: Optional[int] = None,
        samples_per_pixel: Optional[int] = None,
        max_depth: Optional[int] = None,
        frames_to_accumulate: Optional[int] = None,
        aperture: Optional[float] = None,
        focus_distance: Optional[float] = None,
        fog: Optional["Fog"] = None,
        texture_filter: Optional[str] = None,
        sampler: Optional[str] = None,
        light_sample: Optional[str] = None,
    ) -> "Scene":
        """Benchmark / terminal-clamp overrides (lib.rs:113-115), plus the
        depth-of-field lens parameters (CLI --aperture/--focus)."""
        kw = {}
        if aperture is not None or focus_distance is not None:
            cam = self.camera
            kw["camera"] = dataclasses.replace(
                cam,
                aperture=(float(aperture) if aperture is not None
                          else cam.aperture),
                focus_distance=(float(focus_distance)
                                if focus_distance is not None
                                else cam.focus_distance),
            )
        if width is not None:
            kw["width"] = int(width)
        if height is not None:
            kw["height"] = int(height)
        if samples_per_pixel is not None:
            kw["samples_per_pixel"] = int(samples_per_pixel)
        if max_depth is not None:
            kw["max_depth"] = int(max_depth)
        if frames_to_accumulate is not None:
            kw["frames_to_accumulate"] = int(frames_to_accumulate)
        if fog is not None:
            kw["fog"] = fog
        if texture_filter is not None:
            kw["texture_filter"] = str(texture_filter)
        if sampler is not None:
            kw["sampler"] = str(sampler)
        if light_sample is not None:
            kw["light_sample"] = str(light_sample)
        return dataclasses.replace(self, **kw)

    def clamp_to_terminal(self, term_width: int, term_height: int) -> "Scene":
        """Resolution clamp: width <= terminal width, height <= terminal
        height - 2 (two status rows), as in lib.rs:113-115. Floors at 2x2
        so a degenerate terminal can't produce an invalid scene."""
        return self.with_overrides(
            width=max(2, min(self.width, int(term_width))),
            height=max(2, min(self.height, int(term_height) - 2)),
        )

    # ---- SoA array export --------------------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Packed float32 SoA arrays (for grid builds / dynamic variants)."""

        def mat_cols(tag, prims):
            tex = [self.texture_channel(tag, p.material) for p in prims]
            nm = [self.normal_channel(tag, p.material) for p in prims]
            return (
                np.array([p.material.color for p in prims], np.float32).reshape(-1, 3),
                np.array([p.material.emission for p in prims], np.float32).reshape(-1, 3),
                np.array([p.material.reflectivity for p in prims], np.float32),
                np.array([p.material.transparency for p in prims], np.float32),
                np.array([p.material.ior for p in prims], np.float32),
                np.array([p.material.roughness for p in prims], np.float32),
                np.array([p.material.checker_color or (0.0, 0.0, 0.0)
                          for p in prims], np.float32).reshape(-1, 3),
                # scale 0 encodes "no checker" in the numeric channels.
                np.array([p.material.checker_scale if p.material.is_checker
                          else 0.0 for p in prims], np.float32),
                # Signed texture id (0 = none) + uv scale (texture_channel).
                np.array([ti for ti, _ in tex], np.float32),
                np.array([ts for _, ts in tex], np.float32),
                # Normal-map channels (normal_channel: id, scale, strength).
                np.array([c[0] for c in nm], np.float32),
                np.array([c[1] for c in nm], np.float32),
                np.array([c[2] for c in nm], np.float32),
            )

        (s_col, s_emi, s_ref, s_tra, s_ior, s_rgh, s_ckc,
         s_cks, s_txi, s_txs, s_nmi, s_nmx, s_nms) = mat_cols(
            SPHERE, self.spheres)
        (p_col, p_emi, p_ref, p_tra, p_ior, p_rgh, p_ckc,
         p_cks, p_txi, p_txs, p_nmi, p_nmx, p_nms) = mat_cols(
            PLANE, self.planes)
        (t_col, t_emi, t_ref, t_tra, t_ior, t_rgh, t_ckc,
         t_cks, t_txi, t_txs, t_nmi, t_nmx, t_nms) = mat_cols(
            TRIANGLE, self.triangles)
        return {
            "sphere_center": np.array([s.center for s in self.spheres], np.float32).reshape(-1, 3),
            "sphere_radius": np.array([s.radius for s in self.spheres], np.float32),
            "sphere_color": s_col, "sphere_emission": s_emi, "sphere_reflectivity": s_ref,
            "sphere_transparency": s_tra, "sphere_ior": s_ior, "sphere_roughness": s_rgh,
            "sphere_checker_color": s_ckc, "sphere_checker_scale": s_cks,
            "sphere_tex_index": s_txi, "sphere_tex_scale": s_txs,
            "sphere_nm_index": s_nmi, "sphere_nm_scale": s_nmx, "sphere_nm_strength": s_nms,
            "plane_point": np.array([p.point for p in self.planes], np.float32).reshape(-1, 3),
            "plane_normal": np.array([p.normal for p in self.planes], np.float32).reshape(-1, 3),
            "plane_color": p_col, "plane_emission": p_emi, "plane_reflectivity": p_ref,
            "plane_transparency": p_tra, "plane_ior": p_ior, "plane_roughness": p_rgh,
            "plane_checker_color": p_ckc, "plane_checker_scale": p_cks,
            "plane_tex_index": p_txi, "plane_tex_scale": p_txs,
            "plane_nm_index": p_nmi, "plane_nm_scale": p_nmx, "plane_nm_strength": p_nms,
            "triangle_v0": np.array([t.v0 for t in self.triangles], np.float32).reshape(-1, 3),
            "triangle_v1": np.array([t.v1 for t in self.triangles], np.float32).reshape(-1, 3),
            "triangle_v2": np.array([t.v2 for t in self.triangles], np.float32).reshape(-1, 3),
            "triangle_color": t_col, "triangle_emission": t_emi, "triangle_reflectivity": t_ref,
            "triangle_transparency": t_tra, "triangle_ior": t_ior, "triangle_roughness": t_rgh,
            "triangle_checker_color": t_ckc, "triangle_checker_scale": t_cks,
            "triangle_tex_index": t_txi, "triangle_tex_scale": t_txs,
            "triangle_nm_index": t_nmi, "triangle_nm_scale": t_nmx, "triangle_nm_strength": t_nms,
        }


# ---- JSON loading ----------------------------------------------------------


def _material(d: dict) -> Material:
    _check_material_dict(d)
    return Material(
        color=_f32v(d["color"]),
        emission=_f32v(d["emission"]),
        reflectivity=_f32(d["reflectivity"]),
        # Optional dielectric extension fields (absent in the reference's
        # serde structs, lib.rs:73-98; defaults keep reference parity).
        transparency=_f32(d.get("transparency", 0.0)),
        ior=_f32(d.get("ior", 1.5)),
        roughness=_f32(d.get("roughness", 0.0)),
        checker_color=(_f32v(d["checker_color"])
                       if "checker_color" in d else None),
        checker_scale=_f32(d.get("checker_scale", 1.0)),
        texture=d.get("texture"),
        texture_scale=_f32(d.get("texture_scale", 1.0)),
        normal_map=d.get("normal_map"),
        normal_scale=_f32(d.get("normal_scale", 1.0)),
        normal_strength=_f32(d.get("normal_strength", 1.0)),
    )


def _check_material_dict(d: dict) -> None:
    """Cross-field JSON checks _material's defaults would silently
    swallow ("bad configs fail loudly", Scene.__post_init__)."""
    if "checker_scale" in d and "checker_color" not in d:
        raise ValueError(
            "material has checker_scale but no checker_color — a checker "
            "texture needs both (did you misspell checker_color?)"
        )
    if "texture_scale" in d and "texture" not in d:
        raise ValueError(
            "material has texture_scale but no texture — an image texture "
            "needs both (did you misspell texture?)"
        )
    for k in ("normal_scale", "normal_strength"):
        if k in d and "normal_map" not in d:
            raise ValueError(
                f"material has {k} but no normal_map — a normal map needs "
                f"the map name (did you misspell normal_map?)"
            )


def scene_from_dict(cfg: dict, base_dir=None) -> Scene:
    """Build a Scene from a parsed JSON dict. ``base_dir`` resolves relative
    mesh OBJ paths (the directory of the scene file, when loaded from one).

    Schema superset: an optional ``meshes`` array (absent in the
    reference's serde structs) expands OBJ files into ordinary triangles at
    load time — models/mesh.py. Mesh triangles append AFTER the JSON
    ``triangles``, preserving the reference's observable flatten order for
    everything the reference can express."""
    mesh_tris = []
    if cfg.get("meshes"):
        from . import mesh as mesh_mod

        for m in cfg["meshes"]:
            mesh_tris.extend(
                mesh_mod.triangles_from_spec(m, base_dir=base_dir))
    cam = cfg["camera"]
    fog = None
    if cfg.get("fog") is not None:
        f = cfg["fog"]
        fog = Fog(
            density=_f32(f["density"]),
            albedo=_f32v(f.get("albedo", (1.0, 1.0, 1.0))),
            g=_f32(f.get("g", 0.0)),
        )
    sky = None
    if cfg.get("sky") is not None:
        s = cfg["sky"]
        # Short form: "sky": "name". Long form: {"texture": .., "intensity": ..}.
        if isinstance(s, str):
            sky = Sky(texture=s)
        elif isinstance(s, dict):
            if "texture" not in s:
                raise ValueError(
                    "scene 'sky' object needs a 'texture' name (or use the "
                    "short form: \"sky\": \"texture_name\")"
                )
            sky = Sky(texture=str(s["texture"]),
                      intensity=_f32(s.get("intensity", 1.0)))
        else:
            raise ValueError(
                f"scene 'sky' must be a texture name or an object, got "
                f"{type(s).__name__}"
            )
    tex_cfg = cfg.get("textures", {})
    if not isinstance(tex_cfg, dict):
        raise ValueError(
            f"scene 'textures' must be an object of name -> spec, got "
            f"{type(tex_cfg).__name__}"
        )
    textures = tuple(
        texture_from_spec(name, spec, base_dir=base_dir,
                          size=int(cfg.get("texture_size",
                                           _TEX_DEFAULT_SIZE)))
        for name, spec in tex_cfg.items()
    )
    return Scene(
        width=int(cfg["width"]),
        height=int(cfg["height"]),
        samples_per_pixel=int(cfg["samples_per_pixel"]),
        max_depth=int(cfg["max_depth"]),
        frames_to_accumulate=int(cfg["frames_to_accumulate"]),
        camera=Camera_Config(
            fov_degrees=_f32(cam["fov_degrees"]),
            char_aspect_ratio=_f32(cam["char_aspect_ratio"]),
            # Optional depth-of-field extension fields (absent in the
            # reference's schema; default = pinhole).
            aperture=_f32(cam.get("aperture", 0.0)),
            focus_distance=_f32(cam.get("focus_distance", 1.0)),
        ),
        spheres=tuple(
            Sphere(_f32v(s["center"]), _f32(s["radius"]), _material(s))
            for s in cfg.get("spheres", [])
        ),
        planes=tuple(
            Plane(_f32v(p["point"]), _f32v(p["normal"]), _material(p))
            for p in cfg.get("planes", [])
        ),
        # `triangles` is optional, like #[serde(default)] at lib.rs:62-63.
        triangles=tuple(
            Triangle(_f32v(t["v0"]), _f32v(t["v1"]), _f32v(t["v2"]), _material(t))
            for t in cfg.get("triangles", [])
        ) + tuple(mesh_tris),
        fog=fog,
        sky=sky,
        textures=textures,
        texture_filter=str(cfg.get("texture_filter", "nearest")),
        sampler=str(cfg.get("sampler", "reference")),
        light_sample=str(cfg.get("light_sample", "all")),
    )


def load_scene(path_or_name: Optional[str] = None) -> Scene:
    """Load a scene JSON from a filesystem path, or a packaged scene by
    name, or a procedural scene spec `stress:N[:seed]` (an N-sphere
    clustered field, models/gen.py — the many-primitive benchmark scene).

    With no argument, loads the packaged Cornell Box — the reference embeds
    the same default scene in its binary (lib.rs:104-108).

    `icosphere:S[:seed]` (models/gen.py) is the many-TRIANGLE procedural
    scene: an icosphere of 20 * 4**S faces over a floor — the triangle
    counterpart of `stress:N`, exercising the array-resident mesh sweep.

    `lights:L[:seed]` (models/gen.py) is the many-LIGHT procedural scene:
    a diffuse sphere field lit by L emissive spheres spanning ~2 decades
    of power — the benchmark/test fixture for the `light_sample`
    single-light NEE modes.
    """
    if isinstance(path_or_name, str) and path_or_name.startswith("icosphere:"):
        from .gen import icosphere_scene

        parts = path_or_name.split(":")
        try:
            s = int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (IndexError, ValueError):
            raise ValueError(
                f"bad procedural scene spec {path_or_name!r}; expected "
                f"icosphere:S or icosphere:S:seed"
            ) from None
        return icosphere_scene(s, seed=seed)
    if isinstance(path_or_name, str) and path_or_name.startswith("lights:"):
        from .gen import lights_scene

        parts = path_or_name.split(":")
        try:
            n = int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (IndexError, ValueError):
            raise ValueError(
                f"bad procedural scene spec {path_or_name!r}; expected "
                f"lights:L or lights:L:seed"
            ) from None
        return lights_scene(n, seed=seed)
    if isinstance(path_or_name, str) and path_or_name.startswith("stress:"):
        from .gen import stress_scene

        parts = path_or_name.split(":")
        try:
            n = int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (IndexError, ValueError):
            raise ValueError(
                f"bad procedural scene spec {path_or_name!r}; expected "
                f"stress:N or stress:N:seed"
            ) from None
        return stress_scene(n, seed=seed)
    if path_or_name is None:
        path = _SCENES_DIR / f"{DEFAULT_SCENE}.json"
    else:
        p = Path(path_or_name)
        if p.exists():
            path = p
        else:
            candidate = _SCENES_DIR / f"{path_or_name}.json"
            if not candidate.exists():
                raise FileNotFoundError(
                    f"scene not found: {path_or_name!r} (no such file, and no "
                    f"packaged scene named that; packaged: {list_scenes()})"
                )
            path = candidate
    try:
        cfg = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed scene JSON at {path}: {e}") from e
    return scene_from_dict(cfg, base_dir=path.parent)


def list_scenes():
    return sorted(p.stem for p in _SCENES_DIR.glob("*.json"))
