"""The path tracer as plain PyTorch over lanes —
``terminal_raytracer_tpu/ops/tracer.py`` with every scene extension of the
JAX package: the material and texture extensions (dielectrics, rough
metals, checker, image textures, normal maps, sky maps) and the transport
and camera extensions (the unbiased and MIS transports, fog, thin-lens
depth of field, the stratified sampler, one-light NEE).

This is the port's oracle and the plain version of the CUDA kernels
(ops/kernels.py): the same lane math the kernels run per thread, written as
masked tensor ops over a batch of lanes. Every RNG draw keeps the JAX
package's gate and order, so each pixel's chain is bit-identical to the
reference's thread; floating-point expressions keep its operation order.

Reference behaviours kept: emission added on every hit plus NEE over every
light each bounce; the NEE clamp at 10; the sky gradient on a miss; 1e-3
ray offsets; Russian roulette from bounce 4 (kill first, then compensate);
adaptive sampling with base = max(4, spp // 4), budget min(spp - base,
floor(var * 50)) iff var > 10, and the reference's normalisation quirks.

The extensions (``ext``) read per-primitive channels from the scene's
extension table (ops/geometry.py EXT_KEYS) and texels from the scene's
packed atlas (models/texture.py). The JAX package compiles each one in or
out by a static scene-level gate; here one path serves every extension
scene, because each extra draw and each recolor is already gated per lane
on its channel (fuzz on roughness > 0, the Fresnel draw on the glass
branch, which transparency 0 never takes since refl + 0 == refl; recolors
on a nonzero scale or id): a zero channel costs no draw and changes no
value. The JAX order of draws per bounce is kept: branch select, fuzz
pair, Fresnel, cosine pair, roulette. A texel fetch outside the atlas rows
[lo, hi) that the JAX package's row sweep covers gives 0, as there.

The transport and camera extensions (``xt``: any of transport 'unbiased'
or 'mis', fog, aperture > 0, a stratified grid of g > 1, one-light NEE)
are static gates here as in the JAX package: a gate that is off runs the
reference program's ops and draws. A tracer with a gate on renders from
xt tables (ops/geometry.py: the extension table widened by the
light-inverse-area channel, and one-light NEE's pick table) and carries
the transport's emit channel per lane (1 = may emit, fresh under
'reference'/'unbiased'; under 'mis' the previous scatter's continuous pdf,
-1 marking a delta history). Draw order per bounce: the fog distance
(gated on alive), the NEE draws (one-light: the selection, then one pair),
branch select, fuzz pair, Fresnel, cosine pair, the fog direction pair,
roulette; a camera ray takes the jitter pair, then the lens pair.

The scheduler is path regeneration (``regen_step``): a lane whose path ends
starts its next sample on the next iteration, so one loop covers a lane's
whole sample quota. Scheduling never changes a pixel's chain.

Traversal and heavy-pixel chunk split, resolved as the JAX ``PathTracer``
resolves them: ``accel='auto'`` takes the array traversal above
ARRAY_AUTO_THRESHOLD primitives, and from CHUNK_AUTO_THRESHOLD primitives
on the array traversal also splits each pixel's sample chain. Its base
quota becomes ceil(base / chunk_base) entries of <= chunk_base samples and
its extra budget entries of <= chunk_extra samples; entry c > 0 re-seeds a
sub-chain at state + c * CHUNK_GOLDEN and keeps absolute sample indices,
so chunk 0 is the head of the sequential chain. Lanes are then entries of
a chunk-major stream (entry i = chunk i // n_pix of pixel i % n_pix), and
a pixel's totals are its entries' sums added in chunk order.

The opt-in traversals 'grid' (the block-culled sweep, ops/accel.py) and
'gathered' (the grid walk, ops/gathered.py) never split a chain by
themselves (an explicit chunk_base or chunk_extra does); an animated
scene under 'grid' takes the runtime-value path (the grid is ignored, as
in the JAX package), and 'gathered' needs a static scene.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..models import scene as scene_mod
from ..utils import vml
from . import dynamic as dyn
from . import geometry as geom
from . import rng as prng
from . import sampling
from . import vecmath as vm
from .vecmath import V3

SKY_INTENSITY = 0.8
SKY_TOP = (0.5, 0.7, 1.0)
NEE_CLAMP = 10.0
RR_START_BOUNCE = 3  # roulette runs on bounce indices > 3
RR_MAX_SURVIVAL = 0.95
ADAPTIVE_VAR_THRESHOLD = 10.0
ADAPTIVE_VAR_SCALE = 50.0

ACCELS = ("auto", "baked", "array", "grid", "gathered")
ARRAY_AUTO_THRESHOLD = 96  # 'auto' sweeps arrays above this many primitives
CHUNK_AUTO_THRESHOLD = 512  # ... and chunk-splits from this many on
ARRAY_CHUNK_BASE = 2  # 'auto' chunk sizes at array scales
ARRAY_CHUNK_EXTRA = 2
CHUNK_GOLDEN = 0x9E3779B9

TRANSPORTS = ("reference", "unbiased", "mis")
_STRAT_NOTED: set = set()


class Cam(NamedTuple):
    """Per-frame camera basis (Python floats holding f32 values)."""

    pos: V3
    forward: V3
    right: V3
    up: V3


def cam_from_pose(pose) -> Cam:
    """Unpack a models.Camera.pose() (16,) f32 array."""
    p = [float(v) for v in np.asarray(pose, np.float32)[:12]]
    return Cam(V3(*p[0:3]), V3(*p[3:6]), V3(*p[6:9]), V3(*p[9:12]))


def sky_color(d: V3) -> V3:
    t = 0.5 * (d.y + 1.0)
    one = 1.0 - t
    return V3(
        (one + t * SKY_TOP[0]) * SKY_INTENSITY,
        (one + t * SKY_TOP[1]) * SKY_INTENSITY,
        (one + t * SKY_TOP[2]) * SKY_INTENSITY,
    )


def base_sample_count(spp: int) -> int:
    """base = max(4, spp // 4)."""
    return max(4, spp // 4)


def fresnel_schlick(cos_i, eta):
    """Schlick's reflectance r0 + (1 - r0)(1 - cos_i)^5 with r0 =
    ((1 - eta) / (1 + eta))^2."""
    r = (1.0 - eta) / (1.0 + eta)
    r0 = r * r
    m = 1.0 - cos_i
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def refract(d: V3, n: V3, eta):
    """Refract unit `d` about the front-face normal `n` with relative index
    eta. Returns (t_dir, cos_i, cos_t, tir); t_dir and cos_t mean nothing
    where tir (total internal reflection)."""
    cos_i = torch.clamp(-vm.dot(d, n), max=1.0)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    t_dir = d * eta + n * (eta * cos_i - cos_t)
    return t_dir, cos_i, cos_t, tir


def dominant_axes(n: V3):
    """(x-dominant, y-dominant) lanes of |n|, ties to the earlier axis."""
    ax, ay, az = torch.abs(n.x), torch.abs(n.y), torch.abs(n.z)
    xdom = (ax >= ay) & (ax >= az)
    return xdom, ~xdom & (ay >= az)


def _note_strat_fallback(reason: str) -> None:
    """One stderr note a reason that a stratified scene falls back."""
    if reason not in _STRAT_NOTED:
        _STRAT_NOTED.add(reason)
        print("note: sampler=stratified inactive: " + reason,
              file=sys.stderr)


def resolve_strat_g(scene: scene_mod.Scene, base_quota=None) -> int:
    """The stratified sampler's grid side g, as the JAX PathTracer resolves
    it: the largest power of two whose square divides the base count (1:
    the reference jitter; a stratified scene whose base count is not
    divisible by 4 notes on stderr that it falls back). A tracer with a
    `base_quota` (a sample-split shard, parallel/mesh.py) renders a share
    of the base phase on its own seed, where no grid covers every share:
    it falls back too."""
    if scene.sampler != "stratified":
        return 1
    if base_quota is not None:
        _note_strat_fallback(
            "sample-split shards render shard-local sample indices under "
            "decorrelated seeds — absolute strata don't survive the split; "
            "using reference jitter")
        return 1
    base = base_sample_count(scene.samples_per_pixel)
    g = 1
    while 4 * g * g <= base and base % (4 * g * g) == 0:
        g *= 2
    if g == 1:
        _note_strat_fallback(
            f"base sample count {base} is not divisible by 4 — no sub-pixel "
            "grid covers it evenly; using reference jitter")
    return g


def resolve_accel(scene: scene_mod.Scene, accel: str) -> str:
    """'baked', 'array', 'grid' or 'gathered', as the JAX PathTracer
    resolves `accel`."""
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r}; choose from {ACCELS}")
    if accel == "auto":
        return ("array" if scene.primitive_count > ARRAY_AUTO_THRESHOLD
                else "baked")
    return accel


def resolve_chunks(scene: scene_mod.Scene, accel: str, chunk_base="auto",
                   chunk_extra="auto", base_quota=None):
    """(chunk_base, chunk_extra) as the JAX PathTracer resolves them for a
    resolved `accel`; None is no split, and so is a chunk that covers the
    whole quota. 'auto' never splits under a `base_quota` (a sample-split
    shard manages its own runtime shares)."""
    base = (base_quota if base_quota is not None
            else base_sample_count(scene.samples_per_pixel))
    auto = (accel == "array" and scene.primitive_count >= CHUNK_AUTO_THRESHOLD
            and base_quota is None)
    if chunk_base == "auto":
        chunk_base = ARRAY_CHUNK_BASE if auto else None
    if chunk_extra == "auto":
        chunk_extra = ARRAY_CHUNK_EXTRA if auto else None
    if chunk_base is not None and int(chunk_base) >= base:
        chunk_base = None
    max_extra = max(scene.samples_per_pixel - base, 0)
    if chunk_extra is not None and int(chunk_extra) >= max_extra:
        chunk_extra = None
    return (None if chunk_base is None else int(chunk_base),
            None if chunk_extra is None else int(chunk_extra))


class Paths(NamedTuple):
    """Regeneration-scheduler carry, one entry per lane."""

    state: torch.Tensor  # int64 holding u32 RNG state
    samp: torch.Tensor  # int64 absolute sample index
    quota: torch.Tensor  # f32 absolute sample quota
    o: V3
    d: V3
    att: V3
    acc: V3  # radiance of the in-flight sample
    bounce: torch.Tensor  # int64
    alive: torch.Tensor  # bool
    csum: V3
    csumsq: V3
    rays: torch.Tensor  # f32 owed traversal sweeps
    emit: torch.Tensor  # f32 emit channel of the in-flight sample
    iters: torch.Tensor  # int64 executed bounce iterations


class PathTracer:
    """The path tracer for one scene on one device.

    `accel`, `chunk_base`, `chunk_extra`: as in the JAX PathTracer (module
    docstring). `base_quota`: the base samples a pixel renders, in place of
    max(4, spp // 4): a sample-split shard's share (parallel/mesh.py); such
    a tracer never stratifies and never splits chains by itself, and its
    kernel A may take a smaller runtime quota (ops/kernels.py base_q).
    `transport`: 'reference', 'unbiased' or 'mis'. `dynamic`:
    the scene's values arrive per frame through :meth:`bind_packed`
    (ops/dynamic.py); the template fixes the counts and the light
    topology. A scene that uses a material or texture extension
    (ops/geometry.py uses_extensions) gets scene tables with the extension
    table, and tables with that table render through the extension path
    (`ext`); a tracer with a transport or camera gate on gets xt tables,
    and xt tables render through the xt path (`xt`, which implies
    `ext`)."""

    def __init__(self, scene: scene_mod.Scene, device, accel: str = "auto",
                 chunk_base="auto", chunk_extra="auto", dynamic: bool = False,
                 transport: str = "reference", base_quota=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; choose from "
                             f"{TRANSPORTS}")
        self.scene = scene
        self.device = torch.device(device)
        if self.device.type == "cpu":
            vml.warm_vml()  # before any vector math of the process
        self.atlas = None
        # The kernels' traversal counters: None, or a zeroed int64 tensor
        # [4] on the card that the grid and gathered launches add to.
        self.accel_stats = None
        self.accel = resolve_accel(scene, accel)
        if dynamic and self.accel == "gathered":
            raise ValueError(
                "accel='gathered' needs static geometry (the grid and "
                "primitive tables are host-built); use accel='array' for "
                "animated scenes at scale")
        # The opt-in traversal the kernels take (None: the table sweep).
        self.traversal = (self.accel if self.accel in ("grid", "gathered")
                          and not dynamic else None)
        self.width, self.height = scene.width, scene.height
        self.spp = scene.samples_per_pixel
        self.max_depth = scene.max_depth
        self.base_quota = base_quota
        self.base_samples = (base_quota if base_quota is not None
                             else base_sample_count(self.spp))
        self.chunk_base, self.chunk_extra = resolve_chunks(
            scene, self.accel, chunk_base, chunk_extra, base_quota)
        # Entries per pixel of the base and the extra phase.
        self.n_base_chunks = (-(-self.base_samples // self.chunk_base)
                              if self.chunk_base else 1)
        max_extra = max(self.spp - self.base_samples, 0)
        self.n_extra_chunks = (-(-max_extra // self.chunk_extra)
                               if self.chunk_extra else 1)
        self.n_lights = len(scene.lights)
        self._light_kinds = [tag for tag, _ in scene.lights]
        self._init_gates(scene, transport)
        self.dynamic = dynamic
        ext = geom.uses_extensions(scene)
        pick = self.light_mode if self.one_light else None
        if dynamic:
            self.topology = dyn.topology(scene, ext, self.gated, pick)
            self.bind_packed(dyn.pack_scene(scene))
        else:
            # The opt-in traversals always render from xt tables (their
            # kernels are XT instantiations; every gate off is the
            # reference path).
            self.bind_tables(geom.scene_tables(
                scene, self.device, self.accel, ext,
                self.gated or self.traversal is not None, pick))
        # f32 camera intrinsics, computed as the JAX package computes them.
        self.half_height = float(
            np.tan(np.float32(scene.fov_rad) / np.float32(2)))
        self.half_width = float(np.float32(
            float(np.float32(scene.width) / np.float32(scene.height))
            * self.half_height))
        self.inv_char_aspect = float(
            np.float32(1.0) / np.float32(scene.camera.char_aspect_ratio))
        # Divisors as device tensors: a Python-scalar divisor would become
        # a reciprocal multiply on CUDA.
        self._w1 = torch.tensor(float(self.width - 1), device=self.device)
        self._h1 = torch.tensor(float(self.height - 1), device=self.device)
        self._focus = torch.tensor(float(np.float32(self.focus_distance)),
                                   device=self.device)

    def _init_gates(self, scene: scene_mod.Scene, transport: str) -> None:
        """The transport and camera gates, resolved as the JAX PathTracer
        resolves them, and the Python-float constants they fold (each
        rounded to f32 where it meets a tensor): the emit channel of a
        fresh camera ray, fog's -sigma and -1 / sigma (f64, rounded once),
        its albedo and HG anisotropy g, the lens, the stratified grid, and
        one-light NEE with its owed shadow sweeps per bounce."""
        self.transport = transport
        self._emit_fresh = -1.0 if transport == "mis" else 1.0
        self.has_fog = scene.has_fog
        if self.has_fog:
            self.fog_sigma = float(scene.fog.density)
            self.fog_albedo = tuple(float(c) for c in scene.fog.albedo)
            self.fog_g = float(scene.fog.g)
            self._neg_sigma = -self.fog_sigma
            self._neg_inv_sigma = -1.0 / self.fog_sigma
        self.aperture = float(scene.camera.aperture)
        self.focus_distance = float(scene.camera.focus_distance)
        self.strat_g = resolve_strat_g(scene, self.base_quota)
        mode = scene.light_sample
        self.one_light = mode != "all" and self.n_lights > 1
        self.light_mode = mode if self.one_light else "all"
        self.nee_sweeps = 1 if self.one_light else self.n_lights
        self.gated = (transport != "reference" or self.has_fog
                      or self.aperture > 0.0 or self.strat_g > 1
                      or self.one_light)

    def bind_tables(self, tables: geom.SceneTables) -> None:
        """Render from `tables` from now on. The kernels read `tables.buf`
        alone; the plain sweep and light list are built on first use.
        Tables with the extension table take the extension path (and the
        scene's texel atlas) even for a scene that uses no extension, and
        xt tables the xt path even with every gate off."""
        if self.gated and not tables.has_xt:
            raise ValueError("a tracer with a transport or camera gate on "
                             "renders from xt tables")
        if self.one_light and tables.pick.numel() != 2 * self.n_lights + 1:
            raise ValueError("one-light NEE needs the tables' pick table")
        self.tables = tables
        self._prims = self._lights = None
        self.accel_launch = None  # the kernels' trt::Accel of these tables
        self.ext = tables.has_ext
        self.xt = tables.has_xt
        if self.ext and self.atlas is None:
            self._init_textures(self.scene)

    @property
    def prims(self) -> geom.ScenePrims:
        if self._prims is None:
            if self.traversal == "grid":
                from .accel import CulledPrims as prims
            elif self.traversal == "gathered":
                from .gathered import GatheredPrims as prims
            else:
                prims = geom.ScenePrims
            self._prims = prims(self.tables)
        return self._prims

    @property
    def lights(self):
        """Per NEE light: (kind, emission, area, a, b, c, normal)."""
        if self._lights is None:
            self._lights = []
            for kind, row in zip(self._light_kinds, self.tables.lights):
                emission = V3(row[1], row[2], row[3])
                a, b, c, n = (V3(row[i], row[i + 1], row[i + 2])
                              for i in (5, 8, 11, 14))
                self._lights.append((kind, emission, row[4], a, b, c, n))
        return self._lights

    def bind_packed(self, arrays) -> None:
        """Animated scenes: render from the ops/dynamic.pack_scene `arrays`
        (one frame's values) from now on."""
        self.bind_tables(dyn.tables_from_packed(arrays, self.topology,
                                                self.device))

    # ------------------------------------------------------------------
    # Textures: the atlas and the fetches (JAX PathTracer :695-901)
    # ------------------------------------------------------------------

    def _init_textures(self, scene: scene_mod.Scene) -> None:
        """The flat int32 atlas on the device and the scene-level texture
        constants, which the kernels take as launch arguments: texels per
        side S, atlas rows per texture, the filter, the atlas rows [lo, hi)
        of the textures the primitives' colors and normal maps use (the
        JAX package's static sweep bounds), the sky texture's first row (-1:
        the gradient sky) and the sky intensity."""
        self.atlas = torch.from_numpy(
            scene.texture_atlas().reshape(-1)).to(self.device)
        self.tex_size = scene.texture_size
        self.tex_rows = scene.texture_rows
        self.tex_bilinear = scene.tex_bilinear

        def rows_of(names):
            tids = sorted(scene.texture_index(n) for n in names)
            if not tids:
                return 0, 0
            return (tids[0] - 1) * self.tex_rows, tids[-1] * self.tex_rows

        mats = [p.material for _, p in scene.primitives]
        self.tex_lo, self.tex_hi = rows_of(
            m.texture for m in mats if m.is_textured)
        self.nm_lo, self.nm_hi = rows_of(
            m.normal_map for m in mats if m.is_normal_mapped)
        self.sky_lo, self.sky_intensity = -1, 0.0
        if scene.has_sky_texture:
            self.sky_lo = ((scene.texture_index(scene.sky.texture) - 1)
                           * self.tex_rows)
            self.sky_intensity = float(np.float32(scene.sky.intensity))

    @staticmethod
    def unpack_texel(packed: torch.Tensor) -> V3:
        """models/texture.py packing r<<16 | g<<8 | b -> [0, 1] rgb. Texels
        are below 2**24, so >> on the signed integers equals the JAX
        package's logical shift."""
        q = 1.0 / 255.0
        return V3((packed >> 16).to(torch.float32) * q,
                  ((packed >> 8) & 255).to(torch.float32) * q,
                  (packed & 255).to(torch.float32) * q)

    def fetch_texel(self, idx: torch.Tensor, lo: int, hi: int) -> V3:
        """The texel at flat atlas index `idx` (int64 lanes), or 0 outside
        atlas rows [lo, hi), as the JAX package's row sweep gives."""
        ok = (idx >= lo * 128) & (idx < hi * 128)
        packed = self.atlas[torch.where(ok, idx, 0)]
        return self.unpack_texel(torch.where(ok, packed, 0))

    def fetch_bilinear(self, base, u, v, lo: int, hi: int) -> V3:
        """The 2x2 texel blend around wrapped uv (texel centers at
        (i + 0.5) / S; neighbours wrap with & (S - 1) in two's complement)
        of the texture whose texel 0 is at flat index `base`."""
        s, m = float(self.tex_size), self.tex_size - 1
        x = u * s - 0.5
        y = v * s - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        iu0 = x0.to(torch.int64) & m
        iv0 = y0.to(torch.int64) & m
        iu1 = (iu0 + 1) & m
        iv1 = (iv0 + 1) & m
        r0 = base + iv0 * self.tex_size
        r1 = base + iv1 * self.tex_size
        t00, t01, t10, t11 = (
            self.fetch_texel(torch.clamp(i, min=0), lo, hi)
            for i in (r0 + iu0, r0 + iu1, r1 + iu0, r1 + iu1))
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        return top + (bot - top) * fy

    def _nearest_index(self, u, v):
        """The texel of uv in [0, 1] on an S x S grid, clamped at 1."""
        s, smax = float(self.tex_size), self.tex_size - 1
        iu = torch.clamp(torch.floor(u * s).to(torch.int64), max=smax)
        iv = torch.clamp(torch.floor(v * s).to(torch.int64), max=smax)
        return iv * self.tex_size + iu

    @staticmethod
    def spherical_uv(n: V3):
        """Longitude/latitude uv of a unit vector (sampling.atan2)."""
        half_inv_pi = 0.5 / sampling.PI
        u = 0.5 + sampling.atan2(n.z, n.x) * half_inv_pi
        ny = torch.clamp(n.y, -1.0, 1.0)
        v = 0.5 + sampling.atan2(
            ny, torch.sqrt(torch.clamp(1.0 - ny * ny, min=0.0))
        ) * (2.0 * half_inv_pi)
        return u, v

    def sky_radiance(self, d: V3) -> V3:
        """The sky map's texel in direction `d`, times the sky intensity."""
        u, v = self.spherical_uv(d)
        lo, hi = self.sky_lo, self.sky_lo + self.tex_rows
        if self.tex_bilinear:
            texel = self.fetch_bilinear(lo * 128, u, v, lo, hi)
        else:
            texel = self.fetch_texel(lo * 128 + self._nearest_index(u, v),
                                     lo, hi)
        return texel * self.sky_intensity

    def mapped_texel(self, hit: geom.Hit, signed_id, scale, lo: int,
                     hi: int) -> V3:
        """The texel of texture |signed_id| at the hit: +id maps the hit
        point planar along the normal's dominant axis (x -> (z, y), y ->
        (x, z), z -> (x, y)), -id maps the normal's longitude/latitude;
        `scale` tiles the uv. Lanes with id 0 fetch a texel the caller
        drops."""
        n, p = hit.normal, hit.p
        xdom, ydom = dominant_axes(n)
        u_pl = torch.where(xdom, p.z, p.x)
        v_pl = torch.where(xdom, p.y, torch.where(ydom, p.z, p.y))
        u_sp, v_sp = self.spherical_uv(n)
        spherical = signed_id < 0.0
        u = torch.where(spherical, u_sp, u_pl) * scale
        v = torch.where(spherical, v_sp, v_pl) * scale
        u = u - torch.floor(u)
        v = v - torch.floor(v)
        tid = torch.abs(signed_id).to(torch.int64)
        base = (tid - 1) * (self.tex_rows * 128)
        if self.tex_bilinear:
            return self.fetch_bilinear(base, u, v, lo, hi)
        return self.fetch_texel(
            torch.clamp(base + self._nearest_index(u, v), min=0), lo, hi)

    def apply_normal_map(self, hit: geom.Hit) -> geom.Hit:
        """Bend the (front-facing) shading normal by the tangent-space
        normal map: texel rgb -> [-1, 1] xyz, the tangential part scaled by
        the strength, z kept above 1e-3, renormalized. Planar lanes take the
        two world axes their uv projects on; spherical lanes the longitude
        tangent (-n.z, 0, n.x) / len (+x at the poles) and its bitangent.
        `front` stays geometric."""
        ni = hit.nm_index
        texel = self.mapped_texel(hit, ni, hit.nm_scale, self.nm_lo,
                                  self.nm_hi)
        tn = texel * 2.0 - V3(1.0, 1.0, 1.0)
        n = hit.normal
        xdom, ydom = dominant_axes(n)
        zeros = torch.zeros_like(n.x)
        t_pl = vm.where(xdom, V3(zeros, zeros, zeros + 1.0),
                        V3(zeros + 1.0, zeros, zeros))
        b_pl = vm.where(xdom | ~ydom, V3(zeros, zeros + 1.0, zeros),
                        V3(zeros, zeros, zeros + 1.0))
        len2 = n.x * n.x + n.z * n.z
        inv = 1.0 / torch.sqrt(torch.clamp(len2, min=1e-12))
        pole = len2 < 1e-12
        t_sp = V3(torch.where(pole, 1.0, -n.z * inv), zeros,
                  torch.where(pole, 0.0, n.x * inv))
        b_sp = vm.cross(n, t_sp)
        spherical = ni < 0.0
        t_v = vm.where(spherical, t_sp, t_pl)
        b_v = vm.where(spherical, b_sp, b_pl)
        ns = hit.nm_strength
        raw = (t_v * (tn.x * ns) + b_v * (tn.y * ns)
               + n * torch.clamp(tn.z, min=1e-3))
        return hit._replace(
            normal=vm.where(ni != 0.0, vm.normalize(raw), n))

    def shade_hit(self, hit: geom.Hit) -> geom.Hit:
        """The extension recolors and the normal map, in the JAX order:
        checker (odd cells of a world-space 3-D checkerboard with edge
        1 / scale, lattice offset by 0.5), then the image texture (which
        wins over the checker), then the normal map (whose uv still comes
        from the geometric normal)."""
        k = hit.checker_scale
        p = hit.p
        cells = (torch.floor(p.x * k + 0.5) + torch.floor(p.y * k + 0.5)
                 + torch.floor(p.z * k + 0.5))
        odd = (cells - 2.0 * torch.floor(cells * 0.5)) > 0.5
        color = vm.where((k > 0.0) & odd, hit.checker_color, hit.color)
        ti = hit.tex_index
        texel = self.mapped_texel(hit, ti, hit.tex_scale, self.tex_lo,
                                  self.tex_hi)
        hit = hit._replace(color=vm.where(ti != 0.0, texel, color))
        return self.apply_normal_map(hit)

    # ------------------------------------------------------------------

    def stratify_jitter(self, samp, rx, ry):
        """The stratified sampler: a base-phase sample's jitter (rx, ry)
        remapped into cell samp mod g^2 of the g x g sub-pixel grid (`samp`
        the pixel's absolute sample index, int64 lanes); extra samples
        (samp >= base) keep the raw jitter."""
        g = self.strat_g
        in_base = samp < self.base_samples
        cx = (samp & (g - 1)).to(torch.float32)
        cy = ((samp >> (g.bit_length() - 1)) & (g - 1)).to(torch.float32)
        inv_g = 1.0 / float(g)
        return (torch.where(in_base, (cx + rx) * inv_g, rx),
                torch.where(in_base, (cy + ry) * inv_g, ry))

    def gen_ray(self, state, cam: Cam, xf, yf, gate=None, samp=None):
        """One camera ray per lane: two jitter draws (stratified by the
        absolute sample index `samp` when strat_g > 1), NDC with the
        char-aspect squash, then the camera basis; with an aperture, the
        thin lens: two more draws pick a point on the lens disk, and the
        ray aims from it at the pinhole ray's point on the focus plane."""
        state, rx = prng.next_f32(state, gate)
        state, ry = prng.next_f32(state, gate)
        if self.strat_g > 1:
            rx, ry = self.stratify_jitter(samp, rx, ry)
        u = (xf + rx) / self._w1
        v = ((self.height - 1) - yf + ry) / self._h1
        ndc_x = 2.0 * u - 1.0
        ndc_y = (2.0 * v - 1.0) * self.inv_char_aspect
        vx = self.half_width * ndc_x
        vy = self.half_height * ndc_y
        d = vm.normalize(cam.right * vx + cam.up * vy + cam.forward)
        zeros = torch.zeros_like(d.x)
        o = V3(zeros + cam.pos.x, zeros + cam.pos.y, zeros + cam.pos.z)
        if self.aperture > 0.0:
            state, r1, r2 = prng.next_f32_pair(state, gate)
            lr = self.aperture * torch.sqrt(r1)
            phi = sampling.TWO_PI * r2
            t_focus = self._focus / vm.dot(d, cam.forward)
            p_focus = o + d * t_focus
            o = (o + cam.right * (lr * torch.cos(phi))
                 + cam.up * (lr * torch.sin(phi)))
            d = vm.normalize(p_focus - o)
        return state, o, d

    def direct_light(self, state, p: V3, normal: V3, color: V3, att: V3,
                     gate, refl=None, fog=None, rough=None):
        """One NEE estimate per light, in light order (or of one picked
        light, _one_light_nee); returns (state', direct). RNG advances only
        on `gate` lanes. `refl` (mis): the hit's delta-branch probability
        (reflectivity + transparency). `fog`: (scatter mask, scatter point,
        incoming direction); scatter lanes sample from the scatter point
        with the phase function, and every lane's estimate carries the
        shadow segment's transmittance. `rough` (mis): (roughness,
        reflectivity, mirror direction) of the fuzz lobe, whose pdf joins
        the balance weights."""
        zeros = torch.zeros_like(p.x)
        direct = vm.splat(zeros)
        brdf = color * (1.0 / sampling.PI)
        if fog is not None:
            scatter, sp, _ = fog
            p = vm.where(scatter, sp, p)
            if self.fog_g == 0.0:
                phase = V3(*(c * (1.0 / (4.0 * sampling.PI))
                             for c in self.fog_albedo))
                brdf = vm.where(scatter, vm.splat(zeros) + phase, brdf)
        if self.one_light:
            return self._one_light_nee(state, p, normal, brdf, att, gate,
                                       refl, fog, rough)
        for kind, emission, area, a, b, c, n in self.lights:
            if kind == scene_mod.SPHERE:
                state, lp, ln = sampling.sphere_light_point(state, a, b.x,
                                                            gate)
            else:
                state, lp = sampling.triangle_light_point(state, a, b, c,
                                                          gate)
                ln = n
            ok, contrib = self._nee_sample(p, normal, brdf, att, gate, lp,
                                           ln, area, emission, None, refl,
                                           fog, rough)
            direct = direct + vm.where(ok, contrib, vm.splat(zeros))
        return state, direct

    def _nee_sample(self, p, normal, brdf, att, gate, lp, ln, area, emission,
                    psel, refl, fog, rough):
        """The NEE estimate toward the light point `lp` (normal `ln`, light
        `area` and `emission`): (ok, clamped contribution). `psel`: the
        pick probability of one-light NEE (None: every light is sampled).
        Under 'mis' the shadow segment runs from the offset origin and the
        estimate is balance-weighted against the BSDF (or phase) density,
        which in fog carries exp(-sigma t)."""
        lvec = lp - p
        ldist = vm.length(lvec)
        ldir = lvec / ldist
        shadow_o = p + normal * geom.RAY_EPS
        if fog is not None:
            scatter, _, d_in = fog
            shadow_o = vm.where(scatter, p, shadow_o)
        if self.transport == "mis":
            lvec_s = lp - shadow_o
            ldist_s = vm.length(lvec_s)
            sh_dir, sh_tmax = lvec_s / ldist_s, ldist_s - geom.RAY_EPS
        else:
            sh_dir, sh_tmax = ldir, ldist - geom.RAY_EPS
        blocked = self.prims.occluded(shadow_o, sh_dir, geom.RAY_EPS,
                                      sh_tmax, gate)
        cos_s = torch.clamp(vm.dot(normal, ldir), min=0.0)
        if fog is not None:
            cos_s = torch.where(scatter, 1.0, cos_s)
        cos_l = torch.clamp(vm.dot(ln, -ldir), min=0.0)
        ok = ~blocked & (cos_s > 0.0) & (cos_l > 0.0)
        geom_term = (cos_s * cos_l) / (ldist * ldist)
        weight = geom_term * area
        if psel is not None:
            weight = weight * (1.0 / psel)
        if fog is not None:
            trans = torch.exp(self._neg_sigma * ldist)
            weight = weight * trans
        if self.transport == "mis":
            l2 = ldist * ldist
            if psel is not None:
                l2 = psel * l2
            p_l = l2 / (torch.clamp(cos_l, min=1e-8) * area)
            p_b = (1.0 - refl) * cos_s * (1.0 / sampling.PI)
            mix = 1.0 - refl
            if rough is not None:
                f_r, m_refl, m_dir = rough
                metal = m_refl * sampling.fuzz_pdf(vm.dot(m_dir, ldir), f_r)
                p_b = p_b + metal
                mix = mix + metal * sampling.PI / torch.clamp(cos_s, min=1e-8)
            if fog is not None:
                ph_pdf = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
                p_b = torch.where(scatter, ph_pdf, p_b)
                mix = torch.where(scatter, 1.0, mix)
                p_b = p_b * trans
            weight = weight * (mix * p_l / torch.clamp(p_l + p_b, min=1e-20))
        if fog is not None and self.fog_g != 0.0:
            ph = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
            brdf = vm.where(scatter, V3(*self.fog_albedo) * ph, brdf)
        contrib = (brdf * emission) * (att * weight)
        return ok, vm.min_components(contrib, NEE_CLAMP)

    def _one_light_nee(self, state, p, normal, brdf, att, gate, refl, fog,
                       rough):
        """One-light NEE: a selection draw picks light i with probability
        p_i (the pick table of ops/geometry.py), one pair of draws samples
        a point on it (either kind takes two), and the estimate carries
        1 / p_i (under 'mis' the NEE density carries p_i). The picked index
        is the count of selection thresholds cums[:-1] at or below the
        draw, the JAX package's ladder of comparisons; the light's row is
        then indexed."""
        n = self.n_lights
        pick = self.tables.pick
        state, u_sel = prng.next_f32(state, gate)
        state, r1, r2 = prng.next_f32_pair(state, gate)
        idx = (u_sel[..., None] >= pick[n:2 * n - 1]).sum(-1)
        rows = self.tables.lights[idx]
        a, b, c, ln_t = (geom._row3(rows, i) for i in (5, 8, 11, 14))
        cos_theta = 1.0 - 2.0 * r1
        sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
        phi = sampling.TWO_PI * r2
        local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                   cos_theta)
        sqrt_r1 = torch.sqrt(r1)
        bu = 1.0 - sqrt_r1
        bv = r2 * sqrt_r1
        sphere = rows[..., 0] == float(scene_mod.SPHERE)
        lp = vm.where(sphere, a + local * b.x, a * (1.0 - bu - bv) + b * bu
                      + c * bv)
        ln = vm.where(sphere, local, ln_t)
        psel = torch.clamp(pick[idx], min=1e-12)
        ok, contrib = self._nee_sample(p, normal, brdf, att, gate, lp, ln,
                                       rows[..., 4], geom._row3(rows, 1),
                                       psel, refl, fog, rough)
        return state, vm.where(ok, contrib, vm.splat(torch.zeros_like(p.x)))

    def bounce_step(self, state, o: V3, d: V3, att: V3, acc: V3, alive,
                    bounce_idx, rays, emit):
        """Advance every live lane by one bounce. Returns (state, o', d',
        att', acc', alive', rays', emit'); alive' drops lanes that missed
        (sky added), were killed by Russian roulette or (ext) absorbed.
        `emit` is the transport's emit channel (module docstring)."""
        zeros = torch.zeros_like(o.x)
        hit = self.prims.closest_hit(o, d, geom.RAY_EPS, geom.T_FAR, alive)
        rays = rays + alive.to(torch.float32)
        if self.ext:
            hit = self.shade_hit(hit)
        scatter = None
        if self.has_fog:
            # The scatter distance t = -ln(1 - u) / sigma; a draw short of
            # the surface makes this bounce a volume scattering event.
            state, u_d = prng.next_f32(state, alive)
            t_scat = (torch.log(torch.clamp(1.0 - u_d, min=1e-12))
                      * self._neg_inv_sigma)
            t_limit = torch.where(hit.found, hit.t, geom.T_FAR)
            scatter = alive & (t_scat < t_limit)
            sp = o + d * t_scat
        miss_now = alive & ~hit.found
        live = alive & hit.found
        if scatter is not None:
            miss_now = miss_now & ~scatter
            live = live & ~scatter
        sky = (self.sky_radiance(d) if self.ext and self.sky_lo >= 0
               else sky_color(d))
        acc = acc + vm.where(miss_now, sky * att, vm.splat(zeros))
        acc = acc + self._emission(hit, d, att, live, emit)
        nee_refl = hit.reflectivity
        rough_mis = None
        if self.xt:
            nee_refl = nee_refl + hit.transparency
            if self.transport == "mis":
                rough_mis = (hit.roughness, hit.reflectivity,
                             vm.reflect(d, hit.normal))
        nee_gate = live if scatter is None else live | scatter
        state, direct = self.direct_light(
            state, hit.p, hit.normal, hit.color, att, nee_gate, nee_refl,
            None if scatter is None else (scatter, sp, d), rough_mis)
        if self.ext and self.transport != "mis":
            # No matte NEE ghost on glass: scale by the non-glass share
            # (not at volume scatter points; 'mis' weighs it in).
            ghost = 1.0 - hit.transparency
            if scatter is not None:
                ghost = torch.where(scatter, 1.0, ghost)
            direct = direct * ghost
        acc = acc + vm.where(nee_gate, direct, vm.splat(zeros))
        rays = rays + torch.where(nee_gate, float(self.nee_sweeps), 0.0)

        # Scatter: mirror, glass (ext) or diffuse on one draw.
        state, r_spec = prng.next_f32(state, live)
        is_refl = hit.reflectivity > r_spec
        refl_dir = vm.reflect(d, hit.normal)
        diffuse = live & ~is_refl
        if self.ext:
            # Fuzzy mirror: reflect + roughness * a uniform direction,
            # renormalized; a fuzzed direction at or below the surface
            # absorbs the path.
            fuzzy = hit.roughness > 0.0
            state, fz = sampling.uniform_sphere_dir(state,
                                                    live & is_refl & fuzzy)
            raw = refl_dir + fz * hit.roughness
            len2 = vm.dot(raw, raw)
            fuzzed = raw * (1.0 / torch.sqrt(torch.clamp(len2, min=1e-12)))
            below = vm.dot(fuzzed, hit.normal) <= 0.0
            absorbed = live & is_refl & fuzzy & (below | (len2 < 1e-12))
            refl_dir = vm.where(fuzzy & is_refl, fuzzed, refl_dir)
            # Glass on refl <= r < refl + transparency: Fresnel-weighted
            # reflect (a perfect mirror) or refract, on one more draw.
            is_glass = ~is_refl & (hit.reflectivity + hit.transparency
                                   > r_spec)
            ior = torch.where(hit.transparency > 0.0, hit.ior, 1.0)
            eta = torch.where(hit.front, 1.0 / ior, ior)
            t_dir, cos_i, cos_t, tir = refract(d, hit.normal, eta)
            fres = fresnel_schlick(torch.where(eta > 1.0, cos_t, cos_i), eta)
            state, r_fr = prng.next_f32(state, live & is_glass)
            # (refl_dir is unfuzzed on glass lanes, where is_refl is off.)
            glass_dir = vm.where(tir | (fres > r_fr), refl_dir, t_dir)
            diffuse = diffuse & ~is_glass
        state, cos_dir = sampling.cosine_hemisphere(state, hit.normal,
                                                    diffuse)
        new_d = vm.where(is_refl, refl_dir, cos_dir)
        if self.ext:
            new_d = vm.where(is_glass, glass_dir, new_d)
        att = vm.where(live, att * hit.color, att)
        new_o = hit.p + new_d * geom.RAY_EPS
        if scatter is not None:
            # Volume scatter: a phase-sampled direction from the scatter
            # point (uniform at g = 0); the throughput takes the albedo.
            if self.fog_g != 0.0:
                state, fog_dir = sampling.henyey_greenstein_dir(
                    state, d, self.fog_g, scatter)
            else:
                state, fog_dir = sampling.uniform_sphere_dir(state, scatter)
            new_d = vm.where(scatter, fog_dir, new_d)
            new_o = vm.where(scatter, sp + fog_dir * geom.RAY_EPS, new_o)
            att = vm.where(scatter, att * V3(*self.fog_albedo), att)
            live = live | scatter  # scatter events continue like hits

        # Russian roulette: kill first, compensate survivors.
        rr_on = live & (bounce_idx > RR_START_BOUNCE)
        state, r_rr = prng.next_f32(state, rr_on)
        p_surv = torch.clamp(vm.max_component(att), max=RR_MAX_SURVIVAL)
        killed = rr_on & ((p_surv < r_rr) | (p_surv <= 0.0))
        att = vm.where(rr_on & ~killed, att / p_surv, att)
        alive = live & ~killed
        if self.ext:
            alive = alive & ~absorbed

        # Sanitize dead lanes so NaNs can't leak into the next sweep.
        d_out = vm.where(alive, new_d, V3(zeros, zeros, zeros + 1.0))
        o = vm.where(alive, new_o, vm.splat(zeros))
        if self.xt:
            emit = self._next_emit(hit, d, new_d, is_refl | is_glass, is_refl
                                   & fuzzy, nee_refl, scatter, fog_dir
                                   if scatter is not None else None)
        return state, o, d_out, att, acc, alive, rays, emit

    def _emission(self, hit: geom.Hit, d: V3, att: V3, live, emit) -> V3:
        """The hit's emission term on `live` lanes: at full weight under
        'reference'; under 'unbiased' only where NEE could not have sampled
        the emitter (a delta history, emit != 0, or lia == 0); under 'mis'
        balance-weighted against the NEE density t^2 lia / cos_l (times
        the pick probability under one-light NEE; the previous scatter's
        density carries exp(-sigma t) in fog)."""
        zeros = vm.splat(torch.zeros_like(att.x))
        if self.transport == "reference":
            return vm.where(live, hit.emission * att, zeros)
        if self.transport == "unbiased":
            gate = live & ((emit != 0.0) | (hit.lia == 0.0))
            return vm.where(gate, hit.emission * att, zeros)
        cos_l = torch.clamp(vm.dot(hit.normal, -d), min=0.0)
        t2 = hit.t * hit.t
        p_nee = t2 * hit.lia / torch.clamp(cos_l, min=1e-8)
        if self.light_mode == "uniform":
            p_nee = p_nee * (1.0 / self.n_lights)
        elif self.light_mode == "power":
            e = hit.emission
            lum = (geom.LUM[0] * e.x + geom.LUM[1] * e.y + geom.LUM[2] * e.z)
            p_nee = torch.where(
                hit.lia > 0.0, t2 * lum * self.tables.pick[-1]
                / torch.clamp(cos_l, min=1e-8), 0.0)
        p_prev = torch.clamp(emit, min=0.0)
        if self.has_fog:
            p_prev = p_prev * torch.exp(self._neg_sigma * hit.t)
        denom = p_prev + p_nee
        w_emit = torch.where(emit < 0.0, 1.0,
                             p_prev / torch.where(denom > 0.0, denom, 1.0))
        return vm.where(live, hit.emission * (att * w_emit), zeros)

    def _next_emit(self, hit: geom.Hit, d: V3, new_d: V3, is_delta, fuzzed,
                   nee_refl, scatter, fog_dir):
        """The emit channel after this bounce: 'mis' carries the continuous
        part's pdf of the scatter just taken ((1 - refl - transparency)
        cos / pi, plus the fuzz lobe's; a fuzzed mirror is continuous), -1
        after a delta scatter, the phase pdf after a volume scatter; the
        other transports carry 1 after a delta scatter, else 0."""
        if self.transport != "mis":
            emit = torch.where(is_delta, 1.0, 0.0)
            if scatter is not None:
                emit = torch.where(scatter, 0.0, emit)
            return emit
        cos_new = torch.clamp(vm.dot(hit.normal, new_d), min=0.0)
        p_cont = (1.0 - nee_refl) * cos_new * (1.0 / sampling.PI)
        p_cont = p_cont + hit.reflectivity * sampling.fuzz_pdf(
            vm.dot(vm.reflect(d, hit.normal), new_d), hit.roughness)
        emit = torch.where(is_delta & ~fuzzed, -1.0, p_cont)
        if scatter is not None:
            emit = torch.where(scatter, sampling.hg_phase(
                vm.dot(d, fog_dir), self.fog_g), emit)
        return emit

    # ------------------------------------------------------------------
    # Path regeneration
    # ------------------------------------------------------------------

    def regen_carry0(self, state, samp0, quota) -> Paths:
        zeros = torch.zeros_like(quota)
        return Paths(
            state=state, samp=samp0, quota=quota,
            o=vm.splat(zeros), d=V3(zeros, zeros, zeros + 1.0),
            att=vm.splat(zeros), acc=vm.splat(zeros),
            bounce=torch.zeros_like(samp0),
            alive=torch.zeros(quota.shape, dtype=torch.bool,
                              device=quota.device),
            csum=vm.splat(zeros), csumsq=vm.splat(zeros), rays=zeros,
            emit=zeros, iters=torch.zeros_like(samp0),
        )

    def regen_step(self, cam: Cam, xf, yf, c: Paths) -> Paths:
        """One scheduler iteration: regenerate finished lanes, advance every
        live lane one bounce, fold finished samples into the sums."""
        zeros = torch.zeros_like(xf)
        need = ~c.alive & (c.samp.to(torch.float32) < c.quota)
        state = prng.advance_sample(c.state, c.samp, need)
        state, o2, d2 = self.gen_ray(state, cam, xf, yf, need, c.samp)
        o = vm.where(need, o2, c.o)
        d = vm.where(need, d2, c.d)
        att = vm.where(need, vm.splat(zeros + 1.0), c.att)
        acc = vm.where(need, vm.splat(zeros), c.acc)
        bounce = torch.where(need, 0, c.bounce)
        alive = c.alive | need
        emit = torch.where(need, self._emit_fresh, c.emit)

        executed = alive
        state, o, d, att, acc, alive, rays, emit = self.bounce_step(
            state, o, d, att, acc, alive, bounce, c.rays, emit)

        # A sample ends on a miss or roulette kill, or at max_depth.
        bounce = torch.where(executed, bounce + 1, bounce)
        at_depth = alive & (bounce >= self.max_depth)
        finished = (executed & ~alive) | at_depth
        csum = c.csum + vm.where(finished, acc, vm.splat(zeros))
        csumsq = c.csumsq + vm.where(finished, acc * acc, vm.splat(zeros))
        samp = c.samp + finished.to(torch.int64)
        alive = alive & ~at_depth
        return Paths(state, samp, c.quota, o, d, att, acc, bounce, alive,
                     csum, csumsq, rays, emit,
                     c.iters + executed.to(torch.int64))

    def run_regen(self, cam: Cam, xf, yf, c: Paths):
        """Iterate regen_step until no lane owes work. Returns (carry,
        iterations)."""
        max_iters = (self.spp + 1) * self.max_depth + 4  # safety bound
        it = 0
        while it < max_iters:
            pending = c.alive | (c.samp.to(torch.float32) < c.quota)
            if not bool(pending.any()):
                break
            c = self.regen_step(cam, xf, yf, c)
            it += 1
        return c, it

    # ------------------------------------------------------------------
    # The two phases and their glue
    # ------------------------------------------------------------------

    def seed_lanes(self, x, y, seed: int, frame_number: int):
        return prng.seed_pixel(y * self.width + x, seed, frame_number)

    def base_entries(self, y0: int = 0, h_out: int = None):
        """The base phase's chunk-major entries over rows [y0, y0 + h_out):
        (x, y, chunk), int64 [n_base_chunks, h_out, w]."""
        x, y = self.pixel_grid(y0, h_out)
        shape = (self.n_base_chunks, *x.shape)
        c = torch.arange(self.n_base_chunks, device=self.device)
        return x.expand(shape), y.expand(shape), c.view(-1, 1, 1).expand(shape)

    def base_phase(self, cam: Cam, xf, yf, state0, chunk=None, quota=None):
        """The base samples of each lane, or with `chunk` (each lane's chunk
        index) the chunk's share [c * cb, min((c + 1) * cb, base)) on the
        chunk's sub-chain (state0 is the pixel seed either way). `quota`
        (an int at most base_samples) renders that many base samples
        instead: a sample-split shard's runtime share. Returns (state,
        csum, csumsq, rays, executed lane-iterations)."""
        c, it = self._base_run(cam, xf, yf, state0, chunk, quota)
        return c.state, c.csum, c.csumsq, c.rays, it * xf.numel()

    def _base_run(self, cam: Cam, xf, yf, state0, chunk=None, quota=None):
        """base_phase's scheduler run: (final carry, iterations)."""
        if chunk is None:
            samp0 = torch.zeros_like(state0)
            quota = torch.full_like(
                xf, float(self.base_samples if quota is None else quota))
        else:
            cb = self.chunk_base or self.base_samples
            state0 = (state0 + chunk * CHUNK_GOLDEN) & prng.MASK32
            samp0 = chunk * cb
            quota = torch.clamp(samp0 + cb, max=self.base_samples).to(
                torch.float32)
        return self.run_regen(cam, xf, yf,
                              self.regen_carry0(state0, samp0, quota))

    @staticmethod
    def chunk_total(planes: torch.Tensor) -> torch.Tensor:
        """A pixel's total over its chunk planes [n_chunks, ...], added in
        chunk order (the JAX package's order)."""
        total = planes[0]
        for c in range(1, planes.shape[0]):
            total = total + planes[c]
        return total

    def variance_of(self, csum: V3, csumsq: V3, base: int = None):
        """Luminance-sum variance of `base` (default base_samples) samples
        (kept raw; can be slightly negative in f32). A quota of 0 (a shard
        with no base share) has variance 0."""
        base = self.base_samples if base is None else base
        inv = 1.0 / base if base else 0.0
        mean = csum * inv
        return vm.sum_components(csumsq * inv - mean * mean)

    def extra_quota(self, var, base: int = None):
        """(needs mask, per-lane extra-sample budget) after `base` (default
        base_samples) base samples."""
        base = self.base_samples if base is None else base
        needs = var > ADAPTIVE_VAR_THRESHOLD
        budget = torch.clamp(torch.floor(var * ADAPTIVE_VAR_SCALE),
                             max=float(self.spp - base))
        return needs, torch.where(needs, budget, 0.0)

    def extra_phase(self, cam: Cam, xf, yf, state, additional, samp0):
        """`additional` extra samples per lane continuing `state` at sample
        index `samp0`. Returns (esum, rays, executed lane-iterations).
        Only lanes with a budget are traced (zero-budget lanes owe nothing
        and get zeros)."""
        c, full, it = self._extra_run(cam, xf, yf, state, additional, samp0)
        return V3(*(full(v) for v in c.csum)), full(c.rays), it

    def _extra_run(self, cam: Cam, xf, yf, state, additional, samp0):
        """extra_phase's scheduler run over the lanes with a budget: (final
        carry, a function that puts such a carry plane back in the lanes'
        shape with zeros elsewhere, executed lane-iterations)."""
        live = torch.nonzero(additional.reshape(-1) > 0.0).squeeze(1)

        def sub(t):
            return t.reshape(-1)[live]

        def full(t):
            out = torch.zeros(additional.numel(), dtype=t.dtype,
                              device=t.device)
            return out.index_copy_(0, live, t).view(additional.shape)

        c0 = self.regen_carry0(sub(state), sub(samp0),
                               sub(additional) + sub(samp0).to(torch.float32))
        c, it = self.run_regen(cam, sub(xf), sub(yf), c0)
        return c, full, it * live.numel()

    def extra_entries(self, state, additional, samp0: int = None):
        """The extra phase's chunk-major entries of pixels with end state
        `state` and budget `additional`: (budget f32, state, samp0 int64),
        each [n_extra_chunks, *additional.shape]. Entry c owes
        clip(additional - c * ce, 0, ce) samples from sample index
        samp0 + c * ce on the sub-chain state + c * CHUNK_GOLDEN; unchunked,
        the one entry is the pixel's whole budget on its own chain. `samp0`
        (default base_samples) is where the chains stand after the base
        phase: a sample-split shard continues at its own base share."""
        s0 = self.base_samples if samp0 is None else samp0
        ce = self.chunk_extra or max(self.spp - self.base_samples, 0)
        budgets, states, samp0s = [], [], []
        for c in range(self.n_extra_chunks):
            budgets.append(torch.clamp(additional - float(c * ce), 0.0,
                                       float(ce)))
            states.append((state + c * CHUNK_GOLDEN) & prng.MASK32)
            samp0s.append(torch.full_like(state, s0 + c * ce))
        return torch.stack(budgets), torch.stack(states), torch.stack(samp0s)

    def combine_phases(self, csum: V3, esum: V3, needs, additional,
                       base: int = None):
        """The reference's normalisation: adaptive pixels average over the
        samples taken (`base`, default base_samples, plus their budget);
        the rest divide the base sum by spp."""
        base = self.base_samples if base is None else base
        total = float(base) + additional
        current = vm.where(needs, (csum + esum) * (1.0 / total),
                           csum * (1.0 / self.spp))
        return current, total

    # ------------------------------------------------------------------

    def pixel_grid(self, y0: int = 0, h_out: int = None):
        """(x, y) int64 pixel coordinates of rows [y0, y0 + h_out)."""
        h_out = self.height if h_out is None else h_out
        y, x = torch.meshgrid(
            torch.arange(y0, y0 + h_out, device=self.device),
            torch.arange(self.width, device=self.device), indexing="ij")
        return x, y

    def render_pixels(self, pose, seed: int, frame_number: int, y0: int = 0,
                      h_out: int = None):
        """The whole frame of rows [y0, y0 + h_out) in plain PyTorch, over
        the image-order entries (the JAX oracle's render_lanes). Returns
        (current V3, variance, total samples, owed rays (f32), executed
        bounce iterations (int64), each [h_out, w], and the executed
        lane-iterations of the regeneration scheduler's runs)."""
        cam = cam_from_pose(pose)
        x, y, c = self.base_entries(y0, h_out)
        b, it = self._base_run(
            cam, x.to(torch.float32), y.to(torch.float32),
            self.seed_lanes(x, y, seed, frame_number), c)
        it *= x.numel()
        csum = V3(*(self.chunk_total(v) for v in b.csum))
        csumsq = V3(*(self.chunk_total(v) for v in b.csumsq))
        rays, iters = self.chunk_total(b.rays), self.chunk_total(b.iters)
        state = b.state[0]  # the extra phase continues chunk 0's chain
        var = self.variance_of(csum, csumsq)
        if self.base_samples >= self.spp:
            current = csum * (1.0 / self.spp)
            total = torch.full_like(var, float(self.base_samples))
        else:
            needs, additional = self.extra_quota(var)
            budget, st_e, samp0 = self.extra_entries(state, additional)
            shape = budget.shape
            e, full, it_b = self._extra_run(
                cam, x[0].expand(shape).to(torch.float32),
                y[0].expand(shape).to(torch.float32), st_e, budget, samp0)
            esum = V3(*(self.chunk_total(full(v)) for v in e.csum))
            rays = rays + self.chunk_total(full(e.rays))
            iters = iters + self.chunk_total(full(e.iters))
            it += it_b
            current, total = self.combine_phases(csum, esum, needs,
                                                 additional)
        return current, var, total, rays, iters, it

    def render_frame(self, pose, seed: int, frame_number: int):
        """The whole frame in plain PyTorch (render_pixels). Returns
        (current V3[H,W], variance, total samples, owed rays, occupancy) —
        occupancy is owed sweeps over executed lane-iteration sweeps, 1 +
        nee_sweeps each."""
        current, var, total, rays, _, it = self.render_pixels(
            pose, seed, frame_number)
        rays_sum = rays.to(torch.float64).sum()
        occ = rays_sum / max(it * (1.0 + self.nee_sweeps), 1.0)
        return current, var, total, rays_sum, occ
