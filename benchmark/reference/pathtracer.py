"""The plain reference renderer: a frame of a scene configuration in plain
PyTorch, written without the program under test.

It restates the reference viewer's transport (the Rust/WGSL
Terminal-Raytracer, as the port's plain path keeps it): emission on every
hit plus next-event estimation over every light each bounce, the NEE clamp
at 10, the sky gradient on a miss, 1e-3 ray offsets, Russian roulette from
bounce 4 (kill first, then compensate), and adaptive sampling with base =
max(4, spp // 4) samples, a budget of min(spp - base, floor(var * 50))
extra samples where the base samples' luminance variance exceeds 10, and
the reference's normalisation. Every random draw keeps the viewer's gate
and order over a per-pixel PCG-hash chain, and every floating-point
expression keeps the port's operation order, so a correct program matches
it bit for bit.

The schedule is the plainest one: sample after sample, bounce after bounce,
every pixel's lanes side by side (a pixel's chain runs its samples in
order, so scheduling changes no pixel's result). Only the reference gates
are written: a configuration with a material, texture, medium, lens,
sampler or light-selection extension is refused.

`precision="bf16"` holds the radiance accumulators (the per-pixel sample
sums and, in viewer.py, the running mean) in bfloat16: the control that
the comparison has to fail.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INV_U32_MAX = float(1.0 / 4294967295.0)
PI = 3.14159265359
TWO_PI = 2.0 * PI
RAY_EPS = 1e-3
T_FAR = 1e10
MISS = -1.0
PLANE_PARALLEL_EPS = 1e-4
TRI_PARALLEL_EPS = 1e-5
SKY_INTENSITY = 0.8
SKY_TOP = (0.5, 0.7, 1.0)
NEE_CLAMP = 10.0
RR_START_BOUNCE = 3
RR_MAX_SURVIVAL = 0.95
ADAPTIVE_VAR_THRESHOLD = 10.0
ADAPTIVE_VAR_SCALE = 50.0
LIGHT_POWER_EPS = 1e-3
SPHERE, PLANE, TRIANGLE = 0, 1, 2
PRECISIONS = ("f32", "bf16")

# Keys of a scene or material that select an extension the reference does
# not render.
_SCENE_EXT = ("fog", "sky", "meshes", "textures")
_MAT_EXT = ("transparency", "roughness", "checker_color", "texture",
            "normal_map")


# ---------------------------------------------------------------------------
# Vectors: three same-shaped tensors (or floats) per field
# ---------------------------------------------------------------------------


class V3(NamedTuple):
    x: object
    y: object
    z: object

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, s):
        # `s` is a tensor: CUDA turns a division by a Python float into a
        # multiply by its reciprocal.
        return V3(self.x / s, self.y / s, self.z / s)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def splat(c):
    return V3(c, c, c)


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a, b):
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a * (1.0 / torch.sqrt(dot(a, a)))


def reflect(v, n):
    return v - n * (2.0 * dot(v, n))


def vwhere(mask, a, b):
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def row3(t, col):
    return V3(t[..., col], t[..., col + 1], t[..., col + 2])


# ---------------------------------------------------------------------------
# The per-pixel random chain (32-bit values held in int64)
# ---------------------------------------------------------------------------


def pcg_hash(x):
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def u32_to_f32(v):
    """The viewer's u32 -> f32 conversion: through int32, plus 2**32 where
    negative."""
    i = torch.where(v >= 2**31, v - 2**32, v)
    f = i.to(torch.float32)
    return torch.where(i < 0, f + 4294967296.0, f)


def next_f32(state, gate):
    new = pcg_hash(state)
    value = u32_to_f32(new) * INV_U32_MAX
    return torch.where(gate, new, state), value


def next_pair(state, gate):
    state, a = next_f32(state, gate)
    state, b = next_f32(state, gate)
    return state, a, b


def seed_pixel(pixel_index, seed: int, frame_number: int):
    base = ((seed & MASK32) * 9277 + (frame_number & MASK32) * 12345) & MASK32
    return (pixel_index * 1973 + base) & MASK32


def advance_sample(state, sample: int, gate):
    new = pcg_hash((state + sample * 5096) & MASK32)
    return torch.where(gate, new, state)


# ---------------------------------------------------------------------------
# The scene: f32 tables
# ---------------------------------------------------------------------------


def _f32(v) -> float:
    return float(np.float32(v))


def _f32v(v):
    return tuple(_f32(c) for c in v)


def sq_len_f32(v):
    return np.float32(np.float32(v[0] * v[0]) + np.float32(v[1] * v[1])) \
        + np.float32(v[2] * v[2])


def tri_edges_f32(v0, v1, v2):
    """Edges, unit normal and area of a triangle, in f32 steps."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    cr = np.cross(e1, e2).astype(np.float32)
    cr_len = np.sqrt(sq_len_f32(cr))
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (cr / cr_len).astype(np.float32)
    return e1, e2, normal, np.float32(0.5) * cr_len


class Scene(NamedTuple):
    """A scene configuration's numbers, as the viewer narrows them to f32."""

    width: int
    height: int
    spp: int
    max_depth: int
    fov_degrees: float
    char_aspect: float
    spheres: tuple  # (center, radius, material)
    planes: tuple  # (point, normal, material)
    triangles: tuple  # (v0, v1, v2, material)

    @property
    def primitives(self):
        return ([(SPHERE, s) for s in self.spheres]
                + [(PLANE, p) for p in self.planes]
                + [(TRIANGLE, t) for t in self.triangles])

    @property
    def counts(self):
        return len(self.spheres), len(self.planes), len(self.triangles)


def parse_scene(cfg: dict) -> Scene:
    """A Scene from a scene configuration (the viewer's JSON schema)."""
    cam = cfg["camera"]
    bad = [k for k in _SCENE_EXT if cfg.get(k)]
    bad += [k for k in ("aperture",) if cam.get(k, 0.0)]
    if cfg.get("sampler", "reference") != "reference":
        bad.append("sampler")
    if cfg.get("light_sample", "all") != "all":
        bad.append("light_sample")

    def mat(d):
        bad.extend(k for k in _MAT_EXT if d.get(k))
        return (_f32v(d["color"]), _f32v(d["emission"]),
                _f32(d["reflectivity"]))

    scene = Scene(
        int(cfg["width"]), int(cfg["height"]), int(cfg["samples_per_pixel"]),
        int(cfg["max_depth"]), _f32(cam["fov_degrees"]),
        _f32(cam["char_aspect_ratio"]),
        tuple((_f32v(s["center"]), _f32(s["radius"]), mat(s))
              for s in cfg.get("spheres", [])),
        tuple((_f32v(p["point"]), _f32v(p["normal"]), mat(p))
              for p in cfg.get("planes", [])),
        tuple((_f32v(t["v0"]), _f32v(t["v1"]), _f32v(t["v2"]), mat(t))
              for t in cfg.get("triangles", [])))
    if bad:
        raise ValueError("the reference renders the viewer's own scene "
                         f"schema only; this configuration uses {sorted(set(bad))}")
    return scene


class Tables(NamedTuple):
    sph: torch.Tensor  # [n, 5]: center, r*r, 1/r
    pln: torch.Tensor  # [n, 9]: point, raw normal, unit normal
    tri: torch.Tensor  # [n, 12]: v0, edge1, edge2, unit normal
    mat: torch.Tensor  # [n_prims + 1, 7]: color, emission, reflectivity
    lights: list  # (kind, emission V3, area, a V3, b V3, c V3, normal V3)
    const_n: torch.Tensor  # [n_prims + 1, 3] plane / triangle unit normal
    center: torch.Tensor  # [n_prims + 1, 3] sphere center
    inv_r: torch.Tensor  # [n_prims + 1]
    is_sph: torch.Tensor  # [n_prims + 1] bool


def scene_tables(scene: Scene, device) -> Tables:
    """The scene's f32 tables on `device`: sphere r^2 from the f64 radius,
    the rest in f32 steps."""
    sph = np.zeros((len(scene.spheres), 5), np.float32)
    for i, (c, r, _) in enumerate(scene.spheres):
        sph[i] = (*c, r * r, np.float32(1.0) / np.float32(r))
    pln = np.zeros((len(scene.planes), 9), np.float32)
    for i, (p, n, _) in enumerate(scene.planes):
        nn = np.asarray(n, np.float32)
        pln[i] = (*p, *n, *(nn / np.sqrt(sq_len_f32(nn))))
    tri = np.zeros((len(scene.triangles), 12), np.float32)
    for i, (v0, v1, v2, _) in enumerate(scene.triangles):
        e1, e2, n, _ = tri_edges_f32(v0, v1, v2)
        tri[i] = (*v0, *e1, *e2, *n)
    prims = scene.primitives
    n = len(prims)
    mat = np.zeros((n + 1, 7), np.float32)
    const_n = np.zeros((n + 1, 3), np.float32)
    center = np.zeros((n + 1, 3), np.float32)
    inv_r = np.zeros((n + 1,), np.float32)
    is_sph = np.zeros((n + 1,), bool)
    n_sph, n_pln, _ = scene.counts
    const_n[n_sph:n_sph + n_pln] = pln[:, 6:9]
    const_n[n_sph + n_pln:n] = tri[:, 9:12]
    center[:n_sph] = sph[:, 0:3]
    inv_r[:n_sph] = sph[:, 4]
    is_sph[:n_sph] = True
    light_rows = []
    for i, (kind, p) in enumerate(prims):
        color, emission, refl = p[-1]
        mat[i] = (*color, *emission, refl)
        if sum(emission) > LIGHT_POWER_EPS and kind != PLANE:
            row = np.zeros(17, np.float32)
            if kind == SPHERE:
                c, r, _ = p
                row[:8] = (kind, *emission, 4.0 * PI * r * r, *c)
                row[8] = r
            else:
                v0, v1, v2, _ = p
                _, _, nrm, area = tri_edges_f32(v0, v1, v2)
                row[:] = (kind, *emission, area, *v0, *v1, *v2, *nrm)
            light_rows.append(row)

    def t(a):
        return torch.from_numpy(a).to(device)

    lrows = t(np.stack(light_rows) if light_rows
              else np.zeros((0, 17), np.float32))
    lights = [(int(kinds), row3(r, 1), r[4], row3(r, 5), row3(r, 8),
               row3(r, 11), row3(r, 14))
              for kinds, r in zip(lrows[:, 0].tolist(), lrows)]
    return Tables(t(sph), t(pln), t(tri), t(mat), lights, t(const_n),
                  t(center), t(inv_r), t(is_sph))


# ---------------------------------------------------------------------------
# Intersections: every primitive of a kind at once along a trailing axis
# ---------------------------------------------------------------------------


def _sphere_t(o, d, center, rr, t_min, t_max):
    oc = center - o
    h = dot(d, oc)
    c = dot(oc, oc) - rr
    disc = h * h - c
    sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
    near = h - sqrtd
    far = h + sqrtd
    near_ok = (near > t_min) & (near < t_max)
    far_ok = (far > t_min) & (far < t_max)
    root = torch.where(near_ok, near, far)
    return root, (disc >= 0.0) & (near_ok | far_ok)


def _plane_t(o, d, point, normal):
    denom = dot(normal, d)
    parallel = torch.abs(denom) < PLANE_PARALLEL_EPS
    t = dot(point - o, normal) / torch.where(parallel, 1.0, denom)
    return t, parallel


def _triangle_t(o, d, v0, edge1, edge2, t_min, t_max):
    h = cross(d, edge2)
    a = dot(edge1, h)
    parallel = (a > -TRI_PARALLEL_EPS) & (a < TRI_PARALLEL_EPS)
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(d, q)
    t = f * dot(edge2, q)
    hit = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, hit


class Hit(NamedTuple):
    found: torch.Tensor
    p: V3
    normal: V3
    color: V3
    emission: V3
    reflectivity: torch.Tensor


class Sweep:
    """The closest-hit and shadow sweeps over one scene's tables."""

    def __init__(self, tables: Tables, counts):
        self.tb = tables
        self.counts = counts
        self.n_prims = sum(counts)

    def _tests(self, o, d, t_min, t_max, blocked: bool):
        o = V3(o.x[..., None], o.y[..., None], o.z[..., None])
        d = V3(d.x[..., None], d.y[..., None], d.z[..., None])
        if blocked:
            t_max = t_max[..., None]
        n_sph, n_pln, n_tri = self.counts
        cols = []
        if n_sph:
            t, hit = _sphere_t(o, d, row3(self.tb.sph, 0), self.tb.sph[:, 3],
                               t_min, t_max)
            cols.append(hit if blocked else torch.where(hit, t, MISS))
        if n_pln:
            t, parallel = _plane_t(o, d, row3(self.tb.pln, 0),
                                   row3(self.tb.pln, 3))
            if blocked:
                cols.append(~parallel & (t >= t_min) & (t < t_max))
            else:
                hit = ~parallel & (t >= t_min) & (t <= t_max)
                cols.append(torch.where(hit, t, MISS))
        if n_tri:
            t, hit = _triangle_t(o, d, row3(self.tb.tri, 0),
                                 row3(self.tb.tri, 3), row3(self.tb.tri, 6),
                                 t_min, t_max)
            cols.append(hit if blocked else torch.where(hit, t, MISS))
        return torch.cat(cols, -1)

    def closest_hit(self, o, d) -> Hit:
        t_max = T_FAR
        if self.n_prims:
            t = self._tests(o, d, RAY_EPS, t_max, blocked=False)
            t = torch.where((t > 0.0) & (t < t_max), t, float("inf"))
            closest, idx = torch.min(t, -1)
        else:
            closest = torch.full_like(o.x, float("inf"))
            idx = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
        found = closest < t_max
        closest = torch.where(found, closest, t_max)
        idx = torch.where(found, idx, self.n_prims)
        p = o + d * closest
        m = self.tb.mat[idx]
        n_sph = normalize((p - row3(self.tb.center[idx], 0))
                          * self.tb.inv_r[idx])
        normal = vwhere(self.tb.is_sph[idx], n_sph,
                        row3(self.tb.const_n[idx], 0))
        front = dot(d, normal) < 0.0
        normal = vwhere(front, normal, -normal)
        return Hit(found, p, normal, row3(m, 0), row3(m, 3), m[..., 6])

    def occluded(self, o, d, t_max):
        if not self.n_prims:
            return torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
        return self._tests(o, d, RAY_EPS, t_max, blocked=True).any(-1)


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


def sky_color(d):
    t = 0.5 * (d.y + 1.0)
    one = 1.0 - t
    return V3((one + t * SKY_TOP[0]) * SKY_INTENSITY,
              (one + t * SKY_TOP[1]) * SKY_INTENSITY,
              (one + t * SKY_TOP[2]) * SKY_INTENSITY)


def orthonormal_basis(w):
    use_y = torch.abs(w.x) > 0.1
    zeros = torch.zeros_like(w.x)
    u_y = normalize(V3(w.z, zeros, -w.x))
    u_x = normalize(V3(zeros, -w.z, w.y))
    u = vwhere(use_y, u_y, u_x)
    return u, cross(w, u)


def cosine_hemisphere(state, normal, gate):
    state, r1, r2 = next_pair(state, gate)
    cos_theta = torch.sqrt(r1)
    sin_theta = torch.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    w = normalize(normal)
    u, v = orthonormal_basis(w)
    return state, normalize(u * x + v * y + w * cos_theta)


def sphere_light_point(state, center, radius, gate):
    state, r1, r2 = next_pair(state, gate)
    cos_theta = 1.0 - 2.0 * r1
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * r2
    local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
               cos_theta)
    return state, center + local * radius, local


def triangle_light_point(state, v0, v1, v2, gate):
    state, r1, r2 = next_pair(state, gate)
    sqrt_r1 = torch.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    return state, v0 * (1.0 - u - v) + v1 * u + v2 * v


class Frame(NamedTuple):
    """One frame's per-pixel results, [H, W] planes."""

    current: V3  # the frame's radiance estimate
    variance: torch.Tensor  # luminance-sum variance of the base samples
    samples: torch.Tensor  # samples taken (base, or base + budget)
    rays: torch.Tensor  # owed traversal sweeps (f32 counts)


class Renderer:
    """Renders frames of one scene on one device."""

    def __init__(self, cfg: dict, device, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.scene = parse_scene(cfg)
        self.precision = precision
        self.device = torch.device(device)
        sc = self.scene
        self.tables = scene_tables(sc, self.device)
        self.sweep = Sweep(self.tables, sc.counts)
        self.nee_sweeps = len(self.tables.lights)
        self.width, self.height = sc.width, sc.height
        self.spp, self.max_depth = sc.spp, sc.max_depth
        self.base = max(4, sc.spp // 4)
        fov_rad = float(np.radians(np.float32(sc.fov_degrees)))
        self.half_height = float(np.tan(np.float32(fov_rad) / np.float32(2)))
        self.half_width = float(np.float32(
            float(np.float32(sc.width) / np.float32(sc.height))
            * self.half_height))
        self.inv_char_aspect = float(np.float32(1.0)
                                     / np.float32(sc.char_aspect))
        self._w1 = torch.tensor(float(sc.width - 1), device=self.device)
        self._h1 = torch.tensor(float(sc.height - 1), device=self.device)

    def _round(self, t):
        """An accumulator as the precision holds it."""
        if self.precision == "bf16":
            return t.to(torch.bfloat16).to(torch.float32)
        return t

    def gen_ray(self, state, cam, xf, yf, gate):
        state, rx = next_f32(state, gate)
        state, ry = next_f32(state, gate)
        u = (xf + rx) / self._w1
        v = ((self.height - 1) - yf + ry) / self._h1
        ndc_x = 2.0 * u - 1.0
        ndc_y = (2.0 * v - 1.0) * self.inv_char_aspect
        vx = self.half_width * ndc_x
        vy = self.half_height * ndc_y
        pos, fwd, right, up = cam
        d = normalize(right * vx + up * vy + fwd)
        zeros = torch.zeros_like(d.x)
        return state, V3(zeros + pos.x, zeros + pos.y, zeros + pos.z), d

    def direct_light(self, state, p, normal, color, att, gate):
        zeros = torch.zeros_like(p.x)
        direct = splat(zeros)
        brdf = color * (1.0 / PI)
        for kind, emission, area, a, b, c, n in self.tables.lights:
            if kind == SPHERE:
                state, lp, ln = sphere_light_point(state, a, b.x, gate)
            else:
                state, lp = triangle_light_point(state, a, b, c, gate)
                ln = n
            lvec = lp - p
            ldist = length(lvec)
            ldir = lvec / ldist
            shadow_o = p + normal * RAY_EPS
            blocked = self.sweep.occluded(shadow_o, ldir, ldist - RAY_EPS)
            cos_s = torch.clamp(dot(normal, ldir), min=0.0)
            cos_l = torch.clamp(dot(ln, -ldir), min=0.0)
            ok = ~blocked & (cos_s > 0.0) & (cos_l > 0.0)
            weight = ((cos_s * cos_l) / (ldist * ldist)) * area
            contrib = (brdf * emission) * (att * weight)
            contrib = V3(*(torch.clamp(v, max=NEE_CLAMP) for v in contrib))
            direct = direct + vwhere(ok, contrib, splat(zeros))
        return state, direct

    def bounce(self, state, o, d, att, acc, alive, bounce_idx: int, rays):
        """One bounce of every live lane: (state, o, d, att, acc, alive,
        rays); a lane dies on a miss (sky added) or a roulette kill."""
        zeros = torch.zeros_like(o.x)
        hit = self.sweep.closest_hit(o, d)
        rays = rays + alive.to(torch.float32)
        miss_now = alive & ~hit.found
        live = alive & hit.found
        acc = acc + vwhere(miss_now, sky_color(d) * att, splat(zeros))
        acc = acc + vwhere(live, hit.emission * att, splat(zeros))
        state, direct = self.direct_light(state, hit.p, hit.normal,
                                          hit.color, att, live)
        acc = acc + vwhere(live, direct, splat(zeros))
        rays = rays + torch.where(live, float(self.nee_sweeps), 0.0)
        state, r_spec = next_f32(state, live)
        is_refl = hit.reflectivity > r_spec
        refl_dir = reflect(d, hit.normal)
        state, cos_dir = cosine_hemisphere(state, hit.normal,
                                           live & ~is_refl)
        new_d = vwhere(is_refl, refl_dir, cos_dir)
        att = vwhere(live, att * hit.color, att)
        new_o = hit.p + new_d * RAY_EPS
        rr_on = live & (bounce_idx > RR_START_BOUNCE)
        state, r_rr = next_f32(state, rr_on)
        p_surv = torch.clamp(torch.maximum(att.x, torch.maximum(att.y, att.z)),
                             max=RR_MAX_SURVIVAL)
        killed = rr_on & ((p_surv < r_rr) | (p_surv <= 0.0))
        att = vwhere(rr_on & ~killed, att / p_surv, att)
        alive = live & ~killed
        d = vwhere(alive, new_d, V3(zeros, zeros, zeros + 1.0))
        o = vwhere(alive, new_o, splat(zeros))
        return state, o, d, att, acc, alive, rays

    def samples(self, cam, xf, yf, state, first: int, quota):
        """Samples first, first + 1, ... of each lane while its index is
        below `quota` (f32 lanes), continuing `state`. Returns (state,
        csum, csumsq, rays)."""
        zeros = torch.zeros_like(xf)
        csum, csumsq, rays = splat(zeros), splat(zeros), zeros
        last = int(quota.max().item()) if quota.numel() else first
        for s in range(first, last):
            need = torch.tensor(float(s), device=self.device) < quota
            state = advance_sample(state, s, need)
            state, o, d = self.gen_ray(state, cam, xf, yf, need)
            att, acc, alive = splat(zeros + 1.0), splat(zeros), need
            for b in range(self.max_depth):
                executed = alive
                state, o, d, att, acc, alive, rays = self.bounce(
                    state, o, d, att, acc, alive, b, rays)
                at_depth = alive & (b + 1 >= self.max_depth)
                finished = (executed & ~alive) | at_depth
                csum = V3(*(self._round(c + torch.where(finished, a, 0.0))
                            for c, a in zip(csum, acc)))
                csumsq = V3(*(self._round(c + torch.where(finished, a * a,
                                                          0.0))
                              for c, a in zip(csumsq, acc)))
                alive = alive & ~at_depth
                if not bool(alive.any()):
                    break
        return state, csum, csumsq, rays

    def render(self, cam, seed: int, frame_number: int) -> Frame:
        """The frame of camera `cam` ((pos, forward, right, up) V3s of
        floats), per-frame seed `seed` and accumulation frame number
        `frame_number` (which seeds the chains)."""
        h, w, dev = self.height, self.width, self.device
        y, x = torch.meshgrid(torch.arange(h, device=dev),
                              torch.arange(w, device=dev), indexing="ij")
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        state0 = seed_pixel(y * w + x, seed, frame_number)
        base = self.base
        state, csum, csumsq, rays = self.samples(
            cam, xf, yf, state0, 0, torch.full_like(xf, float(base)))
        inv = 1.0 / base
        mean = csum * inv
        sq = csumsq * inv - mean * mean
        var = sq.x + sq.y + sq.z
        if base >= self.spp:
            return Frame(csum * (1.0 / self.spp), var,
                         torch.full_like(var, float(base)), rays)
        needs = var > ADAPTIVE_VAR_THRESHOLD
        budget = torch.clamp(torch.floor(var * ADAPTIVE_VAR_SCALE),
                             max=float(self.spp - base))
        additional = torch.where(needs, budget, 0.0)
        live = torch.nonzero(additional.reshape(-1) > 0.0).squeeze(1)

        def sub(t):
            return t.reshape(-1)[live]

        def full(t):
            out = torch.zeros(h * w, dtype=t.dtype, device=dev)
            return out.index_copy_(0, live, t).view(h, w)

        _, esum, _, erays = self.samples(
            cam, sub(xf), sub(yf), sub(state), base,
            sub(additional) + float(base))
        esum = V3(*(full(c) for c in esum))
        total = float(base) + additional
        cur = vwhere(needs, V3(*(self._round(c) for c in (csum + esum)))
                     * (1.0 / total), csum * (1.0 / self.spp))
        return Frame(cur, var, total, rays + full(erays))
