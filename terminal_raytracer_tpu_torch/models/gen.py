"""Procedural benchmark/test scenes.

The three shipped scenes top out at ~30 primitives — too small for the
block-culled traversal (ops/accel.py) to matter. `stress_scene` builds a
many-sphere field with the same schema/material semantics as the JSON
scenes, used by the accel tests and the `stress*` bench configs."""

from __future__ import annotations

import numpy as np

from . import scene as scene_mod


def stress_scene(
    n_spheres: int = 256,
    seed: int = 0,
    width: int = 200,
    height: int = 100,
    samples_per_pixel: int = 8,
    max_depth: int = 6,
) -> scene_mod.Scene:
    """A field of diffuse/mirror spheres in a slab over a floor plane, lit
    by one emissive sphere — spatially clustered so block culling has
    structure to exploit (random clusters, like demo.json's layout but at
    benchmark scale)."""
    rng = np.random.RandomState(seed)

    def f3(v):
        return tuple(float(np.float32(x)) for x in v)

    spheres = []
    # Emissive sphere light first (light order is parity-relevant).
    spheres.append(scene_mod.Sphere(
        center=(0.0, 8.0, -10.0), radius=2.0,
        material=scene_mod.Material(color=(1.0, 1.0, 1.0),
                                    emission=(12.0, 12.0, 12.0),
                                    reflectivity=0.0),
    ))
    n_clusters = max(1, n_spheres // 32)
    centers = rng.uniform([-12, 0.5, -24], [12, 6.0, -4], size=(n_clusters, 3))
    for i in range(n_spheres - 1):
        c = centers[i % n_clusters] + rng.normal(0, 1.2, 3)
        c[1] = max(0.25, c[1])
        r = float(rng.uniform(0.15, 0.45))
        col = rng.uniform(0.2, 0.95, 3)
        refl = float(rng.rand() < 0.2) * float(rng.uniform(0.5, 1.0))
        spheres.append(scene_mod.Sphere(
            center=f3(c), radius=float(np.float32(r)),
            material=scene_mod.Material(color=f3(col),
                                        emission=(0.0, 0.0, 0.0),
                                        reflectivity=float(np.float32(refl))),
        ))
    planes = (scene_mod.Plane(
        point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
        material=scene_mod.Material(color=(0.55, 0.55, 0.6),
                                    emission=(0.0, 0.0, 0.0),
                                    reflectivity=0.0),
    ),)
    return scene_mod.Scene(
        width=width, height=height,
        samples_per_pixel=samples_per_pixel, max_depth=max_depth,
        frames_to_accumulate=100,
        camera=scene_mod.Camera_Config(fov_degrees=float(np.float32(55.0)),
                                       char_aspect_ratio=float(np.float32(0.55))),
        spheres=tuple(spheres),
        planes=planes,
        triangles=(),
    )


def lights_scene(
    n_lights: int = 16,
    seed: int = 0,
    width: int = 200,
    height: int = 100,
    samples_per_pixel: int = 8,
    max_depth: int = 6,
    light_sample: str = "all",
) -> scene_mod.Scene:
    """The many-LIGHT benchmark scene (`lights:L[:seed]`): a diffuse
    sphere field over a floor, lit by L emissive spheres whose powers span
    ~2 decades (one dominant skylight, a geometric ramp of dimmer lamps) —
    the scene family where NEE's per-bounce cost is dominated by the
    n_lights occlusion sweeps the reference's light loop casts
    (shader.wgsl:338-436: one shadow ray per light per bounce).
    `light_sample` pre-sets the scene's NEE strategy ('all' keeps the
    reference loop; 'uniform'/'power' cast ONE weighted shadow ray —
    models/scene.py) so bench configs and tests can build both sides of
    the A/B from one spec."""
    rng = np.random.RandomState(seed)

    def f3(v):
        return tuple(float(np.float32(x)) for x in v)

    spheres = []
    # Lights first (light order is parity-relevant): one dominant
    # skylight, then a geometric power ramp down to ~1% of it, ringed
    # around the field so every surface sees several.
    for i in range(n_lights):
        ang = 2.0 * np.pi * (i / max(1, n_lights)) + rng.uniform(0, 0.3)
        rad = 10.0 + rng.uniform(-1.5, 1.5)
        c = (rad * np.cos(ang), rng.uniform(5.0, 9.0), -14.0 + rad * np.sin(ang))
        power = 24.0 * (0.01 ** (i / max(1, n_lights - 1))) if n_lights > 1 else 24.0
        tint = rng.uniform(0.6, 1.0, 3)
        tint = tint / tint.max()
        spheres.append(scene_mod.Sphere(
            center=f3(c), radius=float(np.float32(rng.uniform(0.4, 0.8))),
            material=scene_mod.Material(
                color=(1.0, 1.0, 1.0),
                emission=f3(power * tint),
                reflectivity=0.0),
        ))
    for _ in range(24):
        c = rng.uniform([-8, 0.4, -20], [8, 3.0, -8], size=3)
        col = rng.uniform(0.25, 0.9, 3)
        refl = float(rng.rand() < 0.15) * float(rng.uniform(0.5, 0.9))
        spheres.append(scene_mod.Sphere(
            center=f3(c), radius=float(np.float32(rng.uniform(0.3, 0.7))),
            material=scene_mod.Material(color=f3(col),
                                        emission=(0.0, 0.0, 0.0),
                                        reflectivity=float(np.float32(refl))),
        ))
    planes = (scene_mod.Plane(
        point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
        material=scene_mod.Material(color=(0.6, 0.58, 0.55),
                                    emission=(0.0, 0.0, 0.0),
                                    reflectivity=0.0),
    ),)
    return scene_mod.Scene(
        width=width, height=height,
        samples_per_pixel=samples_per_pixel, max_depth=max_depth,
        frames_to_accumulate=100,
        camera=scene_mod.Camera_Config(fov_degrees=float(np.float32(55.0)),
                                       char_aspect_ratio=float(np.float32(0.55))),
        spheres=tuple(spheres),
        planes=planes,
        triangles=(),
        light_sample=light_sample,
    )


def icosphere_scene(
    subdivisions: int = 3,
    seed: int = 0,
    width: int = 200,
    height: int = 100,
    samples_per_pixel: int = 8,
    max_depth: int = 6,
) -> scene_mod.Scene:
    """The many-TRIANGLE benchmark scene (`icosphere:S`): a 20 * 4**S-face
    icosphere mesh (models/mesh.py) over a floor plane, lit by one emissive
    sphere — the triangle counterpart of `stress_scene`, exercising the
    array-resident triangle sweep at mesh scale. `seed` jitters the mesh
    yaw so repeated configs decorrelate (like stress:N:seed)."""
    from . import mesh as mesh_mod

    rng = np.random.RandomState(seed)
    verts, faces = mesh_mod.icosphere(subdivisions)
    tris = mesh_mod.mesh_triangles(
        verts, faces,
        scene_mod.Material(color=(0.75, 0.62, 0.35), emission=(0.0, 0.0, 0.0),
                           reflectivity=0.25),
        scale=1.8, translate=(0.0, 2.0, -6.0),
        rotate_y_degrees=float(rng.uniform(0.0, 360.0)) if seed else 0.0,
    )
    spheres = (scene_mod.Sphere(
        center=(2.5, 7.0, -4.0), radius=1.5,
        material=scene_mod.Material(color=(1.0, 1.0, 1.0),
                                    emission=(14.0, 14.0, 14.0),
                                    reflectivity=0.0),
    ),)
    planes = (scene_mod.Plane(
        point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
        material=scene_mod.Material(color=(0.55, 0.55, 0.6),
                                    emission=(0.0, 0.0, 0.0),
                                    reflectivity=0.0),
    ),)
    return scene_mod.Scene(
        width=width, height=height,
        samples_per_pixel=samples_per_pixel, max_depth=max_depth,
        frames_to_accumulate=100,
        camera=scene_mod.Camera_Config(fov_degrees=float(np.float32(55.0)),
                                       char_aspect_ratio=float(np.float32(0.55))),
        spheres=spheres,
        planes=planes,
        triangles=tris,
    )
