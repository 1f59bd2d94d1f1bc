"""Build a Scene in code — no JSON needed — and print the ASCII render.

The PyTorch/CUDA port's counterpart of examples/custom_scene.py: the three
primitive kinds plus an OBJ-style mesh (models/mesh.py). A Scene is a
frozen value of Python floats; the renderer packs it into the kernels'
scene buffer once. Its 23 primitives take kernel A's grouped form on the
card. --device takes the place of the JAX example's `backend=`: cuda (the
default) runs the CUDA kernels and exits nonzero without a GPU, cpu their
plain PyTorch versions, at the same size.

Usage: python examples_torch/custom_scene.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from terminal_raytracer_tpu_torch.cli import no_gpu
from terminal_raytracer_tpu_torch.models import Camera, mesh, scene as sm
from terminal_raytracer_tpu_torch.ops.tonemap import GLYPH_RAMP
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step

N_FRAMES = 8


def mat(color, emission=(0.0, 0.0, 0.0), reflectivity=0.0):
    return sm.Material(color=color, emission=emission,
                       reflectivity=reflectivity)


def build_scene(device: str):
    """A little stage: floor plane, one mirror sphere, a light, and an
    icosahedron mesh transformed into place; the same on every `device`
    (the JAX example renders it at this size off the TPU too)."""
    verts, faces = mesh.icosahedron()
    return sm.Scene(
        width=80, height=30, samples_per_pixel=4, max_depth=4,
        frames_to_accumulate=100,
        camera=sm.Camera_Config(fov_degrees=55.0, char_aspect_ratio=0.55),
        spheres=(
            sm.Sphere(center=(2.0, 5.0, -5.0), radius=1.0,
                      material=mat((1.0, 1.0, 1.0),
                                   emission=(12.0, 12.0, 12.0))),
            sm.Sphere(center=(-1.8, 0.8, -6.0), radius=0.8,
                      material=mat((0.9, 0.9, 0.95), reflectivity=0.9)),
        ),
        planes=(
            sm.Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                     material=mat((0.5, 0.55, 0.6))),
        ),
        triangles=mesh.mesh_triangles(
            verts, faces, mat((0.85, 0.6, 0.2), reflectivity=0.1),
            scale=1.3, translate=(0.6, 1.5, -5.5), rotate_y_degrees=30.0,
        ),
    )


def frames(scene, n_frames: int, device: str):
    """Yield the FrameOutput (ASCII: its glyphs) of each of `n_frames`
    accumulated frames; the step accumulates in place."""
    step = make_render_step(scene, full_color=False, device=device)
    state, cam = init_state(scene, device), Camera()
    for f in range(n_frames):
        out = step(state, cam.pose(), 11 + f, f)
        state = out.state
        yield out


def glyph_rows(glyphs):
    """The rows of a [H, W] glyph-index image as text."""
    return ["".join(GLYPH_RAMP[i] for i in row)
            for row in glyphs.cpu().tolist()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if no_gpu(args.device):
        return 2
    for out in frames(build_scene(args.device), N_FRAMES, args.device):
        pass
    for row in glyph_rows(out.glyphs):
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
