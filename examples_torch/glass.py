"""Dielectric (glass) materials: transparency + ior on any primitive.

The PyTorch/CUDA port's counterpart of examples/glass.py. A glass sphere
over a floor in front of an emissive wall — refraction bends the wall's
light through the sphere (flip `transparency` to 0 to see the same sphere
go matte). A scene with a dielectric takes the kernels' EXT instantiations;
one without keeps the reference-parity kernels. It renders on the card
unless --device cpu asks for the plain PyTorch versions (at the same
size); with --device cuda and no GPU it exits nonzero.

Usage: python examples_torch/glass.py [out.png] [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from terminal_raytracer_tpu_torch.cli import no_gpu
from terminal_raytracer_tpu_torch.models import Camera, scene as sm
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.utils import imageio

N_FRAMES = 32


def mat(color, emission=(0.0, 0.0, 0.0), reflectivity=0.0,
        transparency=0.0, ior=1.5):
    return sm.Material(color=color, emission=emission,
                       reflectivity=reflectivity,
                       transparency=transparency, ior=ior)


def build_scene(device: str):
    """The glass stage; the same on every `device` (the JAX example renders
    it at this size off the TPU too)."""
    return sm.Scene(
        width=160, height=80, samples_per_pixel=8, max_depth=8,
        frames_to_accumulate=1000,
        camera=sm.Camera_Config(fov_degrees=50.0, char_aspect_ratio=1.0),
        spheres=(
            # The star: a clear glass ball (95% refractive branch,
            # crown-ish index). Try ior=1.33 (water) or 2.4 (diamond).
            sm.Sphere(center=(0.0, -0.2, -2.2), radius=0.6,
                      material=mat((1.0, 1.0, 1.0), transparency=0.95)),
            # A matte companion for contrast.
            sm.Sphere(center=(-1.2, -0.6, -3.0), radius=0.4,
                      material=mat((0.8, 0.3, 0.3))),
            # Key light.
            sm.Sphere(center=(2.0, 2.5, -1.5), radius=0.5,
                      material=mat((1.0, 1.0, 1.0),
                                   emission=(18.0, 18.0, 18.0))),
        ),
        planes=(
            sm.Plane(point=(0.0, -1.0, 0.0), normal=(0.0, 1.0, 0.0),
                     material=mat((0.6, 0.6, 0.65))),
            # Emissive back wall: watch it refract through the glass ball.
            sm.Plane(point=(0.0, 0.0, -6.0), normal=(0.0, 0.0, 1.0),
                     material=mat((0.0, 0.0, 0.0),
                                  emission=(1.5, 2.0, 2.5))),
        ),
        triangles=(),
    )


def frames(scene, n_frames: int, device: str):
    """Yield the FrameOutput of each of `n_frames` accumulated frames; the
    step accumulates in place."""
    step = make_render_step(scene, full_color=True, device=device)
    state, cam = init_state(scene, device), Camera()
    for f in range(n_frames):
        out = step(state, cam.pose(), 7000 + f, f)
        state = out.state
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="glass.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if no_gpu(args.device):
        return 2
    scene = build_scene(args.device)
    for out in frames(scene, N_FRAMES, args.device):
        pass
    imageio.write_png(args.out, out.rgb.cpu().numpy())
    print(f"wrote {args.out} ({N_FRAMES} accumulated frames, "
          f"{scene.width}x{scene.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
