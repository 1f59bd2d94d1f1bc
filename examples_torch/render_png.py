"""Minimal library render: accumulate N frames headless, write a PNG.

The PyTorch/CUDA port's counterpart of examples/render_png.py. It renders
on the card unless --device cpu asks for the plain PyTorch versions; with
--device cuda and no GPU it exits nonzero.

Usage: python examples_torch/render_png.py [out.png] [scene] [frames]
           [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from terminal_raytracer_tpu_torch.cli import no_gpu
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.utils import imageio


def build_scene(device: str, name: str = "scene2"):
    """The packaged scene `name`: at its own size on the card, cut on the
    CPU as the JAX example cuts it off the TPU."""
    scene = load_scene(name)
    if device == "cpu":
        scene = scene.with_overrides(width=120, height=60,
                                     samples_per_pixel=8, max_depth=4)
    return scene


def frames(scene, n_frames: int, device: str):
    """Yield the FrameOutput of each of `n_frames` accumulated frames. The
    step accumulates in place: copy an image to the host before asking
    for the next frame if it is to be kept."""
    step = make_render_step(scene, full_color=True, device=device)
    state, cam = init_state(scene, device), Camera()
    for f in range(n_frames):
        out = step(state, cam.pose(), 1 + f, f)
        state = out.state
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="out.png")
    p.add_argument("scene", nargs="?", default="scene2")
    p.add_argument("frames", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.frames < 1:
        p.error(f"frames must be >= 1 (got {args.frames})")
    if no_gpu(args.device):
        return 2
    scene = build_scene(args.device, args.scene)
    for out in frames(scene, args.frames, args.device):
        pass
    print(f"{args.frames} frames, {float(out.rays):.3e} rays in the last one")
    imageio.write_png(args.out, out.rgb.cpu().numpy())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
