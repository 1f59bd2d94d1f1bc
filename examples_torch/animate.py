"""Dynamic (animated) geometry: scene values stream through ONE step as
runtime arrays — geometry moves every frame, nothing is rebuilt.

The PyTorch/CUDA port's counterpart of examples/animate.py, on the card
unless --device cpu asks for the plain PyTorch versions (then at the JAX
example's CPU size); with --device cuda and no GPU it exits nonzero.

Usage: python examples_torch/animate.py [out_dir] [n_frames]
           [--device cuda|cpu]
"""

import argparse
import os
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from terminal_raytracer_tpu_torch.cli import no_gpu
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.ops.dynamic import pack_scene
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.utils import imageio


def build_scene(device: str):
    """The packaged demo scene: at its own size on the card, cut on the CPU
    as the JAX example cuts it off the TPU."""
    scene = load_scene("demo")
    if device == "cpu":
        scene = scene.with_overrides(width=100, height=50,
                                     samples_per_pixel=4, max_depth=4)
    return scene


def frames(scene, n_frames: int, device: str):
    """Yield the FrameOutput of each of `n_frames` frames of the orbit
    animation. Every packed value streams to the step each frame: the port
    has no counterpart of the JAX step's `animated=` subset of keys. Each
    frame renders fresh and overwrites the last one's image in place: copy
    it to the host before asking for the next."""
    step = make_render_step(scene, full_color=True, dynamic=True,
                            device=device)
    arrays0 = pack_scene(scene)
    orbit = ANIMATORS["orbit"]
    state, cam = init_state(scene, device), Camera()
    for t in range(n_frames):
        # frame_number pinned to 0: animated frames render fresh (temporal
        # accumulation would smear moving geometry).
        out = step(state, cam.pose(), 1 + t, 0, orbit(arrays0, t))
        state = out.state
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="anim_frames")
    p.add_argument("n_frames", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if no_gpu(args.device):
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    scene = build_scene(args.device)
    for t, out in enumerate(frames(scene, args.n_frames, args.device)):
        path = os.path.join(args.out_dir, f"frame_{t:03d}.png")
        imageio.write_png(path, out.rgb.cpu().numpy())
    print(f"wrote {args.n_frames} frames to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
