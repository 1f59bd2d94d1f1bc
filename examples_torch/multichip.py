"""Multi-GPU rendering: shard the image over the ranks of a process group.

The PyTorch/CUDA port's counterpart of examples/multichip.py. Under
torchrun each rank takes cuda:LOCAL_RANK and the group torchrun describes
(nccl; gloo with --device cpu); without torchrun the example starts a
group of one rank itself, so it runs on a single GPU as it is:

    python examples_torch/multichip.py
    torchrun --nproc-per-node N examples_torch/multichip.py
    torchrun --nproc-per-node 4 examples_torch/multichip.py --device cpu

NCCL needs a GPU of its own for each rank, so larger meshes on one host
with one GPU run on the CPU over gloo (at the JAX example's CPU size).
With --device cuda and no GPU it exits nonzero. (The same thing is
available from the CLI as --shard N | px:N,sp:M under torchrun.)
"""

import argparse
import hashlib
import os
import socket
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist

from terminal_raytracer_tpu_torch.cli import no_gpu
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.parallel import (make_mesh,
                                                   make_sharded_render_step)
from terminal_raytracer_tpu_torch.parallel.mesh import (gather_frame,
                                                        join_process_group)

N_FRAMES = 8


def build_scene(device: str):
    """The packaged scene2: at its own size on the card, cut on the CPU as
    the JAX example cuts it off the TPU."""
    scene = load_scene("scene2")
    if device == "cpu":
        scene = scene.with_overrides(width=128, height=64,
                                     samples_per_pixel=8, max_depth=4)
    return scene


def mesh_shape(height: int, world: int):
    """(n_px, n_sp) for `world` ranks: pixel-row sharding needs height %
    n_px == 0, so n_px is the largest divisor of the height that also
    divides the world, and the other factor splits samples. The JAX
    example takes the largest divisor of the height up to the device count
    and leaves the other devices idle (its make_mesh drops them); the
    port's make_mesh needs every rank of the group in the mesh (world ==
    n_px * n_sp), so they split samples instead (e.g. scene2's 100 rows on
    8 ranks -> px:4,sp:2 where the JAX example takes px:5 of 8 devices)."""
    n_px = max(d for d in range(1, world + 1)
               if height % d == 0 and world % d == 0)
    return n_px, world // n_px


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(device: str):
    """(this rank's device, whether this call made the process group): the
    caller's group or torchrun's (parallel.mesh.join_process_group); with
    neither, a group of one rank on a free localhost port (nccl on the
    card, gloo on the CPU)."""
    own = not dist.is_initialized() and "WORLD_SIZE" not in os.environ
    if own:
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl",
            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)
    device, joined = join_process_group(device)
    return device, own or joined


def frames(scene, n_frames: int, device: str, mesh=None):
    """Yield this rank's FrameOutput (its row block; rays over the whole
    mesh) of each of `n_frames` accumulated frames. `device` is this
    rank's (join_group's); `mesh` defaults to mesh_shape's over the
    process group's ranks. Every rank iterates in step: each frame is a
    collective."""
    if mesh is None:
        mesh = make_mesh(*mesh_shape(scene.height, dist.get_world_size()),
                         device)
    step, init_state = make_sharded_render_step(scene, mesh)
    state, cam = init_state(), Camera()
    for f in range(n_frames):
        out = step(state, cam.pose(), 1 + f, f)
        state = out.state
        yield out


def digest(rgb) -> str:
    """A short SHA-256 of an image's bytes: equal images, equal digests."""
    return hashlib.sha256(rgb.cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if no_gpu(args.device):
        return 2
    try:
        device, own = join_group(args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        scene = build_scene(args.device)
        world = dist.get_world_size()
        n_px, n_sp = mesh_shape(scene.height, world)
        mesh = make_mesh(n_px, n_sp, device)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"{world} ranks, mesh px:{n_px},sp:{n_sp}; "
                  f"{scene.height // n_px} rows per rank")
        for out in frames(scene, N_FRAMES, device, mesh):
            pass
        gathered = gather_frame(mesh, out)
        if rank0:
            rgb = gathered[0]
            print(f"rendered {scene.width}x{scene.height}, "
                  f"{float(out.rays):.3e} rays in the last frame; rgb "
                  f"gathered to rank 0: {tuple(rgb.shape)}, sha256 "
                  f"{digest(rgb)}")
        return 0
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
