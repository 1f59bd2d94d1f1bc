"""Command-line entry point — ``terminal_raytracer_tpu/cli.py``.

Reference flags: --full-color, --verbose, --threads N, --path FILE; plus
--scene (packaged names, stress:N[:seed], icosphere:S[:seed],
lights:L[:seed], ...), --accel, --animate, --filter, the transport and
camera extensions --unbiased, --mis, --fog, --aperture, --focus,
--sampler and --light-sample, the display filter --denoise and
--denoise-passes, and --shard (with the JAX package's spellings, defaults
and errors), --frames, --width, --height, --spp, --depth and --device. In
the interactive viewer WASD moves, arrows steer, ESC exits.

Run: python -m terminal_raytracer_tpu_torch [flags]

--shard renders on a mesh of ranks (parallel/mesh.py), one process a rank
under torchrun, which sets RANK, WORLD_SIZE and LOCAL_RANK: rank r takes
cuda:LOCAL_RANK over NCCL, or the CPU over gloo with --device cpu, and
rank 0 prints the frame. E.g. torchrun --nproc-per-node 4 -m
terminal_raytracer_tpu_torch --device cpu --shard px:2,sp:2 --frames 2
(a caller that has initialised a process group of its own keeps it).
"""

from __future__ import annotations

import argparse
import os
import sys

from .ops.tracer import ACCELS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="terminal-raytracer-tpu-torch",
        description="Terminal path tracer on PyTorch with hand-written CUDA "
                    "kernels.",
    )
    p.add_argument("--full-color", action="store_true",
                   help="render 24-bit truecolor block cells instead of ASCII")
    p.add_argument("--verbose", action="store_true",
                   help="print device/runtime info")
    p.add_argument("--threads", type=int, default=0,
                   help="host blitter threads (default: all cores)")
    p.add_argument("--path", metavar="FILE", default=None,
                   help="scene JSON path (default: packaged Cornell box)")
    p.add_argument("--scene", default=None,
                   help="packaged scene name (Cornell_Box, demo, scene2, ...) "
                        "or procedural stress:N[:seed] / icosphere:S[:seed] "
                        "/ lights:L[:seed]")
    p.add_argument("--accel", default="auto", choices=ACCELS,
                   help="traversal: baked, array (many primitives; from 512 "
                        "primitives auto also splits heavy pixels into "
                        "chunks), or auto by primitive count; opt-in: grid "
                        "(block-culled sweep of Morton-ordered blocks) and "
                        "gathered (per-ray uniform-grid walk; static scenes "
                        "only)")
    p.add_argument("--animate", choices=("orbit", "pulse", "bob"),
                   default=None,
                   help="animate the scene (its values are rebuilt on the "
                        "device every frame); each frame renders fresh")
    p.add_argument("--filter", dest="texture_filter", default=None,
                   choices=("nearest", "bilinear"),
                   help="texture magnification filter override: 'bilinear' "
                        "blends the 2x2 texel neighborhood at every image "
                        "texture, normal map and sky fetch (default: the "
                        "scene's texture_filter, or nearest)")
    p.add_argument("--unbiased", action="store_true",
                   help="physically-correct direct lighting: skip re-adding "
                        "emission on NEE-sampled diffuse hits (the reference "
                        "double-counts)")
    p.add_argument("--mis", action="store_true",
                   help="multiple importance sampling: weigh NEE and "
                        "BSDF-hit emission by the balance heuristic (same "
                        "mean as --unbiased, lower variance; the same paths "
                        "and RNG chains)")
    p.add_argument("--fog", metavar="D[:R,G,B[:G]]", default=None,
                   help="homogeneous volumetric fog: extinction density D "
                        "per world unit, optional scattering albedo (default "
                        "1,1,1) and Henyey-Greenstein anisotropy G (default "
                        "0 = isotropic); e.g. --fog 0.15, --fog "
                        "0.2:0.8,0.85,0.9, --fog 0.2:1,1,1:0.7")
    p.add_argument("--aperture", type=float, default=None,
                   help="thin-lens radius for depth of field (0 = pinhole, "
                        "the reference's camera)")
    p.add_argument("--focus", type=float, default=None,
                   help="focus distance along the view axis (with "
                        "--aperture)")
    p.add_argument("--sampler", default=None,
                   choices=("reference", "stratified"),
                   help="pixel-jitter sampler override: 'stratified' places "
                        "base-phase samples on a jittered sub-pixel grid "
                        "(same draws, remapped; adaptive extras keep "
                        "independent jitter). Default: the scene's sampler")
    p.add_argument("--light-sample", dest="light_sample", default=None,
                   choices=("all", "uniform", "power"),
                   help="NEE light sampling override: 'all' casts one shadow "
                        "ray per light per bounce (the reference); "
                        "'uniform'/'power' pick one light per bounce "
                        "(uniformly, or by emitted power) and weight the "
                        "estimate by 1/p(pick). Default: the scene's "
                        "light_sample. Scenes with <= 1 light ignore it")
    p.add_argument("--denoise", type=float, default=0.0, metavar="K",
                   help="edge-aware à-trous filter over the accumulated "
                        "radiance before tonemapping, guided by the adaptive "
                        "sampler's variance: K is the edge-stop strength "
                        "(try 0.5-2; larger = smoother). Display only: the "
                        "estimator and its chains stay raw. 0 = off")
    p.add_argument("--denoise-passes", type=int, default=3, metavar="N",
                   help="à-trous rounds (the tap stride doubles each round; "
                        "default 3 = 13x13 footprint)")
    p.add_argument("--shard", metavar="SPEC", default=None,
                   help="multi-GPU rendering over a mesh of torchrun ranks: "
                        "N = N-way pixel-row data parallelism, or px:N / "
                        "sp:N / px:N,sp:M to also split samples with the "
                        "reference's adaptive statistics")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels (default); cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--frames", type=int, default=None, metavar="N",
                   help="headless: render N accumulated frames and exit")
    p.add_argument("--width", type=int, default=None, help="override")
    p.add_argument("--height", type=int, default=None, help="override")
    p.add_argument("--spp", type=int, default=None,
                   help="override samples_per_pixel")
    p.add_argument("--depth", type=int, default=None, help="override max_depth")
    return p


def parse_fog(spec: str):
    """--fog D[:R,G,B[:G]] -> models.scene.Fog (the JAX CLI's parsing)."""
    from .models.scene import Fog

    parts = spec.split(":")
    density = float(parts[0])
    albedo = (1.0, 1.0, 1.0)
    if len(parts) > 1 and parts[1]:
        rgb = [float(c) for c in parts[1].split(",")]
        if len(rgb) != 3:
            raise ValueError(f"--fog albedo needs 3 comma-separated values, "
                             f"got {parts[1]!r}")
        albedo = tuple(rgb)
    g = float(parts[2]) if len(parts) > 2 else 0.0
    return Fog(density=density, albedo=albedo, g=g)


def _process_group(device: str):
    """The process group for --shard: the caller's, or one initialised
    from torchrun's RANK / WORLD_SIZE / LOCAL_RANK (nccl on cuda:LOCAL_RANK,
    gloo on the CPU). Returns (device, whether this call initialised it);
    raises ValueError where there is none to be had."""
    import torch
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cuda":
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank with LOCAL_RANK {local} and "
                f"{torch.cuda.device_count()} CUDA devices: NCCL needs a "
                "device of its own for each rank")
        device = f"cuda:{local}"
    if dist.is_initialized():
        return device, False
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise ValueError("--shard needs a process group of px * sp ranks: "
                         "run under torchrun --nproc-per-node N")
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device, True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs a CUDA GPU, and torch sees none "
              "(use --device cpu for the plain PyTorch versions)",
              file=sys.stderr)
        return 2
    if not args.shard:
        return _run(args, args.device)
    from .runtime.engine import _parse_shard

    try:
        _parse_shard(args.shard)
        device, own = _process_group(args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        return _run(args, device)
    finally:
        if own:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, device: str) -> int:
    """main's body on `device`, once any process group is up."""
    from .models import load_scene
    from .runtime.engine import Engine
    from .runtime.terminal import terminal_size

    if args.path and args.scene:
        print("error: --path and --scene are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.frames is not None and args.frames < 1:
        print(f"error: --frames must be >= 1 (got {args.frames})",
              file=sys.stderr)
        return 2
    if args.mis and args.unbiased:
        print("error: --mis and --unbiased are mutually exclusive",
              file=sys.stderr)
        return 2
    try:
        scene = load_scene(args.path or args.scene).with_overrides(
            width=args.width, height=args.height,
            samples_per_pixel=args.spp, max_depth=args.depth,
            aperture=args.aperture, focus_distance=args.focus,
            fog=None if args.fog is None else parse_fog(args.fog),
            texture_filter=args.texture_filter, sampler=args.sampler,
            light_sample=args.light_sample,
        )
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    transport = ("mis" if args.mis else
                 "unbiased" if args.unbiased else "reference")

    interactive = args.frames is None
    if interactive:
        tw, th = terminal_size()
        scene = scene.clamp_to_terminal(tw, th)
        if args.shard:
            # The row blocks need height % n_px == 0: round the clamped
            # height down to a multiple of n_px (at least n_px rows).
            from .runtime.engine import _parse_shard

            n_px = _parse_shard(args.shard)[0]
            h = max(scene.height - scene.height % n_px, n_px)
            if h != scene.height:
                scene = scene.with_overrides(height=h)

    try:
        engine = Engine(scene, full_color=args.full_color, device=device,
                        threads=args.threads, verbose=args.verbose,
                        accel=args.accel, animate=args.animate,
                        transport=transport, shard=args.shard,
                        denoise=args.denoise,
                        denoise_passes=args.denoise_passes)
    except ValueError as e:  # e.g. --accel gathered with --animate
        print(f"error: {e}", file=sys.stderr)
        return 2
    if engine.is_root:
        print("outputting with █ characters" if args.full_color
              else "outputting with ASCII characters")

    if interactive:
        if engine.is_root and not sys.stdin.isatty():
            print("error: interactive mode needs a tty (use --frames N for "
                  "headless rendering)", file=sys.stderr)
            engine.cancel_viewer()
            return 2
        engine.run_interactive()
        return 0

    fetched = engine.run_headless(args.frames)
    if fetched is None:  # a rank of a mesh other than 0
        return 0
    _rgb, glyphs, rays, mean_spp = fetched
    if not args.full_color:
        from .ops.tonemap import GLYPH_RAMP

        for row in glyphs:
            print("".join(GLYPH_RAMP[min(int(i), 67)] for i in row))
    if args.verbose:
        # An animated engine counts its frames on the animation clock.
        n_done = engine._anim_t if args.animate else engine.frame_count
        print(f"[headless] {n_done} frames, {rays:.3e} rays in last frame, "
              f"mean spp {mean_spp:.1f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
