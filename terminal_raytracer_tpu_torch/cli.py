"""Command-line entry point — ``terminal_raytracer_tpu/cli.py``.

Reference flags: --full-color, --verbose, --threads N, --path FILE; plus,
with the JAX package's spellings, defaults and errors: --scene (packaged
names, stress:N[:seed], icosphere:S[:seed], lights:L[:seed], ...),
--accel, --animate, --filter, the transport and camera extensions
--unbiased, --mis, --fog, --aperture, --focus, --sampler and
--light-sample, the display filter --denoise and --denoise-passes, the
display transforms --tonemap and --exposure, --shard, --frames, --width,
--height, --spp, --depth, the frame-loop flags --deterministic,
--no-pipeline, --no-clamp and --profile, checkpoints and output
--dump-image, --save-state and --load-state, and the offline modes --scan,
--turntable and --until-noise; and --device. In the interactive viewer
WASD moves, arrows steer, 'v' toggles the variance heat map, 'p' writes a
screenshot PNG, ESC exits.

Run: python -m terminal_raytracer_tpu_torch [flags]

--shard renders on a mesh of ranks (parallel/mesh.py), one process a rank
under torchrun, which sets RANK, WORLD_SIZE and LOCAL_RANK: rank r takes
cuda:LOCAL_RANK over NCCL, or the CPU over gloo with --device cpu, and
rank 0 prints the frame and writes the files. E.g. torchrun
--nproc-per-node 4 -m terminal_raytracer_tpu_torch --device cpu --shard
px:2,sp:2 --frames 2 (a caller that has initialised a process group of its
own keeps it).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from .ops.tracer import ACCELS


def _tonemap_spec(spec: str) -> str:
    """argparse type for --tonemap: refuse a bad spec as a flag error, keep
    the spec string."""
    from .ops.tonemap import parse_mode

    parse_mode(spec)
    return spec


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
    p.add_argument("--tonemap", type=_tonemap_spec, default="reference",
                   metavar="MODE",
                   help="display transform: 'reference' (the reference's "
                        "sqrt / pow-0.3 curves, default), 'aces' (Narkowicz "
                        "ACES filmic fit + 1/2.2 display gamma), or "
                        "'gamma:G' (plain 1/G power curve). Display-only: "
                        "the estimator and checkpoints stay linear radiance")
    p.add_argument("--exposure", type=float, default=0.0, metavar="STOPS",
                   help="pre-tonemap exposure in stops (radiance x "
                        "2^STOPS); display-only, composes with --tonemap")
    p.add_argument("--deterministic", type=int, default=None, metavar="SEED",
                   help="fixed RNG seed (the reference seeds randomly)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="synchronous frame loop, like the reference")
    p.add_argument("--dump-image", metavar="FILE", default=None,
                   help="with --frames: write final frame (.ppm or .png)")
    p.add_argument("--save-state", metavar="FILE", default=None,
                   help="with --frames: checkpoint accumulation state")
    p.add_argument("--load-state", metavar="FILE", default=None,
                   help="resume from a saved state")
    p.add_argument("--no-clamp", action="store_true",
                   help="don't clamp resolution to the terminal size")
    p.add_argument("--turntable", type=int, default=None, metavar="N",
                   help="with --frames: render N poses orbiting the scene "
                        "centroid (accumulating --frames frames each) and "
                        "write a numbered image sequence to --dump-image (a "
                        "%%d pattern, or _NNN is inserted before the "
                        "extension); add --scan to fold the whole orbit on "
                        "the device with no read-back between frames")
    p.add_argument("--until-noise", type=float, default=None, metavar="X",
                   help="with --frames: stop early once the estimated noise "
                        "of the accumulated image (mean sample variance / "
                        "total samples) drops below X; --frames caps the "
                        "run (per pose with --turntable; with --scan the "
                        "check runs between chunks of frames)")
    p.add_argument("--scan", action="store_true",
                   help="with --frames: fold the whole frame sequence on "
                        "the device, one image at the end (offline mode)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="with --frames: write a torch.profiler trace of the "
                        "render to DIR (view with Perfetto or "
                        "chrome://tracing)")
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


def _flag_error(args):
    """The JAX CLI's refusals of flag combinations, as an error message, or
    None."""
    if args.path and args.scene:
        return "--path and --scene are mutually exclusive"
    if args.frames is not None and args.frames < 1:
        return f"--frames must be >= 1 (got {args.frames})"
    if args.mis and args.unbiased:
        return "--mis and --unbiased are mutually exclusive"
    if args.turntable is not None and args.frames is None:
        return ("--turntable needs --frames N (accumulation frames per "
                "pose)")
    if args.animate and args.turntable is not None:
        return "--animate is incompatible with --turntable"
    if args.animate and args.scan and not args.dump_image:
        return ("--animate --scan writes an image sequence; pass "
                "--dump-image (a %d pattern or a name to number)")
    if args.until_noise is not None and args.animate:
        return ("--until-noise cannot converge under --animate (animated "
                "frames never accumulate)")
    if (args.until_noise is not None and args.scan
            and args.turntable is not None):
        return ("--until-noise with --turntable needs per-pose frame "
                "driving (drop --scan)")
    if args.shard:
        # The offline renderers fold frames through the unsharded step.
        for flag, bad in (("--scan", args.scan),
                          ("--turntable", args.turntable is not None)):
            if bad:
                return f"--shard is incompatible with {flag}"
    return None


@contextlib.contextmanager
def _profile(out_dir: str, device: str):
    """--profile: a torch.profiler trace of the block (CPU, and CUDA on a
    CUDA device) written to out_dir as trace_rank<r>.json (rank 0
    unsharded)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    rank = dist.get_rank() if dist.is_initialized() else 0
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_rank{rank}.json"))


def _run(args, device: str) -> int:
    """main's body on `device`, once any process group is up."""
    import numpy as np

    from .models import load_scene
    from .runtime.engine import Engine
    from .runtime.terminal import terminal_size

    err = _flag_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
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
    if interactive and not args.no_clamp:
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
                        deterministic=args.deterministic, accel=args.accel,
                        animate=args.animate, transport=transport,
                        shard=args.shard, denoise=args.denoise,
                        denoise_passes=args.denoise_passes,
                        pipeline=not args.no_pipeline, tonemap=args.tonemap,
                        exposure=args.exposure)
    except ValueError as e:  # e.g. --accel gathered with --animate
        print(f"error: {e}", file=sys.stderr)
        return 2
    if engine.is_root:
        print("outputting with █ characters" if args.full_color
              else "outputting with ASCII characters")

    if args.load_state:
        from .utils.statefile import load_state

        try:
            engine.restore(*load_state(
                args.load_state, expect_shape=(scene.height, scene.width)))
        except (ValueError, OSError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if interactive:
        if engine.is_root and not sys.stdin.isatty():
            print("error: interactive mode needs a tty (use --frames N for "
                  "headless rendering)", file=sys.stderr)
            engine.cancel_viewer()
            return 2
        engine.run_interactive()
        return 0

    profile_ctx = (_profile(args.profile, device) if args.profile
                   else contextlib.nullcontext())

    if args.turntable is not None:
        if args.turntable < 1:
            print(f"error: --turntable must be >= 1 (got {args.turntable})",
                  file=sys.stderr)
            return 2
        if not args.dump_image:
            print("error: --turntable needs --dump-image (a %d pattern or "
                  "a name to number)", file=sys.stderr)
            return 2
        err = _check_sequence_pattern(args.dump_image)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        with profile_ctx:
            paths = _run_turntable(engine, scene, args)
        print(f"wrote {len(paths)} frames: {paths[0]} .. {paths[-1]}")
        return 0

    if args.animate and args.scan:
        err = _check_sequence_pattern(args.dump_image)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        with profile_ctx:
            paths = _run_animation_scan(engine, scene, args)
        print(f"wrote {len(paths)} frames: {paths[0]} .. {paths[-1]}")
        return 0

    with profile_ctx:
        if args.scan:
            from .runtime.offline import (make_noise_scan_renderer,
                                          make_scan_renderer)

            start = engine.frame_count  # continues a --load-state resume
            rng = np.random.RandomState(args.deterministic)
            seeds = (rng.randint(0, 2**32, size=args.frames, dtype=np.uint64)
                     + np.arange(start, start + args.frames,
                                 dtype=np.uint64)).astype(np.uint32)
            pose = engine.camera.pose()
            if args.until_noise is not None:
                render = make_noise_scan_renderer(scene, args.frames,
                                                  args.until_noise,
                                                  step=engine.step)
                engine.state, rgb, glyphs, rays, done = render(
                    engine.state, pose, seeds, start)
                engine.frame_count = start + done
            else:
                render = make_scan_renderer(scene, args.frames,
                                            step=engine.step)
                engine.state, rgb, glyphs, rays = render(engine.state, pose,
                                                         seeds, start)
                engine.frame_count = start + args.frames
            fetched = (rgb.cpu().numpy(), glyphs.cpu().numpy(), float(rays),
                       float("nan"))
        else:
            fetched = engine.run_headless(args.frames,
                                          until_noise=args.until_noise)
    # Sharded, every rank takes part in gathering the checkpoint.
    whole = engine.whole_state() if args.save_state else None
    if fetched is None:  # a rank of a mesh other than 0
        return 0
    rgb, glyphs, rays, mean_spp = fetched
    if args.dump_image:
        _write_frame_image(args.dump_image, rgb)
        print(f"wrote {args.dump_image}")
    if args.save_state:
        from .utils.statefile import save_state

        save_state(args.save_state, whole, engine.frame_count, engine.camera)
        print(f"saved state to {args.save_state}")
    if not args.full_color and glyphs is not None and args.dump_image is None:
        from .ops.tonemap import GLYPH_RAMP

        for row in glyphs:
            print("".join(GLYPH_RAMP[min(int(i), 67)] for i in row))
    if args.verbose:
        # frame_count reflects an early --until-noise stop; an animated
        # engine counts its frames on the animation clock.
        n_done = engine._anim_t if args.animate else engine.frame_count
        print(f"[headless] {n_done} frames, {rays:.3e} rays in last frame, "
              f"mean spp {mean_spp:.1f}", file=sys.stderr)
    return 0


def _turntable_path(pattern: str, k: int) -> str:
    """`%d`-style pattern, or insert _NNN before the extension."""
    if "%" in pattern:
        return pattern % k
    stem, ext = os.path.splitext(pattern)
    return f"{stem}_{k:03d}{ext or '.png'}"


def _check_sequence_pattern(pattern: str) -> "str | None":
    """Check a --dump-image sequence pattern before rendering (a stray '%',
    as in '100%.png', would otherwise fail after the render). Returns an
    error string or None."""
    try:
        _turntable_path(pattern, 0)
    except (TypeError, ValueError) as e:
        return (f"--dump-image pattern {pattern!r} is not a valid %d "
                f"sequence pattern ({e})")
    return None


def _orbit_poses(camera, scene, n):
    """n cameras orbiting the scene centroid in the XZ plane, keeping the
    starting camera's height and orbit radius."""
    import numpy as np

    from .models.camera import Camera

    center = scene.centroid()
    rel = np.asarray(camera.position, np.float32) - center
    radius = float(np.hypot(rel[0], rel[2]))
    if radius < 1e-6:
        radius = max(1.0, float(np.linalg.norm(rel)))
    phi0 = float(np.arctan2(rel[2], rel[0]))
    height = float(rel[1])
    out = []
    for k in range(n):
        phi = phi0 + 2.0 * np.pi * k / n
        pos = center + np.array(
            [radius * np.cos(phi), height, radius * np.sin(phi)], np.float32)
        out.append(Camera.look_at(pos, center))
    return out


def _write_frame_image(path, rgb):
    """rgb (u8 [H, W, 3], numpy or a tensor) to .ppm, else .png."""
    import numpy as np

    from .utils import imageio

    rgb = rgb.cpu().numpy() if hasattr(rgb, "cpu") else np.asarray(rgb)
    if path.endswith(".ppm"):
        imageio.write_ppm(path, rgb)
    else:
        imageio.write_png(path, rgb)


def _run_animation_scan(engine, scene, args):
    """--animate --scan: the animator's values of every frame, evaluated on
    the host up front, rendered through the dynamic step
    (runtime/offline.make_animation_scan_renderer), one image a frame."""
    import numpy as np

    from .models.animate import ANIMATORS
    from .ops.dynamic import pack_scene
    from .runtime.offline import make_animation_scan_renderer

    animator = ANIMATORS[args.animate]
    arrays0 = pack_scene(scene)
    frames = [animator(arrays0, t) for t in range(args.frames)]
    arrays_seq = {k: np.stack([f[k] for f in frames]) for k in arrays0}
    render = make_animation_scan_renderer(scene, args.frames,
                                          step=engine.step)
    # Paths first, so that a bad pattern fails before the render.
    paths = [_turntable_path(args.dump_image, k) for k in range(args.frames)]
    seeds = np.random.RandomState(args.deterministic).randint(
        0, 2**32, size=args.frames, dtype=np.uint64).astype(np.uint32)
    rgbs, _glyphs, _rays = render(engine.camera.pose(), arrays_seq, seeds)
    for path, rgb in zip(paths, rgbs.cpu().numpy()):
        _write_frame_image(path, rgb)
    return paths


def _run_turntable(engine, scene, args):
    """Render `args.turntable` poses orbiting the scene centroid, each pose
    accumulating `args.frames` frames from a fresh state: through the
    engine's step and seeds, one pose after another (frame_count reset to
    0 a pose, the seed stream carried on), or with --scan through
    runtime/offline.make_orbit_scan_renderer on seeds drawn up front."""
    import numpy as np

    from .runtime.state import init_state

    cams = _orbit_poses(engine.camera, scene, args.turntable)
    paths = [_turntable_path(args.dump_image, k)
             for k in range(args.turntable)]

    if args.scan:
        from .runtime.offline import make_orbit_scan_renderer

        render = make_orbit_scan_renderer(scene, args.turntable, args.frames,
                                          step=engine.step)
        seeds = np.random.RandomState(args.deterministic).randint(
            0, 2**32, size=(args.turntable, args.frames),
            dtype=np.uint64).astype(np.uint32)
        poses = np.stack([c.pose() for c in cams])
        rgbs, _glyphs, _rays = render(poses, seeds)
        for path, rgb in zip(paths, rgbs.cpu().numpy()):
            _write_frame_image(path, rgb)
        return paths

    for k, cam in enumerate(cams):
        engine.camera = cam
        engine.state = init_state(scene, engine.device)
        engine.frame_count = 0
        rgb, _g, _r, _s = engine.run_headless(args.frames,
                                              until_noise=args.until_noise)
        _write_frame_image(paths[k], rgb)
        if args.verbose:
            print(f"[turntable] pose {k + 1}/{args.turntable} -> {paths[k]}",
                  file=sys.stderr)
    return paths


if __name__ == "__main__":
    sys.exit(main())
