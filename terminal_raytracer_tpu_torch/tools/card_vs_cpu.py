"""The card against the CPU on the scenes of examples_torch/: the
knife-edge readings that chip_smoke.py [examples] bounds by
KNIFE_CARD_CPU.

Both devices render the same plain arithmetic, but torch's CUDA and CPU
sin/cos/rsqrt differ by an ulp, which at a sphere light's self-shadow edge
can flip a NEE light sample. For render_png, custom_scene, animate and
glass, at chip_smoke's cut (64x32, depth 4) and at the scene's own size,
two sets of inputs run on the card and on the CPU, frame by frame:

  loop   the example's own frame loop (its seeds and frame numbers;
         animate: frame number 0 and the orbit's arrays of frame t), its
         accumulated image: what chip_smoke compares over 2 frames;
  frame  the tracer's whole frame (PathTracer.render_frame) at frame
         number f and seed seed0 + f (animate: the scene's packed arrays
         held still), that frame's image alone.

Each line: rays and per-pixel samples equal, the pixels with a channel
whose relative error exceeds 5e-3 and their summed absolute error, frame
by frame, and the most over any two consecutive frames (the union of
their pixels, the sum of their errors: chip_smoke's measure).

    python -m terminal_raytracer_tpu_torch.tools.card_vs_cpu [--frames 4]
        [--sizes cut,full]

Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

from ..models import Camera
from ..ops.dynamic import pack_scene
from ..ops.tracer import PathTracer

TOL = 5e-3
CUT = dict(width=64, height=32, max_depth=4)  # chip_smoke's cut too
SEED0 = {"render_png": 1, "custom_scene": 11, "animate": 1, "glass": 7000}
EXAMPLES_DIR = Path(__file__).resolve().parents[2] / "examples_torch"


def example(name):
    """examples_torch/<name>.py as a module, its main not run."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def knife(got, want):
    """(mask of the pixels of [3, H, W] images where a channel's relative
    error exceeds TOL, their summed absolute error)."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    bad = (diff / want.abs().clamp(min=1e-3) > TOL).any(0)
    return bad, float(diff[:, bad].sum())


def loop_frames(mod, scene, n, device):
    """(rays, samples, image) of each frame of the example's own loop."""
    return [(float(o.rays), o.state.samples.cpu().clone(),
             o.state.acc.cpu().clone())
            for o in mod.frames(scene, n, device)]


def tracer_frames(name, scene, n, device):
    """(rays, samples, image) of the tracer's whole frame f at seed
    SEED0 + f, frame number f."""
    dynamic = name == "animate"
    tr = PathTracer(scene, device, dynamic=dynamic)
    if dynamic:
        tr.bind_packed(pack_scene(scene))
    out = []
    for f in range(n):
        cur, _, total, rays, _ = tr.render_frame(Camera().pose(),
                                                 SEED0[name] + f, f)
        out.append((float(rays), total.cpu().clone(),
                    torch.stack([c.cpu() for c in cur])))
    return out


def compare(card, cpu):
    """(rays and samples equal in every frame, [(pixels, error)] a frame,
    the most (pixels, error) over two consecutive frames)."""
    same = all(a[0] == b[0] and torch.equal(a[1], b[1])
               for a, b in zip(card, cpu))
    per = [knife(a[2], b[2]) for a, b in zip(card, cpu)]
    pair = [(int((m0 | m1).sum()), e0 + e1)
            for (m0, e0), (m1, e1) in zip(per, per[1:])]
    return (same, [(int(m.sum()), e) for m, e in per],
            (max(n for n, _ in pair), max(e for _, e in pair)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--sizes", default="cut,full")
    args = p.parse_args(argv)
    if args.frames < 2:
        p.error("--frames must be >= 2")
    if not torch.cuda.is_available():
        print("error: needs the card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    ok = True
    for name in SEED0:
        mod = example(name)
        full = mod.build_scene("cuda")
        for size in args.sizes.split(","):
            scene = full.with_overrides(**CUT) if size == "cut" else full
            for mode in ("loop", "frame"):
                runs = [loop_frames(mod, scene, args.frames, dev)
                        if mode == "loop" else
                        tracer_frames(name, scene, args.frames, dev)
                        for dev in ("cuda", "cpu")]
                same, per, most = compare(*runs)
                ok &= same
                print(f"{name} {scene.width}x{scene.height} spp "
                      f"{scene.samples_per_pixel} depth {scene.max_depth} "
                      f"{mode}: rays and samples equal {same}; pixels over "
                      f"{TOL} (summed error) a frame "
                      + ", ".join(f"{n} ({e:.4g})" for n, e in per)
                      + f"; most in two frames {most[0]} ({most[1]:.4g})",
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
