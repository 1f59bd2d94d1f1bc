"""The comparison that decides `correct`: each sampled frame of the timed
path against the plain reference (benchmark/reference), which works it out
again from the run's inputs (the configuration, the seed, the key presses
and the frame's place in the run).

For every sampled frame the reference renders the frame, folds it into the
running mean, tonemaps and encodes it. The running mean before a frame is
the program's own state: the reference follows the program frame by frame
from there. Frames at accumulation frame number 0, which the sample always
holds, start from nothing and check the start by themselves.

The numbers, each the worst over the sampled frames:

- rays_gap: |owed rays - the reference's| / the reference's, whole frame;
- samples_px: share of pixels whose sample count (base plus budget)
  differs;
- var_px: share of pixels whose base-sample variance differs;
- acc_px: share of running-mean values that differ;
- rgb_px: share of the image's bytes that differ;
- rows_px: share of the frame's terminal rows whose bytes differ from the
  reference's encoding (sampled frames that reached the terminal: of the
  reference's image where the frame is also one of the sampled frames
  above, else of the image the program encoded).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.pathtracer import Renderer
from reference import viewer

NUMBERS = ("rays_gap", "samples_px", "var_px", "acc_px", "rgb_px", "rows_px")


class Produced:
    """One frame as a side produced it (program or control): the state
    after it, its rays and images. Tensors on any device, or numpy."""

    def __init__(self, acc, variance, samples, rays, rgb, image=None,
                 payload=None):
        self.acc, self.variance, self.samples = acc, variance, samples
        self.rays, self.rgb, self.image, self.payload = (rays, rgb, image,
                                                         payload)


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _share_differ(a, b) -> float:
    """The share of entries of `a` and `b` that differ (NaNs equal)."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        return 1.0
    same = (a == b)
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return float(1.0 - same.mean())


def _rows_differ(a: bytes, b: bytes) -> float:
    ra, rb = a.split(b"\r\n"), b.split(b"\r\n")
    if len(ra) != len(rb):
        return 1.0
    return sum(x != y for x, y in zip(ra, rb)) / max(len(ra) - 1, 1)


def compare(got: Produced, ref: Produced) -> dict:
    """The numbers of one frame (NUMBERS; rows_px only where `got` reached
    the terminal)."""
    r_ref = float(_np(ref.rays).astype(np.float64).sum())
    r_got = float(_np(got.rays).astype(np.float64).sum())
    out = {
        "rays_gap": abs(r_got - r_ref) / max(r_ref, 1.0),
        "samples_px": _share_differ(got.samples, ref.samples),
        "var_px": _share_differ(got.variance, ref.variance),
        "acc_px": _share_differ(got.acc, ref.acc),
    }
    rgbs = [x for x in (got.rgb, got.image) if x is not None]
    if rgbs:
        out["rgb_px"] = max(_share_differ(x, ref.rgb) for x in rgbs)
    if got.payload is not None:
        out["rows_px"] = _rows_differ(got.payload, ref.payload)
    return out


class Reference:
    """The reference of one configuration on one device."""

    def __init__(self, cfg: dict, device, precision: str = "f32"):
        self.renderer = Renderer(cfg, device, precision)
        self.precision = precision

    def frame(self, inputs, pre_acc, want_payload: bool) -> Produced:
        """The reference's frame of `inputs` (cam, seed, frame number)
        folded into `pre_acc`, the running mean before it."""
        cam, seed, fn = inputs
        f = self.renderer.render(cam, seed, fn)
        acc = viewer.accumulate(pre_acc, f.current, fn, self.precision)
        rgb = viewer.tonemap(acc)
        payload = viewer.encode(_np(rgb)) if want_payload else None
        return Produced(acc, f.variance, f.samples, f.rays, rgb,
                        payload=payload)


def check(captures, inputs, cfg: dict, device, limits: dict,
          require=("rays_gap", "samples_px", "var_px", "acc_px", "rgb_px"),
          shown=()):
    """Compare every capture (drive.Capture) with the reference. `inputs`:
    the (cam, seed, frame number) of every dispatch of the run. `shown`:
    (image, bytes) of sampled frames that reached the terminal, whose bytes
    are held against the reference's encoding of that image (`rows_px`).
    Returns (correct, {number: (worst value, limit)}, frames that failed).
    A number in `require` that no frame gives fails."""
    ref = Reference(cfg, device)
    worst, failed = {}, 0
    for image, payload in shown:
        rows = _rows_differ(payload, viewer.encode(image))
        failed += rows > limits["rows_px"]
        worst["rows_px"] = max(worst.get("rows_px", 0.0), rows)
    for cap in captures:
        got = Produced(cap.acc, cap.variance, cap.samples, cap.rays, cap.rgb,
                       cap.image, cap.payload)
        want = ref.frame(inputs[cap.idx], cap.pre_acc.to(device),
                         cap.payload is not None)
        nums = compare(got, want)
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del got, want
    table = {k: (worst[k], limits[k]) for k in NUMBERS if k in worst}
    correct = (bool(captures) and failed == 0
               and all(k in worst for k in require))
    return correct, table, failed


def control_numbers(cfg: dict, device, seed: int, frames: int = 2) -> dict:
    """The control: the reference with its accumulators in bfloat16, put in
    the program's place for the first `frames` frames of a headless run of
    seed `seed` (frame 0 from nothing, then each folded into the control's
    own running mean), judged by `compare` against the reference. Returns
    the worst of each number."""
    ref, ctl = Reference(cfg, device), Reference(cfg, device, "bf16")
    inputs = viewer.frame_inputs(seed, [[] for _ in range(frames)])
    r = ref.renderer
    pre = torch.zeros((3, r.height, r.width), dtype=torch.float32,
                      device=r.device)
    worst = {}
    for inp in inputs:
        got = ctl.frame(inp, pre, want_payload=True)
        want = ref.frame(inp, pre, want_payload=True)
        for k, v in compare(got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
        pre = got.acc
    return worst
