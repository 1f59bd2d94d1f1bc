"""Trace each pixel where the card and the CPU disagree to the sample and
the test that flips.

For the scenes of examples_torch/ (tools/card_vs_cpu.py's four, at its cut
and at the scene's own size), the plain whole frame (PathTracer.
render_frame: on the card the kernels give it bit for bit) renders on the
card and on the CPU for each frame's inputs: the 'frame' inputs of
card_vs_cpu (seed SEED0 + f, frame number f), which are also the per-frame
inputs of the render_png, custom_scene and glass loops, and animate's
'loop' inputs (seed 1 + t, frame number 0, the orbit's arrays of frame t).
Each pixel whose channel is off by more than TOL (relative) is then
rendered again on both devices with hooks on the tracer, which record for
the pixel's lanes, in order: every scheduler step (sample index, bounce,
state, ray, throughput, radiance), every NEE light point and every sweep
(per primitive: the hit distance of a closest-hit sweep, the blocked flag
of a shadow sweep, with the ray). The two records are compared event by
event:

  first difference  the first recorded value that differs in its bits
                    (where an ulp enters: which sample, bounce and value);
  flips             the discrete outcomes that differ: a shadow sweep's
                    blocked flag or a closest hit's winner, with the
                    primitive, whether it is the light being sampled
                    ('self'), and the flipped test's margin (its root's
                    distance from t_max, in ulps of t_max);
  bound             the pixel's error against the NEE flip bound: a
                    flipped shadow test moves one NEE estimate, at most
                    NEE_CLAMP a channel, so the pixel moves by at most
                    flips x NEE_CLAMP / samples a channel.

    python -m terminal_raytracer_tpu_torch.tools.knife_trace [--frames 4]
        [--sizes cut,full] [--max-pixels 12]

Needs the card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models import Camera
from ..models.animate import ANIMATORS
from ..ops import geometry as geom
from ..ops import tracer as tracer_mod
from ..ops.dynamic import pack_scene
from ..ops.tracer import PathTracer
from ..ops.vecmath import V3
from .card_vs_cpu import CUT, SEED0, TOL, example

STEP_KEYS = ("samp", "bounce", "alive", "state", "o", "d", "att", "acc")


def _values(t, idx):
    """The values of tensor (or V3) `t` at flat lanes `idx`, on the host."""
    if isinstance(t, V3):
        return np.stack([_values(c, idx) for c in t], -1)
    if not torch.is_tensor(t):
        return np.full(len(idx), t)
    return t.reshape(-1)[idx.to(t.device)].cpu().numpy()


class Recorder:
    """Hooks on tracer `tr` that record the events of the lanes of
    `pixels` ([(x, y)]), by pixel: [(tag, phase, chunk, {name: value})]."""

    def __init__(self, tr, pixels):
        self.tr, self.pixels = tr, list(pixels)
        self.events = {p: [] for p in self.pixels}
        self.lanes = []  # [(flat lane, pixel, chunk)] of the running phase
        self.phase = None
        n, w = tr.width * tr.height, tr.width
        base_run, extra_run, step = tr._base_run, tr._extra_run, tr.regen_step
        nee = tr._nee_sample
        prims = tr.prims
        tests = self.tests = prims._tests  # unhooked, for the margins

        def on_base(cam, xf, yf, state0, chunk=None, quota=None):
            self.phase = "base"
            self.lanes = [(c * n + y * w + x, (x, y), c)
                          for x, y in self.pixels
                          for c in range(tr.n_base_chunks)]
            return base_run(cam, xf, yf, state0, chunk, quota)

        def on_extra(cam, xf, yf, state, additional, samp0):
            live = torch.nonzero(additional.reshape(-1) > 0.0).squeeze(1)
            pos = {int(v): i for i, v in enumerate(live.cpu().tolist())}
            self.phase = "extra"
            self.lanes = [(pos[c * n + y * w + x], (x, y), c)
                          for x, y in self.pixels
                          for c in range(additional.shape[0])
                          if c * n + y * w + x in pos]
            return extra_run(cam, xf, yf, state, additional, samp0)

        def on_step(cam, xf, yf, c):
            out = step(cam, xf, yf, c)
            self._add("step", {k: getattr(c, k) for k in ("samp", "bounce",
                                                          "alive")}
                      | {k: getattr(out, k) for k in STEP_KEYS[3:]})
            return out

        def on_nee(*args):
            self._add("nee", {"p": args[0], "normal": args[1],
                              "gate": args[4], "lp": args[5]})
            return nee(*args)

        closest, occluded = prims.closest_hit, prims.occluded

        def on_tests(o, d, t_min, t_max, blocked):
            res = tests(o, d, t_min, t_max, blocked)
            self._add("shadow" if blocked else "closest",
                      {"o": o, "d": d, "t_max": t_max, "res": res,
                       "gate": self.gate})
            return res

        def on_closest(o, d, t_min=geom.RAY_EPS, t_max=geom.T_FAR,
                       gate=None):
            self.gate = gate
            return closest(o, d, t_min, t_max, gate)

        def on_occluded(o, d, t_min, t_max, gate=None):
            self.gate = gate
            return occluded(o, d, t_min, t_max, gate)

        tr._base_run, tr._extra_run, tr.regen_step = on_base, on_extra, on_step
        tr._nee_sample = on_nee
        prims._tests = on_tests
        prims.closest_hit, prims.occluded = on_closest, on_occluded
        self.gate = None

    def _add(self, tag, vals):
        if not self.lanes:
            return
        idx = torch.tensor([lane for lane, _, _ in self.lanes])
        got = {}
        for k, v in vals.items():
            if k == "res":  # [..., n_prims]: by lane, a row each
                rows = v.reshape(-1, v.shape[-1])
                got[k] = rows[idx.to(rows.device)].cpu().numpy()
            else:
                got[k] = _values(v, idx)
        for i, (_, pix, c) in enumerate(self.lanes):
            self.events[pix].append((tag, self.phase, c,
                                     {k: v[i] for k, v in got.items()}))


def _ulps(a, b) -> int:
    """The largest distance in f32 ulps between two arrays of equal shape
    (0 for equal bits; integers and flags: 0 or 1)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != np.float32:
        return int(not np.array_equal(a, b))
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _where(events, i):
    """(phase, chunk, sample, bounce) of event i: from the last step before
    it (the step that follows records the state going in)."""
    tag, phase, c, _ = events[i]
    for j in range(i, len(events)):
        if events[j][0] == "step" and events[j][1] == phase:
            v = events[j][3]
            return phase, c, int(v["samp"]), int(v["bounce"])
    return phase, c, -1, -1


def _prim(tr, j: int) -> str:
    n_sph, n_pln, n_tri, _ = tr.tables.counts
    if j < n_sph:
        return f"sphere {j}"
    if j < n_sph + n_pln:
        return f"plane {j - n_sph}"
    return f"triangle {j - n_sph - n_pln}"


def _margin(rec, ev, j: int) -> str:
    """The flipped shadow test's root (by the recorder's unhooked sweep, on
    its tracer's device) against t_max, in ulps of t_max."""
    v, dev = ev[3], rec.tr.device
    o = V3(*(torch.tensor(v["o"][k:k + 1], device=dev) for k in range(3)))
    d = V3(*(torch.tensor(v["d"][k:k + 1], device=dev) for k in range(3)))
    t_max = np.float32(v["t_max"])
    t = rec.tests(o, d, geom.RAY_EPS, geom.T_FAR, False)[0, j]
    t = np.float32(t.cpu())
    if t <= 0.0:
        return f"no root past RAY_EPS (a grazing ray), t_max {t_max:.9g}"
    return (f"root {t:.9g} vs t_max {t_max:.9g} "
            f"({_ulps(np.array([t]), np.array([t_max]))} ulps)")


def _self_light(tr, ev, j: int) -> bool:
    """Whether primitive j is the sphere whose surface the shadow ray ends
    on: the NEE light being sampled (its point lies on the sphere)."""
    n_sph = tr.tables.counts[0]
    if j >= n_sph:
        return False
    sph = tr.tables.sph[j].double().cpu().numpy()
    o, d = np.float64(ev[3]["o"]), np.float64(ev[3]["d"])
    end = o + d * (np.float64(ev[3]["t_max"]) + geom.RAY_EPS)
    r = np.sqrt(sph[3])
    return abs(np.linalg.norm(end - sph[:3]) - r) < 1e-3 * max(r, 1.0)


def trace_pixel(trs, card, cpu, pix):
    """The comparison of one pixel's records (card, cpu): (first
    difference, [flips])."""
    a, b = card.events[pix], cpu.events[pix]
    first, flips = None, []
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea[0] != eb[0]:
            flips.append(f"the records part at event {i}: {ea[0]} on the "
                         f"card, {eb[0]} on the CPU")
            break
        gate = ea[3].get("gate", True)
        if gate is not None and not (bool(gate) or bool(eb[3]["gate"])):
            continue  # a lane the sweep does not owe: its values are idle
        for k in ea[3]:
            u = _ulps(ea[3][k], eb[3][k])
            if u and first is None:
                ph, c, s, bn = _where(a, i)
                first = (f"{ph} chunk {c} sample {s} bounce {bn}: {ea[0]} "
                         f"'{k}' {u} ulps")
        tag = ea[0]
        if tag == "shadow":
            diff = np.nonzero(ea[3]["res"] != eb[3]["res"])[0]
        elif tag == "closest":
            ta = np.where(ea[3]["res"] > 0, ea[3]["res"], np.inf)
            tb = np.where(eb[3]["res"] > 0, eb[3]["res"], np.inf)
            wa, wb = int(np.argmin(ta)), int(np.argmin(tb))
            diff = [] if (wa == wb or (np.isinf(ta[wa]) and np.isinf(tb[wb]))
                          ) else [wa, wb]
        else:
            diff = []
        if len(diff):
            ph, c, s, bn = _where(a, i)
            j = int(diff[0])
            what = (f"blocked {bool(ea[3]['res'][j])} on the card, "
                    f"{bool(eb[3]['res'][j])} on the CPU by {_prim(trs[0], j)}"
                    if tag == "shadow" else
                    f"winner {_prim(trs[0], diff[0])} on the card, "
                    f"{_prim(trs[0], diff[1])} on the CPU")
            extra = ""
            if tag == "shadow":
                who = ("self (the light sampled)"
                       if _self_light(trs[0], ea, j) else "another primitive")
                extra = (f"; {who}; card {_margin(card, ea, j)}, CPU "
                         f"{_margin(cpu, eb, j)}")
            flips.append(f"{ph} chunk {c} sample {s} bounce {bn}: {tag} "
                         f"{what}{extra}")
    return first, flips


def frame_inputs(name, scene, mode, f):
    """(seed, frame number, packed arrays or None) of frame f."""
    if mode == "loop":  # animate's loop: frame number 0, the orbit
        return 1 + f, 0, ANIMATORS["orbit"](pack_scene(scene), f)
    return SEED0[name] + f, f, (pack_scene(scene) if name == "animate"
                                else None)


def tracer_on(scene, device, arrays):
    tr = PathTracer(scene, device, dynamic=arrays is not None)
    if arrays is not None:
        tr.bind_packed({k: v.to(device) if torch.is_tensor(v) else v
                        for k, v in arrays.items()})
    return tr


def run(name, scene, mode, frames, max_pixels, nee_clamp) -> int:
    """Print the traces of one scene and input set; returns the pixels off
    whose flips are not NEE shadow tests of the sampled light within the
    bound."""
    pose = Camera().pose()
    faults = 0
    for f in range(frames):
        seed, fn, arrays = frame_inputs(name, scene, mode, f)
        outs, trs = [], []
        for dev in ("cuda", "cpu"):
            tr = tracer_on(scene, dev, arrays)
            cur, _, total, rays, _ = tr.render_frame(pose, seed, fn)
            outs.append((torch.stack([c.cpu() for c in cur]).double(),
                         total.cpu(), float(rays)))
            trs.append(tr)
        (ga, sa, ra), (gb, sb, rb) = outs
        diff = (ga - gb).abs()
        bad = (diff / gb.abs().clamp(min=1e-3) > TOL).any(0)
        ys, xs = torch.nonzero(bad, as_tuple=True)
        pixels = list(zip(xs.tolist(), ys.tolist()))
        print(f"[knife] {name} {scene.width}x{scene.height} {mode} frame {f}"
              f": rays equal {ra == rb}, samples equal "
              f"{bool(torch.equal(sa, sb))}, {len(pixels)} pixels over {TOL}",
              flush=True)
        if not pixels:
            continue
        pixels = pixels[:max_pixels]
        recs = []
        for tr in trs:
            rec = Recorder(tr, pixels)
            tr.render_frame(pose, seed, fn)
            recs.append(rec)
        for x, y in pixels:
            err = float(diff[:, y, x].max())
            first, flips = trace_pixel(trs, recs[0], recs[1], (x, y))
            n_samp = float(sb[y, x])
            nee = [s for s in flips if " shadow " in s and "self" in s]
            bound = len(nee) * nee_clamp / n_samp
            ok = len(nee) == len(flips) and len(flips) > 0 and err <= bound
            faults += not ok
            print(f"[knife]   pixel ({x}, {y}): max channel error {err:.4g}, "
                  f"{n_samp:.0f} samples; first difference: {first}; "
                  f"{len(flips)} flips; NEE self-shadow flips {len(nee)}, "
                  f"bound {bound:.4g}: within {ok}", flush=True)
            for s in flips[:6]:
                print(f"[knife]     {s}", flush=True)
    return faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--sizes", default="cut,full")
    p.add_argument("--max-pixels", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs the card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    faults = 0
    for name in SEED0:
        full = example(name).build_scene("cuda")
        for size in args.sizes.split(","):
            scene = full.with_overrides(**CUT) if size == "cut" else full
            for mode in ("frame", "loop") if name == "animate" else ("frame",):
                faults += run(name, scene, mode, args.frames, args.max_pixels,
                              tracer_mod.NEE_CLAMP)
    print(f"[knife] pixels not explained by a NEE self-shadow flip within "
          f"its bound: {faults}", flush=True)
    return 0 if faults == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
