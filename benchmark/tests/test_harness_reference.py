"""The plain reference against the program's CPU path at a tiny size: the
frame, the camera under keys, the per-frame seeds, accumulation, tonemap
and the terminal bytes."""

import numpy as np
import pytest
import torch

from harness import spec as spec_mod
from reference import viewer
from reference.pathtracer import Renderer, parse_scene

SPEC = spec_mod.load_spec()


def _cfg(name, **over):
    cfg = dict(spec_mod.load_config(SPEC, name))
    cfg.update(over)
    return cfg


def _pose_cam(pose):
    p = [float(v) for v in np.asarray(pose, np.float32)[:12]]
    return tuple(viewer.V3(*p[i:i + 3]) for i in (0, 3, 6, 9))


@pytest.mark.parametrize("name,over", [
    ("cornell_box", dict(width=12, height=6, samples_per_pixel=16)),
    ("northstar", dict(width=10, height=6)),
], ids=["cornell_box", "northstar"])
@pytest.mark.parametrize("frame_number", [0, 5])
def test_frame_matches_the_program_bit_for_bit(name, over, frame_number):
    from terminal_raytracer_tpu_torch.models import Camera, scene_from_dict
    from terminal_raytracer_tpu_torch.ops import kernels
    from terminal_raytracer_tpu_torch.ops.tracer import PathTracer

    cfg = _cfg(name, **over)
    tracer = PathTracer(scene_from_dict(cfg), "cpu")
    frame = kernels.make_sorted_render_frame(tracer)
    cam = Camera()
    for key in ("w", "left", "up"):
        cam.apply_key(key)
    pose, seed = cam.pose(), 0xDEADBEEF
    cur, var, total, rays, _ = frame(pose, seed, frame_number)
    ref = Renderer(cfg, "cpu").render(_pose_cam(pose), seed, frame_number)
    for a, b in zip(cur, ref.current):
        assert torch.equal(a, b)
    assert torch.equal(var, ref.variance)
    assert torch.equal(total, ref.samples)
    assert float(rays) == float(ref.rays.double().sum())
    assert (total > tracer.base_samples).any()  # the extra phase ran


def test_camera_under_keys_matches_the_program():
    from terminal_raytracer_tpu_torch.models import Camera

    keys = ["w"] * 45 + ["up"] * 40 + ["down"] * 40 + ["left", "d", "s",
                                                        "a", "right", "v"]
    cam, ref = Camera(), viewer.FlyCamera()
    for key in keys:
        assert cam.apply_key(key) == ref.apply(key)
        want = _pose_cam(cam.pose())
        assert ref.cam() == want


def test_frame_seeds_follow_the_engine():
    from terminal_raytracer_tpu_torch.models import scene_from_dict
    from terminal_raytracer_tpu_torch.runtime.engine import Engine

    cfg = _cfg("cornell_box", width=4, height=2)
    seed = 2**31 + 77
    eng = Engine(scene_from_dict(cfg), device="cpu", deterministic=seed)
    keys_before = [["w"], [], [], ["left", "d"], [], []]
    got = []
    for keys in keys_before:
        moved = False
        for k in keys:
            moved = eng.camera.apply_key(k) or moved
        if moved:
            eng.frame_count = 0
        fn = eng.frame_count
        got.append((eng._seed(), fn))
        eng.frame_count += 1
    want = viewer.frame_inputs(seed, keys_before)
    assert [(s, fn) for _, s, fn in want] == got


def test_accumulate_tonemap_and_bytes_match_the_program():
    from terminal_raytracer_tpu_torch.ops.vecmath import V3
    from terminal_raytracer_tpu_torch.runtime import state
    from terminal_raytracer_tpu_torch.runtime.blit import Blitter

    g = torch.Generator().manual_seed(5)
    prev = torch.rand((3, 4, 6), generator=g) * 2.0
    cur = torch.rand((3, 4, 6), generator=g) * 3.0
    for fn in (0, 1, 6, 999):
        acc = prev.clone()
        state.accumulate(acc, V3(*cur), fn)
        ref = viewer.accumulate(prev, viewer.V3(*cur), fn)
        assert torch.equal(acc, ref)
        rgb, _ = state.display(V3(*acc), True)
        assert torch.equal(rgb, viewer.tonemap(ref))
        blit = Blitter(4, 6, True, force_python=True)
        assert blit.encode(rgb.numpy(), None) == viewer.encode(rgb.numpy())


def test_extensions_refused():
    cfg = _cfg("cornell_box")
    cfg["spheres"] = [dict(cfg["spheres"][0], roughness=0.3)]
    with pytest.raises(ValueError, match="roughness"):
        parse_scene(cfg)
    with pytest.raises(ValueError, match="fog"):
        parse_scene(dict(_cfg("cornell_box"), fog={"density": 0.1}))
