"""The port against the committed golden images and the scalar reference,
as the JAX package is held to them (tests/test_golden.py,
tests/test_parity.py).

Golden images: the port's render step on the CPU renders Cornell_Box,
demo and scene2 at test_golden.py's parameters (96x48, 8 spp, depth 4, 4
accumulated frames, seed 1234) with the per-frame seeds of the JAX
package's render_accumulated (runtime/offline.py:327-331: one numpy
RandomState(seed) draw per frame plus the frame index, frame numbers 0..3),
and the final frame's rgb is held to tests/golden/*_96x48.ppm with the same
bounds: mean abs difference below 1, under 1% of values off by more than 8.

Scalar reference: the port's plain frame at spp 4 (base == spp, so the
mean of 4 samples) against tests/scalar_ref.py render_pixel on
test_parity.py's pixels, seeds and depths, with its tolerances (rtol 2e-4,
atol 2e-6; depth 32 on demo rtol 5e-4, atol 5e-6).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalar_ref import render_pixel  # noqa: E402

from terminal_raytracer_tpu.models import load_scene as jload_scene  # noqa
from terminal_raytracer_tpu_torch.models import Camera, load_scene  # noqa
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer  # noqa: E402
from terminal_raytracer_tpu_torch.runtime import (  # noqa: E402
    init_state, make_render_step)
from terminal_raytracer_tpu_torch.utils.imageio import read_ppm  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

GOLDEN = Path(__file__).parent / "golden"
POSE = Camera().pose()


def _frame_seeds(seed, n_frames):
    """render_accumulated's per-frame seeds (runtime/offline.py:327-331)."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2**32, size=n_frames, dtype=np.uint64)
            + np.arange(n_frames, dtype=np.uint64)).astype(np.uint32)


@pytest.mark.parametrize("name", ["Cornell_Box", "demo", "scene2"])
def test_golden_image(name):
    scene = load_scene(name).with_overrides(
        width=96, height=48, samples_per_pixel=8, max_depth=4)
    step = make_render_step(scene, full_color=True, device="cpu")
    state, rays = init_state(scene, "cpu"), 0.0
    for frame, seed in enumerate(_frame_seeds(1234, 4)):
        out = step(state, POSE, int(seed), frame)
        state, rays = out.state, rays + float(out.rays)
    rgb = out.rgb.numpy()
    want = read_ppm(GOLDEN / f"{name}_96x48.ppm")
    assert rgb.shape == want.shape
    diff = np.abs(rgb.astype(np.int32) - want.astype(np.int32))
    assert diff.mean() < 1.0, f"mean abs diff {diff.mean():.2f}"
    assert (diff > 8).mean() < 0.01, f"{(diff > 8).mean():.3%} off by >8"
    assert rays > 0


PIXELS = [(50, 40), (20, 10), (80, 25), (50, 25), (10, 45)]


def _port_pixels(name, w, h, depth, pixels, seed, frame):
    scene = load_scene(name).with_overrides(
        width=w, height=h, samples_per_pixel=4, max_depth=depth)
    current = PathTracer(scene, "cpu").render_frame(POSE, seed, frame)[0]
    return [np.array([float(c[y, x]) for c in current]) for x, y in pixels]


@pytest.mark.parametrize("name", ["Cornell_Box", "scene2"])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_same_seed_sample_mean_matches_scalar_reference(name, depth):
    got = _port_pixels(name, 100, 50, depth, PIXELS, 1234, 0)
    scene = jload_scene(name).with_overrides(
        width=100, height=50, samples_per_pixel=4, max_depth=depth)
    for (px, py), g in zip(PIXELS, got):
        ref = render_pixel(scene, px, py, seed=1234, frame_number=0,
                           n_samples=4)
        np.testing.assert_allclose(
            g, ref, rtol=2e-4, atol=2e-6,
            err_msg=f"pixel ({px},{py}) depth={depth} scene={name}")


def test_deep_bounce_roulette_matches_scalar_reference():
    pixels = [(10, 10), (32, 16), (50, 28)]
    got = _port_pixels("demo", 64, 32, 32, pixels, 77, 2)
    scene = jload_scene("demo").with_overrides(
        width=64, height=32, samples_per_pixel=4, max_depth=32)
    for (px, py), g in zip(pixels, got):
        ref = render_pixel(scene, px, py, seed=77, frame_number=2,
                           n_samples=4)
        np.testing.assert_allclose(g, ref, rtol=5e-4, atol=5e-6,
                                   err_msg=f"pixel ({px},{py})")
