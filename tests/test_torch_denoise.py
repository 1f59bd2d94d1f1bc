"""The port's à-trous denoiser (ops/denoise.py) against the JAX package's
(``terminal_raytracer_tpu/ops/denoise.py``), on the CPU.

The same numpy-seeded colour and variance planes go through both: one
à-trous pass at strides 1, 2 and 4, the filter at 1-3 passes and its
render-step entry point denoise_acc, all within rtol 1e-5 / atol 1e-7
(XLA-CPU's exp and PyTorch's differ by ulps); strength 0 and 0 passes
are the identity, bit for bit. Then the port's render step with
``denoise=1.0`` against the JAX step (``backend="jnp"``) over three
accumulated Cornell_Box frames: rays and samples exact, the accumulation
within rtol 1e-4 / atol 1e-5 (the frame tolerance of
test_torch_slice.py; no knife edges on Cornell_Box), the displayed image
within one level of the JAX step's (which holds the JAX filter), and the
filter must change the image.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.ops import denoise as jdn
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.ops import denoise as dn
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

RTOL, ATOL = 1e-5, 1e-7
F_RTOL, F_ATOL = 1e-4, 1e-5
POSE = Camera().pose()


def _planes(seed=5, h=16, w=32):
    """Colour [3, h, w] in [0, 2) and a variance plane with a few negative
    entries (the raw variance can dip below 0 in f32)."""
    rng = np.random.default_rng(seed)
    color = 2.0 * rng.random((3, h, w), dtype=np.float32)
    var = (0.3 * rng.random((h, w)) - 0.01).astype(np.float32)
    return color, var


def _port(color, var):
    return V3(*torch.from_numpy(color)), torch.from_numpy(var)


def _close(got, want):
    np.testing.assert_allclose(np.stack([c.numpy() for c in got]),
                               np.stack([np.asarray(c) for c in want]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dy, dx", [(0, 0), (2, 0), (-4, 0), (0, 3),
                                    (4, -2), (-3, -1)])
def test_shift_matches_jax(dy, dx):
    color, _ = _planes()
    np.testing.assert_array_equal(dn._shift(torch.from_numpy(color[0]), dy,
                                            dx).numpy(),
                                  np.asarray(jdn._shift(color[0], dy, dx)))


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_atrous_pass_matches_jax(stride):
    color, var = _planes()
    var = np.maximum(var, 0.0)
    c, v = dn.atrous_pass(*_port(color, var), stride, 0.7)
    jc, jv = jdn.atrous_pass(JV3(*color), var, stride, 0.7)
    _close(c, jc)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_denoise_matches_jax(passes):
    color, var = _planes(seed=passes)
    got = dn.denoise(*_port(color, var), 1.5, passes)
    _close(got, jdn.denoise(JV3(*color), var, 1.5, passes))
    assert not np.array_equal(got[0].numpy(), color[0])


@pytest.mark.parametrize("strength, passes", [(0.0, 3), (-1.0, 2), (1.0, 0)])
def test_off_is_the_identity(strength, passes):
    color, var = _planes()
    acc = V3(*torch.from_numpy(color))
    samples = torch.full(var.shape, 8.0)
    for got in (dn.denoise(acc, torch.from_numpy(var), strength, passes),
                dn.denoise_acc(acc, torch.from_numpy(var), samples, 2,
                               strength, passes)):
        assert all(g is a for g, a in zip(got, acc))


@pytest.mark.parametrize("frame_number", [0, 3])
def test_denoise_acc_matches_jax(frame_number):
    """The variance of the accumulated mean: var / (samples * frames)."""
    color, var = _planes(seed=9)
    samples = np.random.default_rng(1).integers(
        0, 16, var.shape).astype(np.float32)
    got = dn.denoise_acc(*_port(color, var), torch.from_numpy(samples),
                         frame_number, 1.0, 3)
    want = jdn.denoise_acc(JV3(*color), var, samples, np.int32(frame_number),
                           1.0, 3)
    _close(got, want)


def test_render_step_with_denoise_matches_jax_step():
    kw = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
    jscene = jload_scene("Cornell_Box").with_overrides(**kw)
    scene = load_scene("Cornell_Box").with_overrides(**kw)
    jstep = j_make_step(jscene, full_color=True, backend="jnp", denoise=1.0)
    step = make_render_step(scene, device="cpu", denoise=1.0, denoise_passes=3)
    plain = make_render_step(scene, device="cpu")
    jstate, state = j_init_state(jscene), init_state(scene, "cpu")
    pstate = init_state(scene, "cpu")
    for f, seed in enumerate((21, 22, 23)):
        j = jax.device_get(jstep(jstate, POSE, np.uint32(seed), np.int32(f)))
        jstate = j.state
        out = step(state, POSE, seed, f)
        state = out.state
        ref = plain(pstate, POSE, seed, f)
        pstate = ref.state
        assert float(out.rays) == float(j.rays)
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        np.testing.assert_allclose(out.state.acc.numpy(), j.state.acc,
                                   rtol=F_RTOL, atol=F_ATOL)
        # The filter is display only: the accumulation is the unfiltered
        # step's, bit for bit, and the image is not.
        np.testing.assert_array_equal(out.state.acc.numpy(),
                                      ref.state.acc.numpy())
        assert not np.array_equal(out.rgb.numpy(), ref.rgb.numpy())
        assert np.abs(out.rgb.numpy().astype(int) - j.rgb).max() <= 1
