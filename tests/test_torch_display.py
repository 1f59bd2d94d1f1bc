"""The port's display transforms and checkpoints against the JAX package,
on the CPU: ``ops/tonemap.py`` (parse_mode, the reference, aces and gamma
curves, exposure, the variance heat map), the render step's tonemap and
exposure, and ``utils/statefile.py`` (npz checkpoints that load in either
package).

The same numpy-seeded accumulations (24x12, exponential radiance with
black pixels) go through both tonemaps. Every u8 must be within one level
of the JAX package's, and no more values may differ than KNIFE (the count
these seeds show on the CPU: none; aces and gamma take pow with a Python
exponent, which torch and XLA-CPU may round an ulp apart, so a value on a
quantisation step could land one level off). The reference mode at
exposure 0 is torch.equal to the reference ops the port ran before the
display transforms (sqrt, pow(0.3), the Rec.709 luma).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera
from terminal_raytracer_tpu.models.camera import Camera as JCamera
from terminal_raytracer_tpu.ops import tonemap as jtm
from terminal_raytracer_tpu.ops.vecmath import V3 as JV3
from terminal_raytracer_tpu.runtime import FrameState as JFrameState
from terminal_raytracer_tpu.utils import statefile as jsf
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.models.camera import Camera as TCamera
from terminal_raytracer_tpu_torch.ops import tonemap as tm
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import (finalize, init_state,
                                                  make_render_step,
                                                  state_from_numpy,
                                                  state_to_numpy)
from terminal_raytracer_tpu_torch.utils import statefile as sf
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

H, W = 12, 24
SEEDS = (1, 2, 3)
MODES = ("reference", "aces", "gamma:2.2", "gamma:1.8")
EXPOSURES = (-1.0, 0.0, 1.5)
KNIFE = 0  # u8 values one level off JAX's, over the three seeds


def _acc(seed):
    """[3, H, W] f32 radiance, exponential (HDR tail), a black corner."""
    a = np.random.default_rng(seed).exponential(0.6, (3, H, W))
    a = a.astype(np.float32)
    a[:, 0, :4] = 0.0
    return a


GOOD_SPECS = ("reference", "aces", "ACES", " gamma:2.2 ", "gamma:1",
              ("gamma", 2.0), "Gamma:0.5")
BAD_SPECS = ("gamma:0", "gamma:-1", "gamma:x", "gamma:", "gamma:nan",
             "filmic", "", "reference:2")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_mode_accepts_the_jax_specs(spec):
    assert tm.parse_mode(spec) == jtm.parse_mode(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_mode_refuses_the_jax_bad_specs(spec):
    with pytest.raises(ValueError) as want:
        jtm.parse_mode(spec)
    with pytest.raises(ValueError) as got:
        tm.parse_mode(spec)
    assert str(got.value) == str(want.value)


def _port(acc, mode, scale, full_color):
    v = V3(*torch.from_numpy(acc))
    if full_color:
        return [tm.tonemap_fullcolor(v, tm.parse_mode(mode), scale).numpy()]
    return [t.numpy() for t in tm.tonemap_ascii(v, tm.parse_mode(mode),
                                                scale)]


def _jax(acc, mode, scale, full_color):
    v = JV3(*acc)
    if full_color:
        return [np.asarray(jtm.tonemap_fullcolor(v, jtm.parse_mode(mode),
                                                 scale))]
    return [np.asarray(t) for t in jtm.tonemap_ascii(
        v, jtm.parse_mode(mode), scale)]


@pytest.mark.parametrize("full_color", [True, False],
                         ids=["fullcolor", "ascii"])
@pytest.mark.parametrize("exposure", EXPOSURES)
@pytest.mark.parametrize("mode", MODES)
def test_tonemap_matches_jax(mode, exposure, full_color):
    """rgb (and in ASCII the glyph index from the tonemapped luma of the
    exposed colour) within one level of JAX's, at most KNIFE values off."""
    off = 0
    for seed in SEEDS:
        acc = _acc(seed)
        got = _port(acc, mode, 2.0 ** exposure, full_color)
        want = _jax(acc, mode, 2.0 ** exposure, full_color)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == w.shape
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, (mode, exposure, seed)
            off += int(np.count_nonzero(d))
    assert off <= KNIFE


def test_reference_mode_is_the_reference_ops():
    """The default mode and exposure run exactly the reference ops: sqrt
    (full colour), pow(0.3) and the Rec.709 luma's pow(0.3) * 67 (ASCII)."""
    acc = torch.from_numpy(_acc(1))
    v = V3(*acc)

    def q(x):
        return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)

    full = torch.stack([q(torch.sqrt(c)) for c in v], dim=-1)
    rgb = torch.stack([q(torch.pow(c, 0.3)) for c in v], dim=-1)
    luma = 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z
    idx = torch.clamp(torch.pow(luma, 0.3) * 67.0, max=67.0).to(torch.uint8)
    for args in ((), ("reference",), ("reference", 1.0),
                 ("reference", 2.0 ** 0.0)):
        assert torch.equal(tm.tonemap_fullcolor(v, *args), full)
        got_rgb, got_idx = tm.tonemap_ascii(v, *args)
        assert torch.equal(got_rgb, rgb) and torch.equal(got_idx, idx)


def test_exposure_scales_before_the_curve():
    """Exposure E is the curve of the radiance times 2**E (a multiply)."""
    acc = torch.from_numpy(_acc(2))
    for mode in ("aces", ("gamma", 2.2)):
        got = tm.tonemap_fullcolor(V3(*acc), mode, 2.0 ** 1.5)
        want = tm.tonemap_fullcolor(V3(*(acc * 2.0 ** 1.5)), mode, 1.0)
        assert torch.equal(got, want)


def test_variance_heatmap_matches_jax():
    var = np.random.default_rng(4).exponential(3.0, (H, W))
    var = var.astype(np.float32)
    var[0, :3] = (0.0, 10.0, 100.0)
    for scale in (10.0, 2.5):
        got = tm.variance_heatmap(torch.from_numpy(var), scale).numpy()
        want = np.asarray(jtm.variance_heatmap(var, scale))
        assert got.dtype == np.uint8 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny_scene():
    return load_scene("Cornell_Box").with_overrides(
        width=W, height=H, samples_per_pixel=4, max_depth=3)


@pytest.mark.parametrize("full_color", [True, False],
                         ids=["fullcolor", "ascii"])
def test_render_step_applies_the_display_transform(tiny_scene, full_color):
    """The step's image with tonemap / exposure is the display transform of
    its accumulation, and the accumulation is the default step's, bit for
    bit (display only)."""
    pose = Camera().pose()
    plain = make_render_step(tiny_scene, full_color, device="cpu")
    shown = make_render_step(tiny_scene, full_color, device="cpu",
                             tonemap="gamma:2.2", exposure=-1.0)
    s0, s1 = init_state(tiny_scene, "cpu"), init_state(tiny_scene, "cpu")
    for fn in range(2):
        a = plain(s0, pose, 7 + fn, fn)
        b = shown(s1, pose, 7 + fn, fn)
        s0, s1 = a.state, b.state
    assert torch.equal(s0.acc, s1.acc)
    want = (tm.tonemap_fullcolor(V3(*s1.acc), ("gamma", 2.2), 0.5)
            if full_color else
            tm.tonemap_ascii(V3(*s1.acc), ("gamma", 2.2), 0.5))
    if full_color:
        assert torch.equal(b.rgb, want)
        assert not torch.equal(a.rgb, b.rgb)
    else:
        assert torch.equal(b.rgb, want[0]) and torch.equal(b.glyphs, want[1])
    # The step's image is its finalize half on the same state.
    rgb, glyphs = shown.finalize(s1, 1)
    assert torch.equal(rgb, b.rgb) and torch.equal(glyphs, b.glyphs)
    rgb2, _ = finalize(s1, 1, full_color, mode=("gamma", 2.2), scale=0.5)
    assert torch.equal(rgb2, b.rgb)


def test_bad_tonemap_spec_fails_at_build(tiny_scene):
    with pytest.raises(ValueError, match="tonemap"):
        make_render_step(tiny_scene, device="cpu", tonemap="filmic")


def _state_arrays(seed=6):
    rng = np.random.default_rng(seed)
    return (rng.random((3, H, W), dtype=np.float32),
            rng.random((H, W), dtype=np.float32),
            rng.integers(4, 12, (H, W)).astype(np.float32))


def test_port_checkpoint_loads_in_jax(tmp_path):
    arrays = _state_arrays()
    cam = TCamera(position=np.array([0.5, 1.25, -2.0], np.float32),
                  yaw=-1.25, pitch=0.375)
    path = tmp_path / "port.npz"
    sf.save_state(path, state_from_numpy(*arrays, "cpu"), 9, cam)
    z = np.load(path)
    assert {k: (z[k].dtype, z[k].shape) for k in z.files} == {
        "acc": (np.float32, (3, H, W)), "variance": (np.float32, (H, W)),
        "samples": (np.float32, (H, W)), "frame_count": (np.int64, ()),
        "cam_position": (np.float32, (3,)), "cam_yaw": (np.float64, ()),
        "cam_pitch": (np.float64, ())}
    state, fc, jcam = jsf.load_state(path, expect_shape=(H, W))
    for got, want in zip(jax.device_get(tuple(state)), arrays):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert fc == 9
    np.testing.assert_array_equal(jcam.position, cam.position)
    assert (jcam.yaw, jcam.pitch) == (cam.yaw, cam.pitch)
    np.testing.assert_array_equal(jcam.pose(), cam.pose())


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    arrays = _state_arrays(8)
    cam = JCamera(position=np.array([-1.0, 0.25, 3.5], np.float32),
                  yaw=0.625, pitch=-0.125)
    path = tmp_path / "jax.npz"
    jsf.save_state(path, JFrameState(*(jax.numpy.asarray(a)
                                       for a in arrays)), 5, cam)
    state, fc, tcam = sf.load_state(path, expect_shape=(H, W))
    for got, want in zip(state_to_numpy(state), arrays):
        np.testing.assert_array_equal(got, want)
    assert all(t.dtype == torch.float32 for t in state)
    assert fc == 5
    np.testing.assert_array_equal(tcam.position, cam.position)
    assert (tcam.yaw, tcam.pitch) == (cam.yaw, cam.pitch)
    np.testing.assert_array_equal(tcam.pose(), cam.pose())


def test_checkpoint_of_another_shape_is_refused(tmp_path):
    """Both packages refuse a checkpoint whose resolution is not the
    scene's, with the same message."""
    path = tmp_path / "p.npz"
    sf.save_state(path, state_from_numpy(*_state_arrays(), "cpu"), 1,
                  TCamera())
    with pytest.raises(ValueError) as got:
        sf.load_state(path, expect_shape=(H, W + 1))
    with pytest.raises(ValueError) as want:
        jsf.load_state(path, expect_shape=(H, W + 1))
    assert str(got.value) == str(want.value)
    assert "24x12" in str(got.value) and "--width/--height" in str(got.value)
