"""The port's offline modes, headless runner, checkpoints and
frame-loop flags (runtime/offline.py, runtime/engine.py, cli.py) on the
CPU: against the port's own per-frame driving, bit for bit, and against
the JAX package.

Against per-frame driving on the same seeds (torch.equal, accumulation and
images): make_scan_renderer, make_chunk_renderer, make_orbit_scan_renderer,
render_accumulated, Engine.run_headless (one image, from the last frame),
--animate --scan, and a checkpoint run of 2 + 2 frames against 4 straight.

Against the JAX package: every seed stream of the CLI (per-frame, --scan,
--scan from a checkpoint, --turntable with and without --scan, --animate
--scan) and of render_accumulated, and the orbit's poses, exactly, with
the JAX renderers stood in for (no JAX compile); the until-noise stop (frames_done) at three
thresholds through one JAX compile (its chunk renderer, driven by the JAX
Engine); a --scan accumulation against JAX's make_scan_renderer (the
second JAX compile), bounded by KnifeEdges (Cornell_Box has none); and the
CLI's refusals, message for message.

The viewer's 'v', 'p' and --no-pipeline run through Engine.run_interactive
with a stand-in TerminalSession. Two gloo ranks run the CLI on a px:2 mesh
with the display transform, --until-noise and checkpoints.
"""

import contextlib
import io
import os
import time
from datetime import timedelta

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
tmp = pytest.importorskip("torch.multiprocessing")

import terminal_raytracer_tpu.cli as jcli
import terminal_raytracer_tpu.runtime.offline as joffline
from terminal_raytracer_tpu.models import load_scene as jload_scene
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime.engine import Engine as JEngine
from terminal_raytracer_tpu_torch import cli
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.ops import tonemap as tm
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import engine as engine_mod
from terminal_raytracer_tpu_torch.runtime import offline
from terminal_raytracer_tpu_torch.runtime import (init_state,
                                                  make_render_step)
from terminal_raytracer_tpu_torch.runtime.engine import Engine
from terminal_raytracer_tpu_torch.utils import imageio
from terminal_raytracer_tpu_torch.utils.statefile import load_state
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

W, H, SPP, DEPTH = 24, 12, 4, 3
SIZE = ["--width", str(W), "--height", str(H), "--spp", str(SPP), "--depth",
        str(DEPTH)]
PORT = ["--device", "cpu", "--scene", "Cornell_Box"] + SIZE
JAXA = ["--backend", "jnp", "--no-compile-cache", "--scene",
        "Cornell_Box"] + SIZE
POSE = Camera().pose()
KNIFE_SCAN = (0, 0.0)  # Cornell_Box: no knife-edge pixel (test_torch_slice)


def _scene(name="Cornell_Box"):
    return load_scene(name).with_overrides(width=W, height=H,
                                           samples_per_pixel=SPP,
                                           max_depth=DEPTH)


def _per_frame(step, scene, seeds, frame0=0, state=None):
    """The step once a frame: (last FrameOutput, summed rays)."""
    state = init_state(scene, "cpu") if state is None else state
    out, rays = None, 0.0
    for i, seed in enumerate(seeds):
        out = step(state, POSE, int(seed), frame0 + i)
        state = out.state
        rays += float(out.rays)
    return out, rays


def _equal(a, b):
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Against the port's own per-frame driving, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full_color", [True, False],
                         ids=["fullcolor", "ascii"])
def test_scan_and_chunk_renderers_equal_per_frame_driving(full_color):
    scene = _scene()
    opts = dict(full_color=full_color, device="cpu", tonemap="aces",
                exposure=0.5)
    seeds = [101, 202, 303, 404, 505]
    want, rays = _per_frame(make_render_step(scene, **opts), scene, seeds)

    state, rgb, glyphs, total = offline.make_scan_renderer(
        scene, 5, **opts)(init_state(scene, "cpu"), POSE, seeds)
    _equal(state.acc, want.state.acc)
    _equal(rgb, want.rgb)
    _equal(glyphs, want.glyphs)
    assert float(total) == rays

    # Chunks of 2 + 3 from a carried state: frame numbers continue.
    chunk2 = offline.make_chunk_renderer(scene, 2, **opts)
    chunk3 = offline.make_chunk_renderer(scene, 3, step=chunk2.step)
    out, r2 = chunk2(init_state(scene, "cpu"), POSE, seeds[:2], 0)
    out, r3 = chunk3(out.state, POSE, seeds[2:], 2)
    _equal(out.state.acc, want.state.acc)
    _equal(out.rgb, want.rgb)
    _equal(out.glyphs, want.glyphs)
    assert r2.shape == (2,) and r3.shape == (3,)
    assert float(out.rays) == float(want.rays) == float(r3[-1])
    assert float(r2.sum() + r3.sum()) == rays


def test_run_headless_chunks_equal_per_frame():
    """run_headless accumulates each frame and makes one image a call, from
    the last frame: bit-identical to the step with its image once a frame,
    in runs of 16 then 5 frames and with an explicit chunk (which only
    spaces the until-noise check)."""
    scene = _scene("scene2")
    opts = dict(full_color=False, device="cpu", deterministic=7,
                tonemap="gamma:2.2", exposure=-0.5)
    for chunk, lengths in (("auto", (16, 5)), (2, (5,))):
        eng = Engine(scene, **opts)
        images = []
        real = eng.step.finalize
        eng.step.finalize = lambda *a: (images.append(a[1]), real(*a))[1]
        for n in lengths:
            fetched = eng.run_headless(n, chunk=chunk)
        assert images == list(np.cumsum(lengths) - 1)
        ref = Engine(scene, **opts)
        for _ in range(sum(lengths)):
            out = ref.render_one(ref.frame_count)
        want = engine_mod._Fetch(out, False).wait()
        assert eng.frame_count == ref.frame_count == sum(lengths)
        _equal(eng.state.acc, ref.state.acc)
        np.testing.assert_array_equal(fetched[0], want[0])
        np.testing.assert_array_equal(fetched[1], want[1])
        assert fetched[2:] == want[2:4]


def test_run_headless_refusals_and_noise_stop():
    scene = _scene()
    eng = Engine(scene, device="cpu", deterministic=3, animate="bob")
    with pytest.raises(ValueError, match="animated"):
        eng.run_headless(2, until_noise=1.0)
    with pytest.raises(ValueError, match=">= 1"):
        eng.run_headless(0)
    eng = Engine(scene, device="cpu", deterministic=3)
    eng.run_headless(40, until_noise=1e9, chunk=4)
    assert eng.frame_count == 4  # stopped after the first chunk
    eng = Engine(scene, device="cpu", deterministic=3)
    eng.run_headless(3, until_noise=1e9)
    assert eng.frame_count == 1  # per frame
    eng.run_headless(3, until_noise=0.0)
    assert eng.frame_count == 4


def test_orbit_renderer_equals_fresh_per_pose_driving():
    """Each pose from a fresh state at frame numbers 0 ..: the images equal
    the step driven pose by pose, and no pose's image aliases another."""
    scene = _scene()
    cams = cli._orbit_poses(Camera(), scene, 3)
    poses = np.stack([c.pose() for c in cams])
    seeds = np.arange(6, dtype=np.uint32).reshape(3, 2) * 977 + 5
    rgbs, glyphs, rays = offline.make_orbit_scan_renderer(
        scene, 3, 2, full_color=False, device="cpu")(poses, seeds)
    step = make_render_step(scene, False, device="cpu")
    total = 0.0
    for k in range(3):
        state = init_state(scene, "cpu")
        for f in range(2):
            out = step(state, poses[k], int(seeds[k, f]), f)
            state = out.state
            total += float(out.rays)
        _equal(rgbs[k], out.rgb)
        _equal(glyphs[k], out.glyphs)
    assert float(rays) == total
    assert not torch.equal(rgbs[0], rgbs[1])


def test_animate_scan_equals_per_frame_dynamic_stepping(tmp_path):
    """--animate --scan writes the frames that an animated Engine renders
    one at a time on the same seed stream."""
    pattern = str(tmp_path / "anim.ppm")
    assert cli.main(PORT + ["--frames", "3", "--animate", "bob", "--scan",
                            "--deterministic", "4", "--dump-image", pattern,
                            "--full-color", "--tonemap", "aces"]) == 0
    eng = Engine(_scene(), full_color=True, device="cpu", deterministic=4,
                 animate="bob", tonemap="aces")
    for k in range(3):
        out = eng.render_one(0)
        got = imageio.read_ppm(str(tmp_path / f"anim_{k:03d}.ppm"))
        np.testing.assert_array_equal(got, out.rgb.numpy())
    assert eng.frame_count == 0 and eng._anim_t == 3


def test_checkpoint_two_plus_two_equals_four(tmp_path):
    """As tests/test_resume.py: 2 frames, a checkpoint, 2 more in a fresh
    engine whose seed stream is advanced to the same place, equal to 4
    straight; the first resumed frame blends (frame number 2), and the
    CLI continues the counter from the file."""
    from terminal_raytracer_tpu_torch.utils.statefile import save_state

    scene = _scene("scene2")
    eng = Engine(scene, full_color=True, device="cpu", deterministic=7)
    eng.run_headless(2)
    path = tmp_path / "ckpt.npz"
    save_state(path, eng.state, eng.frame_count, eng.camera)
    straight = eng.run_headless(2)

    eng2 = Engine(scene, full_color=True, device="cpu", deterministic=7)
    eng2.restore(*load_state(path, expect_shape=(H, W)))
    assert eng2.frame_count == 2
    for _ in range(eng2.frame_count):
        eng2._rng.randint(0, 2**32, dtype=np.uint64)
    resumed = eng2.run_headless(2)
    np.testing.assert_array_equal(resumed[0], straight[0])
    _equal(eng2.state.acc, eng.state.acc)
    assert eng2.frame_count == 4

    ck = str(tmp_path / "cli.npz")
    args = PORT + ["--deterministic", "1", "--full-color"]
    assert cli.main(args + ["--frames", "2", "--save-state", ck]) == 0
    assert cli.main(args + ["--frames", "2", "--load-state", ck,
                            "--save-state", ck, "--scan"]) == 0
    assert load_state(ck)[1] == 4


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _stub_renderers(monkeypatch, module, torch_out):
    """Stand-ins for the offline renderers of `module` (the port's or the
    JAX package's offline.py) that record what the CLI passes them."""
    got = {}

    def image(n=None):
        shape = (H, W, 3) if n is None else (n, H, W, 3)
        z = np.zeros(shape, np.uint8)
        return (torch.from_numpy(z), torch.from_numpy(z[..., 0])) \
            if torch_out else (z, z[..., 0])

    def scan(scene, n, *a, **k):
        def render(state, pose, seeds, frame0=0):
            got["scan"] = (np.asarray(seeds).copy(), int(frame0),
                           np.asarray(pose).copy())
            return (state, *image(), 0.0)
        return render

    def noise(scene, n, thr, *a, **k):
        def render(state, pose, seeds, frame0=0):
            got["noise"] = (np.asarray(seeds).copy(), int(frame0), thr)
            return (state, *image(), 0.0, n)
        return render

    def orbit(scene, n, f, *a, **k):
        def render(poses, seeds):
            got["orbit"] = (np.asarray(poses).copy(),
                            np.asarray(seeds).copy())
            return (*image(n), 0.0)
        return render

    def anim(scene, n, *a, **k):
        def render(pose, arrays_seq, seeds):
            got["anim"] = (np.asarray(seeds).copy(),
                           {key: np.asarray(v).copy()
                            for key, v in arrays_seq.items()})
            return (*image(n), 0.0)
        return render

    for name, fn in (("make_scan_renderer", scan),
                     ("make_noise_scan_renderer", noise),
                     ("make_orbit_scan_renderer", orbit),
                     ("make_animation_scan_renderer", anim)):
        monkeypatch.setattr(module, name, fn)
    return got


def _quiet(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        return fn(*a)


def test_seed_streams_and_orbit_poses_equal_jax(monkeypatch, tmp_path):
    """Every seed array of the CLI's modes, and the orbit's poses, equal
    the JAX CLI's, with the renderers stood in for on both sides."""
    monkeypatch.chdir(tmp_path)
    mine = _stub_renderers(monkeypatch, offline, True)
    theirs = _stub_renderers(monkeypatch, joffline, False)
    ck = str(tmp_path / "ck.npz")
    runs = [["--frames", "6", "--scan"],
            ["--frames", "6", "--scan", "--until-noise", "0.25"],
            ["--frames", "3", "--turntable", "4", "--scan", "--dump-image",
             "t.png"],
            ["--frames", "5", "--animate", "orbit", "--scan", "--dump-image",
             "a_%d.ppm"]]
    for run in runs:
        args = run + ["--deterministic", "11", "--full-color"]
        assert _quiet(cli.main, PORT + args) == 0
        assert _quiet(jcli.main, JAXA + args) == 0
    # --scan resumed from a checkpoint: seeds offset by its frame_count.
    assert _quiet(cli.main, PORT + ["--frames", "3", "--save-state", ck,
                                    "--deterministic", "2"]) == 0
    for main, base, got in ((cli.main, PORT, mine),
                            (jcli.main, JAXA, theirs)):
        first = got.pop("scan")
        assert _quiet(main, base + ["--frames", "4", "--scan", "--load-state",
                                    ck, "--deterministic", "5"]) == 0
        got["resumed"], got["scan"] = got["scan"], first
    assert sorted(mine) == sorted(theirs) == ["anim", "noise", "orbit",
                                              "resumed", "scan"]
    assert mine["resumed"][1] == theirs["resumed"][1] == 3
    assert mine["scan"][1] == 0 and len(mine["scan"][0]) == 6
    for key in mine:
        for a, b in zip(mine[key], theirs[key]):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)
    assert mine["orbit"][0].shape == (4, 16)
    assert mine["orbit"][1].shape == (4, 3)


def test_per_frame_seed_streams_equal_jax(monkeypatch, tmp_path):
    """Engine._seed (per frame, and the headless runner) and --turntable
    without --scan (frame_count reset a pose, the stream carried on): the
    seed, frame number and pose of every frame equal the JAX package's
    (its chunk renderer stood in for)."""
    monkeypatch.chdir(tmp_path)
    seen = {"port": [], "jax": []}
    real = engine_mod.make_render_step

    def port_step(scene, **kw):
        step = real(scene, **kw)
        accumulate = step.accumulate

        def recorded(state, pose, seed, fn, *a):
            seen["port"].append((int(seed), int(fn), np.asarray(pose).copy()))
            return accumulate(state, pose, seed, fn, *a)
        step.accumulate = recorded
        return step

    def jax_chunk(scene, k, **kw):
        from terminal_raytracer_tpu.runtime.state import FrameOutput

        def chunk(state, pose, seeds, frame0=0):
            for i, seed in enumerate(seeds):
                seen["jax"].append((int(seed), int(frame0) + i,
                                    np.asarray(pose).copy()))
            z = np.zeros((H, W, 3), np.uint8)
            return FrameOutput(state, z, z[..., 0], np.float32(0.0),
                               np.float32(1.0)), np.zeros(k, np.float32)
        return chunk

    monkeypatch.setattr(engine_mod, "make_render_step", port_step)
    monkeypatch.setattr(joffline, "make_chunk_renderer", jax_chunk)
    args = ["--frames", "11", "--turntable", "2", "--dump-image", "o.png",
            "--deterministic", "9", "--full-color"]
    assert _quiet(cli.main, PORT + args) == 0
    assert _quiet(jcli.main, JAXA + args) == 0
    assert len(seen["port"]) == len(seen["jax"]) == 22  # 11 frames a pose
    for (s, f, p), (js, jf, jp) in zip(seen["port"], seen["jax"]):
        assert (s, f) == (js, jf)
        np.testing.assert_array_equal(p, jp)
    # Per frame: the draws of Engine._seed.
    mine = Engine(_scene(), device="cpu", deterministic=13)
    theirs = JEngine(jload_scene("Cornell_Box").with_overrides(
        width=W, height=H), backend="jnp", deterministic=13)
    for fc in (0, 1, 2, 2**32 - 1, 0, 5):
        mine.frame_count = theirs.frame_count = fc
        assert mine._seed() == int(theirs._seed())


def test_render_accumulated_seeds_equal_jax(monkeypatch):
    """render_accumulated draws the seeds the JAX package's does (both
    scan renderers stood in for), and renders them as the scan does."""
    scene = _scene()
    state, rgb, glyphs, rays = offline.render_accumulated(
        scene, POSE, 3, seed=12, device="cpu")
    real_scan = offline.make_scan_renderer
    mine = _stub_renderers(monkeypatch, offline, True)
    theirs = _stub_renderers(monkeypatch, joffline, False)
    offline.render_accumulated(scene, POSE, 3, seed=12, device="cpu")
    joffline.render_accumulated(jload_scene("Cornell_Box").with_overrides(
        width=W, height=H), POSE, 3, seed=12, backend="jnp")
    seeds = mine["scan"][0]
    np.testing.assert_array_equal(seeds, theirs["scan"][0])
    assert seeds.dtype == np.uint32 and len(set(seeds.tolist())) == 3
    st, want_rgb, want_glyphs, want_rays = real_scan(scene, 3, device="cpu")(
        init_state(scene, "cpu"), POSE, seeds)
    _equal(state.acc, st.acc)
    np.testing.assert_array_equal(rgb, want_rgb.numpy())
    np.testing.assert_array_equal(glyphs, want_glyphs.numpy())
    assert isinstance(rays, float) and rays == float(want_rays)


@pytest.fixture(scope="module")
def jax_chunk_engine_stops():
    """The JAX Engine's frames rendered under until_noise at chunks of 2 of
    at most 8 (one JAX compile: its chunk renderer), at three thresholds;
    and the port's noise estimate at each chunk boundary."""
    jscene = jload_scene("Cornell_Box").with_overrides(
        width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH)
    scene = _scene()
    # The port's estimate after 1, 2, 3 chunks of 2 on one seed stream.
    eng = Engine(scene, device="cpu", deterministic=21)
    est = []
    for _ in range(3):
        eng.run_headless(2, chunk=2)
        est.append(eng._noise_estimate(eng.state))
    mid = float(np.sqrt(est[1] * est[2]))  # stops after the third chunk
    margin = min(est[1] / mid, mid / est[2])
    print(f"until-noise threshold {mid:.6g} between the estimates "
          f"{est[1]:.6g} (2 chunks) and {est[2]:.6g} (3 chunks): margin "
          f"x{margin:.3f}")
    assert margin > 1.1
    stops = {}
    j = JEngine(jscene, full_color=True, backend="jnp")
    for thr in (1e9, 0.0, mid):
        # One engine, so that its chunk renderer compiles once.
        j.state, j.frame_count = j_init_state(jscene), 0
        j._rng = np.random.RandomState(21)
        j.run_headless(8, until_noise=thr, chunk=2)
        stops[thr] = j.frame_count
    return stops


def test_noise_scan_frames_done_equals_jax(jax_chunk_engine_stops):
    """make_noise_scan_renderer's frames_done at a huge threshold (the
    first chunk), 0 (the cap) and one between two chunk boundaries equals
    the JAX package's; at 0 it is the plain scan, bit for bit."""
    scene = _scene()
    rng = np.random.RandomState(21)
    seeds = [int((rng.randint(0, 2**32, dtype=np.uint64) + f) & 0xFFFFFFFF)
             for f in range(8)]
    assert sorted(jax_chunk_engine_stops.values()) == [2, 6, 8]
    for thr, want in jax_chunk_engine_stops.items():
        render = offline.make_noise_scan_renderer(scene, 8, thr, chunk=2,
                                                  full_color=True,
                                                  device="cpu")
        got = render(init_state(scene, "cpu"), POSE, seeds)
        assert got[-1] == want, thr
        if thr == 0.0:
            state, rgb, _, rays, _ = got
    st, rgb_s, _, rays_s = offline.make_scan_renderer(
        scene, 8, device="cpu")(init_state(scene, "cpu"), POSE, seeds)
    _equal(state.acc, st.acc)
    _equal(rgb, rgb_s)
    assert float(rays) == float(rays_s)
    # A chunk that does not divide the cap halves until it does (8 -> 1).
    render = offline.make_noise_scan_renderer(scene, 7, 0.0, chunk=8,
                                              device="cpu")
    assert render(init_state(scene, "cpu"), POSE, seeds[:7])[-1] == 7


def test_scan_state_matches_jax_scan(tmp_path):
    """cli --scan's checkpoint against the JAX make_scan_renderer state on
    the same seeds: KnifeEdges (none on Cornell_Box); samples exact."""
    ck = str(tmp_path / "s.npz")
    assert _quiet(cli.main, PORT + ["--frames", "4", "--scan",
                                    "--deterministic", "8", "--save-state",
                                    ck]) == 0
    rng = np.random.RandomState(8)
    seeds = (rng.randint(0, 2**32, size=4, dtype=np.uint64)
             + np.arange(4, dtype=np.uint64)).astype(np.uint32)
    jscene = jload_scene("Cornell_Box").with_overrides(
        width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH)
    state, _rgb, _g, _rays = joffline.make_scan_renderer(
        jscene, 4, full_color=False, backend="jnp")(
        j_init_state(jscene), POSE, jax.numpy.asarray(seeds))
    got, fc, _ = load_state(ck)
    assert fc == 4
    want = jax.device_get(state)
    np.testing.assert_array_equal(got.samples.numpy(), want.samples)
    KnifeEdges().add(got.acc.numpy(), want.acc).check(KNIFE_SCAN)


ERRORS = [
    ["--frames", "0"],
    ["--mis", "--unbiased", "--frames", "1"],
    ["--turntable", "2"],
    ["--frames", "1", "--animate", "orbit", "--turntable", "2"],
    ["--frames", "1", "--animate", "orbit", "--scan"],
    ["--frames", "2", "--animate", "orbit", "--until-noise", "0.5"],
    ["--frames", "2", "--turntable", "2", "--scan", "--until-noise", "0.5",
     "--dump-image", "x.png"],
    ["--frames", "1", "--turntable", "0", "--dump-image", "x.png"],
    ["--frames", "1", "--turntable", "2"],
    ["--frames", "1", "--turntable", "2", "--dump-image", "100%.png"],
    ["--frames", "1", "--animate", "bob", "--scan", "--dump-image",
     "a%.png"],
    ["--frames", "1", "--load-state", "missing.npz"],
]


@pytest.mark.parametrize("argv", ERRORS, ids=lambda a: " ".join(a))
def test_cli_errors_equal_jax(argv, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert cli.main(PORT + argv) == 2
    mine = capsys.readouterr().err
    assert jcli.main(JAXA + argv) == 2
    theirs = capsys.readouterr().err
    assert mine == theirs and mine.startswith("error: ")


def test_cli_refusals_of_bad_values(capsys, tmp_path):
    """Flag values refused by the parser (exit 2), and a checkpoint of
    another size (the load-state error)."""
    for argv in (["--tonemap", "filmic"], ["--tonemap", "gamma:0"],
                 ["--exposure", "x"], ["--turntable", "y"]):
        with pytest.raises(SystemExit) as e:
            cli.main(PORT + argv)
        assert e.value.code == 2
    assert "--tonemap" in capsys.readouterr().err
    ck = str(tmp_path / "c.npz")
    assert cli.main(PORT + ["--frames", "1", "--save-state", ck]) == 0
    capsys.readouterr()
    assert cli.main(PORT[:-8] + ["--width", "16", "--height", "8",
                                 "--frames", "1", "--load-state", ck]) == 2
    assert "holds a 24x12 accumulation but the scene renders 16x8" in (
        capsys.readouterr().err)


def test_cli_flags_render(tmp_path, capsys):
    """Each new flag through cli.main: the display transform, the seed,
    the frame-loop flags, the image, the checkpoints, the offline modes;
    --profile writes a trace."""
    d = str(tmp_path)
    base = PORT + ["--deterministic", "3", "--no-pipeline", "--no-clamp"]
    assert cli.main(base + ["--frames", "2", "--tonemap", "gamma:2.2",
                            "--exposure", "1.5", "--dump-image",
                            f"{d}/a.ppm", "--save-state", f"{d}/s.npz",
                            "--profile", f"{d}/prof", "--verbose"]) == 0
    out = capsys.readouterr()
    assert f"wrote {d}/a.ppm" in out.out and "saved state" in out.out
    assert "[headless] 2 frames" in out.err
    assert os.path.getsize(f"{d}/prof/trace_rank0.json") > 0
    img = imageio.read_ppm(f"{d}/a.ppm")
    state, fc, _ = load_state(f"{d}/s.npz")
    want = tm.tonemap_ascii(V3(*state.acc), ("gamma", 2.2), 2.0 ** 1.5)[0]
    np.testing.assert_array_equal(img, want.numpy())
    assert cli.main(base + ["--frames", "2", "--load-state", f"{d}/s.npz",
                            "--until-noise", "1e9", "--verbose"]) == 0
    assert "[headless] 3 frames" in capsys.readouterr().err
    assert cli.main(base + ["--frames", "2", "--turntable", "2",
                            "--dump-image", f"{d}/t.png"]) == 0
    assert "wrote 2 frames" in capsys.readouterr().out
    a, b = (imageio.read_png(f"{d}/t_{k:03d}.png") for k in range(2))
    assert a.shape == (H, W, 3) and not np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The viewer
# ---------------------------------------------------------------------------


class _Term:
    """A stand-in TerminalSession: returns the scripted keys, one a poll
    after `lead` empty polls, and keeps the frames written."""

    def __init__(self, keys, lead=3):
        self.keys = [None] * lead + list(keys)
        self.frames = []

    def __call__(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll_key(self, timeout=0.001):
        return self.keys.pop(0) if self.keys else "esc"

    def write_frame(self, payload, status, height):
        self.frames.append((payload, status))


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["no-pipeline", "pipeline"])
def test_viewer_v_and_p_keys(pipeline, monkeypatch, tmp_path):
    """'v' shows the variance heat map (truecolor blocks of
    tonemap.variance_heatmap), 'p' writes screenshot_0.png: the display
    transform of the accumulation, in full colour. Synchronous, every
    rendered frame is shown; pipelined, all but the last."""
    monkeypatch.chdir(tmp_path)
    term = _Term([None, "v", None, "p", None, None])
    monkeypatch.setattr(engine_mod, "TerminalSession", term)
    scene = _scene()
    eng = Engine(scene, full_color=False, device="cpu", deterministic=5,
                 pipeline=pipeline, tonemap="aces", exposure=0.5)
    shown = []
    real = eng._display
    monkeypatch.setattr(eng, "_display", lambda t, f, heatmap=False: (
        shown.append((f, heatmap)), real(t, f, heatmap)))
    _quiet(eng.run_interactive)
    n = eng.frame_count
    assert n == 9 and len(term.frames) == (n if not pipeline else n - 1)
    heat = [h for _, h in shown]
    assert heat[0] is False and heat[-1] is True and heat.index(True) <= 6
    rgb, glyphs = shown[-1][0][:2]
    assert glyphs is None and rgb.shape == (H, W, 3)
    want = tm.variance_heatmap(eng.state.variance).numpy()
    if not pipeline:
        np.testing.assert_array_equal(rgb, want)
        assert term.frames[-1][0] == eng._fc_blitter.encode(want, None)
    shot = imageio.read_png(str(tmp_path / "screenshot_0.png"))
    assert shot.shape == (H, W, 3) and shot.any()
    assert eng._shot_idx == 1


def test_screenshot_is_the_tonemapped_accumulation(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    eng = Engine(_scene(), full_color=False, device="cpu", deterministic=5,
                 tonemap="gamma:1.8", exposure=-1.0)
    eng.run_headless(3)
    eng._screenshot()
    want = tm.tonemap_fullcolor(V3(*eng.state.acc), ("gamma", 1.8), 0.5)
    np.testing.assert_array_equal(imageio.read_png("screenshot_0.png"),
                                  want.numpy())


# ---------------------------------------------------------------------------
# On a mesh: two gloo ranks
# ---------------------------------------------------------------------------

MESH_ARGS = ["--scene", "scene2", "--device", "cpu", "--width", "16",
             "--height", "8", "--spp", "4", "--depth", "2", "--deterministic",
             "6", "--full-color", "--tonemap", "aces", "--exposure", "1"]
DEADLINE = 240


def _mesh_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from terminal_raytracer_tpu_torch import cli as pcli

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        d = out_dir
        rcs = [pcli.main(MESH_ARGS + [
            "--shard", "px:2", "--frames", "3", "--dump-image",
            f"{d}/m.ppm", "--save-state", f"{d}/m.npz"]),
            pcli.main(MESH_ARGS + [
                "--shard", "px:2", "--frames", "4", "--load-state",
                f"{d}/m.npz", "--until-noise", "1e9", "--save-state",
                f"{d}/m2.npz"])]
        for flag in ("--scan", "--turntable=2"):
            rcs.append(pcli.main(MESH_ARGS + ["--shard", "px:2", "--frames",
                                              "1", flag]))
        with open(os.path.join(d, f"rcs-{rank}.txt"), "w") as f:
            f.write(" ".join(map(str, rcs)))
    finally:
        dist.destroy_process_group()


def test_cli_on_a_mesh_equals_one_device(tmp_path):
    """px:2 over two gloo ranks: the --tonemap aces --exposure 1 image and
    the gathered checkpoint equal one device's, bit for bit (row blocks
    tile the frame); --load-state splits the checkpoint into row blocks and
    --until-noise stops on the summed estimate (one frame at 1e9); --scan
    and --turntable are refused."""
    d = str(tmp_path)
    ctx = tmp.start_processes(_mesh_rank, args=(2, f"{d}/store", d),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"mesh ranks still running after {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for r in range(2):
        assert open(f"{d}/rcs-{r}.txt").read() == "0 0 2 2"
    one = MESH_ARGS + ["--frames", "3"]
    assert _quiet(cli.main, one + ["--dump-image", f"{d}/o.ppm",
                                   "--save-state", f"{d}/o.npz"]) == 0
    np.testing.assert_array_equal(imageio.read_ppm(f"{d}/m.ppm"),
                                  imageio.read_ppm(f"{d}/o.ppm"))
    (ms, mfc, _), (os_, ofc, _) = load_state(f"{d}/m.npz"), load_state(
        f"{d}/o.npz")
    assert mfc == ofc == 3
    for a, b in zip(ms, os_):
        _equal(a, b)
    assert _quiet(cli.main, MESH_ARGS + [
        "--frames", "4", "--load-state", f"{d}/o.npz", "--until-noise",
        "1e9", "--save-state", f"{d}/o2.npz"]) == 0
    (m2, m2fc, _), (o2, o2fc, _) = load_state(f"{d}/m2.npz"), load_state(
        f"{d}/o2.npz")
    assert m2fc == o2fc == 4
    for a, b in zip(m2, o2):
        _equal(a, b)
