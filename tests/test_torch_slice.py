"""The port's whole main path against the JAX package's jnp oracle: the
plain whole-frame ``render_frame``, the render step (the sorted two-kernel
pipeline, here through the kernels' plain versions), state carry between
the packages, the blitter, the CLI, the port's own scene loader, and the
import boundary (no jax, nothing of the JAX package).

Decisions must agree exactly: owed rays and per-pixel sample counts.
Radiance agrees within rtol 1e-4 / atol 1e-5 except on knife-edge pixels
of scenes with SPHERE lights (demo, scene2): the reference casts a NEE
shadow ray from the normal-offset point but measures its length from the
surface point, which puts the light's own intersection within f32 noise of
the ray's t_max along a curve on the light (the JAX tracer's 'mis' notes
describe it). There an ulp of difference between XLA-CPU and PyTorch-CPU
(sin/cos/rsqrt rounding, XLA's multiply-add contraction) flips whether a
light sample self-shadows, so a few pixels gain or lose one NEE sample.
Those pixels are bounded in number; Cornell_Box (triangle lights) has
none. uint8 outputs agree except where a value straddles a quantisation
step, or on those same pixels.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu.models import Camera, list_scenes, load_scene
from terminal_raytracer_tpu.models.scene import Fog
from terminal_raytracer_tpu.runtime import blit as jblit
from terminal_raytracer_tpu.runtime import init_state as j_init_state
from terminal_raytracer_tpu.runtime import make_render_step as j_make_step
from terminal_raytracer_tpu_torch.cli import main as torch_main
from terminal_raytracer_tpu_torch.models import load_scene as tload_scene
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.runtime import (init_state,
                                                  make_render_step,
                                                  state_from_numpy,
                                                  state_to_numpy)
from terminal_raytracer_tpu_torch.runtime.blit import Blitter
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE = Camera().pose()
SEEDS = (1001, 1002, 1003)
RTOL, ATOL = 1e-4, 1e-5
# (scene, width, height, spp, depth, full_color, knife-edge bounds: (pixels
# off, their summed error) of the first frame and of the three-frame step:
# the count these seeds show on the CPU, the error rounded up to 3 digits)
CASES = [
    ("Cornell_Box", 128, 16, 16, 3, True, ((0, 0.0), (0, 0.0))),
    ("demo", 96, 16, 16, 4, False, ((4, 0.0561), (14, 0.296))),
    ("scene2", 96, 16, 32, 4, True, ((4, 0.00867), (12, 0.0344))),
]


def _scene(name, w, h, spp, depth):
    return load_scene(name).with_overrides(width=w, height=h,
                                           samples_per_pixel=spp,
                                           max_depth=depth)


def _outliers(got, want):
    """Boolean [H, W] mask of pixels outside rtol/atol in any channel."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    return bad.reshape(-1, *bad.shape[-2:]).any(0)


def _jax_frames(scene, full_color, n):
    step = j_make_step(scene, full_color=full_color, backend="jnp")
    state, outs = j_init_state(scene), []
    for f in range(n):
        out = step(state, POSE, np.uint32(SEEDS[f]), np.int32(f))
        state = out.state
        outs.append(jax.device_get(out))
    return outs


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, w, h, spp, depth, full_color, allow = request.param
    scene = _scene(name, w, h, spp, depth)
    return scene, full_color, allow, _jax_frames(scene, full_color, 3)


def test_render_frame_matches_jax_oracle(case):
    """The plain whole-frame render against the oracle's first frame
    (whose accumulation is that frame's radiance)."""
    scene, _fc, allow, jouts = case
    cur, var, total, rays, occ = PathTracer(scene, "cpu").render_frame(
        POSE, SEEDS[0], 0)
    j = jouts[0]
    assert float(rays) == float(j.rays)
    np.testing.assert_array_equal(total.numpy(), j.state.samples)
    KnifeEdges(RTOL, ATOL).add(np.stack([c.numpy() for c in cur]),
                               j.state.acc).check(allow[0])
    assert 0.0 < float(occ) <= 1.0


def test_render_step_matches_jax_step(case):
    """Three accumulated frames through the port's render step (the sorted
    pipeline) against the JAX jnp step, same seeds."""
    scene, full_color, allow, jouts = case
    step = make_render_step(scene, full_color=full_color, device="cpu")
    state = init_state(scene, "cpu")
    knife = KnifeEdges(RTOL, ATOL)
    for f, j in enumerate(jouts):
        out = step(state, POSE, SEEDS[f], f)
        state = out.state
        assert float(out.rays) == float(j.rays)
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        bad = _outliers(out.state.acc.numpy(), j.state.acc)
        knife.add(out.state.acc.numpy(), j.state.acc)
        # uint8: equal off the knife-edge pixels, up to one step of
        # truncation where a value straddles a quantisation boundary.
        for got, want in ((out.rgb.numpy(), j.rgb),
                          (out.glyphs.numpy(), j.glyphs)):
            diff = np.abs(got.astype(int) - want.astype(int))
            diff = diff.reshape(scene.height, scene.width, -1).max(-1)
            assert diff[~bad].max(initial=0) <= 1
            assert (diff[~bad] > 0).mean() < 0.01
    knife.check(allow[1])
    assert out.rgb.dtype == torch.uint8
    assert out.rgb.shape == (scene.height, scene.width, 3)
    if full_color:
        assert int(out.glyphs.max()) == 0
    else:
        assert int(out.glyphs.max()) > 0


def test_state_carries_between_packages():
    """A JAX FrameState after two frames continues in the port."""
    scene = _scene("Cornell_Box", 64, 16, 8, 3)
    jouts = _jax_frames(scene, True, 3)
    state = state_from_numpy(*jouts[1].state, device="cpu")
    out = make_render_step(scene, device="cpu")(state, POSE, SEEDS[2], 2)
    assert float(out.rays) == float(jouts[2].rays)
    np.testing.assert_allclose(out.state.acc.numpy(), jouts[2].state.acc,
                               rtol=RTOL, atol=ATOL)
    acc, var, samples = state_to_numpy(out.state)
    assert acc.dtype == np.float32 and acc.shape == (3, 16, 64)
    np.testing.assert_array_equal(samples, jouts[2].state.samples)


@pytest.mark.parametrize("full_color", [True, False])
def test_blitter_bytes_match_jax(full_color):
    rs = np.random.RandomState(3)
    rgb = rs.randint(0, 256, (9, 17, 3)).astype(np.uint8)
    glyphs = rs.randint(0, 80, (9, 17)).astype(np.uint8)  # incl. > 67
    want = jblit.Blitter(9, 17, full_color).encode(rgb, glyphs)
    assert Blitter(9, 17, full_color).encode(rgb, glyphs) == want
    assert Blitter(9, 17, full_color, force_python=True).encode(
        rgb, glyphs) == want


def _env():
    """This interpreter's environment with the repo importable and the
    child's CPU threads capped like this module's."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def test_headless_cli_runs_on_cpu():
    r = _run(["-m", "terminal_raytracer_tpu_torch", "--device", "cpu",
              "--scene", "Cornell_Box", "--width", "64", "--height", "16",
              "--spp", "4", "--depth", "3", "--frames", "2"])
    assert r.returncode == 0, r.stderr
    rows = r.stdout.splitlines()[1:]
    assert len(rows) == 16 and all(len(row) == 64 for row in rows)
    assert len(set("".join(rows))) > 4  # a picture, not a flat field


def test_port_never_imports_jax():
    """In a fresh interpreter (this test process has jax loaded already):
    import every port module and render frames through the CLI, static and
    animated, and under --accel grid and gathered. No jax module, and no
    module of the JAX package, may load."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import terminal_raytracer_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import terminal_raytracer_tpu_torch.cli as cli\n"
        "assert cli.main(['--device', 'cpu', '--width', '16', '--height',"
        " '4', '--spp', '4', '--depth', '2', '--frames', '1',"
        " '--full-color']) == 0\n"
        "assert cli.main(['--device', 'cpu', '--scene', 'stress:600:3',"
        " '--animate', 'orbit', '--width', '16', '--height', '4', '--spp',"
        " '8', '--depth', '2', '--frames', '2', '--full-color']) == 0\n"
        "assert cli.main(['--device', 'cpu', '--scene', 'bumpy', '--width',"
        " '16', '--height', '4', '--spp', '4', '--depth', '2', '--frames',"
        " '1', '--filter', 'bilinear']) == 0\n"
        "for accel in ('grid', 'gathered'):\n"
        "    assert cli.main(['--device', 'cpu', '--scene', 'stress:48:3',"
        " '--accel', accel, '--width', '16', '--height', '4', '--spp', '4',"
        " '--depth', '2', '--frames', '1']) == 0\n"
        "bad = [m for m in sys.modules if m.startswith('jax')\n"
        "       or m == 'terminal_raytracer_tpu'\n"
        "       or m.startswith('terminal_raytracer_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr


def _fields(obj):
    """A dataclass (nested) as plain Python values, field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_fields(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


@pytest.mark.parametrize("name", list_scenes() + ["stress:120:7",
                                                  "icosphere:1"])
def test_port_loads_scenes_as_the_jax_package_does(name):
    """The port's own copy of the models: primitives, materials, camera and
    settings equal the JAX package's, field by field."""
    got, want = _fields(tload_scene(name)), _fields(load_scene(name))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert tload_scene(name).primitive_count == load_scene(name).primitive_count


def test_cuda_device_without_gpu_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert torch_main(["--device", "cuda", "--frames", "1"]) != 0
    assert "CUDA" in capsys.readouterr().err


def test_unported_scene_features_are_refused(capsys, tmp_path):
    """Every scene feature of the JAX package is ported (fog and depth of
    field take the xt path, a fog JSON renders), and so is every traversal:
    --accel grid and gathered render, refusing nothing."""
    cornell = load_scene("Cornell_Box")
    assert PathTracer(cornell.with_overrides(aperture=0.1, focus_distance=3.0),
                      "cpu").xt
    assert PathTracer(cornell.with_overrides(fog=Fog(density=0.2)), "cpu").xt
    cfg = json.loads((Path(REPO) / "terminal_raytracer_tpu" / "models"
                      / "scenes" / "Cornell_Box.json").read_text())
    cfg["fog"] = {"density": 0.2}
    path = tmp_path / "foggy.json"
    path.write_text(json.dumps(cfg))
    assert torch_main(["--device", "cpu", "--path", str(path), "--width",
                       "16", "--height", "4", "--spp", "4", "--depth", "2",
                       "--frames", "1"]) == 0
    assert "does not support" not in capsys.readouterr().err
    for accel in ("grid", "gathered"):
        assert torch_main(["--device", "cpu", "--accel", accel, "--width",
                           "16", "--height", "4", "--spp", "4", "--depth",
                           "2", "--frames", "1"]) == 0
        assert "error" not in capsys.readouterr().err


def test_interactive_viewer_through_a_pty():
    """The pipelined viewer on the CPU: frames render, WASD/arrows reset
    accumulation, ESC exits and restores the terminal."""
    import fcntl
    import pty
    import select
    import struct
    import termios
    import time

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    proc = subprocess.Popen(
        [sys.executable, "-m", "terminal_raytracer_tpu_torch", "--device",
         "cpu", "--scene", "scene2", "--width", "40", "--height", "12",
         "--spp", "4", "--depth", "2", "--full-color"],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, cwd=REPO,
        env=_env())
    os.close(slave)
    buf = b""

    def read_until(pattern: bytes, timeout: float, start: int = 0) -> bool:
        nonlocal buf
        deadline = time.time() + timeout
        while time.time() < deadline:
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf += os.read(master, 65536)
                except OSError:
                    break
            if pattern in buf[start:]:
                return True
        return False

    try:
        assert read_until(b"Frame: 3/", 120), buf[-2000:].decode("utf-8", "replace")
        assert b"\x1b[38;2;" in buf  # truecolor cells
        mark = len(buf)
        # Move: accumulation restarts. The pipelined loop shows a frame one
        # dispatch late, so the first status after the reset reads 2.
        os.write(master, b"w")
        assert read_until(b"Frame: 2/", 60, mark), buf[-2000:].decode(
            "utf-8", "replace")
        os.write(master, b"\x1b[A")
        time.sleep(0.3)
        os.write(master, b"\x1b")  # ESC exits
        assert read_until(b"Exiting.", 60), buf[-2000:].decode("utf-8", "replace")
        assert b"\x1b[?25h" in buf  # cursor shown again
        proc.wait(timeout=30)
        assert proc.returncode == 0, proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
