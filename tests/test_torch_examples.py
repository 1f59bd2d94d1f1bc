"""The port's examples (examples_torch/) against the JAX package's
(examples/) and against the port's own step, on the CPU.

(a) Each port example, run through its main() with --device cpu, drives
    the render as the JAX example does: the JAX examples render at module
    level, so both run with the package's render step, state, mesh and PNG
    writer stood in for by recorders (no JAX compile, no render); the
    scene field by field, the step's flags, every frame's pose, seed and
    frame number, the animator's arrays and the PNG files must be equal.
(b) The two scenes built in code (custom_scene, glass), cut to 32x16 at
    depth 4 and their own spp, render through the example's own frame loop
    on the CPU and through the JAX jnp step on the same seeds: rays and
    per-pixel sample counts exactly equal, the accumulation bounded by
    KnifeEdges (both scenes are lit by spheres).
(c) render_png's and animate's PNGs equal the port's step driven directly,
    bit for bit, and read back at the scene's shape.
(d) multichip over two gloo ranks: rank 0's gathered image equals the
    one-device step's, bit for bit.
(e) --device cuda without a GPU exits nonzero.
"""

import contextlib
import importlib.util
import io
import os
import runpy
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import terminal_raytracer_tpu.parallel as jparallel
import terminal_raytracer_tpu.runtime as jruntime
from terminal_raytracer_tpu.runtime.state import init_state as j_init_state
from terminal_raytracer_tpu.runtime.state import make_render_step as j_make_step
from terminal_raytracer_tpu.utils import imageio as jimageio
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.ops.dynamic import pack_scene
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.utils import imageio
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_slice import _fields  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

torch.set_num_threads(2)
warm_vml()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("render_png", "custom_scene", "animate", "glass", "multichip")
# Each example's arguments, the JAX one's and the port's (+ --device cpu);
# {d} is a temporary directory.
ARGS = {"render_png": ["{d}/out.png"], "custom_scene": [],
        "animate": ["{d}/anim", "3"], "glass": ["{d}/glass.png"],
        "multichip": []}
# (b): the cut, and the knife-edge bounds of its two frames (pixels off,
# their summed error: the largest these seeds show on the CPU, rounded up).
CUT = dict(width=32, height=16, max_depth=4)
CUT_FRAMES = 2
KNIFE = {"custom_scene": (0, 0.0), "glass": (0, 0.0)}


def _load(name):
    """The port example `name` as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(REPO, "examples_torch",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a):
    """fn(*a) with stdout and stderr kept: (result, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*a)
    return res, out.getvalue(), err.getvalue()


class Recorder:
    """Stand-ins for a package's render step, frame state, mesh, sharded
    step and PNG writer, recording what an example passes them. `image`
    makes an output plane of a shape: numpy for the JAX examples, torch
    for the port's."""

    def __init__(self, image):
        self.image = image
        self.steps, self.calls, self.pngs, self.meshes = [], [], [], []

    def _step(self, scene):
        h, w = scene.height, scene.width

        def step(state, pose, seed, frame_number, arrays=None):
            self.calls.append((
                np.array(pose, np.float32), int(seed), int(frame_number),
                None if arrays is None
                else {k: np.array(v) for k, v in arrays.items()}))
            return SimpleNamespace(state=state,
                                   rgb=self.image((h, w, 3)),
                                   glyphs=self.image((h, w)),
                                   rays=torch.tensor(1.0, dtype=torch.float64))
        return step

    def make_render_step(self, scene, *a, **kw):
        self.steps.append((scene, kw))
        return self._step(scene)

    @staticmethod
    def _state():
        return SimpleNamespace(samples=torch.zeros(1))

    def init_state(self, scene, *a):
        return self._state()

    def make_sharded_render_step(self, scene, mesh, *a, **kw):
        self.steps.append((scene, kw))
        return self._step(scene), self._state

    def write_png(self, path, rgb):
        self.pngs.append((os.path.basename(path), np.asarray(rgb).shape))


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{name: (the JAX example's Recorder, the port example's)}, each run
    with the package's render stood in for."""
    got = {}
    for name in EXAMPLES:
        d = str(tmp_path_factory.mktemp(name))
        args = [a.format(d=d) for a in ARGS[name]]
        jrec = Recorder(lambda shape: np.zeros(shape, np.uint8))
        prec = Recorder(lambda shape: torch.zeros(shape, dtype=torch.uint8))
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            for attr in ("make_render_step", "init_state"):
                mp.setattr(jruntime, attr, getattr(jrec, attr))
            mp.setattr(jimageio, "write_png", jrec.write_png)
            mp.setattr(imageio, "write_png", prec.write_png)
            mp.setattr(jparallel, "make_sharded_render_step",
                       jrec.make_sharded_render_step)

            def jmesh(**kw):
                jrec.meshes.append(kw)
                return SimpleNamespace(shape={"px": kw["n_px"],
                                              "sp": kw["n_sp"]})

            mp.setattr(jparallel, "make_mesh", jmesh)
            path = os.path.join(REPO, "examples", f"{name}.py")
            mp.setattr(sys, "argv", [path] + args)
            _quiet(runpy.run_path, path, None, "__main__")

            mod = _load(name)
            for attr in ("make_render_step", "init_state",
                         "make_sharded_render_step"):
                if hasattr(mod, attr):
                    mp.setattr(mod, attr, getattr(prec, attr))
            if hasattr(mod, "make_mesh"):
                def pmesh(n_px, n_sp, device):
                    prec.meshes.append(dict(n_px=n_px, n_sp=n_sp,
                                            device=device))
                    return SimpleNamespace(n_px=n_px, n_sp=n_sp, px_i=0,
                                           sp_i=0)
                mp.setattr(mod, "make_mesh", pmesh)
            rc, out, err = _quiet(mod.main, args + ["--device", "cpu"])
            assert rc == 0, err
        got[name] = jrec, prec, out
    return got


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_drives_the_render_as_the_jax_example_does(recorded, name):
    """The scene field by field, the step's flags, each frame's pose, seed,
    frame number and (animate) arrays, and the PNGs written."""
    jrec, prec, _ = recorded[name]
    assert len(jrec.steps) == len(prec.steps) == 1
    (jscene, jkw), (pscene, pkw) = jrec.steps[0], prec.steps[0]
    want, got = _fields(jscene), _fields(pscene)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    for flag, default in (("full_color", True), ("dynamic", False)):
        assert pkw.get(flag, default) == jkw.get(flag, default), flag
    if name != "multichip":
        assert pkw["device"] == "cpu"
    assert len(jrec.calls) == len(prec.calls) > 0
    for (jp, js, jf, ja), (pp, ps, pf, pa) in zip(jrec.calls, prec.calls):
        np.testing.assert_array_equal(pp, jp)
        assert (ps, pf) == (js, jf)
        assert (pa is None) == (ja is None)
        if ja is not None:
            assert pa.keys() == ja.keys()
            for k in ja:
                np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    assert prec.pngs == jrec.pngs


def test_multichip_mesh_is_the_jax_examples_where_the_world_divides(
        recorded):
    """The JAX example takes px over the test's 8 CPU devices; the port's
    mesh_shape gives it for a world of 8, and px:1,sp:1 for the one rank
    it started itself (printed by rank 0 with the gathered image)."""
    jrec, prec, out = recorded["multichip"]
    mod = _load("multichip")
    (jm,), (pm,) = jrec.meshes, prec.meshes
    h = jrec.steps[0][0].height
    assert mod.mesh_shape(h, len(jax.devices())) == (jm["n_px"], jm["n_sp"])
    assert (pm["n_px"], pm["n_sp"], pm["device"]) == (1, 1, "cpu")
    assert "1 ranks, mesh px:1,sp:1" in out and "sha256" in out
    # Where the JAX example would leave devices idle, the port splits
    # samples: scene2's 100 rows on 8 ranks.
    assert mod.mesh_shape(100, 8) == (4, 2)


@pytest.mark.parametrize("name", ["custom_scene", "glass"])
def test_scene_built_in_code_renders_as_the_jax_step(recorded, name):
    """The example's scene, cut, through its own frame loop on the CPU
    against the JAX jnp step on the example's seeds."""
    jrec, _, _ = recorded[name]
    mod = _load(name)
    scene = mod.build_scene("cpu").with_overrides(**CUT)
    jscene = jrec.steps[0][0].with_overrides(**CUT)
    full_color = jrec.steps[0][1]["full_color"]
    jstep = j_make_step(jscene, full_color=full_color, backend="jnp")
    jstate = j_init_state(jscene)
    knife = KnifeEdges()
    n = 0
    for out, (pose, seed, frame, _) in zip(
            mod.frames(scene, CUT_FRAMES, "cpu"), jrec.calls):
        j = jax.device_get(jstep(jstate, pose, np.uint32(seed),
                                 np.int32(frame)))
        jstate = j.state
        assert float(out.rays) == float(j.rays)
        np.testing.assert_array_equal(out.state.samples.numpy(),
                                      j.state.samples)
        knife.add(out.state.acc.numpy(), j.state.acc)
        n += 1
    assert n == CUT_FRAMES
    knife.check(KNIFE[name])


def test_render_png_writes_the_steps_image(tmp_path):
    """render_png at the CPU cut, 2 frames: the PNG is the last frame of
    the port's step driven directly, bit for bit."""
    mod = _load("render_png")
    path = str(tmp_path / "o.png")
    rc, out, _ = _quiet(mod.main, [path, "scene2", "2", "--device", "cpu"])
    assert rc == 0 and "wrote" in out
    scene = load_scene("scene2").with_overrides(
        width=120, height=60, samples_per_pixel=8, max_depth=4)
    step = make_render_step(scene, full_color=True, device="cpu")
    state = init_state(scene, "cpu")
    for f in range(2):
        o = step(state, Camera().pose(), 1 + f, f)
        state = o.state
    img = imageio.read_png(path)
    assert img.shape == (60, 120, 3)
    np.testing.assert_array_equal(img, o.rgb.numpy())
    assert img.max() > img.min()


def test_animate_writes_the_steps_frames(tmp_path):
    """animate at the CPU cut, 2 frames: each PNG is the port's dynamic
    step's image on the orbit's arrays, bit for bit, and the frames
    differ."""
    mod = _load("animate")
    d = tmp_path / "anim"
    rc, _, _ = _quiet(mod.main, [str(d), "2", "--device", "cpu"])
    assert rc == 0
    scene = load_scene("demo").with_overrides(
        width=100, height=50, samples_per_pixel=4, max_depth=4)
    step = make_render_step(scene, full_color=True, dynamic=True,
                            device="cpu")
    arrays0, state = pack_scene(scene), init_state(scene, "cpu")
    imgs = []
    for t in range(2):
        o = step(state, Camera().pose(), 1 + t, 0,
                 ANIMATORS["orbit"](arrays0, t))
        state = o.state
        img = imageio.read_png(d / f"frame_{t:03d}.png")
        assert img.shape == (50, 100, 3)
        np.testing.assert_array_equal(img, o.rgb.numpy())
        imgs.append(img)
    assert not np.array_equal(*imgs)
    assert sorted(os.listdir(d)) == ["frame_000.png", "frame_001.png"]


# ---------------------------------------------------------------------------
# multichip over two gloo ranks
# ---------------------------------------------------------------------------

MESH_CUT = dict(width=32, height=8, samples_per_pixel=8, max_depth=3)
TIMEOUT = 180
# One rank as torchrun starts it (RANK, WORLD_SIZE, LOCAL_RANK and the
# store's address in the environment): multichip's main with its scene
# cut, rank 0 saving the gathered image. A child of its own (no jax to
# import), run with the repo importable.
RANK_CODE = """
import importlib.util, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location("multichip", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
build, gather = mod.build_scene, mod.gather_frame
mod.build_scene = lambda device: build(device).with_overrides(**CUT)
def keep(mesh, out):
    g = gather(mesh, out)
    if g is not None:
        np.save(sys.argv[2], g[0].numpy())
    return g
mod.gather_frame = keep
sys.exit(mod.main(["--device", "cpu"]))
"""


def test_multichip_on_two_ranks_equals_one_device(tmp_path):
    """Two gloo ranks started as torchrun starts them: px:2, and rank 0's
    gathered image (and the digest it prints) equal to the one-device
    step's, bit for bit."""
    code = RANK_CODE.replace("CUT", repr(MESH_CUT))
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_load("multichip").free_port()), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    rgb = str(tmp_path / "rgb.npy")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code,
         os.path.join(REPO, "examples_torch", "multichip.py"), rgb],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "2 ranks, mesh px:2,sp:1; 4 rows per rank" in logs[0][0]
    assert logs[1][0] == ""  # rank 1 prints nothing
    scene = load_scene("scene2").with_overrides(**MESH_CUT)
    step = make_render_step(scene, full_color=True, device="cpu")
    state = init_state(scene, "cpu")
    for f in range(8):
        o = step(state, Camera().pose(), 1 + f, f)
        state = o.state
    np.testing.assert_array_equal(np.load(rgb), o.rgb.numpy())
    assert f"sha256 {_load('multichip').digest(o.rgb)}" in logs[0][0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_cuda_without_gpu_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    rc, out, err = _quiet(_load(name).main, ["--device", "cuda"])
    assert rc != 0 and "CUDA" in err and not out



def test_card_vs_cpu_counts_the_knife_edge_pixels():
    """tools/card_vs_cpu's measure, which chip_smoke's KNIFE_CARD_CPU
    bounds: a pixel counts where one channel's relative error exceeds
    5e-3, a pair of frames counts the union of its pixels and the sum of
    its errors; and the examples' own loops, cut, run through it on the
    CPU (each against itself: nothing off)."""
    from terminal_raytracer_tpu_torch.tools import card_vs_cpu as cvc

    want = torch.ones(3, 4, 8)
    a, b = want.clone(), want.clone()
    a[1, 0, 0] += 0.01  # over 5e-3
    a[0, 2, 3] += 0.001  # under
    b[2, 0, 0] -= 0.5
    b[0, 3, 7] += 0.25
    samples = torch.full((4, 8), 4)
    card = [(10.0, samples, a), (12.0, samples, b)]
    cpu = [(10.0, samples, want), (12.0, samples, want)]
    same, per, most = cvc.compare(card, cpu)
    assert same and [n for n, _ in per] == [1, 2]
    assert per[0][1] == pytest.approx(0.01, rel=1e-5)  # the pixel under: 0
    assert most == (2, pytest.approx(0.76, rel=1e-5))
    assert not cvc.compare([(11.0, samples, want)] * 2, cpu)[0]
    for name in cvc.SEED0:
        mod = cvc.example(name)
        scene = mod.build_scene("cpu").with_overrides(
            width=8, height=4, samples_per_pixel=4, max_depth=2)
        run = cvc.loop_frames(mod, scene, 2, "cpu")
        assert cvc.compare(run, run) == (True, [(0, 0.0)] * 2, (0, 0.0))
        assert run[0][2].shape == (3, 4, 8)


@pytest.mark.parametrize("name", ["custom_scene", "animate"])
def test_knife_trace_finds_a_flipped_shadow_test(name):
    """tools/knife_trace's per-pixel records: two CPU runs of one frame
    agree event for event (no difference, no flip); a shadow sweep's
    blocked flag flipped in one record is reported at its sample and
    bounce as a flip of that primitive, and a value moved by one ulp as the
    first difference."""
    import numpy as np

    from terminal_raytracer_tpu_torch.tools import knife_trace as kt

    scene = kt.example(name).build_scene("cpu").with_overrides(
        width=16, height=8, samples_per_pixel=4, max_depth=3)
    seed, fn, arrays = kt.frame_inputs(
        name, scene, "loop" if name == "animate" else "frame", 1)
    pixels = [(x, y) for x in range(0, 16, 3) for y in range(0, 8, 2)]
    trs, recs = [], []
    for _ in range(2):
        tr = kt.tracer_on(scene, "cpu", arrays)
        recs.append(kt.Recorder(tr, pixels))
        tr.render_frame(Camera().pose(), seed, fn)
        trs.append(tr)
    lit = [p for p in pixels if sum(e[0] == "shadow" and bool(e[3]["gate"])
                                    for e in recs[1].events[p]) > 1]
    assert lit
    for p in pixels:
        assert kt.trace_pixel(trs, recs[0], recs[1], p) == (None, [])
    p = lit[0]
    shadow = [e for e in recs[1].events[p]
              if e[0] == "shadow" and bool(e[3]["gate"])][1]
    shadow[3]["res"][0] = ~shadow[3]["res"][0]
    nee = next(e for e in recs[1].events[p]
               if e[0] == "nee" and bool(e[3]["gate"]))
    nee[3]["lp"][0] = np.nextafter(nee[3]["lp"][0], np.float32(np.inf))
    first, flips = kt.trace_pixel(trs, recs[0], recs[1], p)
    assert first.endswith("nee 'lp' 1 ulps")
    assert len(flips) == 1 and " shadow blocked " in flips[0]
    assert kt._prim(trs[0], 0) in flips[0]
