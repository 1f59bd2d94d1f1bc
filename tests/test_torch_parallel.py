"""The port's multi-GPU render step (terminal_raytracer_tpu_torch/parallel)
against the JAX package's ``make_sharded_render_step(backend="jnp")``, on
the CPU: gloo ranks in place of the JAX package's virtual CPU devices.

Each mesh shape runs once, in a module-scoped fixture that spawns its
ranks (torch.multiprocessing, a file:// store, a 60 s group timeout and a
deadline on the join) and renders every configuration of that shape; each
configuration is then its own test. The configurations are the seven of
the JAX package's ``__graft_entry__.dryrun_multichip`` at 4 devices (64
columns, 4 rows a px shard, depth 3, seed 7, frame 0): static Cornell_Box
and glass + fog on a (2, 2) mesh, an orbit-animated Cornell_Box on (2, 1),
the sp-heavy (1, 4) mesh at spp 20 (base 5 splits 2, 1, 1, 1), textures
with a sky map and a normal-mapped floor on (2, 2), the denoiser on (2, 2)
with 2 passes (halo exchange) and 3 (all_gather), and the stratified
sampler on (2, 2) (where the sample split falls back to the reference
jitter) and on (4, 1) (where it stays on).

Against JAX: owed rays and per-pixel sample totals exact; radiance,
variance and the denoised radiance within rtol 1e-4 / atol 1e-5 but for
the knife-edge pixels that the file covering each scene bounds: none on
Cornell_Box (test_torch_slice.py), at most 2 pixels each at most 1e-4 off
in fog and under the stratified sampler (test_torch_medium.py), a
counted few of the textured scene's pixels (KNIFE_TEXTURED: their count
and summed error). The sp ranks of a
row block hold the same block, bit for bit. A px-only mesh equals the
port's single-device step bit for bit (chains are seeded by global pixel),
and so does the sharded denoiser the single-device filter, in both its
halo and its all_gather path.

Kernel A with a runtime quota (the sp shares) is held against the JAX
package's ``make_base_kernel(base_dynamic=True)`` in interpret mode.

The ranks import no jax: this module imports it inside the functions that
run the JAX package.
"""

import contextlib
import dataclasses
import io
import os
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as tmp

from terminal_raytracer_tpu_torch import cli
from terminal_raytracer_tpu_torch.models import Camera, load_scene
from terminal_raytracer_tpu_torch.models.animate import ANIMATORS
from terminal_raytracer_tpu_torch.models.scene import Fog, Sky
from terminal_raytracer_tpu_torch.ops import denoise as dn
from terminal_raytracer_tpu_torch.ops import dynamic as dyn
from terminal_raytracer_tpu_torch.ops import kernels
from terminal_raytracer_tpu_torch.ops.tracer import PathTracer
from terminal_raytracer_tpu_torch.ops.vecmath import V3
from terminal_raytracer_tpu_torch.runtime import init_state, make_render_step
from terminal_raytracer_tpu_torch.runtime.engine import Engine, _parse_shard
from test_torch_knife import KnifeEdges  # noqa: E402
from test_torch_vml import warm_vml  # noqa: E402

warm_vml()  # the ranks run on one thread each

POSE = Camera().pose()
SEED = 7
ROWS = 4  # rows a px shard
RTOL, ATOL = 1e-4, 1e-5
KNIFE_PIXELS, KNIFE_ATOL = 2, 1e-4  # fog and strata: pixels off, how far
# The textured scene: (pixels off, their summed error over radiance and
# variance), as its seed shows on the CPU (the error rounded up to 3
# digits).
KNIFE_TEXTURED = (16, 0.495)
DEADLINE = 240.0  # seconds for a mesh's ranks to render every config

# name: (mesh (n_px, n_sp), scene, overrides, denoise passes, knife rule)
CONFIGS = {
    "static": ((2, 2), "Cornell_Box", dict(samples_per_pixel=8), 0, "none"),
    "glass+fog": ((2, 2), "cornell_glass", dict(samples_per_pixel=8),
                  0, "pixels"),
    "dynamic": ((2, 1), "Cornell_Box", dict(samples_per_pixel=4), 0, "none"),
    "sp-heavy": ((1, 4), "Cornell_Box", dict(samples_per_pixel=20, height=8),
                 0, "none"),
    "textured+sky+nm": ((2, 2), "textured", dict(samples_per_pixel=8), 0,
                        "share"),
    "denoised-halo": ((2, 2), "Cornell_Box", dict(samples_per_pixel=8), 2,
                      "none"),
    "denoised-allgather": ((2, 2), "Cornell_Box", dict(samples_per_pixel=8),
                           3, "none"),
    "stratified-sp": ((2, 2), "Cornell_Box",
                      dict(samples_per_pixel=16, sampler="stratified"), 0,
                      "none"),
    "stratified-px": ((4, 1), "Cornell_Box",
                      dict(samples_per_pixel=16, sampler="stratified"), 0,
                      "pixels"),
}
T_ORBIT = 3  # the animated config's frame time
DENOISE = 1.0
CLI_ARGS = ["--device", "cpu", "--scene", "Cornell_Box", "--width", "64",
            "--height", "8", "--spp", "8", "--depth", "3", "--frames", "2"]


def _scene(name, load, fog_cls, sky_cls):
    """Config `name`'s scene, built with one package's loader and classes."""
    (n_px, _), scene, over, _, _ = CONFIGS[name]
    over = dict(dict(width=64, height=ROWS * n_px, max_depth=3), **over)
    s = load(scene).with_overrides(**over)
    if name == "glass+fog":
        s = s.with_overrides(fog=fog_cls(density=0.12))
    if name == "textured+sky+nm":
        floor = s.planes[0]
        s = dataclasses.replace(
            s, planes=(floor._replace(material=floor.material._replace(
                normal_map="globe")),) + s.planes[1:],
            sky=sky_cls(texture="globe", intensity=1.2))
    return s


def _port_scene(name):
    return _scene(name, load_scene, Fog, Sky)


def _arrays(name, scene, pack, animators):
    return (animators["orbit"](pack(scene), T_ORBIT) if name == "dynamic"
            else None)


# ---------------------------------------------------------------- the ranks


def _rank(rank, world, store, shape, out_dir):
    """One gloo rank of a `shape` mesh: every config of that shape, the
    sharded denoiser on seeded planes (4 x 1), the CLI, and the refusals
    that need a process group (2 x 1). Writes one .npz a config."""
    import torch.distributed as dist

    from terminal_raytracer_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        mesh = pm.make_mesh(*shape, "cpu")
        for name, (cshape, _, _, passes, _) in CONFIGS.items():
            if cshape != shape:
                continue
            scene = _port_scene(name)
            step, init = pm.make_sharded_render_step(
                scene, mesh, dynamic=name == "dynamic", denoise=DENOISE
                if passes else 0.0, denoise_passes=passes)
            state = init()
            out = step(state, POSE, SEED, 0,
                       _arrays(name, scene, dyn.pack_scene, ANIMATORS))
            acc = V3(*out.state.acc)
            shown = pm.denoise_acc_sharded(acc, out.state.variance,
                                           out.state.samples, 0, DENOISE,
                                           passes, mesh) if passes else acc
            np.savez(os.path.join(out_dir, f"{name}-{rank}.npz"),
                     acc=out.state.acc.numpy(),
                     var=out.state.variance.numpy(),
                     samples=out.state.samples.numpy(),
                     shown=torch.stack(list(shown)).numpy(),
                     rgb=out.rgb.numpy(), rays=float(out.rays),
                     occ=float(out.occupancy))
        if shape == (4, 1):
            r0 = ROWS * mesh.px_i
            planes = _seeded_planes(ROWS * 4, 64)[:, r0:r0 + ROWS]
            got = {f"passes{p}": torch.stack(list(pm.denoise_sharded(
                V3(*planes[:3]), planes[3], DENOISE, p, mesh))).numpy()
                for p in (2, 3)}
            np.savez(os.path.join(out_dir, f"denoise-{rank}.npz"), **got)
        if shape == (2, 2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(CLI_ARGS + ["--shard", "px:2,sp:2"])
            with open(os.path.join(out_dir, f"cli-{rank}.txt"), "w") as f:
                f.write(f"{rc}\n{buf.getvalue()}")
        if shape == (2, 1):
            errors = []
            for kw in (dict(shard="px:2,sp:2"), dict(shard="px:2",
                                                     accel="grid"),
                       dict(shard="px:2", transport="unbiased")):
                try:
                    Engine(_port_scene("static"), device="cpu", **kw)
                    errors.append("")
                except ValueError as e:
                    errors.append(str(e))
            rcs = [cli.main(CLI_ARGS + ["--shard", "px:2", flag])
                   for flag in ("--unbiased", "--accel=grid")]
            # The viewer without a tty: rank 0 refuses and stops rank 1's
            # viewer loop, which returns.
            rcs.append(cli.main(CLI_ARGS[:-2] + ["--shard", "px:2"]))
            with open(os.path.join(out_dir, f"refusals-{rank}.txt"),
                      "w") as f:
                f.write("\n".join(errors + [str(rc) for rc in rcs]))
    finally:
        dist.destroy_process_group()


def _seeded_planes(h, w):
    """Colour and variance planes [4, h, w] from a numpy seed."""
    rng = np.random.default_rng(3)
    planes = rng.random((4, h, w), dtype=np.float32)
    planes[3] *= 0.05
    return torch.from_numpy(planes)


def _spawn(shape, out_dir) -> str:
    """Run _rank on every rank of a `shape` mesh, joined with a deadline
    (a rank's exception re-raises here); returns the output dir."""
    world = shape[0] * shape[1]
    ctx = tmp.start_processes(_rank, args=(world, str(out_dir / "store"),
                                           shape, str(out_dir)),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"mesh {shape}: ranks still running after "
                            f"{DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return str(out_dir)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The output dir of each mesh shape, its ranks spawned on first use."""
    done = {}

    def get(shape):
        if shape not in done:
            done[shape] = _spawn(shape, tmp_path_factory.mktemp(
                "x".join(map(str, shape))))
        return done[shape]

    return get


def _load(out_dir, name, shape):
    """Rank outputs of a config: the full frame from sp rank 0 of every row
    block (after checking that each block's sp ranks agree bit for bit),
    and rays and occupancy."""
    n_px, n_sp = shape
    blocks = []
    for p in range(n_px):
        parts = [dict(np.load(os.path.join(out_dir, f"{name}-{p * n_sp + s}"
                                           ".npz"))) for s in range(n_sp)]
        for other in parts[1:]:
            for k, v in parts[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=k)
        blocks.append(parts[0])
    full = {k: np.concatenate([b[k] for b in blocks], axis=-2
                              if blocks[0][k].ndim >= 2 else 0)
            for k in ("acc", "var", "samples", "shown")}
    full["rgb"] = np.concatenate([b["rgb"] for b in blocks], axis=0)
    full["rays"], full["occ"] = float(blocks[0]["rays"]), float(
        blocks[0]["occ"])
    for b in blocks[1:]:
        assert (float(b["rays"]), float(b["occ"])) == (full["rays"],
                                                       full["occ"])
    return full


# ---------------------------------------------------------- the JAX oracle


_JAX = {}


def _jax_oracle(name):
    """The JAX sharded step's frame of config `name` (jnp backend, the
    conftest's CPU devices), and its filtered radiance."""
    if name in _JAX:
        return _JAX[name]
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.models.animate import ANIMATOR_KEYS
    from terminal_raytracer_tpu.models.animate import ANIMATORS as JANIM
    from terminal_raytracer_tpu.models.scene import Fog as JFog
    from terminal_raytracer_tpu.models.scene import Sky as JSky
    from terminal_raytracer_tpu.ops import dynamic as jdyn
    from terminal_raytracer_tpu.parallel import (make_mesh,
                                                 make_sharded_render_step)

    (n_px, n_sp), _, _, passes, _ = CONFIGS[name]
    scene = _scene(name, jload, JFog, JSky)
    mesh = make_mesh(n_px, n_sp, devices=jax.devices()[:n_px * n_sp])
    dynamic = name == "dynamic"
    step, init = make_sharded_render_step(
        scene, mesh, full_color=True, backend="jnp", dynamic=dynamic,
        animated=ANIMATOR_KEYS["orbit"] if dynamic else None,
        denoise=DENOISE if passes else 0.0, denoise_passes=passes or 3)
    arrays = _arrays(name, scene, jdyn.pack_scene, JANIM)
    out = jax.device_get(step(init(), POSE, np.uint32(SEED), np.int32(0),
                              *(() if arrays is None else (arrays,))))
    _JAX[name] = dict(acc=out.state.acc, var=out.state.variance,
                      samples=out.state.samples, rgb=out.rgb,
                      rays=float(out.rays))
    return _JAX[name]


def _assert_close(rule, got, want):
    """Planes [c, h, w] within the frame tolerance but for the knife edges
    `rule` allows; returns the mask of pixels off."""
    err = np.abs(got - want)
    off = (err > ATOL + RTOL * np.abs(want)).any(0)
    if rule == "none":
        assert off.sum() == 0, f"{off.sum()} pixels off, by {err.max()}"
    elif rule == "share":
        KnifeEdges(RTOL, ATOL).add(got, want).check(KNIFE_TEXTURED)
    else:
        assert err.max() <= KNIFE_ATOL, f"a pixel is {err.max()} off"
        assert off.sum() <= KNIFE_PIXELS, f"{off.sum()} pixels off"
    return off


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_step_matches_jax_sharded_step(name, meshes):
    shape, _, _, passes, rule = CONFIGS[name]
    got = _load(meshes(shape), name, shape)
    want = _jax_oracle(name)
    assert got["rays"] == want["rays"]
    np.testing.assert_array_equal(got["samples"], want["samples"])
    spp = _port_scene(name).samples_per_pixel
    if spp > max(4, spp // 4):  # the extra phase runs, and budgets bite
        assert (want["samples"] > want["samples"].min()).any()
    off = _assert_close(rule,
                        np.concatenate([got["acc"], got["var"][None]]),
                        np.concatenate([want["acc"], want["var"][None]]))
    if passes:
        # The sharded filter is the single-device filter of the frame, bit
        # for bit, and near the filter of the JAX frame (the port's filter
        # against the JAX package's: test_torch_denoise.py); the image
        # below holds the JAX sharded step's own filter.
        def filtered(f):
            t = {k: torch.from_numpy(np.array(f[k]))
                 for k in ("acc", "var", "samples")}
            return torch.stack(list(dn.denoise_acc(
                V3(*t["acc"]), t["var"], t["samples"], 0, DENOISE,
                passes))).numpy()

        np.testing.assert_array_equal(got["shown"], filtered(got))
        off |= _assert_close(rule, got["shown"], filtered(want))
        assert not np.array_equal(got["shown"], got["acc"])
    # The image: within one level (a truncation) off the knife edges.
    assert np.abs(got["rgb"].astype(int) - want["rgb"])[~off].max() <= 1
    assert 0.0 < got["occ"] <= 1.0


@pytest.mark.parametrize("name", ["dynamic", "stratified-px"])
def test_px_mesh_equals_single_device_step(name, meshes):
    """Row blocks of a px-only mesh tile the port's single-device frame bit
    for bit: rays, occupancy and every plane."""
    shape = CONFIGS[name][0]
    got = _load(meshes(shape), name, shape)
    scene = _port_scene(name)
    step = make_render_step(scene, device="cpu", dynamic=name == "dynamic")
    out = step(init_state(scene, "cpu"), POSE, SEED, 0,
               _arrays(name, scene, dyn.pack_scene, ANIMATORS))
    assert got["rays"] == float(out.rays)
    assert got["occ"] == float(out.occupancy)
    for key, want in (("acc", out.state.acc), ("var", out.state.variance),
                      ("samples", out.state.samples), ("rgb", out.rgb)):
        np.testing.assert_array_equal(got[key], want.numpy(), err_msg=key)


@pytest.mark.parametrize("passes", [2, 3], ids=["halo", "all_gather"])
def test_sharded_denoiser_equals_single_device_filter(passes, meshes):
    """denoise_sharded over four row blocks of 4 rows: 2 passes exchange
    halos (the widest, 4 rows, fits a block), 3 gather the planes."""
    out = meshes((4, 1))
    got = np.concatenate([np.load(os.path.join(out, f"denoise-{r}.npz"))[
        f"passes{passes}"] for r in range(4)], axis=1)
    planes = _seeded_planes(ROWS * 4, 64)
    want = dn.denoise(V3(*planes[:3]), planes[3], DENOISE, passes)
    np.testing.assert_array_equal(got, torch.stack(list(want)).numpy())


def test_cli_renders_on_a_mesh(meshes):
    """cli.main on every rank of a (2, 2) gloo mesh: rc 0 everywhere, and
    only rank 0 prints the frame."""
    out = meshes((2, 2))
    texts = [open(os.path.join(out, f"cli-{r}.txt")).read().split("\n")
             for r in range(4)]
    assert [t[0] for t in texts] == ["0"] * 4
    rows = [line for line in texts[0][1:] if line]
    assert rows[0] == "outputting with ASCII characters"
    assert len(rows) == 1 + 8 and all(len(r) == 64 for r in rows[1:])
    assert len(set("".join(rows[1:]))) > 4  # not flat
    assert all(t[1:] == [""] for t in texts[1:])


def test_engine_and_cli_refusals_on_a_mesh(meshes):
    """With a process group of 2: a mesh of another size, --accel and
    --unbiased are refused (Engine raises; the CLI exits 2); the viewer
    without a tty exits 2 on rank 0, and rank 1's viewer loop stops."""
    out = meshes((2, 1))
    for r in range(2):
        lines = open(os.path.join(out, f"refusals-{r}.txt")).read().split(
            "\n")
        assert "needs 4 ranks, the process group has 2" in lines[0]
        assert "drop --accel" in lines[1]
        assert "unbiased" in lines[2]
        assert lines[3:] == ["2", "2", "2" if r == 0 else "0"]


def test_viewer_on_a_mesh_through_a_pty():
    """The interactive viewer on a (2, 1) gloo mesh under torchrun, rank
    0's terminal a pty: frames render, a move resets accumulation, ESC
    stops every rank (rank 1's loop follows rank 0's commands)."""
    import fcntl
    import pty
    import select
    import struct
    import subprocess
    import sys
    import termios

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "terminal_raytracer_tpu_torch",
         "--device", "cpu", "--shard", "px:2", "--scene", "Cornell_Box",
         "--width", "32", "--height", "9", "--spp", "4", "--depth", "2",
         "--full-color"],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, cwd=repo, env=env)
    os.close(slave)
    buf = b""

    def read_until(pattern: bytes, timeout: float, start: int = 0) -> bool:
        nonlocal buf
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf += os.read(master, 65536)
                except OSError:
                    break
            if pattern in buf[start:]:
                return True
        return False

    def tail():
        return buf[-2000:].decode("utf-8", "replace")

    try:
        assert read_until(b"Frame: 3/", 120), tail()
        assert b"\x1b[38;2;" in buf  # truecolor cells
        mark = len(buf)
        os.write(master, b"w")  # the move restarts accumulation
        assert read_until(b"Frame: 1/", 60, mark), tail()
        os.write(master, b"\x1b")  # ESC stops every rank
        assert read_until(b"Exiting.", 60), tail()
        proc.wait(timeout=60)
        assert proc.returncode == 0, proc.stderr.read().decode()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)


# ------------------------------------------------- without a process group


GOOD_SPECS = {"4": (4, 1), "px:2": (2, 1), "sp:2": (1, 2),
              "px:2,sp:4": (2, 4), "sp:4, px:2": (2, 4)}
BAD_SPECS = ("0", "px:1", "foo:2", "px:2,sp:x", "", "px:2,4", "px:2,px:8",
             "2,2")


@pytest.mark.parametrize("spec", list(GOOD_SPECS))
def test_parse_shard_accepts_the_jax_specs(spec):
    from terminal_raytracer_tpu.runtime.engine import _parse_shard as jparse

    assert _parse_shard(spec) == GOOD_SPECS[spec] == jparse(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_shard_refuses_the_jax_bad_specs(spec):
    with pytest.raises(ValueError):
        _parse_shard(spec)


def test_shard_without_a_process_group_is_refused(capsys):
    with pytest.raises(ValueError, match="initialised process group"):
        Engine(_port_scene("static"), device="cpu", shard="px:2")
    assert cli.main(CLI_ARGS + ["--shard", "px:2"]) == 2
    assert "torchrun" in capsys.readouterr().err
    assert cli.main(CLI_ARGS + ["--shard", "px:1"]) == 2


def test_make_mesh_asks_for_the_card_by_default(tmp_path):
    """Without a device, make_mesh builds its mesh on the card: on a
    one-rank gloo group it refuses with the CUDA path's message (a mesh on
    CUDA devices reduces over nccl), and with device='cpu' it accepts."""
    import torch.distributed as dist

    from terminal_raytracer_tpu_torch.parallel import mesh as pm

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="reduces over nccl, not gloo"):
            pm.make_mesh(1)
        mesh = pm.make_mesh(1, device="cpu")
        assert mesh.device == torch.device("cpu")
        assert (mesh.n_px, mesh.n_sp) == (1, 1)
    finally:
        dist.destroy_process_group()


# ------------------------------------------ kernel A with a runtime quota


@pytest.mark.parametrize("quota", ["base_lo", "base_hi"])
def test_kernel_a_runtime_quota_matches_pallas_base_dynamic(quota):
    """Kernel A's plain version with base_q = the floor or ceiling share of
    a 4-way split of base 5, on rows [4, 8), against the JAX kernel A built
    with base_dynamic in interpret mode: rays and end states exact, sums
    within rtol 1e-4 / atol 1e-5."""
    import jax

    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import pallas_kernel as pk

    over = dict(width=64, height=8, samples_per_pixel=20, max_depth=3)
    q = {"base_lo": 1, "base_hi": 2}[quota]
    y0, seed = ROWS, (SEED + 3 * 2654435761) & 0xFFFFFFFF
    if "base_fn" not in _JAX:  # one build (and trace) serves both quotas
        base_fn, _, _ = pk.make_base_kernel(
            jload("Cornell_Box").with_overrides(**over), interpret=True,
            shard_rows=ROWS, base_quota=2, base_dynamic=True)
        _JAX["base_fn"] = jax.jit(
            lambda p, s, f, y, b: base_fn(p, s, f, y, base_q=b))
    jcsum, jcsq, jstate, jrays, _ = jax.device_get(_JAX["base_fn"](
        POSE, np.uint32(seed), np.int32(0), np.int32(y0), np.int32(q)))
    tr = PathTracer(load_scene("Cornell_Box").with_overrides(**over), "cpu",
                    base_quota=2)
    assert (tr.chunk_base, tr.strat_g) == (None, 1)
    t = kernels.base_kernel(tr, POSE, seed, 0, y0=y0, h_out=ROWS, base_q=q)
    np.testing.assert_array_equal(t.rays.numpy(), jrays)
    np.testing.assert_array_equal(t.state.numpy(),
                                  np.asarray(jstate).astype(np.int64))
    for got, want in zip((*t.csum, *t.csumsq), (*jcsum, *jcsq)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="base_q"):
        kernels.base_kernel(tr, POSE, seed, 0, base_q=3)


@pytest.mark.parametrize("name, over", [
    ("stress:600", dict(samples_per_pixel=16)),
    ("Cornell_Box", dict(samples_per_pixel=16, sampler="stratified"))],
    ids=["auto-chunks", "strata"])
@pytest.mark.parametrize("quota", [None, 2])
def test_base_quota_resolves_chunks_and_strata_as_jax(name, over, quota):
    """A tracer with a base_quota (a sample-split shard) splits no chain by
    itself and never stratifies; without one, both are on here. As the JAX
    PathTracer resolves them."""
    from terminal_raytracer_tpu.models import load_scene as jload
    from terminal_raytracer_tpu.ops import tracer as jtracer

    jt = jtracer.PathTracer(jload(name).with_overrides(**over),
                            base_quota=quota)
    tr = PathTracer(load_scene(name).with_overrides(**over), "cpu",
                    base_quota=quota)
    got = (tr.base_samples, tr.chunk_base, tr.chunk_extra, tr.strat_g)
    assert got == (jt.base_samples, jt.chunk_base, jt.chunk_extra,
                   jt.strat_g)
    assert (got[1:] == (None, None, 1)) == (quota is not None)
