"""The port's CPU path makes its first vector-math calls on one thread
(terminal_raytracer_tpu_torch/utils/vml.py).

PyTorch-CPU's sqrt, exp, log, log2, tan, tanh, atan and erf are MKL
vector-math calls; a process's first such call, made from two intra-op
threads at once, can compute a chunk with a low-accuracy kernel
(tests/test_torch_vml.py reproduces it). A CPU tracer makes the first call
of each on one thread before it renders, once a process, and restores the
thread count. Here every call of the eight is recorded with the thread
count it ran on.
"""

import pytest

torch = pytest.importorskip("torch")

from terminal_raytracer_tpu_torch import cli
from terminal_raytracer_tpu_torch.models import load_scene
from terminal_raytracer_tpu_torch.runtime.engine import Engine
from terminal_raytracer_tpu_torch.utils import vml

THREADS = 2


@pytest.fixture
def vml_calls(monkeypatch):
    """A fresh process's warm-up state, and the (function, intra-op threads)
    of every call of the eight VML functions."""
    calls = []
    for fn in vml.FNS:
        def record(*args, _fn=fn, _orig=getattr(torch, fn), **kw):
            calls.append((_fn, torch.get_num_threads()))
            return _orig(*args, **kw)
        monkeypatch.setattr(torch, fn, record)
    monkeypatch.setattr(vml, "_warm", False)
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield calls
    torch.set_num_threads(n)


def _scene():
    return load_scene("Cornell_Box").with_overrides(
        width=16, height=8, samples_per_pixel=4, max_depth=3)


def test_cpu_engine_warms_vector_math_once_before_its_first_frame(vml_calls):
    eng = Engine(_scene(), device="cpu", deterministic=42)
    warm = [(fn, 1) for fn in vml.FNS]
    assert vml_calls[:len(warm)] == warm
    assert torch.get_num_threads() == THREADS
    n = len(vml_calls)
    eng.render_one(0)
    assert len(vml_calls) > n
    assert all(t == THREADS for _, t in vml_calls[len(warm):])
    Engine(_scene(), device="cpu", deterministic=42).render_one(0)
    assert sum(t == 1 for _, t in vml_calls) == len(warm)
    assert torch.get_num_threads() == THREADS


def test_cli_on_the_cpu_warms_vector_math_first(vml_calls, capsys):
    rc = cli.main(["--device", "cpu", "--scene", "Cornell_Box", "--width",
                   "16", "--height", "8", "--spp", "4", "--depth", "3",
                   "--frames", "1"])
    assert rc == 0
    assert vml_calls[:len(vml.FNS)] == [(fn, 1) for fn in vml.FNS]
    assert all(t == THREADS for _, t in vml_calls[len(vml.FNS):])
    assert torch.get_num_threads() == THREADS


def test_warm_vml_runs_once_a_process(vml_calls):
    assert vml.warm_vml() is True
    assert vml.warm_vml() is False
    assert vml_calls == [(fn, 1) for fn in vml.FNS]
