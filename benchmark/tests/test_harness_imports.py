"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness import runner

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "terminal_raytracer_tpu"}
PROGRAM = "terminal_raytracer_tpu_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*dirs):
    return [p for d in dirs for p in sorted((BENCH / d).rglob("*.py"))]


@pytest.mark.parametrize("path", _sources("harness", "reference", "metrics")
                         + [BENCH / "run.py"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_banned_import(path):
    assert not (_imports(path) & BANNED)


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)
    assert "harness" not in _imports(path)


@pytest.mark.parametrize("mods,bad", [
    (["terminal_raytracer_tpu_torch", "terminal_raytracer_tpu_torch.ops",
      "jaxtyping", "flaxen"], []),
    (["terminal_raytracer_tpu.ops.rng", "os"], ["terminal_raytracer_tpu.ops.rng"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax.linen", "jax.numpy",
                                             "jaxlib"]),
])
def test_top_level_names_compared_whole(monkeypatch, mods, bad):
    for m in mods:
        monkeypatch.setitem(sys.modules, m, object())
    assert [m for m in runner.banned_modules() if m in mods] == bad


def test_the_program_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import runner\n"
            "import terminal_raytracer_tpu_torch.runtime.engine\n"
            "import reference.viewer\n"
            "print(runner.banned_modules())" % (str(BENCH), str(ROOT)))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"
