"""The ptxas lines of every kernel of the render and probe libraries
(registers, stack, spill stores), and, with --against, the same kernels of
another checkout of the repository side by side: the check that a change
kept the machine code of the kernels it did not mean to touch.

    python -m terminal_raytracer_tpu_torch.tools.ptxas_lines [--against DIR]

Builds the sources (ops/build.py ENTRY_POINTS: the render sources and
probes.cu) of this checkout and, with --against, those of the checkout at
DIR with that checkout's own ops/build.py into its own _build/, all at
once, one nvcc a source.
Kernels are keyed by source and demangled name without the argument list
(cu++filt, beside nvcc); each line prints one kernel's registers, stack
and spill stores, '=' where both checkouts agree, '!=' where they differ,
and the kernels that only one side has. Exits 1 if a kernel of both sides
differs. Needs nvcc (the card's machine); no GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

from ..ops import build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")


def kernels_of(log: str) -> dict:
    """{mangled name: 'R registers, S B stack, T B spill stores'} of an
    nvcc -Xptxas -v log."""
    out, name, spill = {}, None, "?"
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spill = m.group(1), "?"
        elif name and "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            out[name] = (f"{regs} registers, "
                         f"{stack.group(1) if stack else 0} B stack, "
                         f"{spill}")
            name = None
    return out


def demangle(names) -> dict:
    """{mangled: demangled without the argument list}, by cu++filt."""
    names = list(names)
    tool = Path(build.nvcc_path()).with_name("cu++filt")
    proc = subprocess.run([str(tool)], input="\n".join(names), text=True,
                          capture_output=True, check=True)
    plain = proc.stdout.splitlines()
    return {m: _strip_args(d) for m, d in zip(names, plain)}


def _strip_args(name: str) -> str:
    """A demangled function name without its trailing argument list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            return name[:i]
    return name


def lines_of(build_mod) -> dict:
    """{(source, kernel): ptxas line} of a build module's render and probe
    libraries (built where missing)."""
    paths = build_mod.library_paths(tuple(build_mod.ENTRY_POINTS))
    raw = {src: kernels_of(so.with_suffix(".log").read_text())
           for src, so in paths.items()}
    names = demangle({m for ks in raw.values() for m in ks})
    return {(src, names[m]): line for src, ks in raw.items()
            for m, line in ks.items()}


def _load_build(root: Path):
    path = root / "terminal_raytracer_tpu_torch" / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location("_other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None)
    args = ap.parse_args(argv)
    here = lines_of(build)
    if args.against is None:
        for (src, name), line in sorted(here.items()):
            print(f"[ptxas] {src} {name}: {line}")
        return 0
    there = lines_of(_load_build(args.against.resolve()))
    differ = 0
    for key in sorted(set(here) | set(there)):
        src, name = key
        if key in here and key in there:
            same = here[key] == there[key]
            differ += not same
            print(f"[ptxas] {src} {name}: {here[key]} "
                  f"{'=' if same else '!= ' + there[key]}")
        elif key in here:
            print(f"[ptxas] {src} {name}: {here[key]} (this checkout only)")
        else:
            print(f"[ptxas] {src} {name}: {there[key]} ({args.against} only)")
    print(f"[ptxas] {differ} kernels of both checkouts differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
