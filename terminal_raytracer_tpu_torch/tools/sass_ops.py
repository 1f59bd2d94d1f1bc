"""The SASS opcodes of the branch probes' kernels (csrc/probes.cu), counted:
what a heavy step of each floor body compiles to on sm_90a, and which
datapath the predicate's integer arithmetic takes (U-prefixed opcodes run
on the uniform datapath, once a warp).

    python -m terminal_raytracer_tpu_torch.tools.sass_ops [--root DIR]

Builds probes.cu of this checkout (or, with --root, of the checkout at DIR
with that checkout's own ops/build.py) where it is missing, disassembles
the library with cuobjdump -sass (beside nvcc), and prints, for every
kernel of probe_cond and probe_when, its opcode counts and its heavy
steps: one FRND a step for the floorf body, one FFMA.RM a step for the
FP32-pipe body; each FP32-pipe opcode is also printed a step. Needs nvcc
and cuobjdump (the card's machine); no GPU.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from ..ops import build
from .ptxas_lines import _load_build, demangle

SOURCE = "probes.cu"
MATCH = ("probe_cond", "probe_when")
# One line of cuobjdump -sass: /*0a30*/ [@[!]Pn|@[!]UPn] OPCODE[.MOD...] ...
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
# The FP32 pipe's opcodes of a heavy step.
FP32 = ("FMUL", "FADD", "FFMA", "FFMA.RM", "FSEL", "FSETP")


def disassembler() -> Path | None:
    """cuobjdump beside nvcc, or None where the toolkit has none."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    return tool if tool.exists() else None


def functions(sass: str) -> dict:
    """{mangled name: Counter of opcodes (with their modifiers)} of a
    cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = _INSN.search(line) if name else None
        if m:
            out[name][m.group(1)] += 1
    return out


def steps(ops: Counter) -> int:
    """Heavy steps in a kernel's code: one floor each, FRND (floorf) or
    FFMA.RM (the FP32-pipe floor)."""
    return sum(n for op, n in ops.items()
               if op.startswith("FRND") or op == "FFMA.RM")


def per_step(ops: Counter) -> str:
    """The FP32-pipe and FRND opcodes over the heavy steps."""
    n = steps(ops)
    if not n:
        return "no heavy step"
    keep = sorted(op for op in ops if op in FP32 or op.startswith("FRND"))
    return ", ".join(f"{op} {ops[op] / n:.2f}" for op in keep)


def uniform_share(ops: Counter) -> str:
    """Integer and predicate opcodes on the uniform datapath against the
    vector pipes'."""
    uni = sum(n for op, n in ops.items() if op.startswith("U"))
    vec = sum(n for op, n in ops.items() if op.split(".")[0] in (
        "IMAD", "IADD3", "ISETP", "LEA", "SHF", "LOP3", "IABS", "SEL",
        "MOV", "IMNMX", "I2F", "F2I"))
    return f"uniform {uni}, vector integer {vec}"


def listing(build_mod) -> str:
    """cuobjdump -sass of the probes library of `build_mod` (built where
    missing)."""
    tool = disassembler()
    if tool is None:
        raise RuntimeError("no cuobjdump beside nvcc: the toolkit has no "
                           "disassembler")
    so = build_mod.library_paths((SOURCE,))[SOURCE]
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def kernels(build_mod=build) -> dict:
    """{demangled kernel name: Counter of opcodes} of the probes library's
    branch probe kernels (MATCH)."""
    raw = functions(listing(build_mod))
    names = demangle(raw)
    return {names[m]: ops for m, ops in raw.items()
            if any(k in names[m] for k in MATCH)}


def report(found: dict, tag: str = "[sass]") -> None:
    for name, ops in sorted(found.items()):
        print(f"{tag} {name}: {steps(ops)} heavy steps; a step: "
              f"{per_step(ops)}; {uniform_share(ops)}", flush=True)
        print(f"{tag}   {dict(sorted(ops.items()))}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None)
    args = ap.parse_args(argv)
    report(kernels(build if args.root is None
                   else _load_build(args.root.resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
