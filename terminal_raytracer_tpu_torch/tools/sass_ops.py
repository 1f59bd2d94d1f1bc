"""The SASS opcodes of the probes' kernels (csrc/probes.cu), counted: what
a heavy step of each branch probe's floor body compiles to on sm_90a, and
which datapath the predicate's integer arithmetic takes (U-prefixed
opcodes run on the uniform datapath, once a warp); and what each loop of
the gather probes' kernels issues: its fetches (LDG, LDS, SHFL, HMMA) and
FADDs, their order, and how many loads are added only on a later pass of
the loop (the fetch issued ahead of its add); probe21c's loops likewise,
with their instructions a pass (a form's issue-rate floor, one warp an
SM).

    python -m terminal_raytracer_tpu_torch.tools.sass_ops [--root DIR]

Builds probes.cu of this checkout (or, with --root, of the checkout at DIR
with that checkout's own ops/build.py) where it is missing, disassembles
the library with cuobjdump -sass (beside nvcc), and prints, for every
kernel of probe_cond and probe_when, its opcode counts and its heavy
steps: one FRND a step for the floorf body, one FFMA.RM a step for the
FP32-pipe body; each FP32-pipe opcode is also printed a step; and for
every kernel of probe21, probe21b and probe21c, a line a loop. Needs nvcc and
cuobjdump (the card's machine); no GPU.
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
MATCH = ("probe_cond", "probe_when", "probe21<", "probe21b<", "probe21c<")
GATHER = ("probe21<", "probe21b<", "probe21c<")
# One line of cuobjdump -sass: /*0a30*/ [@[!]Pn|@[!]UPn] OPCODE[.MOD...]
# operands ;
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*)")
_REG = re.compile(r"\bR(\d+)\b")
# A gather loop's fetches (loads, shuffles, tensor-core products), and the
# loads whose value an FADD reads.
FETCH = ("LDG", "LDS", "LD", "SHFL", "HMMA")
LOADS = ("LDG", "LDS", "LD")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
# The FP32 pipe's opcodes of a heavy step.
FP32 = ("FMUL", "FADD", "FFMA", "FFMA.RM", "FSEL", "FSETP")


def disassembler() -> Path | None:
    """cuobjdump beside nvcc, or None where the toolkit has none."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    return tool if tool.exists() else None


def instructions(sass: str) -> dict:
    """{mangled name: [(address, opcode with its modifiers, operands)]} of
    a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.search(line) if name else None
        if m:
            out[name].append((int(m.group(1), 16), m.group(2),
                              m.group(3).strip()))
    return out


def functions(sass: str) -> dict:
    """{mangled name: Counter of opcodes (with their modifiers)} of a
    cuobjdump -sass listing."""
    return {name: Counter(op for _, op, _ in insns)
            for name, insns in instructions(sass).items()}


def _base(op: str) -> str:
    return op.split(".")[0]


def loops(insns: list) -> list:
    """The loops of a kernel's instructions, one a backward branch, in
    address order: {start, end, ops (Counter), insns (the body's
    instructions), order, loads, later}. order
    is the body's fetches (L) and FADDs (A) run-length coded; later counts
    the loads (LOADS) whose value no FADD reads further on in the same
    pass but one on the next (through MOV copies too): added on a later
    pass; loads counts those an FADD reads at all."""
    found = []
    for addr, op, args in insns:
        if _base(op) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [(a, o, r) for a, o, r in insns if start <= a <= addr]
        ops = Counter(o for _, o, _ in body)
        marks = "".join("L" if _base(o) in FETCH else "A" for _, o, _ in body
                        if _base(o) in FETCH or _base(o) == "FADD")
        if not marks:
            continue
        runs = re.findall(r"L+|A+", marks)
        loads = later = 0
        for k, (_, o, r) in enumerate(body):
            if _base(o) in LOADS:
                pass_ = _added_in(body[k + 1:] + body, len(body) - k - 1,
                                  set(_REG.findall(r.split(",")[0])))
                loads += pass_ is not None
                later += pass_ == "later"
        found.append(dict(start=start, end=addr, ops=ops, insns=len(body),
                          order=" ".join(f"{r[0]}{len(r)}" for r in runs),
                          loads=loads, later=later))
    return found


def _added_in(after: list, same: int, held: set):
    """Where an FADD first reads a loaded value held in registers `held`
    (and their MOV copies), scanning `after`, the body from the load on
    and once more round the back edge: "same" within its first `same` instructions (the
    load's own pass), "later" after them, None if no FADD reads it."""
    for k, (_, o, r) in enumerate(after):
        dst, *src = r.split(",")
        read = held & set(_REG.findall(",".join(src)))
        if read and _base(o) == "FADD":
            return "same" if k < same else "later"
        if read and (_base(o) == "MOV" or o.startswith("IMAD.MOV")):
            held = held | set(_REG.findall(dst))
        else:
            held = held - set(_REG.findall(dst))
    return None


def loop_line(lp: dict) -> str:
    """A loop's fetches and FADDs as one line."""
    fetch = ", ".join(f"{op} {n}" for op, n in sorted(lp["ops"].items())
                      if _base(op) in FETCH)
    adds = sum(n for op, n in lp["ops"].items() if _base(op) == "FADD")
    return (f"loop {lp['start']:#06x}-{lp['end']:#06x}: {fetch or 'no fetch'}"
            f"; FADD {adds}; order {lp['order']}; {lp['later']} of "
            f"{lp['loads']} loads added on a later pass")


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
    """{demangled kernel name: its instructions} of the probes library's
    branch and gather probe kernels (MATCH)."""
    raw = instructions(listing(build_mod))
    names = demangle(raw)
    return {names[m]: insns for m, insns in raw.items()
            if any(k in names[m] for k in MATCH)}


def report(found: dict, tag: str = "[sass]") -> None:
    for name, insns in sorted(found.items()):
        ops = Counter(op for _, op, _ in insns)
        if any(k in name for k in GATHER):
            for lp in loops(insns):
                ctrl = sum(n for op, n in lp["ops"].items()
                           if _base(op) in ("BRA", "BSSY", "CALL"))
                print(f"{tag} {name}: {loop_line(lp)}; {lp['insns']} "
                      f"instructions a pass, {ctrl} of them BRA, BSSY or "
                      "CALL", flush=True)
            continue
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
