"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles at first use with its own nvcc, all started together,
into a shared library with a plain C interface, loaded with ctypes: no
PyTorch headers, so a build takes seconds, not minutes. A library is
content-hashed over its source, the shared header and the flags, and kept
in ``terminal_raytracer_tpu_torch/_build/`` (listed in .gitignore); nvcc's
output, including ``-Xptxas -v`` register and spill counts, is kept beside
it as ``<name>.log``.

``--fmad=false`` keeps nvcc from contracting a*b+c into one fused
multiply-add, so each kernel rounds like its plain PyTorch version; fast
math is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
HEADERS = ("trace.cuh", "pipeline.cuh", "traverse.cuh", "group.cuh",
           "frame_queue.cuh")
# The queue entries of kernels C and D by mode (kernel_frame.cu,
# kernel_frame_lockstep.cu): each form's launch and its _per_sm query.
QUEUE_ENTRY_POINTS = {
    mode: tuple(
        (f"trt_kernel_{mode}{sfx}_queue{form}{query}", n if q is None else q)
        for sfx, n in (("", 6), ("_ext", 7), ("_xt", 8), ("_grid", 9),
                       ("_gathered", 9))
        for form in ("_solo", "", "_spill")
        if not (sfx == "_gathered" and form == "_spill")
        for query, q in (("", None), ("_per_sm", 2)))
    for mode in ("regen", "lockstep")}
# Source -> (C entry point, number of pointer arguments).
ENTRY_POINTS = {
    "kernel_base.cu": (("trt_kernel_base", 6), ("trt_kernel_base_nested", 6),
                       ("trt_kernel_base_chunked", 6),
                       ("trt_kernel_base_chunked_grouped", 6),
                       ("trt_kernel_base_chunked_grouped_k", 0),
                       ("trt_kernel_base_chunked_grouped_spill", 6),
                       ("trt_kernel_base_chunked_grouped_spill_k", 0),
                       ("trt_kernel_base_chunked_grouped_spill_cap", 0),
                       ("trt_kernel_base_grouped", 7),
                       ("trt_kernel_base_grouped_k", 0),
                       ("trt_kernel_base_grouped_refill", 0),
                       ("trt_kernel_base_ext", 7),
                       ("trt_kernel_base_ext_nested", 7),
                       ("trt_kernel_base_ext_grouped", 8),
                       ("trt_kernel_base_ext_grouped_k", 0),
                       ("trt_kernel_base_ext_grouped_refill", 0),
                       ("trt_kernel_base_chunked_ext", 7),
                       ("trt_kernel_base_chunked_ext_grouped", 7),
                       ("trt_kernel_base_chunked_ext_grouped_k", 0),
                       ("trt_kernel_base_chunked_ext_grouped_spill", 7),
                       ("trt_kernel_base_chunked_ext_grouped_spill_k", 0),
                       ("trt_kernel_base_chunked_ext_grouped_spill_cap", 0),
                       ("trt_kernel_base_xt", 8),
                       ("trt_kernel_base_xt_min_blocks", 0),
                       ("trt_kernel_base_xt_nested", 8),
                       ("trt_kernel_base_chunked_xt", 8),
                       ("trt_kernel_base_chunked_xt_grouped", 8),
                       ("trt_kernel_base_chunked_xt_grouped_k", 0),
                       ("trt_kernel_base_chunked_xt_grouped_spill", 8),
                       ("trt_kernel_base_chunked_xt_grouped_spill_k", 0),
                       ("trt_kernel_base_chunked_xt_grouped_spill_cap", 0)),
    "kernel_extra.cu": (("trt_kernel_extra", 10),
                        ("trt_kernel_extra_grouped", 10),
                        ("trt_kernel_extra_grouped_k", 0),
                        ("trt_kernel_extra_ext", 11),
                        ("trt_kernel_extra_xt", 12),
                        ("trt_kernel_extra_xt_grouped", 12),
                        ("trt_kernel_extra_xt_grouped_k", 0),
                        ("trt_kernel_extra_grouped_spill", 10),
                        ("trt_kernel_extra_grouped_spill_k", 0),
                        ("trt_kernel_extra_grouped_spill_cap", 0),
                        ("trt_kernel_extra_xt_grouped_spill", 12),
                        ("trt_kernel_extra_xt_grouped_spill_k", 0),
                        ("trt_kernel_extra_xt_grouped_spill_cap", 0),
                        ("trt_kernel_extra_ext_grouped", 11),
                        ("trt_kernel_extra_ext_grouped_k", 0),
                        ("trt_kernel_extra_ext_grouped_spill", 11),
                        ("trt_kernel_extra_ext_grouped_spill_k", 0),
                        ("trt_kernel_extra_ext_grouped_spill_cap", 0)),
    "kernel_accel.cu": (("trt_kernel_base_grid", 9),
                        ("trt_kernel_base_grid_min_blocks", 0),
                        ("trt_kernel_base_grid_nested", 9),
                        ("trt_kernel_base_gathered", 9),
                        ("trt_kernel_base_gathered_min_blocks", 0),
                        ("trt_kernel_base_gathered_nested", 9),
                        ("trt_kernel_base_chunked_grid", 9),
                        ("trt_kernel_base_chunked_gathered", 9),
                        ("trt_kernel_base_chunked_grid_grouped", 9),
                        ("trt_kernel_base_chunked_grid_grouped_k", 0),
                        ("trt_kernel_base_chunked_grid_grouped_spill", 9),
                        ("trt_kernel_base_chunked_grid_grouped_spill_k", 0),
                        ("trt_kernel_base_chunked_grid_grouped_spill_cap", 0),
                        ("trt_kernel_base_chunked_gathered_grouped", 9),
                        ("trt_kernel_base_chunked_gathered_grouped_k", 0),
                        ("trt_kernel_extra_grid", 13),
                        ("trt_kernel_extra_gathered", 13),
                        ("trt_kernel_extra_grid_grouped", 13),
                        ("trt_kernel_extra_grid_grouped_k", 0),
                        ("trt_kernel_base_grid_grouped", 10),
                        ("trt_kernel_base_grid_grouped_k", 0),
                        ("trt_kernel_base_grid_grouped_refill", 0),
                        ("trt_kernel_extra_grid_grouped_spill", 13),
                        ("trt_kernel_extra_grid_grouped_spill_k", 0),
                        ("trt_kernel_extra_grid_grouped_spill_cap", 0),
                        ("trt_kernel_base_grid_grouped_spill", 10),
                        ("trt_kernel_base_grid_grouped_spill_k", 0),
                        ("trt_kernel_base_grid_grouped_spill_cap", 0),
                        ("trt_kernel_base_grid_grouped_spill_refill", 0),
                        ("trt_kernel_extra_gathered_grouped", 13),
                        ("trt_kernel_extra_gathered_grouped_k", 0),
                        ("trt_kernel_base_gathered_grouped", 10),
                        ("trt_kernel_base_gathered_grouped_k", 0),
                        ("trt_kernel_base_gathered_grouped_refill", 0)),
    "kernel_frame.cu": tuple(
        (f"trt_kernel_{mode}{sfx}", n)
        for mode in ("regen", "lockstep")
        for sfx, n in (("", 5), ("_ext", 6), ("_xt", 7), ("_grid", 8),
                       ("_gathered", 8))
    ) + QUEUE_ENTRY_POINTS["regen"],
    "kernel_frame_lockstep.cu": QUEUE_ENTRY_POINTS["lockstep"],
    # The Hopper probes of tools/ (terminal_raytracer_tpu_torch/tools/);
    # the *_serial gather and probe21c entries keep the loop the shipped one
    # replaced and are launched by chip_smoke.py and tools/gather_tune.py
    # alone.
    "probes.cu": tuple(
        (f"trt_probe21_{f}", 5) for f in (
            "none", "ldg", "global", "shared", "onehotmm", "selectacc",
            "none_serial", "ldg_serial")
    ) + tuple((f"trt_probe21b_{f}", 5) for f in (
        "none", "tala1_ldg", "tala1_shared", "tala1_shfl", "tala0_ldg",
        "tala0_shared", "tala0_shfl", "rowsel_ldg", "rowsel_shared",
        "rowsel_shfl", "onehot_hi", "none_serial", "rowsel_ldg_serial")
    ) + tuple((f"trt_probe21c_{f}", 5) for f in (
        "none", "f2i", "atan2f", "atan2_poly", "packed", "atan2f_serial",
        "packed_serial")
    ) + tuple((f"trt_probe_when_{f}", 4) for f in (
        "guarded", "unguarded", "divergent", "guarded_frnd")
    ) + tuple((f"trt_probe_cond_{f}", 3) for f in (
        "cond", "unguarded", "divergent", "cond_frnd")),
}
# What a render loads; the probes' library loads only when a probe asks.
RENDER_SOURCES = tuple(src for src in ENTRY_POINTS if src != "probes.cu")
# The group-width sweep of tools/group_k.py: one library a width K (built
# with -DTRT_TUNE_K=K, for the grid kernels' design -DTRT_TUNE_WIDE, for
# kernel A's schedule -DTRT_TUNE_REFILL, for the GroupSpill and GroupWalk
# forms' block width and stage cap -DTRT_TUNE_THREADS, -DTRT_TUNE_STAGE_CAP,
# for GroupWalk's row source -DTRT_TUNE_WALK, for the
# XT, EXT and grid kernel A's residency bound -DTRT_TUNE_MIN_BLOCKS and for
# kernel A's thread-per-pixel loop -DTRT_TUNE_LOOP), with
# the grouped entries of the render libraries and the XT kernel A's forms
# that the sweep weighs, the EXT and grid kernel A's thread per pixel and
# the reference, EXT, XT, grid and gathered kernel A's loops
# (TUNE_ONLY_ENTRY_POINTS).
TUNE_SOURCE = "group_tune.cu"
# The define of a kernel_frame.cu build with its queue entries alone (the
# sweep of tools/group_k.py --only frame, one library a width).
QUEUE_ONLY = "TRT_TUNE_QUEUE_ONLY=1"
# The define of a group_tune.cu build with kernel A's thread-per-pixel
# loops alone (the sweep of tools/group_k.py --only regen).
LOOP_ONLY = "TRT_TUNE_LOOP_ONLY=1"
TUNE_ONLY_ENTRY_POINTS = (
    ("trt_kernel_base_xt", 8), ("trt_kernel_base_xt_min_blocks", 0),
    ("trt_kernel_base_xt_per_sm", 0), ("trt_kernel_base_xt_grouped", 9),
    ("trt_kernel_base_xt_grouped_k", 0),
    ("trt_kernel_base_xt_grouped_refill", 0),
    ("trt_kernel_base_xt_grouped_per_sm", 0), ("trt_kernel_base_grid", 9),
    ("trt_kernel_base_grid_min_blocks", 0), ("trt_kernel_base_grid_per_sm", 0),
    ("trt_kernel_base_ext", 7), ("trt_kernel_base_ext_min_blocks", 0),
    ("trt_kernel_base_ext_per_sm", 0),
    ("trt_kernel_base_ext_grouped_per_sm", 1), ("trt_kernel_base_loop", 7),
    ("trt_kernel_base_ext_loop", 8), ("trt_kernel_base_xt_loop", 9),
    ("trt_kernel_base_grid_loop", 10), ("trt_kernel_base_gathered_loop", 10),
    ("trt_kernel_base_loop_kind", 0),
    ("trt_kernel_base_loop_min_blocks", 0),
    ("trt_kernel_base_loop_per_sm", 1))
TUNE_ENTRY_POINTS = tuple(
    (name, n) for src in ("kernel_extra.cu", "kernel_accel.cu",
                          "kernel_base.cu")
    for name, n in ENTRY_POINTS[src] if "_grouped" in name
) + TUNE_ONLY_ENTRY_POINTS
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}  # sources -> their entry points


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then PATH, then /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str, defines: tuple = ()) -> Path:
    """Where the library of `source` built with `defines` (nvcc -D NAME=VALUE
    strings) lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for name in HEADERS + (source,):
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def library_paths(sources: tuple = tuple(ENTRY_POINTS)) -> dict:
    """Build every library of `sources` that is missing, one nvcc per
    source, all at once; return {source: library path}. A source may be a
    (source, defines) pair."""
    paths = {src: library_path(*_split(src)) for src in sources}
    jobs = []
    for src, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        name, defines = _split(src)
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((so, tmp, cmd, proc))
    failed = []
    for so, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def _split(src):
    """(source, defines) of a source name or (source, defines) pair."""
    return (src, ()) if isinstance(src, str) else (src[0], tuple(src[1]))


def load_kernels(sources: tuple = RENDER_SOURCES) -> SimpleNamespace:
    """The C entry points of `sources` (names, or (TUNE_SOURCE, defines)
    pairs), by name (built on first call)."""
    if sources not in _loaded:
        fns = {}
        for src, so in library_paths(sources).items():
            lib = ctypes.CDLL(str(so))
            name = _split(src)[0]
            entries = (TUNE_ENTRY_POINTS if name == TUNE_SOURCE
                       else ENTRY_POINTS[name])
            if QUEUE_ONLY in _split(src)[1]:
                entries = tuple(e for e in entries if "_queue" in e[0])
            if LOOP_ONLY in _split(src)[1]:
                entries = tuple(e for e in entries if "_loop" in e[0])
            for entry, n_ptr in entries:
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * n_ptr
                fns[entry] = fn
        _loaded[sources] = SimpleNamespace(**fns)
    return _loaded[sources]
