"""The render pipelines — ``terminal_raytracer_tpu/ops/pallas_kernel.py``
make_render_frame with its three schedulers (:func:`make_render_frame`).
The default, 'sorted', is the two-kernel pipeline of
make_sorted_render_frame:

  kernel A  base_kernel: `base` samples per pixel, with each pixel's
            variance and adaptive extra budget (csrc/kernel_base.cu); or,
            for a chunk-split tracer, base_kernel_chunked: one chunk of a
            pixel's base samples per entry of the chunk-major stream, then
            in the glue each pixel's totals in chunk order, its variance
            and its budget (the JAX package's kernel A with `cb`)
  glue      the extra phase's entries (one per pixel, or its budget split
            into chunks), sorted by descending budget with torch.sort,
            carrying each entry's id and RNG state, padded to a
            (rows_b, 512) stream
  kernel B  extra_kernel: the extra samples over the sorted stream
            (csrc/kernel_extra.cu)
  glue      unsort by index_copy_ into chunk planes, added in chunk order
            (index_add_ would add in an order that changes between runs
            on CUDA), then tracer.combine_phases

Kernel B at the reference, XT and EXT gates, over the culled sweep of
`--accel grid` and over the grid walk of `--accel gathered`, kernel A at
the reference and EXT gates, over the culled sweep and over the grid walk,
and the chunked kernel A at the reference, XT and EXT gates, over the
culled sweep and over the grid walk, take
their grouped entries (csrc/group.cuh: a path group of K lanes carries one
entry, the closest-hit and shadow sweeps split across the group, the
scene's geometry rows, and the grid's group table, staged in shared
memory) wherever those fit GROUP_SMEM_BYTES (kernel A also from
GROUP_BASE_MIN_PRIMS primitives on; takes_grouped, a decision by the
table's size alone): extra_kernel passes such a tracer on to
extra_kernel_grouped, extra_kernel_xt_grouped, extra_kernel_ext_grouped,
extra_kernel_grid_grouped or extra_kernel_gathered_grouped (csrc/group.cuh
GroupWalk: the walk's cells split over the group, at every table size),
base_kernel to base_kernel_grouped,
base_kernel_ext to base_kernel_ext_grouped,
base_kernel_grid to base_kernel_grid_grouped, base_kernel_gathered to
base_kernel_gathered_grouped (GroupWalk, every table size),
base_kernel_chunked to base_kernel_chunked_grouped, base_kernel_chunked_xt
to base_kernel_chunked_xt_grouped, base_kernel_chunked_ext to
base_kernel_chunked_ext_grouped, base_kernel_chunked_grid to
base_kernel_chunked_grid_grouped, base_kernel_chunked_gathered to
base_kernel_chunked_gathered_grouped (GroupWalk, every table size), each
counting its own launches. Kernel B
at the reference, XT and EXT gates and over the culled sweep, the chunked
kernel A at the reference, XT and EXT gates and over the culled sweep, and
kernel A over the culled sweep take their grouped entries at every table
size: above the budget
those pass the tracer on to their forms over csrc/group.cuh GroupSpill
(extra_kernel_grouped_spill, extra_kernel_xt_grouped_spill,
extra_kernel_ext_grouped_spill, base_kernel_chunked_grouped_spill,
base_kernel_chunked_xt_grouped_spill,
base_kernel_chunked_ext_grouped_spill), which stage the rows that fit
their stage cap (group_stage) and read the rest from the scene buffer
through L1, or over GroupCulledSpill (extra_kernel_grid_grouped_spill,
base_kernel_grid_grouped_spill, base_kernel_chunked_grid_grouped_spill),
which stage the group table first (culled_stage). Kernel A at the
reference and EXT gates launches its thread per pixel above the budget. The
thread-per-entry entries of every kernel stay, launched directly by
_launch_extra / _launch_chunked / _launch_base with their `kind`. Their
counters of executed lane-iterations count path slots: warp_iters(.., k)
is their plain model (kernel A on the refill schedule, whose groups take
pixels from a counter: at least the pixels' summed iterations). No build
or launch failure falls back to another entry.

The single-kernel schedulers render the whole frame in one launch
(csrc/kernel_frame.cu): kernel C, 'regen' (regen_kernel), and kernel D,
'lockstep' (lockstep_kernel), the same frame on a fixed-trip schedule with
a static occupancy denominator. Both come in the five instantiations below;
on the card each wrapper passes the tracer on to the queue entry of its
form (FRAME_QUEUE, frame_form: resident path groups over a device queue of
chunk items, csrc/group.cuh kernel_frame_queue), which counts the launch.
The thread-per-pixel entries stay, launched only directly (_launch_frame).
Their plain version is the plain whole frame (render_frame_plain);
frame_items_plain is the queue's arithmetic item by item.

Each kernel wrapper takes its plain PyTorch version (``*_plain``, built on
ops/tracer.py) when the tensors it is given lie on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its
launches in ``<wrapper>.launches``. The sort and scatter are plain torch
ops, as they are plain XLA in the JAX package.

A tracer with the material and texture extensions (``tracer.ext``) takes
the kernels' EXT instantiations (csrc/trace.cuh), which read the
extension table in the scene buffer and the tracer's texel atlas: each
wrapper passes such a tracer on to its ``*_ext`` twin, which launches the
EXT entry point and counts its own launches. A tracer with the transport
and camera extensions (``tracer.xt``, xt tables) goes on to the ``*_xt``
twin instead: the XT instantiations, which imply EXT and take the gates
and their f32 constants as one launch argument (trt::Xt, :func:`xt_args`).
The plain versions are the same for all three (ops/tracer.py renders
each).

A tracer with an opt-in traversal (``tracer.traversal``: 'grid', the
block-culled sweep, or 'gathered', the grid walk) renders from xt tables
that carry the traversal's section, and each wrapper passes it on to its
``*_grid`` or ``*_gathered`` twin: the XT instantiation of kernel A,
chunked A or B over that traversal (csrc/kernel_accel.cu; C and D in
csrc/kernel_frame.cu), with the traversal's launch
argument (trt::Accel, :func:`accel_args`). Its plain version is the
tracer's, over the traversal's plain version (ops/accel.py,
ops/gathered.py). While ``tracer.accel_stats`` holds a zeroed int64
tensor [4] on the card, those launches add their traversal counters to it
(CulledPrims.STATS, GatheredPrims.STATS).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import accel as accel_mod
from . import gathered as gathered_mod
from . import geometry as geom
from . import sampling
from . import tracer as tracer_mod
from . import vecmath as vm
from .build import load_kernels
from .vecmath import V3

TILE_H = 16  # sorted-stream rows are padded to a multiple of this
STREAM_COLS = 512  # the JAX package's (rows_b, 4 * 128) stream width


class _Frame(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("max_depth", ctypes.c_int), ("n_sph", ctypes.c_int),
                ("n_pln", ctypes.c_int), ("n_tri", ctypes.c_int),
                ("n_lights", ctypes.c_int), ("pose", ctypes.c_float * 12),
                ("half_w", ctypes.c_float), ("half_h", ctypes.c_float),
                ("inv_char_aspect", ctypes.c_float), ("w1", ctypes.c_float),
                ("h1", ctypes.c_float)]


class _BaseArgs(ctypes.Structure):
    _fields_ = [("f", _Frame), ("h_out", ctypes.c_int), ("y0", ctypes.c_int),
                ("base", ctypes.c_int), ("spp", ctypes.c_int),
                ("seed", ctypes.c_uint32), ("frame", ctypes.c_uint32),
                ("inv_base", ctypes.c_float), ("max_extra", ctypes.c_float)]


class _ExtraArgs(ctypes.Structure):
    _fields_ = [("f", _Frame), ("n_entries", ctypes.c_int)]


class _ChunkArgs(ctypes.Structure):
    _fields_ = [("f", _Frame), ("h_out", ctypes.c_int), ("y0", ctypes.c_int),
                ("base", ctypes.c_int), ("cb", ctypes.c_int),
                ("n_chunks", ctypes.c_int), ("seed", ctypes.c_uint32),
                ("frame", ctypes.c_uint32)]


class _FrameArgs(ctypes.Structure):
    _fields_ = [("f", _Frame), ("h_out", ctypes.c_int), ("y0", ctypes.c_int),
                ("base", ctypes.c_int), ("spp", ctypes.c_int),
                ("cb", ctypes.c_int), ("n_base_chunks", ctypes.c_int),
                ("ce", ctypes.c_int), ("n_extra_chunks", ctypes.c_int),
                ("seed", ctypes.c_uint32), ("frame", ctypes.c_uint32),
                ("inv_base", ctypes.c_float), ("max_extra", ctypes.c_float),
                ("inv_spp", ctypes.c_float)]


class _Tex(ctypes.Structure):
    """trt::Tex: the atlas and the scene-level texture constants."""

    _fields_ = [("atlas", ctypes.c_void_p), ("size", ctypes.c_int),
                ("rows", ctypes.c_int), ("bilinear", ctypes.c_int),
                ("tex_lo", ctypes.c_int), ("tex_hi", ctypes.c_int),
                ("nm_lo", ctypes.c_int), ("nm_hi", ctypes.c_int),
                ("sky_lo", ctypes.c_int), ("sky_intensity", ctypes.c_float)]


class _Xt(ctypes.Structure):
    """trt::Xt: the transport and camera gates and their f32 constants."""

    _fields_ = [("transport", ctypes.c_int), ("fog", ctypes.c_int),
                ("hg", ctypes.c_int), ("dof", ctypes.c_int),
                ("light_mode", ctypes.c_int),
                ("strat_g", ctypes.c_int), ("strat_shift", ctypes.c_int),
                ("base", ctypes.c_int), ("emit_fresh", ctypes.c_float),
                ("neg_sigma", ctypes.c_float),
                ("neg_inv_sigma", ctypes.c_float),
                ("albedo", ctypes.c_float * 3),
                ("iso_phase", ctypes.c_float * 3),
                ("hg_1mg2", ctypes.c_float), ("hg_1pg2", ctypes.c_float),
                ("hg_1mg", ctypes.c_float), ("hg_2g", ctypes.c_float),
                ("aperture", ctypes.c_float), ("focus", ctypes.c_float),
                ("inv_n_lights", ctypes.c_float)]


class _Accel(ctypes.Structure):
    """trt::Accel: the opt-in traversal's section and constants."""

    _fields_ = [("section", ctypes.c_int), ("n_groups", ctypes.c_int),
                ("off", ctypes.c_int), ("idx", ctypes.c_int),
                ("dims", ctypes.c_int * 3), ("max_trips", ctypes.c_int),
                ("lo", ctypes.c_float * 3), ("hi", ctypes.c_float * 3),
                ("cell", ctypes.c_float * 3), ("inv_cell", ctypes.c_float * 3),
                ("stats", ctypes.c_void_p)]


def accel_args(tracer) -> _Accel:
    """The launch argument of `tracer`'s traversal: the offset of its
    section in the scene buffer, the group count (grid) or the CSR offsets
    and the grid's constants (gathered; the f32 values of the section's
    header, read once per bound tables), and tracer.accel_stats."""
    if tracer.accel_launch is None:
        acc = tracer.tables.acc
        x = _Accel(section=acc.storage_offset())
        if tracer.traversal == "grid":
            x.n_groups = acc.numel() // accel_mod.GROUP_W
        else:
            h = gathered_mod.grid_header(acc)
            x.off = x.section + gathered_mod.HDR_W
            x.idx = x.off + h["n_cells"] + 1
            # The CSR's index count, which csrc/group.cuh GroupWalk stages.
            x.n_groups = h["nnz"]
            x.dims = (ctypes.c_int * 3)(*h["dims"])
            x.max_trips = h["max_trips"]
            for name in ("lo", "hi", "cell", "inv_cell"):
                setattr(x, name, (ctypes.c_float * 3)(*h[name]))
        tracer.accel_launch = x
    stats = tracer.accel_stats
    tracer.accel_launch.stats = None if stats is None else stats.data_ptr()
    return tracer.accel_launch


def xt_args(tracer) -> _Xt:
    """The tracer's gates and the f32 roundings of the Python-float
    constants the plain version folds (ops/tracer.py _init_gates,
    ops/sampling.py henyey_greenstein_dir / hg_phase)."""

    def f(v):
        return float(np.float32(v))

    x = _Xt(transport=tracer_mod.TRANSPORTS.index(tracer.transport),
            light_mode=("all", "uniform", "power").index(tracer.light_mode),
            strat_g=tracer.strat_g,
            strat_shift=tracer.strat_g.bit_length() - 1,
            base=tracer.base_samples, emit_fresh=tracer._emit_fresh,
            dof=int(tracer.aperture > 0.0), aperture=f(tracer.aperture),
            focus=f(tracer.focus_distance),
            inv_n_lights=f(1.0 / max(tracer.n_lights, 1)))
    if tracer.has_fog:
        g = tracer.fog_g
        x.fog, x.hg = 1, int(g != 0.0)
        x.neg_sigma, x.neg_inv_sigma = (f(tracer._neg_sigma),
                                        f(tracer._neg_inv_sigma))
        x.albedo = (ctypes.c_float * 3)(*map(f, tracer.fog_albedo))
        x.iso_phase = (ctypes.c_float * 3)(*(
            f(c * (1.0 / (4.0 * sampling.PI))) for c in tracer.fog_albedo))
        x.hg_1mg2, x.hg_1pg2 = f(1.0 - g * g), f(1.0 + g * g)
        x.hg_1mg, x.hg_2g = f(1.0 - g), f(2.0 * g)
    return x


class BaseOut(NamedTuple):
    """Kernel A's per-pixel planes ([h_out, w]) and its executed
    lane-iterations (0-dim f64 tensor, the occupancy denominator)."""

    csum: V3
    csumsq: V3
    state: torch.Tensor  # int64 holding the u32 end state
    rays: torch.Tensor
    var: torch.Tensor
    additional: torch.Tensor
    iters: torch.Tensor


class ChunkedBaseOut(NamedTuple):
    """The chunked kernel A's per-entry planes ([n_chunks, h_out, w], entry
    (c, y, x) = chunk c of pixel (x, y)) and its executed lane-iterations."""

    csum: V3
    csumsq: V3
    state: torch.Tensor  # int64 holding the u32 end state
    rays: torch.Tensor
    iters: torch.Tensor


class FrameOut(NamedTuple):
    """Kernel C's or D's per-pixel planes ([h_out, w]) and its executed
    lane-iterations (0-dim f64 tensor, the occupancy denominator)."""

    current: V3
    var: torch.Tensor
    total: torch.Tensor
    rays: torch.Tensor
    iters: torch.Tensor


def _frame(tracer: tracer_mod.PathTracer, pose) -> _Frame:
    n_sph, n_pln, n_tri, n_lights = tracer.tables.counts
    pose = np.asarray(pose, np.float32)
    return _Frame(tracer.width, tracer.height, tracer.max_depth, n_sph,
                  n_pln, n_tri, n_lights,
                  (ctypes.c_float * 12)(*pose[:12].tolist()),
                  tracer.half_width, tracer.half_height,
                  tracer.inv_char_aspect, float(tracer.width - 1),
                  float(tracer.height - 1))


def _tex(tracer: tracer_mod.PathTracer) -> _Tex:
    return _Tex(tracer.atlas.data_ptr(), tracer.tex_size, tracer.tex_rows,
                int(tracer.tex_bilinear), tracer.tex_lo, tracer.tex_hi,
                tracer.nm_lo, tracer.nm_hi, tracer.sky_lo,
                tracer.sky_intensity)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _iters_tensor(n, device) -> torch.Tensor:
    return torch.tensor(float(n), dtype=torch.float64, device=device)


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------


def _on_cuda(device: torch.device, name: str) -> bool:
    """False for the CPU (the plain version runs), True for CUDA."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device.type == "cuda"


def _require_ext(tracer, name: str) -> None:
    if not tracer.ext or tracer.xt:
        raise ValueError(f"{name}: the tracer has no extension table, or has "
                         "xt tables")


def _require_xt(tracer, name: str) -> None:
    if not tracer.xt or tracer.traversal:
        raise ValueError(f"{name}: the tracer has no xt tables, or an opt-in "
                         "traversal")


def _require_traversal(tracer, traversal: str, name: str) -> None:
    if tracer.traversal != traversal:
        raise ValueError(f"{name}: the tracer's traversal is "
                         f"{tracer.traversal}, not {traversal!r}")


# The shared-memory budget of the grouped kernels' staged rows (bytes;
# csrc/group.cuh GROUP_SMEM_BYTES): a scene whose spheres, planes and
# triangles take more takes the thread-per-entry kernels.
GROUP_SMEM_BYTES = 96 * 1024


def group_rows_bytes(tracer) -> int:
    """The bytes of `tracer`'s geometry rows that the grouped kernels stage
    in shared memory."""
    n_sph, n_pln, n_tri, _ = tracer.tables.counts
    return 4 * (geom.SPH_W * n_sph + geom.PLN_W * n_pln
                + geom.TRI_W * n_tri)


def group_smem_bytes(tracer) -> int:
    """The bytes a grouped kernel stages for `tracer` (csrc/group.cuh
    smem_floats): the geometry rows, and under `--accel grid` the group
    table after them."""
    extra = tracer.tables.acc.numel() if tracer.traversal == "grid" else 0
    return group_rows_bytes(tracer) + 4 * extra


# The most dynamic shared memory a block may take on the H100, the 227 KB
# opt-in limit (csrc/group.cuh GROUP_SMEM_MAX): the bound of the stage cap
# of the grouped forms for any table size (GroupSpill).
GROUP_SMEM_MAX = 232448
# The words of a triangle row that a sweep reads, v0, e1 and e2 (csrc/
# group.cuh TRI_SWEEP_W): what GroupSpill stages.
TRI_SWEEP_W = 9


def group_stage(n_sph: int, n_pln: int, n_tri: int, cap: int) -> tuple:
    """(triangles, spheres, planes) that GroupSpill stages in shared
    memory under a stage cap of `cap` bytes (csrc/group.cuh group_stage):
    as many rows of each kind as fit, triangles first (TRI_SWEEP_W words a
    row), then spheres, then planes. The rest of each kind is read through
    L1."""
    left = cap // 4
    t = min(n_tri, left // TRI_SWEEP_W)
    left -= TRI_SWEEP_W * t
    s = min(n_sph, left // geom.SPH_W)
    left -= geom.SPH_W * s
    return t, s, min(n_pln, left // geom.PLN_W)


def stage_bytes(staged: tuple) -> int:
    """The shared memory of group_stage's staged rows (bytes)."""
    t, s, p = staged
    return 4 * (TRI_SWEEP_W * t + geom.SPH_W * s + geom.PLN_W * p)


def culled_stage(n_groups: int, n_sph: int, n_pln: int, n_tri: int,
                 cap: int) -> tuple:
    """(groups, triangles, spheres, planes) that GroupCulledSpill stages in
    shared memory under a stage cap of `cap` bytes (csrc/group.cuh
    culled_stage): the group table first, as many groups as fit, then
    group_stage's rows under the rest of the cap. The rest of the table and
    of each kind is read through L1."""
    g = min(n_groups, cap // 4 // accel_mod.GROUP_W)
    return (g, *group_stage(n_sph, n_pln, n_tri,
                            cap - 4 * accel_mod.GROUP_W * g))


def culled_stage_bytes(staged: tuple) -> int:
    """The shared memory of culled_stage's staged groups and rows
    (bytes)."""
    return 4 * accel_mod.GROUP_W * staged[0] + stage_bytes(staged[1:])


def grid_counts(tracer) -> tuple:
    """(groups, spheres, planes, triangles) of a `--accel grid` tracer's
    blocked scene: culled_stage's first four arguments."""
    n_sph, n_pln, n_tri, _ = tracer.tables.counts
    return (tracer.tables.acc.numel() // accel_mod.GROUP_W, n_sph, n_pln,
            n_tri)


# The least primitives at which kernel A takes its grouped entry: below it
# a bounce's sweeps are too short to split over the group and the thread
# per pixel is faster. tools/group_k.py on the H100 (PERF.md): Cornell_Box
# (11 primitives) 0.96 ms thread per pixel against 3.6 at K = 32 at the
# north star, 0.19 against 0.74 at 200x100 (2.5 against 10.1 under grid);
# demo (21 primitives) 0.19 against 0.15 at 200x100. At the EXT gates the
# five packaged extension scenes (4-12 primitives) keep the thread per
# pixel too: no grouped or bound form beat its summed time there (2.64 ms;
# tools/group_k.py --only ext, PERF.md). The scene's count, not the rows
# staged: the grid's blocked scene pads each block to 8.
GROUP_BASE_MIN_PRIMS = 16


# The instantiations whose grouped entry serves every table size (its
# GroupSpill or GroupCulledSpill form above GROUP_SMEM_BYTES; the walk
# stages no rows), by kernel.
ANY_SIZE = {"extra": ("ref", "xt", "ext", "grid", "gathered"),
            "chunked": ("ref", "xt", "ext", "grid", "gathered"),
            "base": ("grid", "gathered")}


def takes_grouped(tracer, kernel: str = "extra") -> bool:
    """Whether kernel B ('extra'), kernel A ('base') or the chunked kernel
    A ('chunked') takes its grouped entry for `tracer`: an instantiation
    with one (B: GROUPED_EXTRA; A: GROUPED_BASE; chunked A:
    GROUPED_CHUNKED), at any table size for the ANY_SIZE ones, else with
    what it stages within GROUP_SMEM_BYTES (and kernel A's scene at least
    GROUP_BASE_MIN_PRIMS primitives). A dispatch by the table's size
    alone."""
    kinds = {"extra": GROUPED_EXTRA, "base": GROUPED_BASE,
             "chunked": GROUPED_CHUNKED}[kernel]
    if (kernel == "base"
            and tracer.scene.primitive_count < GROUP_BASE_MIN_PRIMS):
        return False
    kind = _kind(tracer)
    return kind in kinds and (kind in ANY_SIZE[kernel]
                              or group_smem_bytes(tracer) <= GROUP_SMEM_BYTES)


def _over_budget(tracer) -> bool:
    return group_smem_bytes(tracer) > GROUP_SMEM_BYTES


def _require_grouped(tracer, name: str, kind: str = "ref",
                     any_size: bool = False) -> None:
    """Refuse a tracer of another instantiation than `kind`, or (unless
    `any_size`) one whose staged rows exceed GROUP_SMEM_BYTES."""
    if _kind(tracer) != kind:
        raise ValueError(f"{name}: the tracer takes the {_kind(tracer)!r} "
                         "instantiation")
    if not any_size and _over_budget(tracer):
        raise ValueError(f"{name}: the scene's rows take "
                         f"{group_smem_bytes(tracer)} bytes, over the "
                         f"{GROUP_SMEM_BYTES} of shared memory the grouped "
                         "kernels stage")


_GROUPED_ENTRIES = {"extra": "trt_kernel_extra_grouped",
                    "extra_xt": "trt_kernel_extra_xt_grouped",
                    "extra_grid": "trt_kernel_extra_grid_grouped",
                    "extra_ext": "trt_kernel_extra_ext_grouped",
                    "extra_ext_spill": "trt_kernel_extra_ext_grouped_spill",
                    "extra_gathered": "trt_kernel_extra_gathered_grouped",
                    "chunked": "trt_kernel_base_chunked_grouped",
                    "base": "trt_kernel_base_grouped",
                    "base_ext": "trt_kernel_base_ext_grouped",
                    "base_grid": "trt_kernel_base_grid_grouped",
                    "base_gathered": "trt_kernel_base_gathered_grouped",
                    "extra_grid_spill": "trt_kernel_extra_grid_grouped_spill",
                    "base_grid_spill": "trt_kernel_base_grid_grouped_spill",
                    "extra_spill": "trt_kernel_extra_grouped_spill",
                    "extra_xt_spill": "trt_kernel_extra_xt_grouped_spill",
                    "chunked_spill": "trt_kernel_base_chunked_grouped_spill",
                    "chunked_xt": "trt_kernel_base_chunked_xt_grouped",
                    "chunked_xt_spill":
                        "trt_kernel_base_chunked_xt_grouped_spill",
                    "chunked_ext": "trt_kernel_base_chunked_ext_grouped",
                    "chunked_ext_spill":
                        "trt_kernel_base_chunked_ext_grouped_spill",
                    "chunked_grid": "trt_kernel_base_chunked_grid_grouped",
                    "chunked_grid_spill":
                        "trt_kernel_base_chunked_grid_grouped_spill",
                    "chunked_gathered":
                        "trt_kernel_base_chunked_gathered_grouped"}


def group_k(kernel: str, lib=None) -> int:
    """The group width K (lanes an entry) that the grouped `kernel` (a key
    of _GROUPED_ENTRIES: 'extra', 'extra_xt', 'extra_ext', 'extra_grid',
    'extra_gathered', 'chunked', 'chunked_xt', 'chunked_ext',
    'chunked_grid', 'chunked_gathered', 'base', 'base_ext', 'base_grid',
    'base_gathered' or a '*_spill' form) of `lib` (default the render
    libraries) was built with (on the card)."""
    lib = lib or load_kernels()
    return int(getattr(lib, _GROUPED_ENTRIES[kernel] + "_k")())


def group_cap(kernel: str, lib=None) -> int:
    """The stage cap (bytes) of the GroupSpill form `kernel`
    ('extra_spill', 'extra_xt_spill', 'extra_ext_spill', 'chunked_spill',
    'chunked_xt_spill' or 'chunked_ext_spill'; group_stage's `cap`) or of
    the GroupCulledSpill form ('extra_grid_spill', 'base_grid_spill',
    'chunked_grid_spill'; culled_stage's) of `lib` (default the render
    libraries; on the card)."""
    lib = lib or load_kernels()
    return int(getattr(lib, _GROUPED_ENTRIES[kernel] + "_cap")())


def group_refill(kernel: str, lib=None) -> bool:
    """Whether the grouped kernel A `kernel` ('base', 'base_ext',
    'base_grid', 'base_grid_spill' or 'base_gathered') of
    `lib` (default the render libraries) runs the refill schedule (the
    resident groups take pixels from a counter), not the static one (on the
    card)."""
    lib = lib or load_kernels()
    return bool(getattr(lib, _GROUPED_ENTRIES[kernel] + "_refill")())


def _inst_args(tracer, inst: str) -> tuple:
    """The launch arguments after the main one of instantiation `inst`:
    the texture constants, the gates, the traversal's argument."""
    extra = ()
    if inst != "ref":
        extra = (ctypes.byref(_tex(tracer)),)
    if inst not in ("ref", "ext"):
        extra += (ctypes.byref(xt_args(tracer)),)
    if inst in ("grid", "gathered"):
        extra += (ctypes.byref(accel_args(tracer)),)
    return extra


def _launch(lib, entry: str, args, tracer, kind: str, ptrs) -> None:
    """Call the C entry point `entry` (+ '_ext', '_xt', '_grid',
    '_gathered', '_grouped', '_xt_grouped', '_ext_grouped',
    '_grid_grouped', '_gathered_grouped', '_grouped_spill',
    '_xt_grouped_spill', '_ext_grouped_spill' or '_grid_grouped_spill' by
    `kind`; kernel A also '_nested', '_ext_nested', '_xt_nested',
    '_grid_nested', '_gathered_nested', and from csrc/group_tune.cu '_loop',
    '_ext_loop', '_xt_loop', '_grid_loop', '_gathered_loop') with its
    launch arguments and raise on a launch error."""
    name = entry if kind == "ref" else f"{entry}_{kind}"
    inst = (kind.removesuffix("_spill").removesuffix("grouped")
            .removesuffix("nested").removesuffix("loop")
            .removesuffix("_") or "ref")
    _check(getattr(lib, name)(ctypes.byref(args), *_inst_args(tracer, inst),
                              *ptrs), name.replace("trt_", ""))


def _base_quota(tracer, base_q, name: str) -> int:
    """Kernel A's quota: `base_q`, a runtime share in [0, base_samples],
    or the tracer's base_samples."""
    if base_q is None:
        return tracer.base_samples
    if not 0 <= int(base_q) <= tracer.base_samples:
        raise ValueError(f"{name}: base_q={base_q} outside [0, "
                         f"{tracer.base_samples}]")
    return int(base_q)


def base_kernel_plain(tracer, pose, seed: int, frame_number: int, y0: int = 0,
                      h_out: int = None, base_q: int = None) -> BaseOut:
    """Kernel A in plain PyTorch (any device)."""
    q = _base_quota(tracer, base_q, "base_kernel_plain")
    cam = tracer_mod.cam_from_pose(pose)
    x, y = tracer.pixel_grid(y0, h_out)
    state, csum, csumsq, rays, it = tracer.base_phase(
        cam, x.to(torch.float32), y.to(torch.float32),
        tracer.seed_lanes(x, y, seed, frame_number), quota=q)
    var = tracer.variance_of(csum, csumsq, q)
    if q < tracer.spp:
        additional = tracer.extra_quota(var, q)[1]
    else:
        additional = torch.zeros_like(var)
    return BaseOut(csum, csumsq, state, rays, var, additional,
                   _iters_tensor(it, var.device))


def _no_chunks(tracer, name: str) -> None:
    if tracer.chunk_base:
        raise ValueError(f"{name}: the tracer splits pixels into chunks; "
                         "use base_kernel_chunked")


def _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                 kind: str, lib=None) -> BaseOut:
    """Launch kernel A's `kind` instantiation (the grouped entries for
    'grouped', 'ext_grouped', 'grid_grouped', 'grid_grouped_spill',
    'gathered_grouped', and csrc/group_tune.cu's thread-per-pixel loops
    'loop', 'ext_loop', 'xt_loop', 'grid_loop', 'gathered_loop', which also
    take a zeroed pixel counter; the nested twins of the thread per pixel
    'nested', 'ext_nested', 'xt_nested', 'grid_nested', 'gathered_nested'),
    from `lib` (default the render libraries). Its quota (BaseArgs.base),
    and with it the epilogue's 1 / base and budget cap, is the runtime
    share `base_q` where one is given (counted in
    base_kernel.quota_launches), else the tracer's base_samples."""
    device = tracer.tables.buf.device
    h_out = tracer.height if h_out is None else h_out
    w, spp = tracer.width, tracer.spp
    base = _base_quota(tracer, base_q, "base_kernel")
    n = h_out * w
    out = torch.empty((9, n), dtype=torch.float32, device=device)
    state = torch.empty((n,), dtype=torch.int64, device=device)
    # [0]: the executed lane-iterations; [1]: the grouped entries' pixel
    # counter (its low 4 bytes, a u32), zeroed with it.
    iters = torch.zeros((2,), dtype=torch.int64, device=device)
    args = _BaseArgs(_frame(tracer, pose), h_out, y0, base, spp,
                     seed & 0xFFFFFFFF, frame_number & 0xFFFFFFFF,
                     float(np.float32(1.0 / base)) if base else 0.0,
                     float(max(spp - base, 0)))
    counter = ((iters.data_ptr() + iters.element_size(),)
               if "grouped" in kind or kind.endswith("loop") else ())
    ptrs = (tracer.tables.buf.data_ptr(), out.data_ptr(), state.data_ptr(),
            iters.data_ptr(), *counter, _stream(device))
    _launch(lib or load_kernels(), "trt_kernel_base", args, tracer, kind,
            ptrs)
    if base_q is not None:
        base_kernel.quota_launches += 1
    p = out.view(9, h_out, w)
    return BaseOut(V3(p[0], p[1], p[2]), V3(p[3], p[4], p[5]),
                   state.view(h_out, w), p[6], p[7], p[8],
                   iters[0].to(torch.float64))


def base_kernel(tracer, pose, seed: int, frame_number: int, y0: int = 0,
                h_out: int = None, base_q: int = None) -> BaseOut:
    """Kernel A for rows [y0, y0 + h_out) of `tracer`'s image, on the
    device of `tracer`'s scene tables (base_kernel_ext for a tracer with
    the material and texture extensions, base_kernel_xt for one with xt
    tables, base_kernel_grid / _gathered for one with that traversal; the
    grouped entry base_kernel_grouped where takes_grouped(tracer, 'base')).
    `base_q`: a runtime base quota of at most tracer.base_samples (a
    sample-split shard's share, parallel/mesh.py), else base_samples."""
    _no_chunks(tracer, "base_kernel")
    args = (tracer, pose, seed, frame_number, y0, h_out, base_q)
    if not _on_cuda(tracer.tables.buf.device, "base_kernel"):
        return base_kernel_plain(*args)
    if tracer.traversal == "grid":
        return base_kernel_grid(*args)
    if tracer.traversal == "gathered":
        return base_kernel_gathered(*args)
    if tracer.xt:
        return base_kernel_xt(*args)
    if tracer.ext:
        return base_kernel_ext(*args)
    if takes_grouped(tracer, "base"):
        return base_kernel_grouped(*args)
    out = _launch_base(*args, "ref")
    base_kernel.launches += 1
    return out


def base_kernel_grouped(tracer, pose, seed: int, frame_number: int,
                        y0: int = 0, h_out: int = None,
                        base_q: int = None) -> BaseOut:
    """Kernel A's grouped entry (csrc/group.cuh kernel_base_grouped): a
    path group of group_k('base') lanes a pixel, its sweeps split across
    the group over the scene's rows in shared memory, on the schedule
    group_refill('base'). For a tracer of the reference gates and the table
    sweep whose rows fit GROUP_SMEM_BYTES; base_kernel takes it for such a
    tracer of at least GROUP_BASE_MIN_PRIMS primitives (takes_grouped)."""
    _require_grouped(tracer, "base_kernel_grouped")
    _no_chunks(tracer, "base_kernel_grouped")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_grouped"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "grouped")
    base_kernel_grouped.launches += 1
    return out


def base_kernel_ext(tracer, pose, seed: int, frame_number: int,
                    y0: int = 0, h_out: int = None,
                    base_q: int = None) -> BaseOut:
    """Kernel A's EXT instantiation: base_kernel for a tracer with the
    material and texture extensions; the grouped entry
    base_kernel_ext_grouped where takes_grouped(tracer, 'base'), else the
    thread per pixel."""
    _require_ext(tracer, "base_kernel_ext")
    _no_chunks(tracer, "base_kernel_ext")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_ext"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    if takes_grouped(tracer, "base"):
        return base_kernel_ext_grouped(tracer, pose, seed, frame_number, y0,
                                       h_out, base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "ext")
    base_kernel_ext.launches += 1
    return out


def base_kernel_ext_grouped(tracer, pose, seed: int, frame_number: int,
                            y0: int = 0, h_out: int = None,
                            base_q: int = None) -> BaseOut:
    """Kernel A's grouped entry at the EXT gates (csrc/group.cuh
    kernel_base_grouped over GroupSweep): group_k('base_ext') lanes a pixel
    on the schedule group_refill('base_ext'), as base_kernel_grouped. For
    an EXT tracer over the table sweep whose rows fit GROUP_SMEM_BYTES;
    base_kernel_ext takes it for such a tracer of at least
    GROUP_BASE_MIN_PRIMS primitives (takes_grouped)."""
    _require_grouped(tracer, "base_kernel_ext_grouped", "ext")
    _no_chunks(tracer, "base_kernel_ext_grouped")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_ext_grouped"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "ext_grouped")
    base_kernel_ext_grouped.launches += 1
    return out


def base_kernel_xt(tracer, pose, seed: int, frame_number: int,
                   y0: int = 0, h_out: int = None,
                   base_q: int = None) -> BaseOut:
    """Kernel A's XT instantiation: base_kernel for a tracer with xt
    tables (the transport and camera extensions, and EXT's); the thread per
    pixel on the regeneration schedule (trt_kernel_base_xt)."""
    _require_xt(tracer, "base_kernel_xt")
    _no_chunks(tracer, "base_kernel_xt")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_xt"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "xt")
    base_kernel_xt.launches += 1
    return out


def base_kernel_grid(tracer, pose, seed: int, frame_number: int,
                     y0: int = 0, h_out: int = None,
                     base_q: int = None) -> BaseOut:
    """Kernel A over the block-culled sweep: base_kernel for a tracer with
    accel 'grid' (XT instantiation); the grouped entry
    base_kernel_grid_grouped where takes_grouped(tracer, 'base'), else the
    thread per pixel on the regeneration schedule (trt_kernel_base_grid)."""
    _require_traversal(tracer, "grid", "base_kernel_grid")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_grid"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    if takes_grouped(tracer, "base"):
        return base_kernel_grid_grouped(tracer, pose, seed, frame_number, y0,
                                        h_out, base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "grid")
    base_kernel_grid.launches += 1
    return out


def base_kernel_grid_grouped(tracer, pose, seed: int, frame_number: int,
                             y0: int = 0, h_out: int = None,
                             base_q: int = None) -> BaseOut:
    """Kernel A's grouped entry over the culled sweep (csrc/group.cuh
    kernel_base_grouped over GroupCulled, XT instantiation):
    group_k('base_grid') lanes a pixel on the schedule
    group_refill('base_grid'), the serial cull decisions replayed across
    the group, the traversal counters the plain version's. For a `--accel
    grid` tracer; base_kernel_grid takes it for such a tracer of at least
    GROUP_BASE_MIN_PRIMS primitives (takes_grouped). Rows and group table
    over GROUP_SMEM_BYTES go on to base_kernel_grid_grouped_spill."""
    _require_grouped(tracer, "base_kernel_grid_grouped", "grid",
                     any_size=True)
    _no_chunks(tracer, "base_kernel_grid_grouped")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_grid_grouped"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    if _over_budget(tracer):
        return base_kernel_grid_grouped_spill(tracer, pose, seed,
                                              frame_number, y0, h_out, base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "grid_grouped")
    base_kernel_grid_grouped.launches += 1
    return out


def base_kernel_grid_grouped_spill(tracer, pose, seed: int,
                                   frame_number: int, y0: int = 0,
                                   h_out: int = None,
                                   base_q: int = None) -> BaseOut:
    """Kernel A's grouped form over the culled sweep for any table size
    (csrc/group.cuh GroupCulledSpill): group_k('base_grid_spill') lanes a
    pixel on the schedule group_refill('base_grid_spill'), the group table
    and then the rows that fit group_cap('base_grid_spill') staged
    (culled_stage), the rest read through L1; the decisions, hits and
    counters those of base_kernel_grid_grouped. For a `--accel grid`
    tracer; base_kernel_grid_grouped takes it where the rows and group
    table exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "base_kernel_grid_grouped_spill", "grid",
                     any_size=True)
    _no_chunks(tracer, "base_kernel_grid_grouped_spill")
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_grid_grouped_spill"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "grid_grouped_spill")
    base_kernel_grid_grouped_spill.launches += 1
    return out


def base_kernel_gathered(tracer, pose, seed: int, frame_number: int,
                         y0: int = 0, h_out: int = None,
                         base_q: int = None) -> BaseOut:
    """Kernel A over the grid walk: base_kernel for a tracer with accel
    'gathered' (XT instantiation); the grouped entry
    base_kernel_gathered_grouped where takes_grouped(tracer, 'base'), else
    the thread per pixel on the regeneration schedule
    (trt_kernel_base_gathered)."""
    _require_traversal(tracer, "gathered", "base_kernel_gathered")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_gathered"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    if takes_grouped(tracer, "base"):
        return base_kernel_gathered_grouped(tracer, pose, seed, frame_number,
                                            y0, h_out, base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "gathered")
    base_kernel_gathered.launches += 1
    return out


def base_kernel_gathered_grouped(tracer, pose, seed: int, frame_number: int,
                                 y0: int = 0, h_out: int = None,
                                 base_q: int = None) -> BaseOut:
    """Kernel A's grouped entry over the grid walk (csrc/group.cuh
    kernel_base_grouped over GroupWalk, XT instantiation):
    group_k('base_gathered') lanes a pixel on the schedule
    group_refill('base_gathered'), each cell's bucket split across the
    group, the traversal counters the plain version's. For an `--accel
    gathered` tracer of any table size; base_kernel_gathered takes it for
    such a tracer of at least GROUP_BASE_MIN_PRIMS primitives
    (takes_grouped)."""
    _require_grouped(tracer, "base_kernel_gathered_grouped", "gathered",
                     any_size=True)
    _no_chunks(tracer, "base_kernel_gathered_grouped")
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_gathered_grouped"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "gathered_grouped")
    base_kernel_gathered_grouped.launches += 1
    return out


def base_kernel_nested(tracer, pose, seed: int, frame_number: int,
                       y0: int = 0, h_out: int = None,
                       base_q: int = None) -> BaseOut:
    """Kernel A's thread per pixel with the nested sample and bounce loops
    (trt_kernel_base_nested, csrc/trace.cuh run_samples), which the
    regeneration schedule of trt_kernel_base replaced: the same outputs bit
    for bit. No dispatch takes it; chip_smoke.py launches it to hold and
    time the shipped entry against it."""
    if _kind(tracer) != "ref":
        raise ValueError("base_kernel_nested: the tracer takes the "
                         f"{_kind(tracer)!r} instantiation")
    _no_chunks(tracer, "base_kernel_nested")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_nested"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "nested")
    base_kernel_nested.launches += 1
    return out


def base_kernel_ext_nested(tracer, pose, seed: int, frame_number: int,
                           y0: int = 0, h_out: int = None,
                           base_q: int = None) -> BaseOut:
    """base_kernel_nested at the EXT gates (trt_kernel_base_ext_nested),
    the nested twin of base_kernel_ext's thread per pixel."""
    _require_ext(tracer, "base_kernel_ext_nested")
    _no_chunks(tracer, "base_kernel_ext_nested")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_ext_nested"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "ext_nested")
    base_kernel_ext_nested.launches += 1
    return out


def base_kernel_xt_nested(tracer, pose, seed: int, frame_number: int,
                          y0: int = 0, h_out: int = None,
                          base_q: int = None) -> BaseOut:
    """base_kernel_nested at the XT gates (trt_kernel_base_xt_nested),
    the nested twin of base_kernel_xt's thread per pixel: the same outputs
    bit for bit at max_depth >= 1 (at max_depth 0 its paths bounce none,
    where the plain version and the shipped entry bounce each once)."""
    _require_xt(tracer, "base_kernel_xt_nested")
    _no_chunks(tracer, "base_kernel_xt_nested")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_xt_nested"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "xt_nested")
    base_kernel_xt_nested.launches += 1
    return out


def base_kernel_grid_nested(tracer, pose, seed: int, frame_number: int,
                            y0: int = 0, h_out: int = None,
                            base_q: int = None) -> BaseOut:
    """base_kernel_nested over the culled sweep
    (trt_kernel_base_grid_nested), the nested twin of base_kernel_grid's
    thread per pixel: the same outputs and traversal counters bit for bit
    at max_depth >= 1 (at max_depth 0 its paths bounce none, where the
    plain version and the shipped entry bounce each once)."""
    _require_traversal(tracer, "grid", "base_kernel_grid_nested")
    _no_chunks(tracer, "base_kernel_grid_nested")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_grid_nested"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "grid_nested")
    base_kernel_grid_nested.launches += 1
    return out


def base_kernel_gathered_nested(tracer, pose, seed: int, frame_number: int,
                                y0: int = 0, h_out: int = None,
                                base_q: int = None) -> BaseOut:
    """base_kernel_nested over the grid walk
    (trt_kernel_base_gathered_nested), the nested twin of
    base_kernel_gathered's thread per pixel: the same outputs and
    traversal counters bit for bit at max_depth >= 1 (at max_depth 0 its
    paths bounce none, where the plain version and the shipped entry bounce
    each once)."""
    _require_traversal(tracer, "gathered", "base_kernel_gathered_nested")
    _no_chunks(tracer, "base_kernel_gathered_nested")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_gathered_nested"):
        return base_kernel_plain(tracer, pose, seed, frame_number, y0, h_out,
                                 base_q)
    out = _launch_base(tracer, pose, seed, frame_number, y0, h_out, base_q,
                       "gathered_nested")
    base_kernel_gathered_nested.launches += 1
    return out


base_kernel.launches = 0
base_kernel.quota_launches = 0  # launches of any instantiation with a base_q
base_kernel_nested.launches = 0
base_kernel_ext_nested.launches = 0
base_kernel_xt_nested.launches = 0
base_kernel_grid_nested.launches = 0
base_kernel_gathered_nested.launches = 0
base_kernel_grouped.launches = 0
base_kernel_ext.launches = 0
base_kernel_ext_grouped.launches = 0
base_kernel_xt.launches = 0
base_kernel_grid.launches = 0
base_kernel_grid_grouped.launches = 0
base_kernel_grid_grouped_spill.launches = 0
base_kernel_gathered.launches = 0
base_kernel_gathered_grouped.launches = 0

# The grouped kernel A of each instantiation that has one.
GROUPED_BASE = {"ref": base_kernel_grouped, "ext": base_kernel_ext_grouped,
                "grid": base_kernel_grid_grouped,
                "gathered": base_kernel_gathered_grouped}


def base_entry_iters(tracer, pose, seed: int, frame_number: int, y0: int = 0,
                     h_out: int = None, base_q: int = None) -> torch.Tensor:
    """Kernel A's bounce iterations per pixel (int64 [h_out, w]), from its
    plain version's scheduler: the iterations each pixel's thread or path
    group runs. warp_iters of them is the thread-per-pixel (both loops) and
    the static grouped kernels' counter, and the count that the thread per
    pixel executes on the regeneration schedule; the refill schedule's
    counter is at least their sum."""
    q = _base_quota(tracer, base_q, "base_entry_iters")
    cam = tracer_mod.cam_from_pose(pose)
    x, y = tracer.pixel_grid(y0, h_out)
    carry, _ = tracer._base_run(cam, x.to(torch.float32),
                                y.to(torch.float32),
                                tracer.seed_lanes(x, y, seed, frame_number),
                                quota=q)
    return carry.iters


def base_sample_iters(tracer, pose, seed: int, frame_number: int,
                      y0: int = 0, h_out: int = None,
                      base_q: int = None) -> torch.Tensor:
    """Kernel A's bounce iterations per sample and pixel (int64 [quota,
    h_out, w]; quota base_q, else base_samples), from its plain version's
    scheduler: row s holds each pixel's bounces of its sample s. Summed
    over samples, base_entry_iters; nested_iters of it is the count that
    the nested sample and bounce loops execute."""
    q = _base_quota(tracer, base_q, "base_sample_iters")
    cam = tracer_mod.cam_from_pose(pose)
    x, y = tracer.pixel_grid(y0, h_out)
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    c = tracer.regen_carry0(tracer.seed_lanes(x, y, seed, frame_number),
                            torch.zeros_like(x),
                            torch.full_like(xf, float(q)))
    out = torch.zeros((q, *x.shape), dtype=torch.int64, device=x.device)
    for _ in range((tracer.spp + 1) * tracer.max_depth + 4):  # run_regen's
        if not bool((c.alive | (c.samp < q)).any()):
            break
        nxt = tracer.regen_step(cam, xf, yf, c)
        # A lane runs sample c.samp in this step (it advances on the path's
        # end, after the bounce).
        ran = nxt.iters - c.iters
        out.scatter_add_(0, c.samp.clamp(max=max(q - 1, 0)).unsqueeze(0),
                         ran.unsqueeze(0))
        c = nxt
    return out


def base_kernel_chunked_plain(tracer, pose, seed: int, frame_number: int,
                              y0: int = 0, h_out: int = None
                              ) -> ChunkedBaseOut:
    """The chunked kernel A in plain PyTorch (any device)."""
    cam = tracer_mod.cam_from_pose(pose)
    x, y, c = tracer.base_entries(y0, h_out)
    state, csum, csumsq, rays, it = tracer.base_phase(
        cam, x.to(torch.float32), y.to(torch.float32),
        tracer.seed_lanes(x, y, seed, frame_number), c)
    return ChunkedBaseOut(csum, csumsq, state, rays,
                          _iters_tensor(it, rays.device))


def chunked_entry_iters(tracer, pose, seed: int, frame_number: int,
                        y0: int = 0, h_out: int = None) -> torch.Tensor:
    """The chunked kernel A's bounce iterations per entry (int64 [n_chunks,
    h_out, w]), from its plain version's scheduler (extra_entry_iters)."""
    cam = tracer_mod.cam_from_pose(pose)
    x, y, c = tracer.base_entries(y0, h_out)
    carry, _ = tracer._base_run(cam, x.to(torch.float32),
                                y.to(torch.float32),
                                tracer.seed_lanes(x, y, seed, frame_number), c)
    return carry.iters


def _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                    kind: str, lib=None) -> ChunkedBaseOut:
    """Launch the chunked kernel A's `kind` instantiation (the grouped
    entries for 'grouped', 'xt_grouped', 'ext_grouped', 'grid_grouped',
    their '_spill' forms and 'gathered_grouped'), from
    `lib` (default the render libraries)."""
    device = tracer.tables.buf.device
    h_out = tracer.height if h_out is None else h_out
    n_chunks, w = tracer.n_base_chunks, tracer.width
    n = n_chunks * h_out * w
    out = torch.empty((7, n), dtype=torch.float32, device=device)
    state = torch.empty((n,), dtype=torch.int64, device=device)
    iters = torch.zeros((1,), dtype=torch.int64, device=device)
    args = _ChunkArgs(_frame(tracer, pose), h_out, y0, tracer.base_samples,
                      tracer.chunk_base or tracer.base_samples, n_chunks,
                      seed & 0xFFFFFFFF, frame_number & 0xFFFFFFFF)
    ptrs = (tracer.tables.buf.data_ptr(), out.data_ptr(), state.data_ptr(),
            iters.data_ptr(), _stream(device))
    _launch(lib or load_kernels(), "trt_kernel_base_chunked", args, tracer,
            kind, ptrs)
    p = out.view(7, n_chunks, h_out, w)
    return ChunkedBaseOut(V3(p[0], p[1], p[2]), V3(p[3], p[4], p[5]),
                          state.view(n_chunks, h_out, w), p[6],
                          iters[0].to(torch.float64))


def base_kernel_chunked(tracer, pose, seed: int, frame_number: int,
                        y0: int = 0, h_out: int = None) -> ChunkedBaseOut:
    """Kernel A over the chunk-major stream of rows [y0, y0 + h_out): entry
    (c, y, x) renders samples [c * cb, min((c + 1) * cb, base)) of pixel
    (x, y) on the sub-chain seed + c * CHUNK_GOLDEN (an unchunked tracer
    has one chunk of `base` samples). No budget epilogue: the variance
    needs the per-pixel totals. base_kernel_chunked_ext / _xt for a tracer
    with the extensions, base_kernel_chunked_grid / _gathered for one with
    that traversal; the grouped entries (base_kernel_chunked_grouped,
    base_kernel_chunked_xt_grouped, base_kernel_chunked_ext_grouped,
    base_kernel_chunked_grid_grouped, base_kernel_chunked_gathered_grouped)
    where takes_grouped(tracer, 'chunked')."""
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_chunked"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if tracer.traversal == "grid":
        return base_kernel_chunked_grid(tracer, pose, seed, frame_number, y0,
                                        h_out)
    if tracer.traversal == "gathered":
        return base_kernel_chunked_gathered(tracer, pose, seed, frame_number,
                                            y0, h_out)
    if tracer.xt:
        return base_kernel_chunked_xt(tracer, pose, seed, frame_number, y0,
                                      h_out)
    if tracer.ext:
        return base_kernel_chunked_ext(tracer, pose, seed, frame_number, y0,
                                       h_out)
    if takes_grouped(tracer, "chunked"):
        return base_kernel_chunked_grouped(tracer, pose, seed, frame_number,
                                           y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out, "ref")
    base_kernel_chunked.launches += 1
    return out


def base_kernel_chunked_grouped(tracer, pose, seed: int, frame_number: int,
                                y0: int = 0, h_out: int = None
                                ) -> ChunkedBaseOut:
    """The chunked kernel A's grouped entry (csrc/group.cuh): a path group
    of group_k('chunked') lanes an entry, each sweep split across the
    group over the scene's rows in shared memory. For a tracer of the
    reference gates and the table sweep (takes_grouped); base_kernel_chunked
    takes it for such a tracer. Rows over GROUP_SMEM_BYTES go on to
    base_kernel_chunked_grouped_spill."""
    _require_grouped(tracer, "base_kernel_chunked_grouped", any_size=True)
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_chunked_grouped"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if _over_budget(tracer):
        return base_kernel_chunked_grouped_spill(tracer, pose, seed,
                                                 frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "grouped")
    base_kernel_chunked_grouped.launches += 1
    return out


def base_kernel_chunked_grouped_spill(tracer, pose, seed: int,
                                      frame_number: int, y0: int = 0,
                                      h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's grouped form for any table size
    (csrc/group.cuh GroupSpill): group_k('chunked_spill') lanes an entry,
    the rows that fit group_cap('chunked_spill') staged, the rest read
    through L1. For a tracer of the reference gates and the table sweep;
    base_kernel_chunked_grouped takes it where the rows exceed
    GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "base_kernel_chunked_grouped_spill",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_grouped_spill"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "grouped_spill")
    base_kernel_chunked_grouped_spill.launches += 1
    return out


def base_kernel_chunked_ext(tracer, pose, seed: int, frame_number: int,
                            y0: int = 0, h_out: int = None
                            ) -> ChunkedBaseOut:
    """The chunked kernel A's EXT instantiation: its grouped entry
    base_kernel_chunked_ext_grouped where takes_grouped(tracer, 'chunked')
    (every table size), else the thread per entry."""
    _require_ext(tracer, "base_kernel_chunked_ext")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_chunked_ext"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if takes_grouped(tracer, "chunked"):
        return base_kernel_chunked_ext_grouped(tracer, pose, seed,
                                               frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out, "ext")
    base_kernel_chunked_ext.launches += 1
    return out


def base_kernel_chunked_ext_grouped(tracer, pose, seed: int,
                                    frame_number: int, y0: int = 0,
                                    h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's grouped entry at the EXT gates (csrc/group.cuh
    over GroupSweep): group_k('chunked_ext') lanes an entry, as
    base_kernel_chunked_grouped. For an EXT tracer over the table sweep;
    base_kernel_chunked_ext takes it for such a tracer. Rows over
    GROUP_SMEM_BYTES go on to base_kernel_chunked_ext_grouped_spill."""
    _require_grouped(tracer, "base_kernel_chunked_ext_grouped", "ext",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_ext_grouped"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if _over_budget(tracer):
        return base_kernel_chunked_ext_grouped_spill(tracer, pose, seed,
                                                     frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "ext_grouped")
    base_kernel_chunked_ext_grouped.launches += 1
    return out


def base_kernel_chunked_ext_grouped_spill(tracer, pose, seed: int,
                                          frame_number: int, y0: int = 0,
                                          h_out: int = None
                                          ) -> ChunkedBaseOut:
    """The chunked kernel A's grouped form at the EXT gates for any table
    size (csrc/group.cuh GroupSpill): group_k('chunked_ext_spill') lanes an
    entry, as base_kernel_chunked_grouped_spill. For an EXT tracer over the
    table sweep; base_kernel_chunked_ext_grouped takes it where the rows
    exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "base_kernel_chunked_ext_grouped_spill", "ext",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_ext_grouped_spill"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "ext_grouped_spill")
    base_kernel_chunked_ext_grouped_spill.launches += 1
    return out


def base_kernel_chunked_xt(tracer, pose, seed: int, frame_number: int,
                           y0: int = 0, h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's XT instantiation: its grouped entry
    base_kernel_chunked_xt_grouped where takes_grouped(tracer, 'chunked')
    (every table size over the table sweep), else the thread per entry."""
    _require_xt(tracer, "base_kernel_chunked_xt")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_chunked_xt"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if takes_grouped(tracer, "chunked"):
        return base_kernel_chunked_xt_grouped(tracer, pose, seed,
                                              frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out, "xt")
    base_kernel_chunked_xt.launches += 1
    return out


def base_kernel_chunked_xt_grouped(tracer, pose, seed: int,
                                   frame_number: int, y0: int = 0,
                                   h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's grouped entry at the XT gates (csrc/group.cuh
    over GroupSweep): group_k('chunked_xt') lanes an entry, as
    base_kernel_chunked_grouped. For an XT tracer over the table sweep;
    base_kernel_chunked_xt takes it for such a tracer. Rows over
    GROUP_SMEM_BYTES go on to base_kernel_chunked_xt_grouped_spill."""
    _require_grouped(tracer, "base_kernel_chunked_xt_grouped", "xt",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_xt_grouped"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if _over_budget(tracer):
        return base_kernel_chunked_xt_grouped_spill(tracer, pose, seed,
                                                    frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "xt_grouped")
    base_kernel_chunked_xt_grouped.launches += 1
    return out


def base_kernel_chunked_xt_grouped_spill(tracer, pose, seed: int,
                                         frame_number: int, y0: int = 0,
                                         h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's grouped form at the XT gates for any table
    size (csrc/group.cuh GroupSpill): group_k('chunked_xt_spill') lanes an
    entry, as base_kernel_chunked_grouped_spill. For an XT tracer over the
    table sweep; base_kernel_chunked_xt_grouped takes it where the rows
    exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "base_kernel_chunked_xt_grouped_spill", "xt",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_xt_grouped_spill"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "xt_grouped_spill")
    base_kernel_chunked_xt_grouped_spill.launches += 1
    return out


def base_kernel_chunked_grid(tracer, pose, seed: int, frame_number: int,
                             y0: int = 0, h_out: int = None
                             ) -> ChunkedBaseOut:
    """The chunked kernel A over the block-culled sweep (XT
    instantiation): its grouped entry base_kernel_chunked_grid_grouped
    where takes_grouped(tracer, 'chunked') (every table size), else the
    thread per entry."""
    _require_traversal(tracer, "grid", "base_kernel_chunked_grid")
    if not _on_cuda(tracer.tables.buf.device, "base_kernel_chunked_grid"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if takes_grouped(tracer, "chunked"):
        return base_kernel_chunked_grid_grouped(tracer, pose, seed,
                                                frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out, "grid")
    base_kernel_chunked_grid.launches += 1
    return out


def base_kernel_chunked_grid_grouped(tracer, pose, seed: int,
                                     frame_number: int, y0: int = 0,
                                     h_out: int = None) -> ChunkedBaseOut:
    """The chunked kernel A's grouped entry over the culled sweep
    (csrc/group.cuh kernel_base_chunked_grouped over GroupCulled, XT
    instantiation): group_k('chunked_grid') lanes an entry, the serial cull
    decisions replayed across the group, the traversal counters the plain
    version's. For an `--accel grid` tracer; base_kernel_chunked_grid takes
    it for such a tracer. Rows and group table over GROUP_SMEM_BYTES go on
    to base_kernel_chunked_grid_grouped_spill."""
    _require_grouped(tracer, "base_kernel_chunked_grid_grouped", "grid",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_grid_grouped"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if _over_budget(tracer):
        return base_kernel_chunked_grid_grouped_spill(
            tracer, pose, seed, frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "grid_grouped")
    base_kernel_chunked_grid_grouped.launches += 1
    return out


def base_kernel_chunked_grid_grouped_spill(tracer, pose, seed: int,
                                           frame_number: int, y0: int = 0,
                                           h_out: int = None
                                           ) -> ChunkedBaseOut:
    """The chunked kernel A's grouped form over the culled sweep for any
    table size (csrc/group.cuh GroupCulledSpill):
    group_k('chunked_grid_spill') lanes an entry, the group table and then
    the rows that fit group_cap('chunked_grid_spill') staged
    (culled_stage), the rest read through L1; the decisions, hits and
    counters those of base_kernel_chunked_grid_grouped. For an `--accel
    grid` tracer; base_kernel_chunked_grid_grouped takes it where the rows
    and group table exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "base_kernel_chunked_grid_grouped_spill", "grid",
                     any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_grid_grouped_spill"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "grid_grouped_spill")
    base_kernel_chunked_grid_grouped_spill.launches += 1
    return out


def base_kernel_chunked_gathered(tracer, pose, seed: int, frame_number: int,
                                 y0: int = 0, h_out: int = None
                                 ) -> ChunkedBaseOut:
    """The chunked kernel A over the grid walk (XT instantiation): its
    grouped entry base_kernel_chunked_gathered_grouped where
    takes_grouped(tracer, 'chunked') (every table size), else the thread
    per entry."""
    _require_traversal(tracer, "gathered", "base_kernel_chunked_gathered")
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_gathered"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    if takes_grouped(tracer, "chunked"):
        return base_kernel_chunked_gathered_grouped(tracer, pose, seed,
                                                    frame_number, y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "gathered")
    base_kernel_chunked_gathered.launches += 1
    return out


def base_kernel_chunked_gathered_grouped(tracer, pose, seed: int,
                                         frame_number: int, y0: int = 0,
                                         h_out: int = None
                                         ) -> ChunkedBaseOut:
    """The chunked kernel A's grouped entry over the grid walk
    (csrc/group.cuh kernel_base_chunked_grouped over GroupWalk, XT
    instantiation): group_k('chunked_gathered') lanes an entry, each cell's
    bucket split across the group, the traversal counters the plain
    version's. For an `--accel gathered` tracer of any table size;
    base_kernel_chunked_gathered takes it for such a tracer."""
    _require_grouped(tracer, "base_kernel_chunked_gathered_grouped",
                     "gathered", any_size=True)
    if not _on_cuda(tracer.tables.buf.device,
                    "base_kernel_chunked_gathered_grouped"):
        return base_kernel_chunked_plain(tracer, pose, seed, frame_number,
                                         y0, h_out)
    out = _launch_chunked(tracer, pose, seed, frame_number, y0, h_out,
                          "gathered_grouped")
    base_kernel_chunked_gathered_grouped.launches += 1
    return out


base_kernel_chunked.launches = 0
base_kernel_chunked_grouped.launches = 0
base_kernel_chunked_grouped_spill.launches = 0
base_kernel_chunked_ext.launches = 0
base_kernel_chunked_ext_grouped.launches = 0
base_kernel_chunked_ext_grouped_spill.launches = 0
base_kernel_chunked_xt.launches = 0
base_kernel_chunked_xt_grouped.launches = 0
base_kernel_chunked_xt_grouped_spill.launches = 0
base_kernel_chunked_grid.launches = 0
base_kernel_chunked_grid_grouped.launches = 0
base_kernel_chunked_grid_grouped_spill.launches = 0
base_kernel_chunked_gathered.launches = 0
base_kernel_chunked_gathered_grouped.launches = 0

# The grouped chunked kernel A of each instantiation that has one (each
# but the walk's, which stages no rows, passes a table over the budget on
# to its GroupSpill or GroupCulledSpill form).
GROUPED_CHUNKED = {"ref": base_kernel_chunked_grouped,
                   "xt": base_kernel_chunked_xt_grouped,
                   "ext": base_kernel_chunked_ext_grouped,
                   "grid": base_kernel_chunked_grid_grouped,
                   "gathered": base_kernel_chunked_gathered_grouped}


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------


def extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B in plain PyTorch (any device): returns (esum V3, rays,
    executed lane-iterations) over the entries."""
    cam = tracer_mod.cam_from_pose(pose)
    esum, rays, it = tracer.extra_phase(
        cam, xs.to(torch.float32), ys.to(torch.float32), state, add,
        samp0.to(torch.int64))
    return esum, rays, _iters_tensor(it, rays.device)


def extra_entry_iters(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's bounce iterations per entry (int64, xs's shape; 0 without
    a budget), from its plain version's scheduler: the iterations each
    entry's thread or path group runs. warp_iters of them is the kernels'
    counter."""
    cam = tracer_mod.cam_from_pose(pose)
    c, full, _ = tracer._extra_run(
        cam, xs.to(torch.float32), ys.to(torch.float32), state, add,
        samp0.to(torch.int64))
    return full(c.iters)


def _extra_on_cuda(tracer, xs, ys, state, add, samp0, name: str) -> bool:
    """Check kernel B's inputs; False where the plain version runs."""
    device = xs.device
    if any(t.device != device for t in (ys, state, add, samp0,
                                        tracer.tables.buf)):
        raise ValueError(f"{name}: inputs and scene tables must lie on one "
                         "device")
    if not _on_cuda(device, name):
        return False
    for t, dtype in ((xs, torch.int32), (ys, torch.int32),
                     (state, torch.int64), (add, torch.float32),
                     (samp0, torch.int32)):
        if t.dtype != dtype or t.shape != xs.shape or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous int32 "
                             "xs/ys/samp0, int64 state and f32 add of one "
                             "shape")
    return True


def _launch_extra(tracer, pose, xs, ys, state, add, samp0, kind: str,
                  lib=None):
    """Launch kernel B's `kind` instantiation (the grouped entries for
    'grouped', 'xt_grouped', 'ext_grouped', 'grid_grouped',
    'gathered_grouped', their GroupSpill forms for 'grouped_spill',
    'xt_grouped_spill', 'ext_grouped_spill', the GroupCulledSpill form for
    'grid_grouped_spill'), from `lib` (default the render libraries)."""
    device, n = xs.device, xs.numel()
    out = torch.empty((4, n), dtype=torch.float32, device=device)
    iters = torch.zeros((1,), dtype=torch.int64, device=device)
    args = _ExtraArgs(_frame(tracer, pose), n)
    ptrs = (tracer.tables.buf.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            state.data_ptr(), add.data_ptr(), samp0.data_ptr(),
            out.data_ptr(), iters.data_ptr(), _stream(device))
    _launch(lib or load_kernels(), "trt_kernel_extra", args, tracer, kind,
            ptrs)
    p = out.view(4, *xs.shape)
    return V3(p[0], p[1], p[2]), p[3], iters[0].to(torch.float64)


def extra_kernel(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B: entry i renders `add[i]` extra samples of pixel
    (xs[i], ys[i]) continuing RNG `state[i]` at sample index `samp0[i]`.
    xs, ys, samp0 int32; state int64; add f32; all of one shape.
    extra_kernel_ext / _xt for a tracer with the extensions, extra_kernel_grid
    / _gathered for one with that traversal; the grouped entries
    (extra_kernel_grouped, _xt_grouped, _ext_grouped, _grid_grouped,
    _gathered_grouped) where takes_grouped."""
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0, "extra_kernel"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    if takes_grouped(tracer):
        return GROUPED_EXTRA[_kind(tracer)](tracer, pose, xs, ys, state, add,
                                            samp0)
    if tracer.traversal == "grid":
        return extra_kernel_grid(tracer, pose, xs, ys, state, add, samp0)
    if tracer.traversal == "gathered":
        return extra_kernel_gathered(tracer, pose, xs, ys, state, add, samp0)
    if tracer.xt:
        return extra_kernel_xt(tracer, pose, xs, ys, state, add, samp0)
    if tracer.ext:
        return extra_kernel_ext(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "ref")
    extra_kernel.launches += 1
    return out


def extra_kernel_grouped(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped entry (csrc/group.cuh): a path group of
    group_k('extra') lanes an entry, its sweeps split across the group
    over the scene's rows in shared memory; blocks without a budgeted entry
    leave at once. For a tracer of the reference gates and the table sweep
    (takes_grouped); extra_kernel takes it for such a tracer. Rows over
    GROUP_SMEM_BYTES go on to extra_kernel_grouped_spill."""
    _require_grouped(tracer, "extra_kernel_grouped", any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_grouped"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    if _over_budget(tracer):
        return extra_kernel_grouped_spill(tracer, pose, xs, ys, state, add,
                                          samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "grouped")
    extra_kernel_grouped.launches += 1
    return out


def extra_kernel_grouped_spill(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped form for any table size (csrc/group.cuh
    GroupSpill): group_k('extra_spill') lanes an entry, the rows that fit
    group_cap('extra_spill') staged, the rest read through L1. For a tracer
    of the reference gates and the table sweep; extra_kernel_grouped takes
    it where the rows exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "extra_kernel_grouped_spill", any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_grouped_spill"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "grouped_spill")
    extra_kernel_grouped_spill.launches += 1
    return out


def extra_kernel_xt_grouped(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped entry at the XT gates (csrc/group.cuh over
    GroupSweep): group_k('extra_xt') lanes an entry, as
    extra_kernel_grouped. For an XT tracer over the table sweep;
    extra_kernel takes it for such a tracer. Rows over GROUP_SMEM_BYTES go
    on to extra_kernel_xt_grouped_spill."""
    _require_grouped(tracer, "extra_kernel_xt_grouped", "xt", any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_xt_grouped"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    if _over_budget(tracer):
        return extra_kernel_xt_grouped_spill(tracer, pose, xs, ys, state, add,
                                             samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "xt_grouped")
    extra_kernel_xt_grouped.launches += 1
    return out


def extra_kernel_xt_grouped_spill(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped form at the XT gates for any table size
    (csrc/group.cuh GroupSpill): group_k('extra_xt_spill') lanes an entry,
    as extra_kernel_grouped_spill. For an XT tracer over the table sweep;
    extra_kernel_xt_grouped takes it where the rows exceed
    GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "extra_kernel_xt_grouped_spill", "xt",
                     any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_xt_grouped_spill"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "xt_grouped_spill")
    extra_kernel_xt_grouped_spill.launches += 1
    return out


def extra_kernel_grid_grouped(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped entry over the culled sweep (csrc/group.cuh
    GroupCulled, XT instantiation): group_k('extra_grid') lanes an entry,
    the serial cull decisions replayed across the group, the traversal
    counters the plain version's. For a `--accel grid` tracer; extra_kernel
    takes it for such a tracer. Rows and group table over GROUP_SMEM_BYTES
    go on to extra_kernel_grid_grouped_spill."""
    _require_grouped(tracer, "extra_kernel_grid_grouped", "grid",
                     any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_grid_grouped"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    if _over_budget(tracer):
        return extra_kernel_grid_grouped_spill(tracer, pose, xs, ys, state,
                                               add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "grid_grouped")
    extra_kernel_grid_grouped.launches += 1
    return out


def extra_kernel_grid_grouped_spill(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped form over the culled sweep for any table size
    (csrc/group.cuh GroupCulledSpill): group_k('extra_grid_spill') lanes an
    entry, the group table and then the rows that fit
    group_cap('extra_grid_spill') staged (culled_stage), the rest read
    through L1; the decisions, hits and counters those of
    extra_kernel_grid_grouped. For a `--accel grid` tracer;
    extra_kernel_grid_grouped takes it where the rows and group table
    exceed GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "extra_kernel_grid_grouped_spill", "grid",
                     any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_grid_grouped_spill"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "grid_grouped_spill")
    extra_kernel_grid_grouped_spill.launches += 1
    return out


def extra_kernel_ext_grouped(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped entry at the EXT gates (csrc/group.cuh over
    GroupSweep): group_k('extra_ext') lanes an entry, as
    extra_kernel_grouped. For an EXT tracer over the table sweep;
    extra_kernel takes it for such a tracer. Rows over GROUP_SMEM_BYTES go
    on to extra_kernel_ext_grouped_spill."""
    _require_grouped(tracer, "extra_kernel_ext_grouped", "ext", any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_ext_grouped"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    if _over_budget(tracer):
        return extra_kernel_ext_grouped_spill(tracer, pose, xs, ys, state,
                                              add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "ext_grouped")
    extra_kernel_ext_grouped.launches += 1
    return out


def extra_kernel_ext_grouped_spill(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped form at the EXT gates for any table size
    (csrc/group.cuh GroupSpill): group_k('extra_ext_spill') lanes an entry,
    as extra_kernel_grouped_spill. For an EXT tracer over the table sweep;
    extra_kernel_ext_grouped takes it where the rows exceed
    GROUP_SMEM_BYTES."""
    _require_grouped(tracer, "extra_kernel_ext_grouped_spill", "ext",
                     any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_ext_grouped_spill"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "ext_grouped_spill")
    extra_kernel_ext_grouped_spill.launches += 1
    return out


def extra_kernel_gathered_grouped(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's grouped entry over the grid walk (csrc/group.cuh
    GroupWalk, XT instantiation): group_k('extra_gathered') lanes an entry,
    every lane making the walk's DDA decisions and each cell's bucket split
    over the group in windows, so the traversal counters are the plain
    version's. For an `--accel gathered` tracer of any table size;
    extra_kernel takes it for such a tracer."""
    _require_grouped(tracer, "extra_kernel_gathered_grouped", "gathered",
                     any_size=True)
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_gathered_grouped"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0,
                        "gathered_grouped")
    extra_kernel_gathered_grouped.launches += 1
    return out


def extra_kernel_ext(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's EXT instantiation."""
    _require_ext(tracer, "extra_kernel_ext")
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_ext"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "ext")
    extra_kernel_ext.launches += 1
    return out


def extra_kernel_xt(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B's XT instantiation."""
    _require_xt(tracer, "extra_kernel_xt")
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_xt"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "xt")
    extra_kernel_xt.launches += 1
    return out


def extra_kernel_grid(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B over the block-culled sweep (XT instantiation)."""
    _require_traversal(tracer, "grid", "extra_kernel_grid")
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_grid"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "grid")
    extra_kernel_grid.launches += 1
    return out


def extra_kernel_gathered(tracer, pose, xs, ys, state, add, samp0):
    """Kernel B over the grid walk (XT instantiation)."""
    _require_traversal(tracer, "gathered", "extra_kernel_gathered")
    if not _extra_on_cuda(tracer, xs, ys, state, add, samp0,
                          "extra_kernel_gathered"):
        return extra_kernel_plain(tracer, pose, xs, ys, state, add, samp0)
    out = _launch_extra(tracer, pose, xs, ys, state, add, samp0, "gathered")
    extra_kernel_gathered.launches += 1
    return out


extra_kernel.launches = 0
extra_kernel_grouped.launches = 0
extra_kernel_grouped_spill.launches = 0
extra_kernel_xt_grouped.launches = 0
extra_kernel_xt_grouped_spill.launches = 0
extra_kernel_grid_grouped.launches = 0
extra_kernel_grid_grouped_spill.launches = 0
extra_kernel_ext_grouped.launches = 0
extra_kernel_ext_grouped_spill.launches = 0
extra_kernel_gathered_grouped.launches = 0
extra_kernel_ext.launches = 0
extra_kernel_xt.launches = 0
extra_kernel_grid.launches = 0
extra_kernel_gathered.launches = 0

# The grouped kernel B of each instantiation that has one, and the GroupSpill
# and GroupCulledSpill forms that those of ANY_SIZE pass a table over the
# budget on to.
GROUPED_EXTRA = {"ref": extra_kernel_grouped, "xt": extra_kernel_xt_grouped,
                 "ext": extra_kernel_ext_grouped,
                 "grid": extra_kernel_grid_grouped,
                 "gathered": extra_kernel_gathered_grouped}
SPILL_EXTRA = {"ref": extra_kernel_grouped_spill,
               "xt": extra_kernel_xt_grouped_spill,
               "ext": extra_kernel_ext_grouped_spill,
               "grid": extra_kernel_grid_grouped_spill}


# ---------------------------------------------------------------------------
# The glue and the pipeline
# ---------------------------------------------------------------------------


class SortedStream(NamedTuple):
    """Kernel B's input: the extra phase's entries (ops/tracer.py
    extra_entries) sorted by descending budget, padded with zero-budget
    entries to (rows, 512); `order` maps stream position -> entry id
    (c * n_pix + flat pixel)."""

    order: torch.Tensor
    n_chunks: int
    xs: torch.Tensor
    ys: torch.Tensor
    state: torch.Tensor
    add: torch.Tensor
    samp0: torch.Tensor


def sorted_stream(tracer, state, additional, y0: int = 0,
                  samp0: int = None) -> SortedStream:
    """Sort the extra phase's entries of the row block [y0, y0 + h_out)
    whose planes `state` and `additional` are ([h_out, w]) by descending
    budget (zero-budget entries end up in whole warps), carrying entry id,
    RNG state, the global row and the sample index each continues at
    (`samp0`, default the tracer's base_samples: tracer.extra_entries)."""
    budget, st_e, samp0 = tracer.extra_entries(state, additional, samp0)
    n_chunks, n_pix = budget.shape[0], additional.numel()
    n = budget.numel()
    rows = -(-n // STREAM_COLS)
    rows = -(-rows // TILE_H) * TILE_H
    n_pad = rows * STREAM_COLS - n

    def pad(a, fill):
        return torch.cat([a, a.new_full((n_pad,), fill)]).view(
            rows, STREAM_COLS)

    neg, order = torch.sort(-budget.reshape(-1))
    pix = pad((order % n_pix).to(torch.int32), 0)
    return SortedStream(order, n_chunks, pix % tracer.width,
                        y0 + pix // tracer.width,
                        pad(st_e.reshape(-1)[order], 0), pad(-neg, 0.0),
                        pad(samp0.reshape(-1)[order].to(torch.int32), 0))


def unsort(stream: SortedStream, plane: torch.Tensor, shape) -> torch.Tensor:
    """A per-entry plane back in image order: each entry to its place in
    the chunk planes, the planes added in chunk order."""
    n = stream.order.numel()
    flat = torch.zeros((n,), dtype=plane.dtype, device=plane.device)
    flat.index_copy_(0, stream.order, plane.reshape(-1)[:n])
    return tracer_mod.PathTracer.chunk_total(
        flat.view(stream.n_chunks, *shape))


def make_sorted_extra_phase(tracer, y0: int = 0):
    """The sort glue + kernel B over the row block starting at global row
    `y0`. Returns ``extra_phase(pose, state, additional, samp0=None) ->
    (esum V3 [h_out, w], rays, lane_iters)``: `samp0` (an int, default
    base_samples) is the sample index where the chains continue."""

    def extra_phase(pose, state, additional, samp0=None):
        s = sorted_stream(tracer, state, additional, y0, samp0)
        esum_s, rays_s, iters = extra_kernel(tracer, pose, s.xs, s.ys,
                                             s.state, s.add, s.samp0)
        esum = V3(*(unsort(s, c, state.shape) for c in esum_s))
        return esum, rays_s.sum(dtype=torch.float64), iters

    return extra_phase


def base_phase(tracer, pose, seed: int, frame_number: int, y0: int = 0,
               h_out: int = None):
    """The sorted pipeline's base phase of rows [y0, y0 + h_out): kernel A
    (chunked or not) and, chunked, each pixel's totals in chunk order, its
    variance and its budget. Returns (csum, csumsq, end state, rays,
    lane-iterations, variance, needs, additional); the extra phase
    continues the end state (chunk 0's chain)."""
    if not tracer.chunk_base:
        a = base_kernel(tracer, pose, seed, frame_number, y0, h_out)
        # Budgets are all-or-nothing under the reference's constants (var >
        # 10 => floor(var * 50) >= spp - base), so a needy pixel never has
        # a zero budget.
        return (a.csum, a.csumsq, a.state, a.rays, a.iters, a.var,
                a.additional > 0.0, a.additional)
    a = base_kernel_chunked(tracer, pose, seed, frame_number, y0, h_out)
    csum = V3(*(tracer.chunk_total(v) for v in a.csum))
    csumsq = V3(*(tracer.chunk_total(v) for v in a.csumsq))
    var = tracer.variance_of(csum, csumsq)
    needs, additional = tracer.extra_quota(var)
    return (csum, csumsq, a.state[0], a.rays, a.iters, var, needs,
            additional)


def make_sorted_render_frame(tracer, y0: int = 0, h_out: int = None):
    """``render_frame(pose, seed, frame_number[, arrays]) -> (current V3,
    variance, total samples, rays, occupancy)`` of rows [y0, y0 + h_out)
    (default the whole image) through kernel A (chunked or not), the sort,
    kernel B and combine_phases; rays and occupancy are 0-dim f64 tensors
    on the device (no host sync). Chains are seeded by global pixel, so
    row blocks tile the whole frame bit for bit. A dynamic tracer takes
    the frame's ops/dynamic.pack_scene `arrays` and renders from them.
    ``render_frame.sweeps`` returns the occupancy's denominator in place of
    the occupancy (parallel/mesh.py adds it up over row blocks)."""
    base, spp = tracer.base_samples, tracer.spp
    extra_phase = make_sorted_extra_phase(tracer, y0) if base < spp else None
    sweeps_per_iter = 1.0 + tracer.nee_sweeps

    def render_sweeps(pose, seed: int, frame_number: int, arrays=None):
        """(current, variance, total, rays, executed lane-iteration sweeps:
        the occupancy's denominator, which adds up over row blocks)."""
        if tracer.dynamic:
            tracer.bind_packed(arrays)
        csum, csumsq, state, rays_a, iters, var, needs, additional = (
            base_phase(tracer, pose, seed, frame_number, y0, h_out))
        rays = rays_a.sum(dtype=torch.float64)
        if extra_phase is None:
            current = csum * (1.0 / spp)
            total = torch.full_like(var, float(base))
        else:
            esum, rays_b, it_b = extra_phase(pose, state, additional)
            current, total = tracer.combine_phases(csum, esum, needs,
                                                   additional)
            rays = rays + rays_b
            iters = iters + it_b
        return current, var, total, rays, iters * sweeps_per_iter

    def render_frame(pose, seed: int, frame_number: int, arrays=None):
        current, var, total, rays, sweeps = render_sweeps(
            pose, seed, frame_number, arrays)
        return current, var, total, rays, rays / torch.clamp(sweeps, min=1.0)

    render_frame.sweeps = render_sweeps
    return render_frame


# ---------------------------------------------------------------------------
# Kernels C and D: the single-kernel schedulers
# ---------------------------------------------------------------------------

MODES = ("sorted", "regen", "lockstep")
WARP = 32


def lockstep_samples(tracer) -> int:
    """The sample slots every lockstep thread runs (pallas_kernel.py
    :528-536): max(base, spp), or base plus whole extra chunks of ce
    slots."""
    base, spp = tracer.base_samples, tracer.spp
    if base >= spp:
        return base
    return base + tracer.n_extra_chunks * (tracer.chunk_extra or spp - base)


def lockstep_iters(tracer, h_out: int = None) -> float:
    """Kernel D's executed lane-iterations, a static count: every lane of
    ceil(h_out * w / 32) warps runs lockstep_samples x max_depth."""
    h_out = tracer.height if h_out is None else h_out
    lanes = -(-h_out * tracer.width // WARP) * WARP
    return float(lanes * lockstep_samples(tracer) * tracer.max_depth)


def _warps(lane_iters: torch.Tensor, k: int) -> torch.Tensor:
    """Per-entry iteration counts as the warps that run them k lanes an
    entry: [warps, 32 / k], zero-padded."""
    if k < 1 or WARP % k:
        raise ValueError(f"group width {k} does not divide {WARP}")
    slots = WARP // k
    flat = lane_iters.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % slots)])
    return flat.view(-1, slots)


def warp_iters(lane_iters: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Executed lane-iterations of per-entry iteration counts run k lanes
    an entry (path groups of k lanes; k = 1, one thread an entry): a warp
    carries 32 / k consecutive entries and spends 32 / k path slots for as
    many iterations as its longest entry runs (trace.cuh count_warp_iters,
    count_slot_iters). 0-dim f64. With an entry's count its summed bounces
    over its samples, this is the executed count of a loop that starts each
    lane's next sample as soon as its path ends (trace.cuh
    run_samples_regen); for the nested sample and bounce loops (run_samples,
    kernel A's *_nested twins), which the kernels count the same way, it is
    a lower bound, and nested_iters gives their executed count."""
    w = _warps(lane_iters, k)
    return (w.amax(1).sum() * w.shape[1]).to(torch.float64)


def nested_iters(sample_iters: torch.Tensor) -> torch.Tensor:
    """Executed lane-iterations of the nested sample and bounce loops, one
    thread a pixel (trace.cuh run_samples), from each sample's bounces per
    pixel (base_sample_iters: [samples, ...]): sample by sample, every lane
    of a warp waits for the warp's longest path of that sample, so a warp
    spends 32 x the sum over samples of that longest path. At least
    warp_iters of the samples' sum, warp by warp. 0-dim f64."""
    return sum((warp_iters(row) for row in sample_iters),
               torch.zeros((), dtype=torch.float64,
                           device=sample_iters.device))


def working_warps(lane_iters: torch.Tensor, k: int = 1) -> int:
    """The warps of warp_iters that run at least one iteration."""
    return int((_warps(lane_iters, k).amax(1) > 0).sum())


def render_frame_plain(tracer, mode: str, pose, seed: int, frame_number: int,
                       y0: int = 0, h_out: int = None) -> FrameOut:
    """Kernel C ('regen') or D ('lockstep') in plain PyTorch (any device):
    the plain whole frame (ops/tracer.py render_pixels) with the count of
    the queue schedule's model: regen, the items' summed iterations (the
    least the kernel's count can be, regen_iters_bounds); lockstep, the
    static formula lockstep_iters."""
    cur, var, total, rays, lane_iters, _ = tracer.render_pixels(
        pose, seed, frame_number, y0, h_out)
    if mode == "regen":
        iters = lane_iters.sum().to(torch.float64)
    elif mode == "lockstep":
        iters = _iters_tensor(lockstep_iters(tracer, h_out), var.device)
    else:
        raise ValueError(f"unknown kernel mode {mode!r}")
    return FrameOut(cur, var, total, rays, iters)


def regen_iters_bounds(lane_iters: torch.Tensor, k: int) -> tuple:
    """The regen queue kernel's count of executed lane-iterations, bounded
    from the items' iterations (lane_iters: a pixel's summed items, as
    render_pixels gives them) at group width k (the lesser of the entry's
    KB and KE): at least the items' sum (every item's iterations run on one
    path slot), at most 32 / k times it (a warp adds 32 / K x its busiest
    group's sum in each phase, at most the sum of all its groups'). Which
    group takes which item is the device's: within these bounds the count
    is not fixed. (lo, hi), floats."""
    if k < 1 or WARP % k:
        raise ValueError(f"group width {k} does not divide {WARP}")
    lo = float(lane_iters.sum())
    return lo, lo * (WARP // k)


def frame_items_plain(tracer, mode: str, pose, seed: int, frame_number: int,
                      y0: int = 0, h_out: int = None) -> FrameOut:
    """The queue schedule's arithmetic in plain PyTorch (any device): each
    base item (pixel, base chunk) from zero sums, a pixel's items added in
    chunk order from zero sums, its variance and budget, each extra chunk
    it owes (regen: budget above 0; lockstep: every chunk) added in chunk
    order, then combine_phases (csrc/group.cuh frame_base_item,
    frame_fold_base, frame_extra_item, frame_fold_extra). Its count is
    render_frame_plain's. Equal to render_pixels bit for bit, which
    tests/test_torch_frame_queue.py holds."""
    if mode not in ("regen", "lockstep"):
        raise ValueError(f"unknown kernel mode {mode!r}")
    cam = tracer_mod.cam_from_pose(pose)
    x, y, c = tracer.base_entries(y0, h_out)
    b, _ = tracer._base_run(cam, x.to(torch.float32), y.to(torch.float32),
                            tracer.seed_lanes(x, y, seed, frame_number), c)
    zero = torch.zeros_like(b.rays[0])
    csum = csumsq = esum = V3(zero, zero, zero)
    rays = zero
    for k in range(tracer.n_base_chunks):
        csum = csum + V3(*(v[k] for v in b.csum))
        csumsq = csumsq + V3(*(v[k] for v in b.csumsq))
        rays = rays + b.rays[k]
    iters = b.iters.sum()
    var = tracer.variance_of(csum, csumsq)
    if tracer.base_samples >= tracer.spp:
        current = csum * (1.0 / tracer.spp)
        total = torch.full_like(var, float(tracer.base_samples))
    else:
        needs, additional = tracer.extra_quota(var)
        budget, st_e, samp0 = tracer.extra_entries(b.state[0], additional)
        e, full, _ = tracer._extra_run(
            cam, x[0].expand(budget.shape).to(torch.float32),
            y[0].expand(budget.shape).to(torch.float32), st_e, budget, samp0)
        runs = budget > 0.0 if mode == "regen" else torch.ones_like(
            budget, dtype=torch.bool)
        es, e_rays = V3(*(full(v) for v in e.csum)), full(e.rays)
        for k in range(budget.shape[0]):
            esum = vm.where(runs[k], esum + V3(*(v[k] for v in es)), esum)
            rays = rays + e_rays[k]
        iters = iters + full(e.iters).sum()
        current, total = tracer.combine_phases(csum, esum, needs, additional)
    if mode == "lockstep":
        count = _iters_tensor(lockstep_iters(tracer, h_out), var.device)
    else:
        count = iters.to(torch.float64)
    return FrameOut(current, var, total, rays, count)


def _kind(tracer) -> str:
    """The instantiation a tracer takes: its traversal, or 'xt', 'ext' or
    'ref'."""
    return tracer.traversal or ("xt" if tracer.xt else "ext" if tracer.ext
                                else "ref")


def _frame_args(tracer, pose, seed, frame_number, y0, h_out) -> _FrameArgs:
    w, base, spp = tracer.width, tracer.base_samples, tracer.spp
    return _FrameArgs(_frame(tracer, pose), h_out, y0, base, spp,
                      tracer.chunk_base or base, tracer.n_base_chunks,
                      tracer.chunk_extra or max(spp - base, 0),
                      tracer.n_extra_chunks, seed & 0xFFFFFFFF,
                      frame_number & 0xFFFFFFFF,
                      float(np.float32(1.0 / base)),
                      float(max(spp - base, 0)),
                      float(np.float32(1.0 / spp)))


def _frame_out(out, iters, h_out, w) -> FrameOut:
    p = out.view(6, h_out, w)
    return FrameOut(V3(p[0], p[1], p[2]), p[3], p[4], p[5],
                    iters.to(torch.float64))


def _launch_frame(tracer, pose, seed, frame_number, y0, h_out, entry,
                  kind) -> FrameOut:
    """Launch the thread-per-pixel kernel C or D `entry` ('trt_kernel_regen'
    or 'trt_kernel_lockstep') of instantiation `kind` (no dispatch takes
    these since the queue schedule; chip_smoke.py launches them directly
    and counts nothing)."""
    device = tracer.tables.buf.device
    h_out = tracer.height if h_out is None else h_out
    n = h_out * tracer.width
    out = torch.empty((6, n), dtype=torch.float32, device=device)
    iters = torch.zeros((1,), dtype=torch.int64, device=device)
    args = _frame_args(tracer, pose, seed, frame_number, y0, h_out)
    ptrs = (tracer.tables.buf.data_ptr(), out.data_ptr(), iters.data_ptr(),
            _stream(device))
    _launch(load_kernels(), entry, args, tracer, kind, ptrs)
    return _frame_out(out, iters[0], h_out, tracer.width)


# ---------------------------------------------------------------------------
# Kernels C and D on the queue schedule (csrc/group.cuh kernel_frame_queue)
# ---------------------------------------------------------------------------

# The u32 words of the queue's control buffer before the queue (csrc/
# group.cuh FRAME_CTL_HEAD): the iteration count (two words), the next base
# item, the next extra ticket, the queue's tail, the folded pixels.
FRAME_CTL_HEAD = 8
# The forms of each instantiation, and the suffix of their entry points.
FRAME_FORMS = {"solo": "_solo", "group": "", "spill": "_spill"}
# The group widths of each (kind, form), base items then extra items
# (KB, KE), mirrored from csrc/frame_queue.cuh (GROUP_KB_FRAME*,
# GROUP_KE_FRAME*; tests/test_torch_frame_queue.py reads them there). The
# thread per item ('solo') takes base items one a lane.
FRAME_QUEUE_K = {("ref", "solo"): (1, 32), ("ext", "solo"): (1, 16),
                 ("xt", "solo"): (1, 8), ("grid", "solo"): (1, 32),
                 ("gathered", "solo"): (1, 8),
                 ("ref", "group"): (32, 32), ("ext", "group"): (16, 32),
                 ("xt", "group"): (8, 16), ("grid", "group"): (8, 32),
                 ("gathered", "group"): (4, 16), ("ref", "spill"): (32, 32),
                 ("ext", "spill"): (32, 32), ("xt", "spill"): (32, 32),
                 ("grid", "spill"): (32, 32)}


def frame_nec(tracer) -> int:
    """The extra chunks of a pixel's frame: none when base >= spp."""
    return (tracer.n_extra_chunks if tracer.base_samples < tracer.spp
            else 0)


def frame_queue_words(n: int, nbc: int, nec: int) -> tuple:
    """(u32 words of the zeroed control buffer, f32 words of the scratch)
    of the queue schedule over n pixels, nbc base and nec extra chunks
    (csrc/group.cuh frame_queue): the head, the queue [n * nec] and the
    per-pixel base and extra counters; the base chunk planes [7][nbc][n]
    (nbc > 1), the extra chunk planes [4][nec][n] (nec > 1), the folded
    base [5][n] and the end states [n]."""
    ctl = FRAME_CTL_HEAD + n * nec + 2 * n
    scratch = ((7 * nbc * n if nbc > 1 else 0)
               + (4 * nec * n if nec > 1 else 0) + 6 * n)
    return ctl, scratch


def frame_form(tracer) -> str:
    """The form of the queue kernel a tracer takes: 'solo' (one thread an
    item) below GROUP_BASE_MIN_PRIMS primitives, as kernel A keeps its
    thread per pixel there; 'spill' (GroupSpill, GroupCulledSpill) where
    the staged rows exceed GROUP_SMEM_BYTES (the walk stages none: always
    'group'); else 'group'. A dispatch by the scene alone."""
    if tracer.scene.primitive_count < GROUP_BASE_MIN_PRIMS:
        return "solo"
    if _kind(tracer) != "gathered" and _over_budget(tracer):
        return "spill"
    return "group"


def frame_queue_entry(mode: str, kind: str, form: str) -> str:
    """The C entry point of kernel C ('regen') or D ('lockstep') on the
    queue schedule, instantiation `kind`, form `form`."""
    sfx = "" if kind == "ref" else f"_{kind}"
    return f"trt_kernel_{mode}{sfx}_queue{FRAME_FORMS[form]}"


def frame_queue_per_sm(tracer, mode: str, pose=None, lib=None) -> int:
    """The resident blocks an SM of the queue entry `tracer` takes in
    `mode`, at its staged rows (on the card; `lib` default the render
    libraries)."""
    lib = lib or load_kernels()
    kind = _kind(tracer)
    entry = frame_queue_entry(mode, kind, frame_form(tracer))
    pose = np.zeros(12, np.float32) if pose is None else pose
    args = _frame_args(tracer, pose, 0, 0, 0, tracer.height)
    acc = (ctypes.byref(accel_args(tracer)) if kind in ("grid", "gathered")
           else None)
    return int(getattr(lib, entry + "_per_sm")(ctypes.byref(args), acc))


def _launch_frame_queue(tracer, mode, pose, seed, frame_number, y0, h_out,
                        form, lib=None) -> FrameOut:
    device = tracer.tables.buf.device
    h_out = tracer.height if h_out is None else h_out
    n = h_out * tracer.width
    n_ctl, n_scratch = frame_queue_words(n, tracer.n_base_chunks,
                                         frame_nec(tracer))
    out = torch.empty((6, n), dtype=torch.float32, device=device)
    ctl = torch.zeros((n_ctl,), dtype=torch.int32, device=device)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    args = _frame_args(tracer, pose, seed, frame_number, y0, h_out)
    kind = _kind(tracer)
    name = frame_queue_entry(mode, kind, form)
    lib = lib or load_kernels()
    _check(getattr(lib, name)(
        ctypes.byref(args), *_inst_args(tracer, kind),
        tracer.tables.buf.data_ptr(), out.data_ptr(), ctl.data_ptr(),
        scratch.data_ptr(), _stream(device)), name.replace("trt_", ""))
    return _frame_out(out, ctl[:2].view(torch.int64)[0], h_out,
                      tracer.width)


def _frame_queue_kernel(mode: str, kind: str, form: str):
    """The wrapper of kernel C or D's queue entry of instantiation `kind`,
    form `form`."""
    sfx = "" if kind == "ref" else f"_{kind}"
    name = f"{mode}_kernel{sfx}_queue{FRAME_FORMS[form]}"

    def wrapper(tracer, pose, seed: int, frame_number: int, y0: int = 0,
                h_out: int = None, lib=None) -> FrameOut:
        if _kind(tracer) != kind:
            raise ValueError(f"{name}: the tracer takes the "
                             f"{_kind(tracer)!r} instantiation")
        if frame_form(tracer) != form:
            raise ValueError(f"{name}: the tracer takes the "
                             f"{frame_form(tracer)!r} form")
        if not _on_cuda(tracer.tables.buf.device, name):
            return render_frame_plain(tracer, mode, pose, seed, frame_number,
                                      y0, h_out)
        out = _launch_frame_queue(tracer, mode, pose, seed, frame_number, y0,
                                  h_out, form, lib)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"Kernel {'C' if mode == 'regen' else 'D'} ({mode}) on the queue "
        f"schedule, the {kind} instantiation, form {form!r} (csrc/group.cuh "
        "kernel_frame_queue): rows [y0, y0 + h_out) of the frame. Returns "
        "FrameOut.")
    wrapper.launches = 0
    return wrapper


KINDS = ("ref", "ext", "xt", "grid", "gathered")
FRAME_QUEUE = {(mode, kind, form): _frame_queue_kernel(mode, kind, form)
               for mode in ("regen", "lockstep") for kind in KINDS
               for form in FRAME_FORMS
               if not (kind == "gathered" and form == "spill")}
for _w in FRAME_QUEUE.values():
    globals()[_w.__name__] = _w
del _w


def _frame_kernel(mode: str, kind: str):
    """The wrapper of kernel C or D's `kind` instantiation: it passes a
    tracer on the card to its queue entry (FRAME_QUEUE, by frame_form); the
    'ref' wrapper passes a tracer of another kind on to its twin. Its own
    count stays 0: the thread-per-pixel entries are launched only directly
    (_launch_frame)."""
    name = f"{mode}_kernel" + ("" if kind == "ref" else f"_{kind}")

    def wrapper(tracer, pose, seed: int, frame_number: int, y0: int = 0,
                h_out: int = None) -> FrameOut:
        if kind == "ref" and _kind(tracer) != "ref":
            return FRAME_KERNELS[mode, _kind(tracer)](
                tracer, pose, seed, frame_number, y0, h_out)
        if _kind(tracer) != kind:
            raise ValueError(f"{name}: the tracer takes the "
                             f"{_kind(tracer)!r} instantiation")
        if not _on_cuda(tracer.tables.buf.device, name):
            return render_frame_plain(tracer, mode, pose, seed, frame_number,
                                      y0, h_out)
        return FRAME_QUEUE[mode, kind, frame_form(tracer)](
            tracer, pose, seed, frame_number, y0, h_out)

    wrapper.__name__ = wrapper.__qualname__ = name
    which = "any tracer" if kind == "ref" else f"the {kind} instantiation"
    wrapper.__doc__ = (
        f"Kernel {'C' if mode == 'regen' else 'D'} ({mode}), {which}: rows "
        "[y0, y0 + h_out) of the frame, on the queue schedule "
        "(the *_queue entries of csrc/kernel_frame.cu and "
        "kernel_frame_lockstep.cu). Returns FrameOut.")
    wrapper.launches = 0
    return wrapper


FRAME_KERNELS = {(mode, kind): _frame_kernel(mode, kind)
                 for mode in ("regen", "lockstep")
                 for kind in KINDS}
regen_kernel = FRAME_KERNELS["regen", "ref"]
regen_kernel_ext = FRAME_KERNELS["regen", "ext"]
regen_kernel_xt = FRAME_KERNELS["regen", "xt"]
regen_kernel_grid = FRAME_KERNELS["regen", "grid"]
regen_kernel_gathered = FRAME_KERNELS["regen", "gathered"]
lockstep_kernel = FRAME_KERNELS["lockstep", "ref"]
lockstep_kernel_ext = FRAME_KERNELS["lockstep", "ext"]
lockstep_kernel_xt = FRAME_KERNELS["lockstep", "xt"]
lockstep_kernel_grid = FRAME_KERNELS["lockstep", "grid"]
lockstep_kernel_gathered = FRAME_KERNELS["lockstep", "gathered"]


def make_render_frame(tracer, mode: str = "sorted"):
    """``render_frame(pose, seed, frame_number[, arrays]) -> (current V3,
    variance, total samples, rays, occupancy)`` through the scheduler
    `mode`: 'sorted' (make_sorted_render_frame), 'regen' (kernel C) or
    'lockstep' (kernel D), one launch a frame. Rays and occupancy are 0-dim
    f64 tensors on the device (no host sync); regen's occupancy denominator
    is its executed lane-iterations, lockstep's the static lockstep_iters.
    A dynamic tracer takes the frame's ops/dynamic.pack_scene `arrays`."""
    if mode == "sorted":
        return make_sorted_render_frame(tracer)
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}")
    kernel = FRAME_KERNELS[mode, "ref"]
    sweeps_per_iter = 1.0 + tracer.nee_sweeps
    static = _iters_tensor(lockstep_iters(tracer), tracer.device)

    def render_frame(pose, seed: int, frame_number: int, arrays=None):
        if tracer.dynamic:
            tracer.bind_packed(arrays)
        out = kernel(tracer, pose, seed, frame_number)
        rays = out.rays.sum(dtype=torch.float64)
        iters = out.iters if mode == "regen" else static
        occ = rays / torch.clamp(iters * sweeps_per_iter, min=1.0)
        return out.current, out.var, out.total, rays, occ

    return render_frame
