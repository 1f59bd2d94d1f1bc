"""Multi-GPU rendering over a ('px', 'sp') mesh of ranks —
``terminal_raytracer_tpu/parallel/mesh.py`` on ``torch.distributed``.

Rank r of a world of n_px * n_sp ranks holds mesh position
(px_i, sp_i) = divmod(r, n_sp), the JAX package's
``np.array(devices).reshape(n_px, n_sp)``. Two axes:

* ``px``: pixel-row data parallelism. Each px row block of H / n_px rows
  renders on its own, through the single-device sorted pipeline of
  ops/kernels.py over its rows (chains are seeded by global pixel, so the
  blocks tile the single-device frame bit for bit). No collective until
  the frame's totals and the display.
* ``sp``: sample parallelism with the reference's adaptive statistics.
  The base budget max(4, spp // 4) is split over the sp ranks of a row
  block (floor shares, the remainder to the lowest indices): each renders
  its share through kernel A with a runtime quota, on its own seed
  (seed + sp_i * SEED_STRIDE, mod 2**32). The per-pixel sums are summed
  over sp, so the variance and the extra budget come from all base
  samples, as on one device. The budget is split over sp the same way,
  each rank renders its share through kernel B continuing its own chain
  at its own base share, and a second sum over sp merges the extra sums
  before the reference's normalisation. Only the RNG streams differ from
  one device.

The sample split is written as named phases of :class:`SampleSplit`
(base, budget, extra, normalise) joined by :func:`render_split`, whose
`reduce` sums one phase's tensors over sp: ``dist.all_reduce`` over the
rank's sp group in :func:`make_sharded_render_step`, the tensors of every
shard added in rank order in :func:`sample_split_frame`, which runs all
shards of a row block in one process (the same phases without a process
group).

Which group reduces what: sums, rays and executed lane-iterations over
the sp group (the ranks of one row block) inside the step; rays and the
occupancy's denominator over the px group (the ranks of one sample share
across row blocks) at the end; an all-reduce over the world would count
each block n_sp times.

The caller initialises the process group (backend 'nccl' for CUDA
devices, one device per rank; 'gloo' on the CPU); :func:`make_mesh`
builds every row's and column's group over it. ``torch.distributed`` is
imported only where a group is used.
"""

from __future__ import annotations

import functools
import operator
import os
from typing import NamedTuple, Optional, Sequence

import torch

from ..models import scene as scene_mod
from ..ops import denoise as dn
from ..ops import kernels
from ..ops import tonemap as tm
from ..ops.tracer import PathTracer, base_sample_count
from ..ops.vecmath import V3
from ..runtime.state import FrameOutput, FrameState, accumulate, display

SEED_STRIDE = 2654435761  # Knuth's multiplicative-hash odd constant
MASK32 = 0xFFFFFFFF


class Mesh(NamedTuple):
    """This rank's place in the ('px', 'sp') mesh, its device and its
    groups: `sp_group` holds the ranks of its row block (px_i fixed),
    `px_group` those of its sample share (sp_i fixed)."""

    n_px: int
    n_sp: int
    px_i: int
    sp_i: int
    device: torch.device
    sp_group: object
    px_group: object

    def rank_of(self, px_i: int, sp_i: int) -> int:
        return px_i * self.n_sp + sp_i


def make_mesh(n_px: int, n_sp: int = 1, device="cuda") -> Mesh:
    """The mesh over the caller's process group, whose world size must be
    n_px * n_sp, on the card unless `device` says otherwise. A CUDA
    `device` needs the 'nccl' backend and a device of its own on its host
    (NCCL refuses two ranks on one device); the CPU needs 'gloo'. Every
    rank creates every group, in the same order."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a px:{n_px},sp:{n_sp} mesh needs an initialised "
                         f"process group of {n_px * n_sp} ranks")
    world = dist.get_world_size()
    if n_px < 1 or n_sp < 1 or world != n_px * n_sp:
        raise ValueError(f"shard px:{n_px},sp:{n_sp} needs {n_px * n_sp} "
                         f"ranks, the process group has {world}")
    device = torch.device(device)
    backend = dist.get_backend()
    if device.type == "cuda":
        if backend != "nccl":
            raise ValueError(f"a mesh on CUDA devices reduces over nccl, "
                             f"not {backend}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if local > torch.cuda.device_count():
            raise ValueError(
                f"{local} ranks on this host and {torch.cuda.device_count()} "
                "CUDA devices: NCCL needs a device of its own for each rank")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif backend != "gloo":
        raise ValueError(f"a mesh on the CPU reduces over gloo, not {backend}")
    rows = [dist.new_group([p * n_sp + s for s in range(n_sp)])
            for p in range(n_px)]
    cols = [dist.new_group([p * n_sp + s for p in range(n_px)])
            for s in range(n_sp)]
    px_i, sp_i = divmod(dist.get_rank(), n_sp)
    return Mesh(n_px, n_sp, px_i, sp_i, device, rows[px_i], cols[sp_i])


def join_process_group(device: str):
    """This rank's process group: the caller's, or one initialised from
    torchrun's RANK / WORLD_SIZE / LOCAL_RANK (nccl on cuda:LOCAL_RANK,
    which becomes the current device; gloo on the CPU). Returns (this
    rank's device, whether this call initialised the group); raises
    ValueError where there is none to be had."""
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cuda":
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank with LOCAL_RANK {local} and "
                f"{torch.cuda.device_count()} CUDA devices: NCCL needs a "
                "device of its own for each rank")
        device = f"cuda:{local}"
        torch.cuda.set_device(torch.device(device))
    if dist.is_initialized():
        return device, False
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise ValueError("a mesh needs a process group of px * sp ranks: "
                         "run under torchrun --nproc-per-node N")
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device, True


# ---------------------------------------------------------------------------
# The sample split as phases
# ---------------------------------------------------------------------------


class ShardBase(NamedTuple):
    """One sp shard's base phase: `sums` f32 [6, rows, w] (csum rgb,
    csumsq rgb), its end RNG `state`, and `stats` f64 [2] (owed rays,
    executed lane-iterations)."""

    sums: torch.Tensor
    state: torch.Tensor
    stats: torch.Tensor


class SampleSplit:
    """The phases of the sample-split render of the row block
    [y0, y0 + rows) over n_sp shards (module docstring). The tracer's
    base_quota is the ceiling share; kernel A takes each shard's share as
    its runtime quota (ops/kernels.py base_q)."""

    def __init__(self, scene: scene_mod.Scene, device, n_sp: int, y0: int = 0,
                 rows: Optional[int] = None, transport: str = "reference",
                 dynamic: bool = False):
        self.n_sp, self.y0 = n_sp, y0
        self.rows = scene.height if rows is None else rows
        self.spp = scene.samples_per_pixel
        self.base_full = base_sample_count(self.spp)
        self.base_lo, self.base_rem = divmod(self.base_full, n_sp)
        self.tracer = PathTracer(
            scene, device, transport=transport, dynamic=dynamic,
            base_quota=self.base_lo + (1 if self.base_rem else 0))
        self.sweeps_per_iter = 1.0 + self.tracer.nee_sweeps
        self._extra = (kernels.make_sorted_extra_phase(self.tracer, y0)
                       if self.base_full < self.spp else None)
        # A tensor divisor: CUDA turns / python_scalar into a reciprocal
        # multiply, and floor would then lose one at multiples of n_sp.
        self._n_sp = torch.tensor(float(n_sp), device=self.tracer.device)

    def share(self, sp_i: int) -> int:
        """Shard sp_i's base samples."""
        return self.base_lo + (1 if sp_i < self.base_rem else 0)

    @staticmethod
    def seed(seed: int, sp_i: int) -> int:
        """Shard sp_i's frame seed (host ints: no u32 wrap on the device)."""
        return (int(seed) + sp_i * SEED_STRIDE) & MASK32

    def base(self, pose, seed: int, frame_number: int, sp_i: int) -> ShardBase:
        """Kernel A for shard sp_i: its share of the base samples on its
        seed."""
        a = kernels.base_kernel(self.tracer, pose, self.seed(seed, sp_i),
                                frame_number, self.y0, self.rows,
                                base_q=self.share(sp_i))
        # Kernel A's variance and budget are of the shard's share alone:
        # the budget phase recomputes them from the merged sums.
        return ShardBase(torch.stack([*a.csum, *a.csumsq]), a.state,
                         torch.stack([a.rays.sum(dtype=torch.float64),
                                      a.iters]))

    def budget(self, sums: torch.Tensor):
        """(variance, needs, additional) of the sums merged over sp: the
        variance of all base_full samples, the extra budget as on one
        device (needs and additional are None when base_full >= spp)."""
        tr = self.tracer
        var = tr.variance_of(V3(*sums[:3]), V3(*sums[3:]), self.base_full)
        if self._extra is None:
            return var, None, None
        needs, additional = tr.extra_quota(var, self.base_full)
        return var, needs, additional

    def extra(self, pose, state, additional, sp_i: int):
        """Kernel B for shard sp_i: its share of each pixel's budget
        (floor(additional / n_sp), one more below the remainder),
        continuing its chain at its base share. Returns (esum f32
        [3, rows, w], stats f64 [2])."""
        share_q = torch.floor(additional / self._n_sp)
        share_rem = additional - share_q * float(self.n_sp)
        mine = share_q + (share_rem > float(sp_i)).to(torch.float32)
        esum, rays, iters = self._extra(pose, state, mine,
                                        samp0=self.share(sp_i))
        return torch.stack(list(esum)), torch.stack([rays, iters])

    def normalise(self, sums, esums, needs, additional):
        """(current V3, total samples): the reference's normalisation on
        the merged sums."""
        csum = V3(*sums[:3])
        if needs is None:
            current = csum * (1.0 / self.spp)
            return current, torch.full_like(csum.x, float(self.base_full))
        return self.tracer.combine_phases(csum, V3(*esums), needs, additional,
                                          self.base_full)


def render_split(split: SampleSplit, shards: Sequence[int], pose, seed: int,
                 frame_number: int, reduce):
    """The sample-split frame of a row block from the shards `shards` that
    this process renders: base -> sum over sp -> budget -> extra -> sum
    over sp -> normalise. `reduce(tensors)` returns the sum over sp of one
    phase's tensors (one per shard in `shards`). Returns (current V3,
    variance, total, rays, executed lane-iteration sweeps)."""
    bases = [split.base(pose, seed, frame_number, i) for i in shards]
    sums = reduce([b.sums for b in bases])
    stats = reduce([b.stats for b in bases])
    var, needs, additional = split.budget(sums)
    esums = None
    if needs is not None:
        extras = [split.extra(pose, b.state, additional, i)
                  for b, i in zip(bases, shards)]
        esums = reduce([e[0] for e in extras])
        stats = stats + reduce([e[1] for e in extras])
    current, total = split.normalise(sums, esums, needs, additional)
    return current, var, total, stats[0], stats[1] * split.sweeps_per_iter


def sample_split_frame(split: SampleSplit, pose, seed: int,
                       frame_number: int, arrays=None):
    """Every shard of the split in this process, each phase's tensors added
    in rank order: the sharded step's render of a row block without a
    process group. Returns render_split's tuple."""
    if split.tracer.dynamic:
        split.tracer.bind_packed(arrays)
    return render_split(split, range(split.n_sp), pose, seed, frame_number,
                        lambda ts: functools.reduce(operator.add, ts))


# ---------------------------------------------------------------------------
# The sharded render step
# ---------------------------------------------------------------------------


def make_sharded_render_step(scene: scene_mod.Scene, mesh: Mesh,
                             full_color: bool = True,
                             transport: str = "reference",
                             dynamic: bool = False, denoise: float = 0.0,
                             denoise_passes: int = 3, tonemap="reference",
                             exposure: float = 0.0):
    """The multi-GPU render step, with the call shape of
    runtime/state.make_render_step: returns ``(step, init_state)``, where
    ``step(state, pose, seed, frame_number[, arrays]) -> FrameOutput`` on
    this rank's row block ([3, rows, w] accumulation, [rows, w] planes and
    image; rays and occupancy over the whole mesh) and ``init_state()``
    gives the block's zero FrameState. Every rank calls the step with the
    same arguments (runtime/engine.py broadcasts them from rank 0).
    `denoise` > 0 filters the accumulation before tonemapping, exchanging
    halo rows with the neighbouring row blocks (denoise_sharded);
    `tonemap` and `exposure` are the display transform, as in
    make_render_step."""
    import torch.distributed as dist

    mode = tm.parse_mode(tonemap)
    scale = 2.0 ** float(exposure)

    h, w = scene.height, scene.width
    if h % mesh.n_px:
        raise ValueError(f"height={h} not divisible by px={mesh.n_px}")
    rows = h // mesh.n_px
    y0 = mesh.px_i * rows
    if mesh.n_sp == 1:
        tracer = PathTracer(scene, mesh.device, dynamic=dynamic,
                            transport=transport)
        render = kernels.make_sorted_render_frame(tracer, y0, rows).sweeps
    else:
        split = SampleSplit(scene, mesh.device, mesh.n_sp, y0, rows,
                            transport, dynamic)
        tracer = split.tracer

        def reduce(ts):
            dist.all_reduce(ts[0], group=mesh.sp_group)
            return ts[0]

        def render(pose, seed, frame_number, arrays=None):
            if dynamic:
                tracer.bind_packed(arrays)
            return render_split(split, (mesh.sp_i,), pose, seed,
                                frame_number, reduce)

    def step(state: FrameState, pose, seed, frame_number,
             arrays=None) -> FrameOutput:
        current, variance, samples, rays, sweeps = render(
            pose, int(seed), int(frame_number), arrays)
        acc_v = accumulate(state.acc, current, int(frame_number))
        acc_v = denoise_acc_sharded(acc_v, variance, samples,
                                    int(frame_number), denoise,
                                    denoise_passes, mesh)
        rgb, glyphs = display(acc_v, full_color, mode, scale)
        totals = torch.stack([rays, sweeps])
        dist.all_reduce(totals, group=mesh.px_group)
        occ = totals[0] / torch.clamp(totals[1], min=1.0)
        return FrameOutput(FrameState(state.acc, variance, samples), rgb,
                           glyphs, totals[0], occ)

    def init_state() -> FrameState:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=mesh.device)

        return FrameState(zeros(3, rows, w), zeros(rows, w), zeros(rows, w))

    step.tracer = tracer
    return step, init_state


def gather_frame(mesh: Mesh, out: FrameOutput):
    """Rank 0 gathers the row blocks of sample share 0 (its px group):
    (rgb u8 [H, W, 3], glyphs u8 [H, W], mean samples as a 0-dim tensor)
    on rank 0, None on every other rank. A collective of the ranks with
    sp_i == 0; the others return at once."""
    if mesh.sp_i != 0:
        return None
    block = torch.cat([out.rgb, out.glyphs[..., None]], dim=-1)
    samples = out.state.samples
    if mesh.n_px > 1:
        block = _gather_rows(mesh, block.contiguous())
        samples = _gather_rows(mesh, samples.contiguous())
    if block is None:
        return None
    return block[..., :3], block[..., 3], samples.mean()


def gather_state(mesh: Mesh, state: FrameState):
    """Rank 0 gathers the row blocks of sample share 0's state (a
    checkpoint of the whole image): the FrameState on rank 0, None on
    every other rank. A collective of the ranks with sp_i == 0."""
    if mesh.sp_i != 0:
        return None
    if mesh.n_px == 1:
        return state
    acc = _gather_rows(mesh, state.acc.permute(1, 0, 2).contiguous())
    planes = _gather_rows(mesh, torch.stack([state.variance,
                                             state.samples], 1))
    if acc is None:
        return None
    return FrameState(acc.permute(1, 0, 2).contiguous(), planes[:, 0],
                      planes[:, 1])


def state_rows(mesh: Mesh, state: FrameState) -> FrameState:
    """This rank's row block of a whole-image FrameState, on its device."""
    rows = state.variance.shape[0] // mesh.n_px
    r = slice(mesh.px_i * rows, (mesh.px_i + 1) * rows)
    return FrameState(*(t[..., r, :].to(mesh.device).contiguous()
                        for t in state))


def _gather_rows(mesh: Mesh, t: torch.Tensor):
    """The row blocks `t` of the px group concatenated on global rank 0,
    None elsewhere."""
    import torch.distributed as dist

    root = mesh.px_i == 0
    parts = [torch.empty_like(t) for _ in range(mesh.n_px)] if root else None
    dist.gather(t, parts, dst=mesh.rank_of(0, mesh.sp_i),
                group=mesh.px_group)
    return torch.cat(parts) if root else None


# ---------------------------------------------------------------------------
# The à-trous denoiser over row blocks (ops/denoise.py)
# ---------------------------------------------------------------------------


def _exchange_halo(planes: torch.Tensor, halo: int, mesh: Mesh):
    """Pad [c, rows, w] blocks to [c, rows + 2 * halo, w] with the
    neighbouring blocks' rows over the px group; the global top and bottom
    edges replicate, as the single-device filter's border does."""
    import torch.distributed as dist

    top = planes[:, :1].expand(-1, halo, -1).contiguous()
    bot = planes[:, -1:].expand(-1, halo, -1).contiguous()
    ops = []
    if mesh.px_i > 0:
        peer = mesh.rank_of(mesh.px_i - 1, mesh.sp_i)
        ops += [dist.P2POp(dist.isend, planes[:, :halo].contiguous(), peer,
                           mesh.px_group),
                dist.P2POp(dist.irecv, top, peer, mesh.px_group)]
    if mesh.px_i < mesh.n_px - 1:
        peer = mesh.rank_of(mesh.px_i + 1, mesh.sp_i)
        ops += [dist.P2POp(dist.isend, planes[:, -halo:].contiguous(), peer,
                           mesh.px_group),
                dist.P2POp(dist.irecv, bot, peer, mesh.px_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([top, planes, bot], dim=1)


def denoise_sharded(color: V3, var: torch.Tensor, strength: float,
                    passes: int, mesh: Mesh) -> V3:
    """ops/denoise.denoise of this rank's row block, bit-identical to the
    rows of the single-device filter of the whole image. Each pass pads
    the block with 2 * stride halo rows from the neighbouring px ranks;
    when the widest pass's halo exceeds a block (2 * 2**(passes - 1) >
    rows), one all_gather of the planes runs the single-device filter."""
    import torch.distributed as dist

    if strength <= 0.0 or passes <= 0:
        return color
    if mesh.n_px == 1:
        return dn.denoise(color, var, strength, passes)
    rows = color.x.shape[0]
    planes = torch.stack([*color, torch.clamp(var, min=0.0)])
    if 2 * (1 << (passes - 1)) > rows:
        parts = [torch.empty_like(planes) for _ in range(mesh.n_px)]
        dist.all_gather(parts, planes, group=mesh.px_group)
        full = torch.cat(parts, dim=1)
        out = dn.denoise(V3(*full[:3]), full[3], strength, passes)
        r0 = mesh.px_i * rows
        return V3(*(c[r0:r0 + rows] for c in out))
    for p in range(passes):
        stride = 1 << p
        halo = 2 * stride
        padded = _exchange_halo(planes, halo, mesh)
        c, v = dn.atrous_pass(V3(*padded[:3]), padded[3], stride,
                              float(strength))
        planes = torch.stack([*c, v])[:, halo:halo + rows]
    return V3(*planes[:3])


def denoise_acc_sharded(acc: V3, variance: torch.Tensor,
                        samples: torch.Tensor, frame_number: int,
                        strength: float, passes: int, mesh: Mesh) -> V3:
    """ops/denoise.denoise_acc for the sharded render step."""
    if strength <= 0.0 or passes <= 0:
        return acc
    return denoise_sharded(acc, dn.mean_variance(variance, samples,
                                                 frame_number),
                           strength, passes, mesh)
