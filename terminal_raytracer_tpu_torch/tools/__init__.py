"""The Hopper probes: counterparts of the JAX package's Mosaic
micro-benchmarks in the repository's ``tools/``, under the same names.

  perf_probe21   per-lane gather from a 1-D table: global, __ldg and shared
                 loads, a one-hot TF32 mma.sync product, a compare-select
                 loop (tools/perf_probe21.py)
  perf_probe21b  the (16, 128) table's lane, sublane and full gathers
                 through __ldg, shared memory and warp shuffles, and the
                 3xTF32 one-hot product (tools/perf_probe21b.py)
  perf_probe21c  the texture channel's building blocks: texel index from
                 uv, atan2f against the port's polynomial atan2, the packed
                 rgb fetch (tools/perf_probe21c.py)
  probe_when     is an untaken branch skipped: warp-uniform, unguarded and
                 per-lane divergent predicates (tools/probe_when.py)
  probe_cond     the same for a carried value (tools/probe_cond.py)

and three tools of the port's own:

  group_k        the sweep over the group width K of the grouped kernel B
                 and chunked kernel A (csrc/group.cuh), each K beside the
                 thread-per-entry kernels on the same inputs (card only)
  ptxas_lines    every render kernel's ptxas registers, stack and spills,
                 beside another checkout's with --against (nvcc only)
  card_vs_cpu    the examples' scenes on the card against the CPU, frame
                 by frame: the knife-edge pixels that chip_smoke.py
                 bounds (card only)

Each runs its kernels (csrc/probes.cu) on the card and prints the JAX
script's table:  python -m terminal_raytracer_tpu_torch.tools.perf_probe21
With ``--device cpu`` it runs the plain PyTorch versions and prints
values, not times.
"""
