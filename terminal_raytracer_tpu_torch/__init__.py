"""terminal_raytracer_tpu_torch — the terminal path tracer on PyTorch with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of ``terminal_raytracer_tpu`` (JAX/Pallas), which stays the
reference it is tested against. Layout follows the JAX package:

  models/    scene schema and loader, procedural scenes, meshes, textures,
             animators, fly camera (the port's own copy, numpy only)
  ops/       vecmath, rng, sampling, geometry (scene tables + sweeps),
             dynamic (per-frame scene tables of animated scenes), tracer
             (the reference transport in plain PyTorch), kernels (the
             sorted two-kernel pipeline and its CUDA wrappers), build
             (nvcc + ctypes), tonemap
  runtime/   render step + frame state, offline renderers (scan, chunk,
             orbit, animation), engine, ANSI blitter, terminal, timers
  utils/     image IO, checkpoints (statefile)
  csrc/      the CUDA kernels (kernel_base.cu, kernel_extra.cu, trace.cuh)
             and the ANSI blitter (blit.cpp)

Nothing here imports jax or the JAX package.
"""
