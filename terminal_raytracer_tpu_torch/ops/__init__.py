"""The compute path: math, RNG, sampling, scene sweeps, the reference
transport in plain PyTorch, the CUDA kernel pipeline, tonemap."""
