"""Image IO — the port's copy of ``terminal_raytracer_tpu/utils/imageio.py``
(textures load through it)."""
