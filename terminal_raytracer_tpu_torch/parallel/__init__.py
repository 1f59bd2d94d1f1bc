"""Multi-GPU rendering over a ('px', 'sp') mesh of torch.distributed ranks."""

from .mesh import (Mesh, SampleSplit, make_mesh,  # noqa: F401
                   make_sharded_render_step, sample_split_frame)
