"""Runtime: render step + frame state, offline renderers, engine, ANSI
blitter, terminal, phase timers."""

from .offline import (make_animation_scan_renderer,  # noqa: F401
                      make_chunk_renderer, make_noise_scan_renderer,
                      make_orbit_scan_renderer, make_scan_renderer,
                      render_accumulated)
from .state import (FrameOutput, FrameState, finalize,  # noqa: F401
                    init_state, make_render_step, state_from_numpy,
                    state_to_numpy)
