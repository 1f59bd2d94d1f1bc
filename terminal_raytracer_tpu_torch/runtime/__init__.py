"""Runtime: render step + frame state, engine, ANSI blitter, terminal,
phase timers."""

from .state import (FrameOutput, FrameState, init_state,  # noqa: F401
                    make_render_step, state_from_numpy, state_to_numpy)
