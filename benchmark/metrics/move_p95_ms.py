"""move_p95_ms: 95th percentile, over every key press of the window, of
the seconds from the press's due time to the display of the first frame
dispatched after its delivery, in milliseconds (the viewer's answer to a
key; the traced sub-window's profiler slows 2 s of the window)."""

from harness import stats


def read(ctx):
    lat = ctx.move_latencies
    if not lat:
        return None
    return 1e3 * stats.percentile(lat, 95.0)
