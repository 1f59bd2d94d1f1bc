"""device_idle: percent of the traced sub-window in which no operation ran
on the device (the complement of the union of its activity intervals)."""

from harness import stats


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0.0:
        return None
    busy = stats.busy_seconds([(a, b) for _, a, b in tl.events], tl.t0,
                              tl.t1)
    return 100.0 * (1.0 - busy / tl.window_s)
