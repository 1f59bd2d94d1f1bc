"""kernel_roofline: percent of the FP32 peak that kernels A and B reach on
the intersection tests their frames owe.

Operations: the owed sweeps of the frames dispatched in the traced
sub-window times the FP32 operations of one sweep's tests over the scene's
primitives (harness/peaks.py). Time: the device time of the kernels whose
names hold one of KERNELS in that sub-window. Nothing to read (no trace, a
card without a listed peak, no such kernel) gives no value."""

KERNELS = ("kernel_base", "kernel_extra")


def read(ctx):
    tl = ctx.timeline
    if tl is None or not ctx.peak_fp32 or not ctx.traced_rays:
        return None
    t = sum(b - a for name, a, b in tl.events
            if any(k in name for k in KERNELS))
    if t <= 0.0:
        return None
    return 100.0 * ctx.traced_rays * ctx.ops_per_sweep / (ctx.peak_fp32 * t)
