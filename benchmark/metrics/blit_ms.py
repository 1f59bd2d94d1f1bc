"""blit_ms: mean host milliseconds of Blitter.encode for a displayed frame,
from the harness's span around the call."""


def read(ctx):
    spans = (ctx.spans or {}).get("encode") or []
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
