"""enqueue_ms: mean host milliseconds of Engine.render_one (the frame's
dispatch; it does not wait for the device)."""


def read(ctx):
    spans = (ctx.spans or {}).get("enqueue") or []
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
