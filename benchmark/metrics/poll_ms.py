"""poll_ms: mean host milliseconds of one key poll of the viewer loop (the
scripted terminal's poll, which waits its timeout where no key is due)."""


def read(ctx):
    spans = (ctx.spans or {}).get("poll") or []
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
