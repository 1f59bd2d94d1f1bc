"""The metric arithmetic: rates over a window, tails over every sample, and
busy and idle time on a device timeline."""

from __future__ import annotations

import bisect


def window_rate(work: float, t0: float, t1: float) -> float:
    """All the work of a window over all of its time."""
    if t1 <= t0:
        raise ValueError("empty window")
    return work / (t1 - t0)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, by linear
    interpolation between order statistics (numpy's default method)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return float(vals[lo] + (vals[hi] - vals[lo]) * (pos - lo))


def move_latencies(presses, displays) -> list:
    """Seconds from each press's due time to the display of the first frame
    dispatched after the press was delivered. `presses`: (due time,
    dispatches before delivery); `displays`: (time, dispatch index of the
    frame shown), in time order. A press whose frame is never shown gives
    no latency."""
    out, j = [], 0
    for due, n_before in presses:
        while j < len(displays) and displays[j][0] < due:
            j += 1
        k = j
        while k < len(displays) and (displays[k][1] is None
                                     or displays[k][1] < n_before):
            k += 1
        if k < len(displays):
            out.append(displays[k][0] - due)
    return out


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                     if b > lo and a < hi)
    out = []
    for a, b in clipped:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_seconds(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(intervals, lo, hi))


def idle_intervals(intervals, lo: float, hi: float) -> list:
    """The gaps of [lo, hi] in which no interval runs."""
    gaps, t = [], lo
    for a, b in union(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def attribute(gaps, spans: dict) -> dict:
    """Idle seconds by what the host was doing: each gap's overlap with the
    host spans of each label; time no span covers goes to 'other'. The
    spans of one label do not overlap one another."""
    ordered = {label: sorted(ivs) for label, ivs in spans.items()}
    ends = {label: [y for _, y in ivs] for label, ivs in ordered.items()}
    out = {}
    for a, b in gaps:
        covered = 0.0
        for label, ivs in ordered.items():
            s, i = 0.0, bisect.bisect_right(ends[label], a)
            while i < len(ivs) and ivs[i][0] < b:
                s += max(0.0, min(b, ivs[i][1]) - max(a, ivs[i][0]))
                i += 1
            if s > 0.0:
                out[label] = out.get(label, 0.0) + s
                covered += s
        rest = (b - a) - covered
        if rest > 0.0:
            out["other"] = out.get("other", 0.0) + rest
    return out

