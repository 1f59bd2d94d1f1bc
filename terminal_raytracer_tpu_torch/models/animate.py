"""Built-in scene animators for the --animate mode.

An animator maps (packed0, t) -> packed arrays (the ops.dynamic.pack_scene
layout), host-side NumPy on a handful of scalars per frame — the per-frame
analog of the reference's per-frame uniform refresh (src/lib.rs:418-442),
extended to the geometry its storage-buffer design could have re-uploaded
but never did (SURVEY.md §3.4: "no rebuilds, no animation of primitives").
The compiled step consumes the arrays as runtime inputs; nothing retraces.
"""

from __future__ import annotations

import numpy as np

OMEGA = 0.05  # radians (orbit) / phase units (pulse) per frame


def _centroid_xz(arrays):
    pts = []
    if arrays["s_cx"].size:
        pts.append(np.stack([arrays["s_cx"], arrays["s_cz"]], -1))
    for a, c in (("t_ax", "t_az"), ("t_bx", "t_bz"), ("t_cx", "t_cz")):
        if arrays[a].size:
            pts.append(np.stack([arrays[a], arrays[c]], -1))
    if not pts:
        return 0.0, -3.0
    cat = np.concatenate(pts)
    return float(cat[:, 0].mean()), float(cat[:, 1].mean())


def orbit(arrays0, t):
    """Rotate all spheres and triangles about the vertical axis through the
    finite geometry's centroid (planes are infinite — they stay)."""
    cx, cz = _centroid_xz(arrays0)
    ang = OMEGA * t
    c, s = np.cos(ang), np.sin(ang)
    out = dict(arrays0)

    def rot(xk, zk):
        x = arrays0[xk] - cx
        z = arrays0[zk] - cz
        out[xk] = (cx + c * x + s * z).astype(np.float32)
        out[zk] = (cz - s * x + c * z).astype(np.float32)

    rot("s_cx", "s_cz")
    for xk, zk in (("t_ax", "t_az"), ("t_bx", "t_bz"), ("t_cx", "t_cz")):
        rot(xk, zk)
    return out


def pulse(arrays0, t):
    """Breathe every light's emission between 10% and 100%."""
    k = np.float32(0.55 + 0.45 * np.sin(OMEGA * 2.0 * t))
    out = dict(arrays0)
    for prefix in ("s", "p", "t"):
        for ch in ("emir", "emig", "emib"):
            out[f"{prefix}_{ch}"] = (arrays0[f"{prefix}_{ch}"] * k).astype(
                np.float32
            )
    return out


def bob(arrays0, t):
    """Bounce spheres vertically, each with a phase offset by index."""
    out = dict(arrays0)
    n = arrays0["s_cy"].size
    if n:
        phase = OMEGA * 3.0 * t + np.arange(n) * (2.0 * np.pi / max(n, 1))
        out["s_cy"] = (
            arrays0["s_cy"] + 0.25 * np.abs(np.sin(phase))
        ).astype(np.float32)
    return out


ANIMATORS = {"orbit": orbit, "pulse": pulse, "bob": bob}

# The pack_scene keys each animator actually varies. Everything outside an
# animator's set is folded back to baked constants by the dynamic traversal
# (ops/dynamic.DynPrims `animated=`): an orbit keeps its axis-aligned
# planes at baked-sweep cost, a pulse keeps ALL geometry baked and streams
# only emission. test_dynamic pins each set against the animator's output.
ANIMATOR_KEYS = {
    "orbit": frozenset({
        "s_cx", "s_cz", "t_ax", "t_az", "t_bx", "t_bz", "t_cx", "t_cz",
    }),
    "pulse": frozenset({
        f"{p}_{ch}" for p in ("s", "p", "t")
        for ch in ("emir", "emig", "emib")
    }),
    "bob": frozenset({"s_cy"}),
}
