"""The split sweeps of the grouped kernels (csrc/group.cuh GroupSweep and
GroupCulled) in plain PyTorch: the models that the CPU tests hold to the
serial sweeps.

A path group of k lanes carries one ray. Lane j tests primitives j, j + k,
j + 2k, ... of each kind (spheres, planes, triangles) in order, feeding
its own running closest forward as each test's t_max, as the serial sweep
(csrc/trace.cuh closest_hit, k = 1) feeds its one; the lanes' results are
then reduced by (t, then primitive index) over the butterfly of
``__shfl_xor_sync`` (offsets k/2, k/4, ..., 1). A shadow sweep is each
lane's OR over its share, stopping at its first blocker, joined over the
group. Every test is ops/geometry.py's, so the model computes what the
kernels compute, over a batch of rays at once.

The culled sweep of `--accel grid` splits another way (split_culled_closest,
split_culled_occluded): a window of k groups at a time, their boxes tested
at once, then the candidate groups swept p at a time, l = k / p lanes a
group, each lane with its own running closest from the closest at the
step's start, and the serial cull decisions replayed from the groups'
minima (csrc/group.cuh GroupCulled says why that is exact). Both return
each ray's four traversal counters (ops/accel.py CulledPrims.STATS) as
the kernel counts them, once a group.

The grid walk of `--accel gathered` splits each cell (split_walk_closest,
split_walk_occluded; csrc/group.cuh GroupWalk): every lane makes the
walk's DDA decisions, and the cell's bucket is tested in windows of up to
k entries, each lane one entry with the running closest at the window's
start as t_max, the window reduced by (t, then position in the bucket).
They return the walk's four counters (ops/gathered.py GatheredPrims.STATS).
"""

from __future__ import annotations

import torch

from . import accel as accel_mod
from . import geometry as geom
from .vecmath import V3

WARP = 32
NONE = 2**31 - 1  # a lane that took nothing (INT_MAX in the kernels)
CULL_BLOCK = 8  # the wide design's lanes a group (csrc/group.cuh)


def _row3(row, col: int) -> V3:
    return V3(row[col], row[col + 1], row[col + 2])


def _check_k(k: int) -> None:
    if k < 1 or k > WARP or k & (k - 1):
        raise ValueError(f"group width {k}: a power of two dividing {WARP}")


def lane_closest(prims: geom.ScenePrims, o: V3, d: V3, j: int, k: int):
    """Lane j's closest over its share: (t, index), (T_FAR, NONE) where it
    took nothing; each f32 [rays] / int64 [rays]."""
    tab = prims.tables
    n_sph, n_pln, n_tri, _ = tab.counts
    closest = torch.full_like(o.x, geom.T_FAR)
    idx = torch.full(o.x.shape, NONE, dtype=torch.int64, device=o.x.device)

    def take(t, hit, i):
        nonlocal closest, idx
        t = torch.where(hit, t, geom.MISS)
        won = (t > 0.0) & (t < closest)
        closest = torch.where(won, t, closest)
        idx = torch.where(won, i, idx)

    for i in range(j, n_sph, k):
        s = tab.sph[i]
        take(*geom._sphere_t(o, d, _row3(s, 0), s[3], geom.RAY_EPS, closest),
             i)
    for i in range(j, n_pln, k):
        q = tab.pln[i]
        t, parallel = geom._plane_t(o, d, _row3(q, 0), _row3(q, 3))
        take(t, ~parallel & (t >= geom.RAY_EPS) & (t <= closest), n_sph + i)
    for i in range(j, n_tri, k):
        q = tab.tri[i]
        take(*geom._triangle_t(o, d, _row3(q, 0), _row3(q, 3), _row3(q, 6),
                               geom.RAY_EPS, closest), n_sph + n_pln + i)
    return closest, idx


def split_closest(prims: geom.ScenePrims, o: V3, d: V3, k: int):
    """The group's closest hit as each of its k lanes holds it after the
    butterfly reduction by (t, then index): a list of k (t, primitive
    index) pairs, (T_FAR, NONE) on a miss."""
    _check_k(k)
    lanes = [lane_closest(prims, o, d, j, k) for j in range(k)]
    off = k // 2
    while off:
        nxt = []
        for j, (t, i) in enumerate(lanes):
            t_o, i_o = lanes[j ^ off]
            take = (t_o < t) | ((t_o == t) & (i_o < i))
            nxt.append((torch.where(take, t_o, t), torch.where(take, i_o, i)))
        lanes = nxt
        off //= 2
    return lanes


def split_occluded(prims: geom.ScenePrims, o: V3, d: V3, t_min, t_max,
                   k: int) -> torch.Tensor:
    """The group's shadow sweep: each lane's OR over its share (the kernel
    stops a lane at its first blocker, which leaves the OR as it is),
    joined over the k lanes."""
    _check_k(k)
    tab = prims.tables
    n_sph, n_pln, n_tri, _ = tab.counts
    blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for j in range(k):
        lane = torch.zeros_like(blocked)
        for i in range(j, n_sph, k):
            s = tab.sph[i]
            lane = lane | geom.blocked_sphere(o, d, _row3(s, 0), s[3],
                                              t_min, t_max)
        for i in range(j, n_pln, k):
            q = tab.pln[i]
            lane = lane | geom.blocked_plane(o, d, _row3(q, 0), _row3(q, 3),
                                             t_min, t_max)
        for i in range(j, n_tri, k):
            q = tab.tri[i]
            lane = lane | geom.blocked_triangle(
                o, d, _row3(q, 0), _row3(q, 3), _row3(q, 6), t_min, t_max)
        blocked = blocked | lane
    return blocked


# ----------------------------------------------------------- the culled sweep


def culled_lanes(k: int, wide: bool = None):
    """(lanes a group l, groups a step p) of GroupCulled<k, wide>: wide
    (default for k > 8) sweeps k / 8 groups a step, 8 lanes each; else one
    group a step on all k lanes."""
    _check_k(k)
    if wide is None:
        wide = k > CULL_BLOCK
    lanes = CULL_BLOCK if wide and k > CULL_BLOCK else k
    return lanes, k // lanes


def _culled_groups(prims):
    """The group table of a CulledPrims on the host: per group (kind, first
    row within the kind, first flatten index, count, guarded), and its
    boxes (lo, hi) [G, 3] on the prims' device."""
    tab = prims.tables
    n_sph, n_pln, _, _ = tab.counts
    g = tab.acc.view(-1, accel_mod.GROUP_W)
    start = {0: 0, 1: n_sph, 2: n_sph + n_pln}
    rows = []
    for kind, r0, cnt, guarded in g[:, :4].tolist():
        kind, r0 = int(kind), int(r0)
        rows.append((kind, r0, start[kind] + r0, int(cnt), guarded != 0.0))
    return rows, g[:, 4:7], g[:, 7:10]


def _member_test(prims, kind: int, r: int, o, d, t_min, t_max,
                 shadow: bool):
    """Row r of `kind`: (t, taken) of a closest-hit test in (t_min, t_max)
    (a plane: t <= t_max), or a shadow ray's blocked flag."""
    tab = prims.tables
    if kind == 0:
        s = tab.sph[r]
        t, hit = geom._sphere_t(o, d, _row3(s, 0), s[3], t_min, t_max)
        return hit if shadow else (t, hit)
    if kind == 1:
        q = tab.pln[r]
        t, parallel = geom._plane_t(o, d, _row3(q, 0), _row3(q, 3))
        hit = ~parallel & (t >= t_min) & ((t < t_max) if shadow
                                          else (t <= t_max))
        return hit if shadow else (t, hit)
    q = tab.tri[r]
    t, hit = geom._triangle_t(o, d, _row3(q, 0), _row3(q, 3), _row3(q, 6),
                              t_min, t_max)
    return hit if shadow else (t, hit)


def group_minimum(prims, group, o, d, c0, lanes: int):
    """One group's (t, index) as GroupCulled's `lanes` lanes reduce it: lane
    l tests members l, l + lanes, ... with its own running closest from
    `c0` ((c0, NONE) where it took nothing), then the lexicographic minimum
    over the lanes, which the butterfly reduces."""
    kind, r0, k0, cnt, _ = group
    best_t, best_i = c0, torch.full(c0.shape, NONE, dtype=torch.int64)
    for lane in range(lanes):
        c, ci = c0, torch.full(c0.shape, NONE, dtype=torch.int64)
        for m in range(lane, cnt, lanes):
            t, hit = _member_test(prims, kind, r0 + m, o, d, geom.RAY_EPS, c,
                                  False)
            t = torch.where(hit, t, geom.MISS)
            won = (t > 0.0) & (t < c)
            c, ci = torch.where(won, t, c), torch.where(won, k0 + m, ci)
        take = (c < best_t) | ((c == best_t) & (ci < best_i))
        best_t, best_i = torch.where(take, c, best_t), torch.where(take, ci,
                                                                   best_i)
    return best_t, best_i


def _counters(n: int):
    return {name: torch.zeros(n, dtype=torch.int64)
            for name in ("sweeps", "swept", "skipped", "tests")}


def _stack(cnt) -> torch.Tensor:
    """The counters as [4, rays] in CulledPrims.STATS order."""
    return torch.stack([cnt["sweeps"], cnt["swept"], cnt["skipped"],
                        cnt["tests"]])


def split_culled_closest(prims, o: V3, d: V3, k: int, wide: bool = None):
    """GroupCulled<k, wide>'s closest hit over the CulledPrims `prims`:
    (t, primitive index, counters [4, rays]), (T_FAR, NONE) on a miss.

    Window by window of k groups, per ray: a group is a candidate under
    the closest C when its slab predicate holds (an unguarded group: always)
    and tn < C. A step opens at the first candidate under the current C,
    takes C0 = C and the next p candidates under C0 (p groups a step), each
    group's minimum taken with t_max = C0 over its l lanes; the replay
    enters a step's group iff it is unguarded or tn < C, and takes its
    minimum iff entered and t < C. A window's end closes a step."""
    lanes, per_step = culled_lanes(k, wide)
    groups, lo, hi = _culled_groups(prims)
    n = o.x.shape[0]
    cnt = _counters(n)
    cnt["sweeps"] += 1
    closest = torch.full_like(o.x, geom.T_FAR)
    idx = torch.full((n,), NONE, dtype=torch.int64)
    if groups:
        tn, tf = accel_mod.slab_interval(geom._lanes(o), geom._lanes(d), lo,
                                         hi)
    for g0 in range(0, len(groups), k):
        slots = torch.zeros(n, dtype=torch.int64)
        c0 = closest
        for g in range(g0, min(g0 + k, len(groups))):
            group = groups[g]
            guarded = group[4]
            if guarded:
                pred = (tn[:, g] <= tf[:, g]) & (tf[:, g] > geom.RAY_EPS)
                tn_g = tn[:, g]
            else:
                pred = torch.ones(n, dtype=torch.bool)
                tn_g = torch.full_like(closest, -accel_mod._BIG)
            is_open = slots > 0
            member = pred & (tn_g < torch.where(is_open, c0, closest))
            opens = member & ~is_open
            c0 = torch.where(opens, closest, c0)
            slots = torch.where(opens, per_step, slots)
            slots = torch.where(member, slots - 1, slots)
            t_b, i_b = group_minimum(prims, group, o, d, c0, lanes)
            entered = member & (tn_g < closest)
            take = entered & (t_b < closest)
            closest = torch.where(take, t_b, closest)
            idx = torch.where(take, i_b, idx)
            if guarded:
                cnt["swept"] += entered
                cnt["skipped"] += ~entered
            cnt["tests"] += entered * group[3]
    return closest, idx, _stack(cnt)


def split_culled_occluded(prims, o: V3, d: V3, t_min, t_max, k: int,
                          wide: bool = None):
    """GroupCulled<k, wide>'s shadow sweep over the CulledPrims `prims`:
    (blocked, counters [4, rays]). Its decisions use the fixed bounds, so
    the steps visit the entered groups in order; a lane stops at its first
    blocker, a group's first blocker is the least over its l lanes, and the
    first group with one ends the sweep (its tests counted up to the
    blocker, no later group counted)."""
    lanes, _ = culled_lanes(k, wide)
    groups, lo, hi = _culled_groups(prims)
    n = o.x.shape[0]
    cnt = _counters(n)
    cnt["sweeps"] += 1
    blocked = torch.zeros(n, dtype=torch.bool)
    if groups:
        tn, tf = accel_mod.slab_interval(geom._lanes(o), geom._lanes(d), lo,
                                         hi)
    for g, group in enumerate(groups):
        kind, r0, _, count, guarded = group
        live = ~blocked
        entered = torch.ones(n, dtype=torch.bool)
        if guarded:
            entered = ((tn[:, g] <= tf[:, g]) & (tn[:, g] < t_max)
                       & (tf[:, g] > t_min))
            cnt["swept"] += live & entered
            cnt["skipped"] += live & ~entered
        first = torch.full((n,), NONE, dtype=torch.int64)
        for lane in range(lanes):
            mine = torch.full((n,), NONE, dtype=torch.int64)
            for m in range(lane, count, lanes):
                hit = _member_test(prims, kind, r0 + m, o, d, t_min, t_max,
                                   True)
                mine = torch.where(hit & (mine == NONE), m, mine)
            first = torch.minimum(first, mine)
        now = live & entered
        stop = now & (first != NONE)
        cnt["tests"] += torch.where(stop, first + 1, now * count)
        blocked = blocked | stop
    return blocked, _stack(cnt)


# ------------------------------------------------------------- the grid walk


def split_walk(prims, o: V3, d: V3, t_min, t_cap, mask, any_hit: bool,
               k: int):
    """GroupWalk<k>'s walk over the GatheredPrims `prims` for every ray
    whose `mask` is set (None: all), `t_cap` the exit and strictly-closer
    bound: (walk id of the winner, -1 for none; t_best; counters [4, rays]
    in GatheredPrims.STATS order, walks counted where `mask` holds).

    Step by step, per ray: at max_trips steps the walk is capped; in a
    cell with entries left a window of w = min(end - cur, k, max_trips -
    trips) entries is tested with t_max = t_best, its winner the least t
    below t_best at the least position (any_hit: the first hit ends the
    walk, its tests counted up to it), and w trips taken; else the DDA
    advances one cell (one trip), or the walk ends."""
    _check_k(k)
    active, ic, tm, stp, dt = prims.walk_start(o, d, t_cap, mask)
    n = o.x.shape[0]
    cur, end = prims._cell_range(*ic)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.x.device)
    t_best = t_cap + torch.zeros_like(o.x)
    tests, advances, capped, trips = (torch.zeros_like(best)
                                      for _ in range(4))
    while bool(active.any()):
        cap = active & (trips == prims.max_trips)
        capped = capped + cap.long()
        active = active & ~cap
        work = active & (cur < end)
        w = torch.where(work, torch.clamp(torch.minimum(
            end - cur, prims.max_trips - trips), max=k), 0)
        win_t, win_pid = t_best, best
        first = torch.full_like(best, k)
        for j in range(k):
            lane = work & (j < w)
            pid = prims._idx[torch.where(lane, cur + j, 0)]
            t, _ = prims.test_at(pid, o, d, t_min, t_best)
            ok = lane & (t > 0.0) & (t < t_best)
            if any_hit:
                take = ok & (first == k)
                first = torch.where(take, j, first)
            else:
                take = ok & (t < win_t)
                win_t = torch.where(take, t, win_t)
            win_pid = torch.where(take, pid, win_pid)
        best = win_pid
        if any_hit:
            hit = first < k
            tests = tests + torch.where(hit, first + 1, w)
            active = active & ~hit
        else:
            t_best = win_t
            tests = tests + w
        cur, trips = cur + w, trips + w
        adv = active & ~work
        done, move = prims.advance(adv, ic, tm, stp, dt, t_best)
        new_cur, new_end = prims._cell_range(*ic)
        cur = torch.where(move, new_cur, cur)
        end = torch.where(move, new_end, end)
        advances = advances + adv.long()
        trips = trips + adv.long()
        active = active & ~done
    walks = (torch.ones_like(best) if mask is None else mask.long())
    return best, t_best, torch.stack([walks, tests, advances, capped])


def split_walk_closest(prims, o: V3, d: V3, k: int):
    """GroupWalk<k>'s closest hit over the GatheredPrims `prims`: the
    planes' closest hit (every lane sweeps them, as the serial walk does)
    caps the walk; (t_best, the winner's flatten index, -1 on a miss,
    counters [4, rays])."""
    n_sph, n_pln, _ = prims._counts
    t_cap = torch.full_like(o.x, geom.T_FAR)
    plane = torch.full(o.x.shape, -1, dtype=torch.int64)
    for i in range(n_pln):
        q = prims.tables.pln[i]
        t, parallel = geom._plane_t(o, d, _row3(q, 0), _row3(q, 3))
        hit = ~parallel & (t >= geom.RAY_EPS) & (t <= t_cap)
        t = torch.where(hit, t, geom.MISS)
        won = (t > 0.0) & (t < t_cap)
        t_cap = torch.where(won, t, t_cap)
        plane = torch.where(won, i, plane)
    best, t_best, counts = split_walk(prims, o, d, geom.RAY_EPS, t_cap,
                                      None, False, k)
    idx = torch.where(best >= 0,
                      torch.where(best < n_sph, best, best + n_pln),
                      torch.where(plane >= 0, n_sph + plane, -1))
    return t_best, idx, counts


def split_walk_occluded(prims, o: V3, d: V3, t_min, t_max, k: int):
    """GroupWalk<k>'s shadow walk over the GatheredPrims `prims`: a plane
    blocker ends it before the walk (no walk counted); (blocked, counters
    [4, rays])."""
    n_pln = prims._counts[1]
    blocked_p = torch.zeros(o.x.shape, dtype=torch.bool)
    for i in range(n_pln):
        q = prims.tables.pln[i]
        blocked_p = blocked_p | geom.blocked_plane(o, d, _row3(q, 0),
                                                   _row3(q, 3), t_min, t_max)
    best, _, counts = split_walk(prims, o, d, t_min, t_max, ~blocked_p,
                                 True, k)
    return (best >= 0) | blocked_p, counts
