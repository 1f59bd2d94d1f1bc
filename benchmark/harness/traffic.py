"""The general traffic generator: what a mix file's parameters make of a
seed.

A `view` mix is a scripted keyboard: held-key bursts at the terminal's
auto-repeat rate, separated by pauses. The mix lists its bursts as pairs
(key, seconds): each pair is sent as a burst of the key, a pause, then a
burst of the opposite key for as long, which brings the camera back, so
every seed sends the same keys for the same times and only their order
and the pauses' order change. A `headless` mix renders images of a fixed
number of accumulated frames, back to back."""

from __future__ import annotations

import random
from typing import NamedTuple

OPPOSITE = {"w": "s", "s": "w", "a": "d", "d": "a", "up": "down",
            "down": "up", "left": "right", "right": "left"}
DRIVERS = ("view", "headless")
# The engine options a mix may set: those the plain reference follows.
ENGINE_KEYS = ("full_color", "pipeline")


class Press(NamedTuple):
    due: float  # seconds after the window opens
    key: str


def check_mix(mix: dict) -> None:
    """Raise ValueError on a mix the generator cannot run."""
    driver = mix.get("driver")
    if driver not in DRIVERS:
        raise ValueError(f"mix driver {driver!r} not in {DRIVERS}")
    unknown = sorted(set(mix.get("engine", {})) - set(ENGINE_KEYS))
    if unknown:
        raise ValueError(f"engine options {unknown} are not run: a mix may "
                         f"set only {ENGINE_KEYS}")
    if driver == "headless":
        if int(mix["frames_per_image"]) < 1:
            raise ValueError("frames_per_image must be >= 1")
        return
    if float(mix["key_rate_hz"]) <= 0:
        raise ValueError("key_rate_hz must be > 0")
    for key, seconds in mix["pairs"]:
        if key not in OPPOSITE or float(seconds) <= 0:
            raise ValueError(f"bad burst pair {[key, seconds]}")
    if len(mix["pause_s"]) != 2 * len(mix["pairs"]):
        raise ValueError("a view mix needs two pauses for each pair")


def key_script(mix: dict, seed: int, seconds: float) -> list:
    """The presses of a `view` mix due in a window of `seconds`: cycles of
    every pair (burst, pause, opposite burst, pause) in an order drawn from
    `seed`, repeated until the window ends; no press is due in the
    window's last `tail_s` seconds. A mix with no pairs sends no keys."""
    if not mix["pairs"]:
        return []
    rng = random.Random(seed)
    rate = float(mix["key_rate_hz"])
    end = seconds - float(mix.get("tail_s", 0.0))
    presses, t = [], 0.0
    while t < end:
        pairs = rng.sample(list(mix["pairs"]), len(mix["pairs"]))
        pauses = rng.sample(list(mix["pause_s"]), len(mix["pause_s"]))
        for i, (key, burst) in enumerate(pairs):
            for k, p in ((key, pauses[2 * i]), (OPPOSITE[key],
                                                pauses[2 * i + 1])):
                n = int(round(float(burst) * rate))
                presses.extend(Press(t + j / rate, k) for j in range(n))
                t += float(burst) + float(p)
    return [p for p in presses if p.due < end]


def warmup_script(mix: dict) -> list:
    """The presses of a view mix's warm-up: a few keys of its first pair
    and its opposite, then quiet (none for a mix with no pairs)."""
    if not mix["pairs"]:
        return []
    key = mix["pairs"][0][0]
    rate = float(mix["key_rate_hz"])
    n = int(mix.get("warmup_presses", 4))
    return [Press(j / rate, key if j % 2 == 0 else OPPOSITE[key])
            for j in range(n)]
