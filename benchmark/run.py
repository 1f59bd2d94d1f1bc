"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The run keeps its threads on two fixed cores, builds the program's
kernels on first use (into the program's own build directory), warms up
the cell's shapes, measures for `--seconds` seconds, compares sampled
frames of the timed path with the plain reference, and prints as the
last line of its standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device` (`built` where this run built
the program's libraries, so its `setup_s` holds the build; with --trace 1
also `busy_s` and `window_s` of the traced sub-window), with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). It exits non-zero, with
no result line, without a CUDA card, with fewer cards than the cell asks
for, without the program, or where JAX or the JAX package got loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Caches at fixed places inside the checkout (the kernels themselves build
# into the program's own terminal_raytracer_tpu_torch/_build/).
CACHE = ROOT / ".bench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "TRITON_CACHE_DIR": CACHE / "triton",
             "CUDA_CACHE_PATH": CACHE / "nv"}
# The run's host threads (the program's, CUDA's, the blitter's) share two
# fixed cores of the machine: on a card's host, which other machines share,
# runs spread over every core read the viewer's frame time up to 20% apart
# on one seed; on two cores the runs agree far more closely (PERF.md).
CORES = (2, 3)


def _pin() -> None:
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) > max(CORES):
        os.sched_setaffinity(0, {allowed[c] for c in CORES})


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    args = _args(argv)
    _pin()
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    from harness import runner, spec as spec_mod

    spec = spec_mod.load_spec()
    try:
        wl = spec_mod.workload(spec, args.workload)
    except KeyError as e:
        _fail(str(e))
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device")
    if torch.cuda.device_count() < int(wl["chips"]):
        _fail(f"the cell asks for {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present")
    try:
        import terminal_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program is not in this checkout ({e})")
    run = runner.Run(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", spec=spec)
    result = runner.run_cell(
        run, T_PROCESS, log=lambda m: print(m, file=sys.stderr, flush=True))
    banned = runner.banned_modules()
    if banned:
        _fail("JAX or the JAX package was loaded: " + ", ".join(banned), 3)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
