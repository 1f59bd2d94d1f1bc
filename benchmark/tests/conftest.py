"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository's root (on a CUDA card: `python -m pytest benchmark/tests -m
cuda`). The harness and the reference import as top-level packages from
benchmark/, the program from the root."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH.parent, BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    return torch.device("cuda")
