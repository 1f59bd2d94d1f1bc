"""Knife-edge bounds of the port's frames against the JAX oracle.

On scenes with sphere lights a few pixels differ from the oracle by more
than the frame tolerance (rtol 1e-4 / atol 1e-5): the NEE self-shadow edge
explained in tests/test_torch_slice.py, where an ulp between XLA-CPU and
PyTorch-CPU decides whether a light sample is shadowed. A frame test bounds
those pixels by their count and by the summed absolute error over them,
not by a share of the image: a fault that moves a few pixels by a lot (a
wrong emission channel on one material) then fails the test.

The frame tests import KnifeEdges from here, as they import warm_vml:
``KnifeEdges().add(got, want).check(BOUND)``, where BOUND = (pixels, summed
error) is the largest figure the test's own seeds and sizes show on the
CPU, stated beside the test. ``add`` takes planes [..., h, w] (channels
first) and may be called once a frame: the count is that of the union of
the frames' off pixels, the error the sum over each frame's off pixels.
"""

import numpy as np
import pytest

RTOL, ATOL = 1e-4, 1e-5


class KnifeEdges:
    """The pixels of one or more frames where any plane is outside
    `rtol` / `atol` of the oracle, and the summed absolute error over
    them."""

    def __init__(self, rtol=RTOL, atol=ATOL):
        self.rtol, self.atol = rtol, atol
        self.mask, self.err = None, 0.0

    def add(self, got, want):
        """Count the off pixels of planes `got` against `want` ([..., h,
        w], one shape)."""
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (got.shape, want.shape)
        diff = np.abs(got - want).reshape(-1, *got.shape[-2:])
        bad = (diff > self.atol + self.rtol
               * np.abs(want).reshape(diff.shape)).any(0)
        self.mask = bad if self.mask is None else self.mask | bad
        self.err += float(diff[:, bad].astype(np.float64).sum())
        return self

    @property
    def n(self) -> int:
        return 0 if self.mask is None else int(np.count_nonzero(self.mask))

    def check(self, bound):
        """Assert at most bound[0] pixels off, their summed error at most
        bound[1]."""
        max_px, max_err = bound
        assert self.n <= max_px and self.err <= max_err, (
            f"{self.n} pixels off (at most {max_px}), their summed error "
            f"{self.err:.6g} (at most {max_err})")
        return self


def test_counts_the_union_and_sums_the_error():
    want = np.zeros((3, 2, 4), np.float32)
    a, b = want.copy(), want.copy()
    a[0, 0, 0], a[2, 0, 0] = 0.5, -0.25  # one pixel, two planes
    a[1, 1, 3] = 1e-6  # within atol
    b[1, 0, 0], b[0, 1, 1] = 0.125, 2.0
    k = KnifeEdges().add(a, want).add(b, want)
    assert k.n == 2
    assert k.err == pytest.approx(0.5 + 0.25 + 0.125 + 2.0)
    assert k.mask.tolist() == [[True, False, False, False],
                               [False, True, False, False]]


def test_relative_tolerance_scales_with_the_oracle():
    want = np.full((1, 1, 2), 100.0, np.float32)
    got = want + np.array([[[0.005, 0.02]]], np.float32)
    k = KnifeEdges().add(got, want)
    assert k.n == 1 and k.err == pytest.approx(0.02, rel=1e-3)


@pytest.mark.parametrize("bound, ok", [((1, 1.0), True), ((0, 1.0), False),
                                       ((1, 0.4), False)])
def test_check_bounds_the_count_and_the_error(bound, ok):
    want = np.zeros((1, 2, 2), np.float32)
    got = want.copy()
    got[0, 1, 0] = 0.5
    k = KnifeEdges().add(got, want)
    if ok:
        assert k.check(bound) is k
    else:
        with pytest.raises(AssertionError, match="pixels off"):
            k.check(bound)


def test_no_frame_is_no_pixel_off():
    assert KnifeEdges().n == 0
    KnifeEdges().check((0, 0.0))
