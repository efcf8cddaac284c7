"""Matmul four-step FFT vs numpy reference."""

import numpy as np
import pytest

from gnss_dsp.ops import cplx, fft


@pytest.mark.parametrize("n", [128, 512, 1024, 4096, 30690, 15345, 16384])
def test_fft_matches_numpy(n, rng):
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = cplx.to_numpy(fft.fft(cplx.from_numpy(x)))
    want = np.fft.fft(x)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 2e-5


@pytest.mark.parametrize("n", [4096, 30690])
def test_ifft_roundtrip(n, rng):
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = cplx.to_numpy(fft.ifft(fft.fft(cplx.from_numpy(x))))
    assert np.max(np.abs(got - x)) < 2e-5 * np.max(np.abs(x))


def test_fft_batched(rng):
    x = rng.standard_normal((3, 5, 1024)) + 1j * rng.standard_normal((3, 5, 1024))
    got = cplx.to_numpy(fft.fft(cplx.from_numpy(x)))
    want = np.fft.fft(x, axis=-1)
    assert np.max(np.abs(got - want)) < 2e-5 * np.max(np.abs(want))


def test_large_pow2_recursion(rng):
    n = 81920  # l1cp acquisition window: 320*256, recursion depth 1
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = cplx.to_numpy(fft.fft(cplx.from_numpy(x)))
    want = np.fft.fft(x)
    assert np.max(np.abs(got - want)) < 3e-5 * np.max(np.abs(want))
