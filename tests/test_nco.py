"""NCO / mixer: device int32-DDS path vs the float64 host oracle."""

import numpy as np
import pytest

from gnss_dsp.ops import nco


@pytest.mark.parametrize(
    "f,p,n",
    [
        (0.01, 0.0, 4096),
        (-2400.0 / 4096000.0, 0.3, 4096),
        (0.133416, 0.9, 70000),   # large carrier offset, long block
        (1e-5, 0.0, 81920),       # 20 ms L2CM-scale block
    ],
)
def test_nco_matches_host_oracle(f, p, n):
    dev = np.asarray(nco.nco(f, p, n))

    # exact parity with a host emulation of the uint32 DDS (the same
    # truncated-increment scheme as the reference's Numba mix_, nco.py:30-38)
    df = np.int64(nco.freq_to_fixed(f))
    p0 = np.int64(nco.phase_to_fixed(p))
    ph = (p0 + np.arange(n, dtype=np.int64) * df) & 0xFFFFFFFF
    idx = (ph >> 22).astype(np.int64)
    fixed_oracle = np.exp(2j * np.pi * idx / 1024.0)
    assert np.max(np.abs(dev - fixed_oracle)) < 1e-5

    # and closeness to the float64 reference nco() (nco.py:6-10): indices can
    # differ by at most one LUT step, and only where the exact-rational test
    # frequency lands the phase precisely on a quantization boundary
    host = nco.nco_host(f, p, n)
    assert np.max(np.abs(dev - host)) < 2 * np.pi / 1024 + 1e-3


def test_nco_unit_modulus():
    w = np.asarray(nco.nco(0.01, 0.25, 1024))
    assert np.allclose(np.abs(w), 1.0, atol=1e-6)


def test_mix_is_functional_wipeoff(rng):
    n = 8192
    f = 1500.0 / 4.096e6
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    carrier = nco.nco_host(f, 0.0, n).astype(np.complex64)
    sig = (x * carrier).astype(np.complex64)
    out = np.asarray(nco.mix(sig, -f, 0.0))
    # wiping off the same LUT-quantized carrier recovers x up to LUT error
    assert np.median(np.abs(out - x)) < 0.02


def test_boc11_host_square_wave():
    # at 0.5 chips/sample one BOC(1,1) cycle spans 2 samples -> alternate each sample
    b = nco.boc11_host(0, 0, 0.5, 8)
    assert np.array_equal(b, np.array([-1, 1, -1, 1, -1, 1, -1, 1], dtype=float))
    # at 0.25 chips/sample each half-cycle spans 2 samples
    b = nco.boc11_host(0, 0, 0.25, 8)
    assert np.array_equal(b, np.array([-1, -1, 1, 1, -1, -1, 1, 1], dtype=float))


def test_accum_code_bins():
    import jax.numpy as jnp

    x = (jnp.ones(100, jnp.float32), jnp.zeros(100, jnp.float32))
    ar, ai = nco.accum_code_bins(x, 0.0, 0.1, 10)
    # 100 samples at 0.1 chip/sample -> each of 10 bins gets 10 samples
    assert np.allclose(np.asarray(ar), 10.0)
    assert np.allclose(np.asarray(ai), 0.0)
