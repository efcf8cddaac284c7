"""Acquisition engine: synthetic-signal end-to-end checks."""

import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.models.codes import gps_ca
from gnss_dsp.acquire import acquire_signal
from gnss_dsp.utils import synth


@pytest.mark.parametrize("doppler,code_phase", [(2400.0, 817.5), (-3150.0, 12.25)])
def test_gps_l1_acquisition_synthetic(doppler, code_phase):
    sig = get_signal("gps-l1")
    fs = sig.acq_fs
    ms = 20
    n = int(fs * (ms + 2) / 1000)
    prn = 21
    x = synth.synth_iq(
        gps_ca.ca_code(prn).astype(np.float64), sig.chip_rate, fs, n,
        doppler_hz=doppler, code_phase=code_phase, cn0_dbhz=45.0,
        rng=np.random.default_rng(7),
    )
    res = acquire_signal(sig, x, prns=[prn, 5], doppler_search=(-5000, 5000, 200), ms=ms)

    hit = res[0]
    assert hit.prn == prn
    assert abs(hit.doppler - doppler) <= 200.0
    # code offset within one sample (1023/4096 chips)
    err = min(abs(hit.code_offset - code_phase),
              1023 - abs(hit.code_offset - code_phase))
    assert err <= 0.5
    # absent PRN has a much weaker metric
    assert res[1].metric < 0.5 * hit.metric


def test_acquisition_matches_reference_search_numerics():
    """Oracle check: our jit grid search vs a float64 numpy transcription of
    the reference search() loop (acquire-gps-l1.py:18-40) on the same input."""
    sig = get_signal("gps-l1")
    fs, n, ms = sig.acq_fs, 4096, 8
    prn = 9
    rng = np.random.default_rng(3)
    x = synth.synth_iq(
        gps_ca.ca_code(prn).astype(np.float64), sig.chip_rate, fs,
        int(fs * (ms + 2) / 1000), doppler_hz=1000.0, code_phase=100.0,
        cn0_dbhz=40.0, rng=rng,
    ).astype(np.complex128)

    # numpy oracle
    from gnss_dsp.models.codes import resample_host
    from gnss_dsp.ops import nco as nco_ops

    incr = sig.code_length / n
    c = np.fft.fft(resample_host(gps_ca.ca_code(prn), 0, 0, incr, n))
    m_metric, m_code, m_dop = 0.0, 0.0, 0.0
    for dop in np.arange(-2000.0, 2000.0, 250.0):
        w = nco_ops.nco_host(-dop / fs, 0, n)
        q = np.zeros(n)
        for b in range(ms):
            blk = x[b * n:(b + 1) * n] * w
            q += np.abs(np.fft.ifft(c * np.conj(np.fft.fft(blk))))
        idx = np.argmax(q)
        metric = q[idx] / np.mean(q)
        if metric > m_metric:
            m_metric, m_code, m_dop = metric, sig.code_length * idx / n, dop

    res = acquire_signal(sig, x.astype(np.complex64), [prn],
                         doppler_search=(-2000, 2000, 250), ms=ms)[0]
    assert res.doppler == m_dop
    assert abs(res.code_offset - m_code) < 1e-6
    assert abs(res.metric - m_metric) / m_metric < 0.02


def test_code_fft_device_cache_same_results():
    """The round-5 device-resident code-FFT LRU must not change
    results: two identical acquire_signal calls (2nd = cache hit) and a
    cache-cleared call all agree exactly."""
    import numpy as np

    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    import dataclasses

    sig = dataclasses.replace(sig, acq_fs=1.024e6, acq_lowpass_hz=0.4e6)
    n = int(sig.acq_fs * 0.014)
    x = synth_iq(sig.code_table((7,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=1000.0, code_phase=123.0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio)
    eng._CODE_FFTS_DEV.clear()
    kw = dict(doppler_search=(-2000.0, 2000.0, 500.0), ms=8)
    a = eng.acquire_signal(sig, x, [7, 9], **kw)
    assert len(eng._CODE_FFTS_DEV) == 1
    b = eng.acquire_signal(sig, x, [7, 9], **kw)     # cache hit
    eng._CODE_FFTS_DEV.clear()
    c = eng.acquire_signal(sig, x, [7, 9], **kw)     # rebuilt
    for r1, r2 in zip(a, b):
        assert (r1.prn, r1.doppler, r1.metric, r1.code_offset) == \
               (r2.prn, r2.doppler, r2.metric, r2.code_offset)
    for r1, r2 in zip(a, c):
        assert (r1.prn, r1.doppler, r1.metric, r1.code_offset) == \
               (r2.prn, r2.doppler, r2.metric, r2.code_offset)
    assert abs(a[0].doppler - 1000.0) <= 500.0
