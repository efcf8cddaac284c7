"""Extended-coherent acquisition (acquire/coherent.py) against the float64
numpy oracle of the coherent formula (bench.reference_search_coherent):
linear 2n windows (pad2 / sliding signals) and circular n windows,
shared and per-PRN overlays, the einsum and the FFT-over-overlay
combines, several groups, and coherent spans that are not a multiple of
the overlay length.  Winning cell (Doppler, code phase, alignment) must
be identical and the metric within 1e-4.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

from gnss_dsp.acquire import engine as eng
from gnss_dsp.acquire.coherent import acquire_signal_coherent
from gnss_dsp.models import get_signal
from gnss_dsp.utils.synth import synth_iq

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402


def _overlays(n_chips, prns, seed, shared):
    rng = np.random.default_rng(seed)
    if shared:
        s = rng.choice([-1, 1], n_chips).astype(np.int8)
        return {p: s for p in prns}
    return {p: rng.choice([-1, 1], n_chips).astype(np.int8) for p in prns}


# id -> (signal, acq_fs, pad2 override, overlay (None = the signal's own,
# else (chips, shared)), m_coh, ms, plants {prn: (doppler, code phase)},
# doppler grid)
CASES = {
    "nh10_linear_l5i": ("gps-l5i", 10.23e6, None, None, None, 10,
                        {25: (-400.0, 9696.0), 3: (200.0, 100.0)},
                        (-400.0, 201.0, 300.0)),
    "nh20_circular_b1i": ("beidou-b1i", 2.048e6, False, None, None, 20,
                          {34: (20.0, 500.0)}, (-40.0, 41.0, 20.0)),
    "nh20_linear_b1i_two_groups": ("beidou-b1i", 2.048e6, None, None, None,
                                   40, {34: (-20.0, 1200.0)},
                                   (-40.0, 41.0, 20.0)),
    "span_not_overlay_multiple": ("beidou-b1i", 2.048e6, None, None, 10, 20,
                                  {34: (0.0, 700.0)}, (-50.0, 51.0, 50.0)),
    "span_twice_overlay": ("gps-l5i", 10.23e6, None, None, 20, 20,
                           {25: (100.0, 5000.0)}, (-100.0, 101.0, 50.0)),
    "per_prn_nh20_einsum": ("beidou-b1i", 2.048e6, None, (20, False), None,
                            20, {5: (20.0, 500.0), 34: (-20.0, 1200.0)},
                            (-40.0, 41.0, 20.0)),
    "shared_cs25_fft": ("beidou-b1i", 2.048e6, None, (25, True), None, 25,
                        {5: (16.0, 500.0), 34: (-16.0, 1200.0)},
                        (-32.0, 33.0, 16.0)),
    "per_prn_cs25_fft": ("beidou-b1i", 2.048e6, None, (25, False), None, 25,
                         {5: (16.0, 500.0), 34: (-16.0, 1200.0)},
                         (-32.0, 33.0, 16.0)),
    "per_prn_cs100_e5aq": ("galileo-e5aq", 1.023e6, None, None, None, 100,
                           {2: (0.0, 3000.0), 9: (5.0, 8000.0)},
                           (-5.0, 6.0, 5.0)),
    "sliding_cs25_e1c": ("galileo-e1c", 1.024e6, None, None, None, 100,
                         {11: (0.0, 1000.5)}, (-5.0, 6.0, 5.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coherent_matches_numpy_oracle(case):
    name, fs, pad2, ovl, m_coh, ms, plants, grid = CASES[case]
    sig = dataclasses.replace(get_signal(name), acq_fs=fs)
    if pad2 is not None:
        sig = dataclasses.replace(sig, acq_pad2=pad2)
    prns = sorted(plants)
    if ovl is not None:
        table = _overlays(ovl[0], prns, hash(case) % 1000, ovl[1])
        sig = dataclasses.replace(sig, secondary=lambda p: table[p])
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    rng = np.random.default_rng(5)
    nsamp = int(fs * (ms + 3 * sig.acq_coherent_ms) / 1000)
    x = 0.5 * (rng.standard_normal(nsamp) + 1j * rng.standard_normal(nsamp))
    for p, (dop, cp) in plants.items():
        x = x + synth_iq(sig.code_table((p,))[0], sig.chip_rate, fs, nsamp,
                         doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                         subcarrier=sig.subcarrier,
                         carrier_ratio=sig.carrier_ratio,
                         data_bits=np.roll(sig.secondary(p), -2),
                         code_doppler_hz=dop)
    res = acquire_signal_coherent(sig, x.astype(np.complex64), prns, grid,
                                  m_coh=m_coh, ms=ms)
    M = m_coh or len(sig.secondary(prns[0]))
    blocks = max(int(ms / sig.acq_coherent_ms) // M, 1) * M
    dops, fixed = eng.doppler_grid(sig, grid)
    rm, rci, rdi, ral = bench.reference_search_coherent(
        x, eng.build_code_ffts(sig, prns, n, window),
        (fixed.astype(np.int64) % 2**32) / 2**32, n, window, blocks, M,
        [sig.secondary(p) for p in prns])
    for k, r in enumerate(res):
        assert r.linear == (window == 2 * n)
        assert r.doppler == dops[rdi[k]], (case, r, dops[rdi[k]])
        code = (sig.code_length * float(rci[k]) / n) % sig.code_length
        assert abs(r.code_offset - code) < 1e-6, (case, r, code)
        assert r.align == ral[k], (case, r, ral[k])
        assert abs(r.metric - rm[k]) / rm[k] < 1e-4, (case, r, rm[k])
        # and the plant itself was found
        dop, cp = plants[r.prn]
        err = abs(r.code_offset - cp)
        assert min(err, sig.code_length - err) <= 1.0, (case, r)


def test_coherent_handoff_overlay_phase():
    """B1I NH20 planted capture: code, Doppler and the overlay phase
    handed to the tracker (CoherentAcqResult.track_overlay_phase) are
    recovered on the linear 2n-window search."""
    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn, doppler, cp0 = 34, 20.0, 500.0
    sec = sig.secondary(prn)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs,
                 int(sig.acq_fs * 0.046), doppler_hz=doppler, code_phase=cp0,
                 cn0_dbhz=None, carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sec, -3), rng=np.random.default_rng(2))
    r = acquire_signal_coherent(sig, x, [prn], (-40.0, 41.0, 20.0),
                                ms=40)[0]
    err = abs(r.code_offset - cp0)
    assert min(err, sig.code_length - err) < 1.0, r
    assert abs(r.doppler - doppler) <= 20.0, r
    assert r.linear
    assert r.track_overlay_phase(sig.code_length) == (3 + 1) % 20, r


def test_coherent_low_cn0_lock():
    """27 dB-Hz B1I NH20: the 40 ms coherent search still locks (the
    sensitivity the feature exists for)."""
    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn, doppler, cp0, ms = 34, 20.0, 500.0, 40
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs,
                 int(sig.acq_fs * (ms + 4) / 1000), doppler_hz=doppler,
                 code_phase=cp0, cn0_dbhz=27.0,
                 carrier_ratio=sig.carrier_ratio,
                 data_bits=sig.secondary(prn), rng=np.random.default_rng(1))
    r = acquire_signal_coherent(sig, x, [prn], (-100.0, 101.0, 25.0),
                                ms=ms)[0]
    err = abs(r.code_offset - cp0)
    assert min(err, sig.code_length - err) < 1.0, r
    assert abs(r.doppler - doppler) <= 25.0, r
