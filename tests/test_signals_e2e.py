"""End-to-end synthetic tests across signal families: generate IQ with a
known PRN/doppler/code phase, run the batched acquisition engine, and for
a subset run the tracking engine to convergence.

Covers each acquisition template variant (SURVEY.md §2.4): no-pad
circular (gps-l1), 2n-pad sliding (b1i, l5i), long-coherent sliding
(l2cm), BOC-reference no-pad (l1cp), CBOC sliding (e1b), FDMA offsets
(glonass-l1), and the assisted serial searches (l2cl, glonass-l1-p).
"""

from __future__ import annotations

import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.acquire.engine import acquire_signal
from gnss_dsp.acquire.serial import serial_search
from gnss_dsp.utils.synth import synth_iq

SUBC = {"gps-l1cp": "tmboc", "gps-l1cd": "boc11", "galileo-e1b": "cboc",
        "galileo-e1c": "cboc", "beidou-b1cd": "boc11", "beidou-b1cp": "boc11",
        "gps-l2cm": "rz_even", "gps-l2cl": "rz_odd"}


def make_iq(sig, prn, fs, ms, doppler, code_phase, cn0=None, chan=0):
    code = sig.code_table((prn,))[0]
    n = int(fs * ms / 1000.0)
    return synth_iq(
        code, sig.chip_rate, fs, n, doppler_hz=doppler + sig.fdma_hz * chan,
        code_phase=code_phase, cn0_dbhz=cn0,
        subcarrier=SUBC.get(sig.name, "none"),
        carrier_ratio=sig.track_carrier_ratio(chan),
        code_doppler_hz=doppler,
    )


def run_acq(name, prn, doppler, code_phase, ms=24, dop_search=None,
            chan=0, tol_chips=1.0, extra_prns=(), cn0=None):
    sig = get_signal(name)
    dop_search = dop_search or (doppler - 1000.0, doppler + 1000.0, 200.0)
    x = make_iq(sig, prn, sig.acq_fs, ms + 4, doppler, code_phase,
                cn0=cn0, chan=chan)
    prns = [prn] + list(extra_prns)
    res = acquire_signal(sig, x, prns, doppler_search=dop_search, ms=ms,
                         chan=chan)
    r = res[0]
    assert abs(r.doppler - doppler) <= 200.0, r
    err = min(abs(r.code_offset - code_phase),
              sig.code_length - abs(r.code_offset - code_phase))
    assert err <= tol_chips, (r, code_phase)
    if extra_prns:
        assert r.metric == max(q.metric for q in res), res
    return r


def test_acquire_l5i():
    run_acq("gps-l5i", 25, 3200.0, 5000.25, extra_prns=(1, 7))


def test_acquire_e5aq():
    run_acq("galileo-e5aq", 12, -2600.0, 123.0)


def test_acquire_b1i():
    run_acq("beidou-b1i", 34, 1800.0, 1000.5, extra_prns=(2,))


def test_acquire_b2ad():
    # quirk parity: 80 non-coherent blocks regardless of --time
    sig = get_signal("beidou-b2ad")
    assert sig.acq_blocks_override == 80
    x = make_iq(sig, 19, sig.acq_fs, 85, 900.0, 42.0)
    r = acquire_signal(sig, x, [19],
                       doppler_search=(0.0, 1800.0, 200.0), ms=80)[0]
    assert abs(r.doppler - 900.0) <= 200.0
    assert min(abs(r.code_offset - 42.0),
               10230 - abs(r.code_offset - 42.0)) <= 1.0


def test_acquire_e6b():
    run_acq("galileo-e6b", 3, 400.0, 2222.0)


def test_acquire_b3i():
    run_acq("beidou-b3i", 7, -4000.0, 9000.0)


def test_acquire_l3ocd():
    run_acq("glonass-l3ocd", 30, 2200.0, 77.0)


def test_acquire_l2cm_long_coherent():
    # 20 ms coherent blocks, sliding windows (acquire-gps-l2cm.py:19-25)
    run_acq("gps-l2cm", 29, 500.0, 3000.0, ms=80,
            dop_search=(440.0, 560.0, 20.0), tol_chips=1.0)


def test_acquire_l1cp_boc():
    # BOC(1,1) FFT reference, 10 ms coherent, no pad
    run_acq("gps-l1cp", 18, -300.0, 512.0, ms=40,
            dop_search=(-400.0, -200.0, 20.0))


def test_acquire_e1b_cboc_sliding():
    run_acq("galileo-e1b", 24, 1200.0, 831.0, ms=32,
            dop_search=(1000.0, 1400.0, 50.0))


def test_acquire_glonass_fdma():
    # channel -3: grid offset -3*562500 Hz folded into the NCO
    run_acq("glonass-l1", 0, 1500.0, 100.0, chan=-3, extra_prns=())


def test_acquire_xona_x1_wide_doppler():
    run_acq("xona-x1p", 0, 41000.0, 500.0,
            dop_search=(39000.0, 43000.0, 200.0))


def test_serial_l2cl():
    sig = get_signal("gps-l2cl")
    fs = 4.096e6
    k_true = 31
    phase = float((k_true * 10230 + 1234.0) % sig.code_length)
    x = make_iq(sig, 5, fs, 44, 250.0, phase)
    r = serial_search(sig, x, 5, 250.0, parent_code_phase=1234.0,
                      fs=fs, ms=40)
    assert r.k == k_true, (r.k, k_true)
    assert abs(r.code_offset - phase) < 1e-6


def test_serial_glonass_p():
    sig = get_signal("glonass-l1-p")
    fs = 8.192e6
    k_true = 417
    ca_phase = 33.0
    phase = float((k_true * 5110 + 10 * ca_phase) % sig.code_length)
    x = make_iq(sig, 0, fs, 28, -700.0, phase, chan=2)
    r = serial_search(sig, x, 0, -700.0, parent_code_phase=ca_phase,
                      fs=fs, ms=24, chan=2)
    assert r.k == k_true, (r.k, k_true)


@pytest.mark.parametrize("name,prn,sub", [
    ("galileo-e1b", 24, 4),     # CBOC, 4 ms period in 4 sub-blocks
    ("gps-l1cp", 18, 10),       # TMBOC, 10 ms period in 10 sub-blocks
    ("gps-l2cm", 29, 20),       # RZ even half-chips, 20 ms period
    ("beidou-b1i", 34, 1),      # plain BPSK at 2.046 Mcps
])
def test_track_convergence(name, prn, sub):
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq
    import io as _io

    sig = get_signal(name)
    assert sig.sub_blocks == sub
    fs = 4.096e6 if sig.chip_rate <= 1.1e6 else 8.192e6
    doppler, cp0 = 1000.0, float(sig.code_length // 3)
    ms = 700
    x = make_iq(sig, prn, fs, ms, doppler, cp0, cn0=55.0)
    fp = _io.BytesIO(to_int8_iq(x, scale=24.0))
    ch = TrackChannel(prn=prn, doppler=doppler + 15.0, code_offset=cp0)
    track_file(sig, fp, fs, 0.0, [ch], loop_dwells=(200, 150))
    rows = ch.rows
    assert len(rows) > sub * 400 // max(1, int(sig.code_period_ms)), len(rows)
    tail = rows[-40:]
    cf = np.array([r["carrier_f"] for r in tail])
    # carrier loop must converge to the true doppler
    assert abs(np.mean(cf) - doppler) < 8.0, np.mean(cf)
    # prompt power should dominate early/late (code lock)
    pr = np.array([r["prompt"] for r in tail])
    el = np.array([max(r["early"], r["late"]) for r in tail])
    assert np.mean(pr) > np.mean(el), (np.mean(pr), np.mean(el))


def test_track_glonass_fdma_ratio():
    """Two FDMA channels tracked in one batch get distinct carrier-aiding
    ratios (track-glonass-l1.py:38-40)."""
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq
    import io as _io

    sig = get_signal("glonass-l1")
    assert sig.track_carrier_ratio(-7) != sig.track_carrier_ratio(7)
    fs = 4.096e6
    x = make_iq(sig, 0, fs, 400, 800.0, 100.0, cn0=55.0, chan=0)
    fp = _io.BytesIO(to_int8_iq(x, scale=24.0))
    ch = TrackChannel(prn=0, doppler=810.0, code_offset=100.0)
    track_file(sig, fp, fs, 0.0, [ch], loop_dwells=(150, 100))
    cf = np.array([r["carrier_f"] for r in ch.rows[-30:]])
    assert abs(np.mean(cf) - 800.0) < 8.0


def test_track_glonass_fdma_channel_offsets():
    """Two FDMA channels at DIFFERENT chans in one batch: each channel's
    carrier wipeoff must include its own 562500*chan on top of the shared
    channel-0 coffset (track-glonass-l1.py:161).  Regression for the
    round-2 sky-capture code-lock failure."""
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq
    import io as _io

    sig = get_signal("glonass-l1")
    fs, coffset = 8.192e6, 6000.0
    t = np.arange(int(fs * 0.400))
    x = (make_iq(sig, -3, fs, 400, 900.0, 150.0, cn0=55.0, chan=-3)
         + make_iq(sig, 2, fs, 400, -700.0, 350.0, cn0=55.0, chan=2))
    x = x * np.exp(2j * np.pi * coffset / fs * t)
    fp = _io.BytesIO(to_int8_iq(x, scale=24.0))
    chs = [TrackChannel(prn=-3, doppler=912.0, code_offset=150.0),
           TrackChannel(prn=2, doppler=-688.0, code_offset=350.0)]
    track_file(sig, fp, fs, coffset, chs, loop_dwells=(150, 100))
    for ch, dop in zip(chs, (900.0, -700.0)):
        cf = np.array([r["carrier_f"] for r in ch.rows[-30:]])
        assert abs(np.mean(cf) - dop) < 8.0, (ch.prn, np.mean(cf))
        pr = np.array([r["prompt"] for r in ch.rows[-30:]])
        el = np.array([max(r["early"], r["late"]) for r in ch.rows[-30:]])
        assert np.mean(pr) > np.mean(el), ch.prn


@pytest.mark.slow
def test_track_l2cl_long_code():
    """L2CL: 767250-chip code, 1.5 s period tracked in 1500 sub-blocks —
    exercises the int/frac split code phase at chip indices ~7.6e5."""
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq
    import io as _io

    sig = get_signal("gps-l2cl")
    assert sig.sub_blocks == 1500
    fs = 2.048e6
    # code phase near the period end so the initial code-boundary
    # alignment (track driver :141-143) discards only ~15 ms
    cp0 = 760000.0
    x = make_iq(sig, 5, fs, 450, 800.0, cp0, cn0=55.0)
    fp = _io.BytesIO(to_int8_iq(x, scale=24.0))
    ch = TrackChannel(prn=5, doppler=805.0, code_offset=cp0)
    track_file(sig, fp, fs, 0.0, [ch], loop_dwells=(100, 80),
               max_blocks=380)
    rows = ch.rows
    assert len(rows) >= 300, len(rows)
    cf = np.array([r["carrier_f"] for r in rows[-40:]])
    assert abs(np.mean(cf) - 800.0) < 8.0, np.mean(cf)
    pr = np.array([r["prompt"] for r in rows[-40:]])
    el = np.array([max(r["early"], r["late"]) for r in rows[-40:]])
    assert np.mean(pr) > np.mean(el)
    # code phase advanced ~0.25 chips/sample without wrapping artifacts
    cps = np.array([r["code_p"] for r in rows[:100]])
    d = np.diff(cps)
    d = d[d > 0]
    assert abs(np.median(d) - (sig.chip_rate / fs) * fs * 0.001) < 2.0


def test_track_xona_pll_start():
    """Xona starts directly in PLL with hot gains (track-xona-x1p.py:151)."""
    from gnss_dsp.track.driver import TrackChannel, make_params, track_file
    from gnss_dsp.utils.synth import to_int8_iq
    import io as _io

    sig = get_signal("xona-x1p")
    p = make_params(sig, 4.096e6, 0.0)
    assert p.fll_wide_blocks == 0 and p.fll_narrow_blocks == 0
    assert p.pll_k1 == 0.5 and p.pll_k2 == 15.0
    fs = 4.096e6
    x = make_iq(sig, 0, fs, 300, 41000.0, 200.0, cn0=55.0)
    fp = _io.BytesIO(to_int8_iq(x, scale=24.0))
    ch = TrackChannel(prn=0, doppler=41001.0, code_offset=200.0)
    track_file(sig, fp, fs, 0.0, [ch])
    cf = np.array([r["carrier_f"] for r in ch.rows[-30:]])
    assert abs(np.mean(cf) - 41000.0) < 3.0, np.mean(cf)


def test_acquire_glonass_fdma_batched():
    """All 15 FDMA channels in one grid program == the per-channel loop."""
    from gnss_dsp.acquire.engine import acquire_signal_fdma

    sig = get_signal("glonass-l1")
    chans = list(range(-3, 4))
    live = {-2: (1200.0, 300.0), 2: (-900.0, 77.0)}
    fs = sig.acq_fs
    ms = 16
    n = int(fs * (ms + 3) / 1000)
    x = np.zeros(n, np.complex64)
    for chan, (dop, cp) in live.items():
        x += make_iq(sig, 0, fs, ms + 3, dop, cp, chan=chan)
    res = acquire_signal_fdma(sig, x, chans,
                              doppler_search=(-2000.0, 2000.0, 200.0), ms=ms)
    assert [r.prn for r in res] == chans
    for r in res:
        if r.prn in live:
            dop, cp = live[r.prn]
            assert abs(r.doppler - dop) <= 200.0, r
            err = min(abs(r.code_offset - cp), 511 - abs(r.code_offset - cp))
            assert err <= 1.0, r
    # live channels must out-metric the dead ones
    dead_max = max(r.metric for r in res if r.prn not in live)
    for chan in live:
        assert next(r.metric for r in res if r.prn == chan) > 1.5 * dead_max
    # matches the per-channel loop exactly
    for chan in live:
        single = acquire_signal(sig, x, [0],
                                doppler_search=(-2000.0, 2000.0, 200.0),
                                ms=ms, chan=chan)[0]
        batched = next(r for r in res if r.prn == chan)
        assert single.doppler == batched.doppler
        assert single.code_offset == batched.code_offset
