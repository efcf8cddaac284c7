"""Secondary-code wipeoff / extended-coherent acquisition (VERDICT
round-1 item 6): at a C/N0 where the reference-style 1 ms non-coherent
search fails, 20 ms secondary-aligned coherent integration succeeds."""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_dsp.models import get_signal
from gnss_dsp.utils.synth import synth_iq


def _err_chips(sig, r, cp0):
    e = abs(r.code_offset - cp0)
    return min(e, sig.code_length - e)


def test_coherent_beats_noncoherent_at_low_cn0():
    """BeiDou B1I (NH20 overlay): cn0 = 27 dB-Hz, 40 ms of data.  The
    1 ms + 40 non-coherent sums search misses the code phase by hundreds
    of chips; one NH20-wiped 20 ms coherent x 2 groups nails it."""
    from gnss_dsp.acquire.engine import acquire_signal
    from gnss_dsp.acquire.coherent import acquire_signal_coherent

    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn, doppler, cp0, cn0, ms = 34, 20.0, 500.0, 27.0, 40
    sec = sig.secondary(prn)
    assert len(sec) == 20 and set(np.unique(sec)) <= {-1, 1}
    n = int(sig.acq_fs * (ms + 4) / 1000)
    # the synthetic pilot really carries the overlay (±1 per code period)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=doppler, code_phase=cp0, cn0_dbhz=cn0,
                 carrier_ratio=sig.carrier_ratio, data_bits=sec,
                 rng=np.random.default_rng(1))
    grid = (-100.0, 101.0, 25.0)

    nc = acquire_signal(sig, x, [prn], doppler_search=grid, ms=ms)[0]
    co = acquire_signal_coherent(sig, x, [prn], grid, ms=ms)[0]
    assert _err_chips(sig, nc, cp0) > 50.0, nc      # non-coherent lost
    assert _err_chips(sig, co, cp0) < 1.0, co       # coherent locked
    assert abs(co.doppler - doppler) <= 25.0, co


def test_coherent_noiseless_alignment_l5i():
    """GPS L5I (NH10): noiseless sanity — exact code phase and doppler
    bin through the 10 ms coherent path, arbitrary overlay alignment in
    the data (block 0 starts mid-overlay)."""
    from gnss_dsp.acquire.coherent import acquire_signal_coherent

    sig = dataclasses.replace(get_signal("gps-l5i"), acq_fs=12.288e6)
    prn, doppler, cp0 = 25, -40.0, 3333.0
    sec = np.roll(sig.secondary(prn), 3)       # unknown overlay phase
    n = int(sig.acq_fs * 0.024)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=doppler, code_phase=cp0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio, data_bits=sec)
    r = acquire_signal_coherent(sig, x, [prn], (-120.0, 121.0, 40.0),
                                ms=20)[0]
    assert abs(r.doppler - doppler) <= 40.0, r
    assert _err_chips(sig, r, cp0) < 1.5, r


def test_coherent_no_secondary_plain():
    """Signals without an overlay ride the same engine with an all-ones
    secondary (plain extended coherent)."""
    from gnss_dsp.acquire.coherent import acquire_signal_coherent

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=2.048e6)
    prn, doppler, cp0 = 7, 30.0, 222.0
    n = int(sig.acq_fs * 0.014)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=doppler, code_phase=cp0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio)
    r = acquire_signal_coherent(sig, x, [prn], (-90.0, 91.0, 30.0),
                                m_coh=10, ms=10)[0]
    assert abs(r.doppler - doppler) <= 30.0, r
    assert _err_chips(sig, r, cp0) < 1.0, r


def test_coherent_fdma_channel_offset():
    """GLONASS (FDMA, no secondary): plain extended-coherent per channel
    folds the channel's band offset into its doppler grid — a planted
    channel -3 signal is found at its true residual doppler and code
    phase (the CLI's `--channel K --coherent M` path)."""
    from gnss_dsp.acquire.coherent import acquire_signal_coherent

    sig = dataclasses.replace(get_signal("glonass-l1"), acq_fs=2.048e6)
    chan, doppler, cp0 = -3, 40.0, 123.0
    fs = sig.acq_fs
    n = int(fs * 0.014)
    x = synth_iq(sig.code_table((chan,))[0], sig.chip_rate, fs, n,
                 doppler_hz=doppler + sig.fdma_hz * chan, code_phase=cp0,
                 cn0_dbhz=None, carrier_ratio=sig.track_carrier_ratio(chan),
                 # the FDMA band offset is not doppler: code rate rides
                 # only the true doppler (test_parallel.make_iq)
                 code_doppler_hz=doppler)
    r = acquire_signal_coherent(sig, x, [chan], (-90.0, 91.0, 30.0),
                                m_coh=8, ms=8, chan=chan)[0]
    assert _err_chips(sig, r, cp0) < 1.0, r
    assert abs(r.doppler - doppler) <= 30.0, r
    # wrong channel's offset must miss by the FDMA spacing
    r0 = acquire_signal_coherent(sig, x, [chan], (-90.0, 91.0, 30.0),
                                 m_coh=8, ms=8, chan=0)[0]
    assert r0.metric < r.metric


def test_acquire_to_track_overlay_handoff():
    """Coherent acquisition returns the overlay alignment; mapped through
    CoherentAcqResult.track_overlay_phase it seeds coherent tracking
    directly — the full weak-signal workflow, no overlay knowledge needed
    from the user."""
    import io as _io

    from gnss_dsp.acquire.coherent import acquire_signal_coherent
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq

    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn, doppler, cp0, cn0 = 34, 20.0, 500.0, 30.0
    fs = sig.acq_fs
    sec = sig.secondary(prn)
    true_roll = 7                      # capture starts mid-overlay
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs,
                 int(fs * 0.8), doppler_hz=doppler, code_phase=cp0,
                 cn0_dbhz=cn0, carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sec, -true_roll),
                 rng=np.random.default_rng(2))

    r = acquire_signal_coherent(sig, x, [prn], (-80.0, 81.0, 20.0),
                                ms=40)[0]
    assert _err_chips(sig, r, cp0) < 1.0, r
    assert abs(r.doppler - doppler) <= 20.0, r
    ovl = r.track_overlay_phase(sig.code_length)
    # ground truth: period p carries chip (true_roll + p) mod 20; the
    # tracker starts at period 1
    assert ovl == (true_roll + 1) % 20, (ovl, r.align)

    sigma = np.sqrt(fs / (2 * 10 ** (cn0 / 10)))
    raw = to_int8_iq(x, scale=100.0 / (4 * sigma))
    ch = TrackChannel(prn=prn, doppler=r.doppler, code_offset=r.code_offset,
                      pll_from_start=True, overlay_phase=ovl)
    track_file(sig, _io.BytesIO(raw), fs, 0.0, [ch], coherent_blocks=20)
    cf = np.array([r_["carrier_f"] for r_ in ch.rows[-200:]])
    assert abs(np.mean(cf) - doppler) < 1.0, np.mean(cf)
    assert np.std(cf) < 1.0, np.std(cf)
