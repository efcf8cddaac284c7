"""Single-program multi-band receiver (track/receiver.py): every
channel of every band in one compiled scan with per-channel segment
ends — trajectories match the per-band `track multi` runs."""

import io

import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import TrackChannel, track_file
from gnss_dsp.track.receiver import track_receiver
from gnss_dsp.utils import synth

FS = 4.096e6
# band -> [(signal, prn, doppler, code phase, coffset)]
BANDS = {
    0: [("gps-l1", 7, 900.0, 317.25, 200.0),
        ("glonass-l1", -3, -700.0, 41.5, 200.0)],
    1: [("beidou-b1i", 34, 400.0, 1500.6, -150.0)],
}


def _band_stream(rows, seconds=0.05, seed=1):
    n = int(FS * seconds)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp, coff in rows:
        sig = get_signal(name)
        chan = prn if sig.fdma_hz else 0
        x += synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                            sig.chip_rate, FS, n,
                            doppler_hz=dop + sig.fdma_hz * chan + coff,
                            code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(chan),
                            code_doppler_hz=dop,
                            subcarrier=sig.subcarrier)
    return synth.to_int8_iq(x, scale=24.0)


def _rows(rows, n=30):
    keys = ("block", "p_re", "p_im", "carrier_f", "code_f_offset",
            "early", "prompt", "late", "code_p")
    return np.array([[r[k] for k in keys] for r in rows[:n]])


@pytest.mark.parametrize("chunk_ms", [2000.0, 4.0],
                         ids=["one_chunk", "refills"])
def test_receiver_matches_per_band_multi(chunk_ms):
    """chunk_ms=4 refills every few blocks: each band's segment is
    rebased on its own consumed count between scans."""
    data = {b: _band_stream(rows) for b, rows in BANDS.items()}

    # per-band reference runs (track_file multi)
    ref = {}
    for b, rows in BANDS.items():
        sigs = [get_signal(nm) for nm, *_ in rows]
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp, _co in rows]
        track_file(sigs[0], io.BytesIO(data[b]), FS, 0.0, chans,
                   loop_dwells=(8, 8), max_blocks=32, sigs=sigs,
                   coffsets=[co for *_x, co in rows])
        ref[b] = [c.rows for c in chans]

    # one-program receiver over both bands
    bands = []
    for b, rows in BANDS.items():
        sigs = [get_signal(nm) for nm, *_ in rows]
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp, _co in rows]
        bands.append((io.BytesIO(data[b]), sigs, chans,
                      [co for *_x, co in rows]))
    # stalled steps at each chunk end count against max_blocks: give the
    # refilled run room to emit the compared rows
    out = track_receiver(bands, FS, loop_dwells=(8, 8),
                         max_blocks=32 if chunk_ms > 100 else 64,
                         chunk_ms=chunk_ms)

    k = 0
    for b, rows in BANDS.items():
        for j, (name, *_rest) in enumerate(rows):
            a = _rows(ref[b][j])
            r = _rows(out[k].rows)
            assert a.shape == r.shape and a.shape[0] >= 20, (name, a.shape)
            np.testing.assert_allclose(a, r, rtol=2e-3, atol=2e-2,
                                       err_msg=f"band{b}:{name}")
            k += 1


def test_receiver_coherent_matches_per_band():
    """Per-channel extended-coherent spans inside the one-program
    receiver (coherent_blocks=-1: each signal's own overlay length;
    GPS L1 stays non-coherent) match the per-band multi runs."""

    coh_bands = {
        0: [("gps-l1", 7, 900.0, 317.25, 200.0)],
        1: [("beidou-b1i", 34, 400.0, 1500.6, -150.0)],
    }

    def band_stream(rows, seconds=0.06):
        n = int(FS * seconds)
        x = np.zeros(n, np.complex64)
        for name, prn, dop, cp, coff in rows:
            sig = get_signal(name)
            bits = (np.asarray(sig.secondary(prn), np.float64)
                    if sig.secondary is not None else None)
            x += synth.synth_iq(
                sig.code_table((prn,))[0].astype(np.float64),
                sig.chip_rate, FS, n, doppler_hz=dop + coff,
                code_phase=cp, cn0_dbhz=None,
                carrier_ratio=sig.track_carrier_ratio(prn),
                code_doppler_hz=dop, data_bits=bits)
        return synth.to_int8_iq(x, scale=24.0)

    data = {b: band_stream(rows) for b, rows in coh_bands.items()}
    ref = {}
    for b, rows in coh_bands.items():
        sigs = [get_signal(nm) for nm, *_ in rows]
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp, _co in rows]
        track_file(sigs[0], io.BytesIO(data[b]), FS, 0.0, chans,
                   loop_dwells=(8, 8), max_blocks=40, sigs=sigs,
                   coffsets=[co for *_x, co in rows],
                   coherent_blocks=-1)
        ref[b] = [c.rows for c in chans]

    bands = []
    for b, rows in coh_bands.items():
        sigs = [get_signal(nm) for nm, *_ in rows]
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp, _co in rows]
        bands.append((io.BytesIO(data[b]), sigs, chans,
                      [co for *_x, co in rows]))
    out = track_receiver(bands, FS, loop_dwells=(8, 8), max_blocks=40,
                         coherent_blocks=-1)
    k = 0
    for b, rows in coh_bands.items():
        for j, (name, *_r) in enumerate(rows):
            a = _rows(ref[b][j])
            r = _rows(out[k].rows)
            assert a.shape == r.shape and a.shape[0] >= 20, (name, a.shape)
            # the one-program nmax envelope differs from the per-band
            # one, so summation orders differ; 20-block coherent sums
            # amplify that fp scheduling noise (~1%)
            np.testing.assert_allclose(a, r, rtol=2e-2, atol=2e-2,
                                       err_msg=f"band{b}:{name}")
            k += 1
