"""Card-only checks: the compiled GPU programs against the numpy
references and against the same programs on the CPU.  They skip
without a GPU; on the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ -n 0
"""

from __future__ import annotations

import dataclasses
import io
import os
import sys

import numpy as np
import pytest

from gnss_dsp.models import get_signal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


def test_grid_search_on_card_matches_numpy(gpu):
    import jax

    import bench
    from gnss_dsp.acquire import engine as eng

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=2.048e6)
    ms, prns = 10, (5, 12, 21, 7)
    x = bench.synth_sky(sig, sig.acq_fs, (ms + 2) * 2048)
    dops = (-5000.0, 5000.0, 250.0)
    with jax.default_device(gpu):
        args, kw, bins, _ = eng.search_inputs(sig, x, prns, dops, ms)
        m, ci, di = (np.asarray(a) for a in eng.grid_search(*args, **kw))
    rm, rci, rdi = bench.reference_search(sig, x, prns, bins, ms)
    np.testing.assert_array_equal(ci, rci)
    np.testing.assert_array_equal(di, rdi)
    np.testing.assert_allclose(m, rm, rtol=1e-4)


def test_coherent_on_card_matches_numpy(gpu):
    import jax

    import bench
    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.acquire.coherent import acquire_signal_coherent
    from gnss_dsp.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn, n = 34, 4096
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs,
                 46 * n, doppler_hz=20.0, code_phase=500.0, cn0_dbhz=40.0,
                 carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sig.secondary(prn), -3),
                 rng=np.random.default_rng(1))
    grid = (-40.0, 41.0, 20.0)
    with jax.default_device(gpu):
        res = acquire_signal_coherent(sig, x, [prn, 3], grid, ms=40)
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    dops, fixed = eng.doppler_grid(sig, grid)
    rm, rci, rdi, ral = bench.reference_search_coherent(
        x, eng.build_code_ffts(sig, [prn, 3], n, window),
        (fixed.astype(np.int64) % 2**32) / 2**32, n, window, 40, 20,
        [sig.secondary(prn), sig.secondary(3)])
    for k, r in enumerate(res):
        assert r.doppler == dops[rdi[k]] and r.align == ral[k], r
        assert abs(r.code_offset - (sig.code_length * rci[k] / n)
                   % sig.code_length) < 1e-6
        assert abs(r.metric - rm[k]) / rm[k] < 1e-4


def test_track_file_card_matches_cpu(gpu):
    import jax

    from chip_smoke import compare_rows, track_scene
    from gnss_dsp.track.driver import TrackChannel, track_file

    sig = get_signal("galileo-e1b")
    fs, prns = 8.192e6, [11, 24]
    dops, phases = [700.0, -1500.0], [100.0, 2047.3]
    data, _ = track_scene("galileo-e1b", prns, fs, 0.2, dops, phases)

    def run(dev):
        chans = [TrackChannel(prn=p, doppler=d, code_offset=c)
                 for p, d, c in zip(prns, dops, phases)]
        with jax.default_device(dev):
            track_file(sig, io.BytesIO(data), fs, 0.0, chans,
                       loop_dwells=(200, 200), max_blocks=120)
        return chans

    for a, b in zip(run(gpu), run(jax.devices("cpu")[0])):
        compare_rows(sig, a.rows, b.rows, 100)
