"""The tracking correlator (track/engine._track_block through track_file)
against the numpy correlator of tools/baseline_track_numpy.py
(mix_vec / correlate_vec): the first block's E/P/L of every channel from
the initial state track_file builds, for every modulation family, FDMA
carrier offsets, sub-divided and multi-million-chip codes, and the
overlay wipe of coherent tracking.  Same check as chip_smoke.py's
phase D, at small sizes on the CPU.
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import TrackChannel, track_file

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import EPL_TOL, first_block_epl, track_scene  # noqa: E402

# (signal, fs, prns/channels, dopplers, code phases, coherent span)
CASES = [
    ("gps-l1", 2.048e6, [3, 17], [900.0, -2300.0], [5.0, 700.25], 1),
    ("gps-l1", 6.144e6, [9], [3100.0], [1010.5], 1),
    ("glonass-l1", 8.192e6, [-3, 5], [-700.0, 1200.0], [41.5, 300.0], 1),
    ("gps-l1cd", 4.096e6, [3], [-250.0], [17.0], 1),
    ("galileo-e1b", 4.096e6, [11, 24], [700.0, -1500.0], [100.0, 2047.3],
     1),
    ("galileo-e1b", 8.192e6, [7], [250.0], [3000.5], 1),
    ("gps-l1cp", 4.096e6, [9], [400.0], [5000.6], 1),
    ("gps-l2cm", 2.048e6, [29], [900.0], [5111.2], 1),
    ("gps-l2cl", 2.048e6, [29], [900.0], [767200.4], 1),
    ("glonass-l1-p", 12.288e6, [0], [1200.0], [5109000.7], 1),
    ("beidou-b1i", 4.096e6, [34, 6], [400.0, -900.0], [1500.6, 20.0], -1),
    ("gps-l5i", 20.0e6, [25], [-1600.0], [9696.0], -1),
    ("galileo-e5ai", 17.0e6, [24], [200.0], [7919.0], 1),
    ("beidou-b2i", 4.096e6, [14], [-600.0], [1682.9], 1),
]


def _first_block(name, fs, prns, dops, phases, coherent):
    sig = get_signal(name)
    L = sig.code_length
    seconds = (sig.code_period_ms * (1 + max((L - c) / L for c in phases))
               + 2 * sig.code_period_ms / sig.sub_blocks + 1.0) / 1000.0
    data, x = track_scene(name, prns, fs, seconds, dops, phases, seed=3)
    chans = [TrackChannel(prn=p, doppler=d, code_offset=c)
             for p, d, c in zip(prns, dops, phases)]
    track_file(sig, io.BytesIO(data), fs, 0.0, chans, loop_dwells=(8, 8),
               max_blocks=2, coherent_blocks=coherent)
    return sig, x, chans


@pytest.mark.parametrize("name,fs,prns,dops,phases,coherent", CASES,
                         ids=[f"{c[0]}@{c[1] / 1e6:g}" for c in CASES])
def test_first_block_epl_matches_numpy(name, fs, prns, dops, phases,
                                       coherent):
    sig, x, chans = _first_block(name, fs, prns, dops, phases, coherent)
    for ch in chans:
        r0 = ch.rows[0]
        (e, p, l), (se, sp, sl) = first_block_epl(sig, fs, x, ch, r0)
        # coherent tracking reports the overlay-wiped correlators: the
        # first tracked period carries overlay chip 0
        s0 = (float(sig.secondary(ch.prn)[0])
              if coherent != 1 and sig.secondary is not None else 1.0)
        pm = abs(p)
        got = np.array([r0["early"], r0["p_re"], r0["p_im"], r0["prompt"],
                        r0["late"]])
        want = np.array([abs(e), s0 * p.real, s0 * p.imag, pm, abs(l)])
        slack = np.array([se, sp, sp, sp, sl])
        # the edge samples are few: the comparison stays meaningful
        assert slack.max() < 0.1 * pm, (name, pm, slack)
        err = np.maximum(np.abs(got - want) - slack, 0.0) / pm
        assert err.max() <= EPL_TOL, (name, ch.prn, got, want, slack)
