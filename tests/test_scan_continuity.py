"""A long scan equals the same blocks scanned in several launches: the
loop state (two-float code phase, sub-block index, coherent accumulator,
recovery bins, stall latch) carries across track_scan calls exactly, for
every engine shape — sub-divided periods, subcarriers, multi-million-
chip codes, extended-coherent spans and unknown-code recovery.  This is
what lets the driver stream a capture chunk by chunk."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.ops import nco
from gnss_dsp.track.driver import make_params
from gnss_dsp.track.engine import (
    SIGP_COH, SIGP_NOV, init_state, sigp_from_params, track_scan)
from gnss_dsp.utils import synth

# (signal, fs, prns, dopplers, code phases, blocks, coherent M, recovery)
FAMILIES = [
    ("gps-l1", 2.048e6, [7, 13], [900.0, -2200.0], [5.0, 417.25], 24, 1,
     False),
    ("galileo-e1b", 2.048e6, [11, 24], [700.0, -1500.0], [100.0, 2047.3],
     24, 1, False),
    ("gps-l1cp", 2.048e6, [9], [400.0], [5000.6], 22, 1, False),
    ("gps-l2cm", 2.048e6, [29], [900.0], [5111.2], 22, 1, False),
    ("gps-l2cl", 2.048e6, [29], [900.0], [700000.4], 20, 1, False),
    ("glonass-l1-p", 4.096e6, [0], [1200.0], [2555000.7], 16, 1, False),
    ("beidou-b1i", 4.096e6, [34, 6], [400.0, -900.0], [1500.6, 20.0], 24,
     20, False),
    ("beidou-b2bi", 4.096e6, [22], [300.0], [400.0], 24, 1, True),
]


@pytest.mark.parametrize("name,fs,prns,dops,phases,nb,M,recover", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_split_scan_matches_one_scan(name, fs, prns, dops, phases, nb, M,
                                     recover):
    sig = get_signal(name)
    n = int(fs * 0.04)
    x = sum(synth.synth_iq(sig.code_table((p,))[0].astype(np.float64),
                           sig.chip_rate, fs, n, doppler_hz=d,
                           code_phase=cp, cn0_dbhz=None,
                           carrier_ratio=sig.track_carrier_ratio(p),
                           subcarrier=sig.subcarrier)
            for p, d, cp in zip(prns, dops, phases))
    x = x * np.exp(2j * np.pi * 1250.0 / fs * np.arange(n))
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    params = make_params(sig, fs, coffset=1250.0, loop_dwells=(8, 8),
                         coherent_blocks=M,
                         recover_after=4 if recover else -1)
    C = len(prns)
    kw = dict(ratios=jnp.asarray([sig.track_carrier_ratio(p) for p in prns],
                                 jnp.float32),
              coffset_df=jnp.asarray([nco.freq_to_fixed(-1250.0 / fs)] * C,
                                     jnp.int32))
    if M > 1:
        ovl = np.stack([np.roll(sig.secondary(p), -k).astype(np.float32)
                        for k, p in enumerate(prns)])
        sigp = np.array(sigp_from_params(params, C))
        sigp[:, SIGP_COH] = M
        sigp[:, SIGP_NOV] = ovl.shape[1]
        kw.update(overlay=jnp.asarray(ovl), sigp=jnp.asarray(sigp))
    tab = jnp.asarray(sig.code_table(tuple(prns)).astype(np.int8))

    def fresh():
        return init_state(code_p=phases, code_f_off=np.zeros(C),
                          carrier_p=np.zeros(C), carrier_f=dops,
                          recover_bins=sig.code_length if recover else 1)

    st_a, rf_a, ri_a = track_scan(xd, jnp.int32(n), tab, fresh(), params,
                                  nb, **kw)
    assert (np.asarray(ri_a)[:, :, 0] > 0).all()      # nobody stalled
    st, parts = fresh(), []
    for k in (nb // 3, nb // 3, nb - 2 * (nb // 3)):
        st, rf, ri = track_scan(xd, jnp.int32(n), tab, st, params, k, **kw)
        parts.append((np.asarray(rf), np.asarray(ri)))
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  np.asarray(rf_a))
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                  np.asarray(ri_a))
    for leaf in st_a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, leaf)),
                                      np.asarray(getattr(st_a, leaf)),
                                      err_msg=leaf)
