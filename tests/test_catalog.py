"""Catalog-wide invariants: every registered signal yields well-formed
code tables, secondaries, and engine parameters (the inventory the
reference spreads over 65 scripts, SURVEY.md §2.3-2.4)."""

import numpy as np
import pytest

from gnss_dsp.models.signal import all_signals

SIGS = all_signals()


def test_registry_complete():
    # 33 script-backed signals + gps-p + xona-x5d (module-only in the
    # reference)
    assert len(SIGS) == 35
    for family in ("gps-l1", "gps-l2cm", "gps-l2cl", "gps-l5i", "gps-l1cp",
                   "galileo-e1b", "galileo-e5aq", "galileo-e6c",
                   "beidou-b1i", "beidou-b1cp", "beidou-b2ap", "beidou-b2bi",
                   "beidou-b3i", "glonass-l1", "glonass-l1-p",
                   "glonass-l3ocd", "xona-x1p", "xona-x5p"):
        assert family in SIGS, family


@pytest.mark.parametrize("name", sorted(SIGS))
def test_signal_invariants(name):
    sig = SIGS[name]
    assert sig.chip_rate > 0 and sig.code_length > 0
    assert sig.subcarrier in ("none", "boc11", "cboc", "tmboc",
                              "rz_even", "rz_odd")
    prns = sig.prns()
    assert prns and all(p in sig.prn_all for p in prns), name

    if sig.code_table is not None and sig.code_length <= 10_230_000:
        take = prns[:2]
        t = sig.code_table(tuple(take))
        assert t.shape == (len(take), sig.code_length), name
        assert t.dtype == np.int8
        assert set(np.unique(t)) <= {-1, 1}, name
    if sig.secondary is not None:
        s = sig.secondary(prns[0])
        assert s.ndim == 1 and len(s) in (4, 5, 10, 20, 25, 100, 1800), name
        assert set(np.unique(s)) <= {-1, 1}, name
    if sig.acq_serial:
        assert sig.acq_serial_stride > 0 and sig.acq_serial_coh_ms > 0
    elif sig.code_table is not None:
        assert sig.acq_fs > 0 and sig.acq_coherent_ms > 0
        # internal-rate coherent window must hold an integer number of
        # samples and be FFT-able by the engine
        n = sig.acq_fs * sig.acq_coherent_ms / 1000.0
        assert abs(n - round(n)) < 1e-6, name
    assert sig.sub_blocks >= 1
    if sig.fdma_code_mhz:
        assert sig.track_carrier_ratio(-7) != sig.track_carrier_ratio(7)
    else:
        assert sig.track_carrier_ratio(0) == sig.carrier_ratio
