"""chip_smoke.py's phases at tiny sizes on the CPU: the same checks the
card run makes (numpy references, card-vs-CPU row comparison, mesh
equality, kernel count), so a broken phase shows here before it costs
a run on the card."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def test_phase_b_tiny():
    line = cs.phase_b("CPU", acq_fs=1.024e6, ms=8,
                      dops_cfg=(-7000.0, 7000.0, 500.0))
    assert line.startswith("B sky search") and "cells identical" in line


def test_phase_d_tiny():
    line = cs.phase_d("CPU", nblk=60, n_l1=3, fs=2.048e6, cmp_blocks=30,
                      long_code=False)
    assert "card rows == CPU rows" in line and "kernels/step" in line


def test_four_cards_tiny():
    lines = cs.four_cards("CPU", acq_fs=1.024e6, ms=8,
                          dops_cfg=(-7000.0, 7000.0, 500.0), nblk=60,
                          n_l1=8, fs=2.048e6)
    assert [ln[:2] for ln in lines] == ["B4", "D4", "M4"]


def test_coherent_check_tiny():
    import jax

    from gnss_dsp.models import get_signal
    from gnss_dsp.ops import cplx
    from gnss_dsp.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("gps-l5i"), acq_fs=10.23e6)
    x = synth_iq(sig.code_table((25,))[0], sig.chip_rate, sig.acq_fs,
                 int(sig.acq_fs * 0.012), doppler_hz=-400.0,
                 code_phase=9696.0, cn0_dbhz=45.0,
                 carrier_ratio=sig.carrier_ratio,
                 data_bits=sig.secondary(25), rng=np.random.default_rng(4))
    res, err = cs.coherent_check(sig, cplx.from_numpy(x), [25, 3], [25, 3],
                                 (-400.0, 1.0, 200.0), 10, 10,
                                 jax.lax.Precision.HIGHEST)
    assert err < cs.ACQ_TOL["HIGHEST"]
    assert max(res, key=lambda r: r.metric).prn == 25


def test_count_loop_kernels():
    hlo = """HloModule m

%body.1 (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %p = (s32[], f32[4]{0}) parameter(0)
  %g = f32[4]{0} get-tuple-element(%p), index=1
  %f = f32[4]{0} fusion(%g), kind=kLoop, calls=%fc
  %c = f32[4]{0} custom-call(%f), custom_call_target="x"
  ROOT %t = (s32[], f32[4]{0}) tuple(%g, %c)
}

ENTRY %main.2 (a: f32[4]) -> f32[4] {
  %a = f32[4]{0} parameter(0)
  %w = (s32[], f32[4]{0}) while(%a), condition=%cond.3, body=%body.1
}
"""
    assert cs.count_loop_kernels(hlo) == {"fusion": 1, "custom-call": 1}


def test_compare_rows_tolerates_only_rare_edge_events():
    """One chip-edge event (a single sample on the other side of an edge)
    passes; a systematic difference fails."""
    from gnss_dsp.models import get_signal

    sig = get_signal("gps-l1")
    rows = [{"early": 900.0, "prompt": 1000.0, "late": 800.0,
             "carrier_f": 100.0, "code_f_offset": 0.0, "carrier_p": 0.5,
             "code_p": 1022.9} for _ in range(200)]
    one = [dict(r) for r in rows]
    one[7]["early"] += 50.0                      # one edge event
    assert cs.compare_rows(sig, one, rows, 200) == 1
    drift = [dict(r, prompt=r["prompt"] * 1.01) for r in rows]
    with pytest.raises(AssertionError):
        cs.compare_rows(sig, drift, rows, 200)
