"""Parity MATRIX: one subprocess diff per reference script name, so every
one of the 65 acquire-*/track-* behaviors is cross-checked against the
actual reference implementation — a transcription
error in any catalog entry (carrier ratio, E/L spacing, sub-blocks,
subcarrier, code construction, FDMA offsets) breaks its row here.

Files are synthesized noiselessly (int8 quantization only), so both
implementations see identical bits and the comparisons stay tight at
short durations.  The heavier rates are marked slow; `test_matrix_covers
_all_reference_scripts` pins the 65/65 coverage accounting (including
the 10 scripts exercised by the focused tests in test_reference_parity
.py)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

REF = os.environ.get("GNSS_REF", "/root/reference")
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not present")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scripts with focused tests in test_reference_parity.py (kept there)
COVERED_ELSEWHERE = {
    "acquire-gps-l1.py", "acquire-beidou-b1i.py", "acquire-gps-l5i.py",
    "acquire-gps-l2cl.py", "acquire-glonass-l1.py", "acquire-gps-l1cp.py",
    "track-gps-l1.py", "track-galileo-e1b.py", "track-glonass-l1.py",
    "track-gps-l2cm.py",
}


def _synth_file(tmp_path, sig, prn, fs, ms, doppler, code_phase, coffset,
                chan=0, scale=18.0, fname="mx.iq"):
    """Noiseless one-signal capture; FDMA channel IF included when the
    signal is FDMA (the synth carrier rides doppler + fdma_hz*chan while
    the code NCO sees only the true doppler)."""
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    n = int(fs * ms / 1000)
    carrier_dop = doppler + sig.fdma_hz * chan
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                 doppler_hz=carrier_dop, code_phase=code_phase,
                 cn0_dbhz=None, subcarrier=sig.subcarrier,
                 carrier_ratio=sig.track_carrier_ratio(chan),
                 code_doppler_hz=doppler)
    x = x * np.exp(2j * np.pi * coffset / fs * np.arange(n))
    p = os.path.join(tmp_path, fname)
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=scale))
    return p


# int-returning legendre_symbol for the reference's Weil modules (modern
# sympy returns Integer objects that crash its pure-python track loop —
# see tests/data/sympy_shim/sympy/__init__.py)
SYMPY_SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "sympy_shim")


def _run(script, args, ours: bool):
    if ours:
        cmd = [sys.executable, os.path.join(REPO, "scripts", script)]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
    else:
        cmd = [sys.executable, os.path.join(REF, script)]
        env = dict(os.environ, PYTHONPATH=SYMPY_SHIM + os.pathsep + REF)
    out = subprocess.run(cmd + args, capture_output=True, text=True,
                         timeout=600, env=env, cwd=REF if not ours else None)
    assert out.returncode == 0, (script, ours, out.stderr[-2000:])
    return out.stdout.strip().splitlines()


# ---------------------------------------------------------------------------
# acquisition matrix


class A:
    """One acquisition parity case (standard template)."""

    def __init__(self, signal, prn, time_ms, doppler=400.0,
                 search="0,1000,200", code_frac=0.31, coffset=2000.0,
                 chan=None):
        self.signal, self.prn, self.time_ms = signal, prn, time_ms
        self.doppler, self.search = doppler, search
        self.code_frac, self.coffset, self.chan = code_frac, coffset, chan


ACQ = {
    # GPS
    "acquire-gps-l1cd.py":      A("gps-l1cd", 9, 20),
    "acquire-gps-l2cm.py":      A("gps-l2cm", 29, 40),
    "acquire-gps-l5q.py":       A("gps-l5q", 25, 8),
    "acquire-xona-x1.py":       A("xona-x1p", 0, 12),
    "acquire-xona-x5p.py":      A("xona-x5p", 0, 8),
    # Galileo
    "acquire-galileo-e1b.py":   A("galileo-e1b", 11, 12),
    "acquire-galileo-e1c.py":   A("galileo-e1c", 11, 12),
    "acquire-galileo-e5ai.py":  A("galileo-e5ai", 7, 8),
    "acquire-galileo-e5aq.py":  A("galileo-e5aq", 7, 8),
    "acquire-galileo-e5bi.py":  A("galileo-e5bi", 7, 8),
    "acquire-galileo-e5bq.py":  A("galileo-e5bq", 7, 8),
    "acquire-galileo-e6b.py":   A("galileo-e6b", 3, 8),
    "acquire-galileo-e6c.py":   A("galileo-e6c", 3, 8),
    # BeiDou
    "acquire-beidou-b1cd.py":   A("beidou-b1cd", 22, 20),
    "acquire-beidou-b1cp.py":   A("beidou-b1cp", 22, 20),
    "acquire-beidou-b2i.py":    A("beidou-b2i", 12, 12),
    # b2ad hardcodes 80 non-coherent blocks (acquire-beidou-b2ad.py:29):
    # the file must cover them regardless of --time
    "acquire-beidou-b2ad.py":   A("beidou-b2ad", 30, 81),
    "acquire-beidou-b2ap.py":   A("beidou-b2ap", 30, 8),
    "acquire-beidou-b2bi.py":   A("beidou-b2bi", 19, 8),
    "acquire-beidou-b2bq.py":   A("beidou-b2bq", 19, 8),
    "acquire-beidou-b3i.py":    A("beidou-b3i", 12, 8),
    # GLONASS
    "acquire-glonass-l2.py":    A("glonass-l2", None, 12, chan=-2),
    "acquire-glonass-l3ocd.py": A("glonass-l3ocd", 5, 8),
    "acquire-glonass-l3ocp.py": A("glonass-l3ocp", 5, 8),
}

# the heavier internal rates (30.69 / 15.345 MHz): reference pure-python
# mix loop + big FFTs
ACQ_SLOW = {
    "acquire-gps-l5q.py", "acquire-xona-x5p.py",
    "acquire-galileo-e5ai.py", "acquire-galileo-e5aq.py",
    "acquire-galileo-e5bi.py", "acquire-galileo-e5bq.py",
    "acquire-galileo-e6b.py", "acquire-galileo-e6c.py",
    "acquire-beidou-b2ad.py", "acquire-beidou-b2ap.py",
    "acquire-beidou-b2bi.py", "acquire-beidou-b2bq.py",
    "acquire-beidou-b3i.py",
    "acquire-glonass-l3ocd.py", "acquire-glonass-l3ocp.py",
}


def _params(table, slow_set):
    return [pytest.param(k, marks=pytest.mark.slow) if k in slow_set
            else k for k in sorted(table)]


@pytest.mark.parametrize("script", _params(ACQ, ACQ_SLOW))
def test_acquire_matrix(script, tmp_path):
    from gnss_dsp.models import get_signal

    case = ACQ[script]
    sig = get_signal(case.signal)
    fs = sig.acq_fs          # capture at the internal rate: cheap for both
    prn = case.prn if case.prn is not None else 0
    chan = case.chan or 0
    cp = round(case.code_frac * sig.code_length, 2)
    path = _synth_file(tmp_path, sig, prn, fs, case.time_ms + 6,
                       case.doppler, cp, case.coffset, chan=chan)
    sel = (["--channel", str(chan)] if sig.fdma_hz
           else ["--prn", str(prn)])
    args = sel + ["--doppler-search", case.search,
                  "--time", str(case.time_ms),
                  path, "%d" % fs, "%d" % case.coffset]
    ref_rows = _run(script, args, ours=False)
    our_rows = _run(script, args, ours=True)
    assert len(ref_rows) == len(our_rows) == 1, (ref_rows, our_rows)
    rt, ot = ref_rows[0].split(), our_rows[0].split()
    assert rt[1] == ot[1], (ref_rows, our_rows)              # prn / chan
    assert float(rt[3]) == float(ot[3]) == case.doppler, (ref_rows, our_rows)
    # one internal-rate sample, in chips
    tol = 1.05 * sig.chip_rate / sig.acq_fs + 0.01
    dcode = abs(float(rt[7]) - float(ot[7]))
    dcode = min(dcode, sig.code_length - dcode)              # wrap
    assert dcode <= tol, (ref_rows, our_rows, tol)
    assert abs(float(rt[5]) - float(ot[5])) / float(rt[5]) < 0.05, \
        (ref_rows, our_rows)


@pytest.mark.slow
def test_acquire_glonass_p_handover_matches_reference(tmp_path):
    """GLONASS P serial handover (acquire-glonass-l1-p.py:15-33): 1000
    P-code hypotheses seeded by a C/A fix, cp = 5110*k + 10*ca_phase,
    4 ms coherent blocks at the NATIVE rate (no resample).  Both
    implementations must report the same winning k and code phase."""
    from gnss_dsp.models import get_signal

    sig = get_signal("glonass-l1-p")
    fs, chan, doppler = 8.192e6, -2, 300.0
    k_true, ca_phase = 417, 123.4
    cp = float((5110 * k_true + 10 * ca_phase) % sig.code_length)
    path = _synth_file(tmp_path, sig, 0, fs, 30, doppler, cp, 0.0,
                       chan=chan, scale=20.0)
    args = ["--time", "20", path, "%d" % fs, "0", str(chan),
            "%f" % doppler, "%f" % ca_phase]
    ref_rows = _run("acquire-glonass-l1-p.py", args, ours=False)
    our_rows = _run("acquire-glonass-l1-p.py", args, ours=True)
    rp, rm = (float(v) for v in ref_rows[-1].split())
    op, om = (float(v) for v in our_rows[-1].split())
    assert rp == op == 5110 * k_true + 10 * ca_phase, (ref_rows, our_rows)
    assert abs(rm - om) / rm < 0.05, (ref_rows, our_rows)


@pytest.mark.slow
def test_acquire_glonass_l2_p_handover_matches_reference(tmp_path):
    """L2 P handover: same search, L2 FDMA plan (437500*chan wipeoff,
    acquire-glonass-l2-p.py)."""
    from gnss_dsp.models import get_signal

    sig = get_signal("glonass-l2-p")
    fs, chan, doppler = 8.192e6, 3, -250.0
    k_true, ca_phase = 88, 55.8
    cp = float((5110 * k_true + 10 * ca_phase) % sig.code_length)
    path = _synth_file(tmp_path, sig, 0, fs, 30, doppler, cp, 0.0,
                       chan=chan, scale=20.0)
    args = ["--time", "20", path, "%d" % fs, "0", str(chan),
            "%f" % doppler, "%f" % ca_phase]
    ref_rows = _run("acquire-glonass-l2-p.py", args, ours=False)
    our_rows = _run("acquire-glonass-l2-p.py", args, ours=True)
    rp, rm = (float(v) for v in ref_rows[-1].split())
    op, om = (float(v) for v in our_rows[-1].split())
    assert rp == op == 5110 * k_true + 10 * ca_phase, (ref_rows, our_rows)
    assert abs(rm - om) / rm < 0.05, (ref_rows, our_rows)


# ---------------------------------------------------------------------------
# tracking matrix


class T:
    """One tracking parity case."""

    def __init__(self, signal, prn, fs, doppler=321.0, code_frac=0.3,
                 coffset=1500.0, blocks=40, dwells="15,15", chan=None,
                 cols=9, cp_abs=None, file_ms=None):
        self.signal, self.prn, self.fs = signal, prn, fs
        self.doppler, self.code_frac = doppler, code_frac
        self.coffset, self.blocks, self.dwells = coffset, blocks, dwells
        self.chan, self.cols, self.cp_abs = chan, cols, cp_abs
        self.file_ms = file_ms


TRACK = {
    # GPS
    "track-gps-l1cd.py":      T("gps-l1cd", 9, 8.192e6),
    "track-gps-l1cp.py":      T("gps-l1cp", 9, 8.192e6),
    # track-gps-l2cl reads the ENTIRE 1.5 s code period in one gulp
    # before printing its 1500 sub-block rows (track-gps-l2cl.py:153-165,
    # no code-boundary alignment discard) — so the file must span a full
    # period; fs kept low to bound the reference's pure-python loops
    # deeper tail: the two row streams are offset by the reference's
    # missing alignment discard, so compare well inside PLL lock
    "track-gps-l2cl.py":      T("gps-l2cl", 5, 1.024e6, blocks=120,
                                dwells="10,20",
                                cp_abs=767250.0 - 41.3, file_ms=1650),
    "track-gps-l5i.py":       T("gps-l5i", 25, 16.384e6),
    "track-gps-l5q.py":       T("gps-l5q", 25, 16.384e6),
    "track-xona-x1d.py":      T("xona-x1d", 0, 4.096e6, cols=14),
    "track-xona-x1p.py":      T("xona-x1p", 0, 4.096e6, cols=14),
    # x5p prints 9 columns (track-xona-x5p.py:171), unlike x1d/x1p's 14
    "track-xona-x5p.py":      T("xona-x5p", 0, 16.384e6, cols=9),
    # Galileo
    "track-galileo-e1c.py":   T("galileo-e1c", 11, 8.192e6),
    "track-galileo-e5ai.py":  T("galileo-e5ai", 7, 16.384e6),
    "track-galileo-e5aq.py":  T("galileo-e5aq", 7, 16.384e6),
    "track-galileo-e5bi.py":  T("galileo-e5bi", 7, 16.384e6),
    "track-galileo-e5bq.py":  T("galileo-e5bq", 7, 16.384e6),
    "track-galileo-e6b.py":   T("galileo-e6b", 3, 16.384e6),
    "track-galileo-e6c.py":   T("galileo-e6c", 3, 16.384e6),
    # BeiDou
    "track-beidou-b1i.py":    T("beidou-b1i", 12, 8.192e6),
    "track-beidou-b2i.py":    T("beidou-b2i", 12, 8.192e6),
    "track-beidou-b1cd.py":   T("beidou-b1cd", 22, 8.192e6),
    "track-beidou-b1cp.py":   T("beidou-b1cp", 22, 8.192e6),
    "track-beidou-b2ad.py":   T("beidou-b2ad", 30, 16.384e6),
    "track-beidou-b2ap.py":   T("beidou-b2ap", 30, 16.384e6),
    "track-beidou-b2bi.py":   T("beidou-b2bi", 19, 16.384e6),
    "track-beidou-b2bq.py":   T("beidou-b2bq", 19, 16.384e6),
    "track-beidou-b3i.py":    T("beidou-b3i", 12, 16.384e6),
    # GLONASS
    "track-glonass-l2.py":    T("glonass-l2", None, 8.192e6, chan=-2),
    # like l2cl, the P trackers read the ENTIRE 1 s code period in one
    # gulp before printing their 1000 sub-block rows
    # (track-glonass-l1-p.py:152-157) — full-period files, low fs
    "track-glonass-l1-p.py":  T("glonass-l1-p", None, 8.192e6, chan=-2,
                                blocks=120, dwells="10,20",
                                cp_abs=5110000.0 - 150.4, file_ms=1050),
    "track-glonass-l2-p.py":  T("glonass-l2-p", None, 8.192e6, chan=3,
                                blocks=120, dwells="10,20",
                                cp_abs=5110000.0 - 150.4, file_ms=1050),
    "track-glonass-l3ocd.py": T("glonass-l3ocd", 5, 16.384e6),
    "track-glonass-l3ocp.py": T("glonass-l3ocp", 5, 16.384e6),
}

TRACK_SLOW = ({k for k, c in TRACK.items() if c.fs > 8.2e6}
              | {"track-gps-l2cl.py",
                 # ~80 s each (1+ s of data to cover the 1 s P-code
                 # period; the heaviest rows in the default loop)
                 "track-glonass-l1-p.py", "track-glonass-l2-p.py"})


@pytest.mark.parametrize("script", _params(TRACK, TRACK_SLOW))
def test_track_matrix(script, tmp_path):
    from gnss_dsp.models import get_signal

    case = TRACK[script]
    sig = get_signal(case.signal)
    prn = case.prn if case.prn is not None else 0
    chan = case.chan or 0
    ident = chan if sig.fdma_hz else prn
    cp = (case.cp_abs if case.cp_abs is not None
          else round(case.code_frac * min(sig.code_length, 10230) + 0.17, 2))
    ms = case.file_ms or (case.blocks + 14)
    path = _synth_file(tmp_path, sig, prn, case.fs, ms, case.doppler,
                       cp, case.coffset, chan=chan, scale=20.0)
    args = ["--loop-dwells", case.dwells, path, "%d" % case.fs,
            "%d" % case.coffset, str(ident), "%f" % case.doppler,
            "%f" % cp]
    ref_rows = _run(script, args, ours=False)
    our_rows = _run(script, ["--blocks", str(case.blocks)] + args,
                    ours=True)
    nb = min(len(ref_rows), len(our_rows))
    assert nb >= case.blocks - 2, (len(ref_rows), len(our_rows))
    ref = np.array([[float(v) for v in r.split()] for r in ref_rows[:nb]])
    ours = np.array([[float(v) for v in r.split()] for r in our_rows[:nb]])
    assert ref.shape[1] == ours.shape[1] == case.cols, \
        (ref.shape, ours.shape)
    k = min(10, nb // 4)
    # carrier loop: same converged frequency (noiseless -> tight)
    assert abs(np.mean(ref[-k:, 3]) - np.mean(ours[-k:, 3])) < 2.0, \
        (ref[-3:, 3], ours[-3:, 3])
    # code loop: same code-frequency offset trajectory
    assert abs(np.mean(ref[-k:, 4]) - np.mean(ours[-k:, 4])) < 2.0, \
        (ref[-3:, 4], ours[-3:, 4])
    # same signal power through the prompt correlator
    rp, op_ = np.mean(ref[-k:, 7]), np.mean(ours[-k:, 7])
    assert abs(rp / op_ - 1) < 0.07, (rp, op_)
    # and both code-locked: prompt beats max(early, late) by at least
    # half the E/L spacing's autocorrelation falloff (el=0.05 signals
    # legitimately sit at P/EL ~ 1.05, BPSK ACF(d) = 1-d)
    el = np.mean(np.maximum(ours[-k:, 6], ours[-k:, 8]))
    assert op_ > (1.0 + 0.5 * sig.el_spacing) * el, (op_, el, sig.el_spacing)


# ---------------------------------------------------------------------------
# coverage accounting: every reference script name is exercised somewhere


def test_matrix_covers_all_reference_scripts():
    import glob

    all_scripts = {os.path.basename(p) for p in
                   glob.glob(os.path.join(REF, "acquire-*.py"))
                   + glob.glob(os.path.join(REF, "track-*.py"))}
    assert len(all_scripts) == 65, len(all_scripts)
    here = (set(ACQ) | set(TRACK)
            | {"acquire-glonass-l1-p.py", "acquire-glonass-l2-p.py"})
    covered = here | COVERED_ELSEWHERE
    missing = all_scripts - covered
    assert not missing, sorted(missing)
    stale = covered - all_scripts
    assert not stale, sorted(stale)
