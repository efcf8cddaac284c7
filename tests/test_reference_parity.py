"""Cross-implementation parity: run the ACTUAL reference scripts
(/root/reference, numpy fallback) as subprocesses on the same synthetic
int8 I/Q file and compare against our CLI/engines.

Skipped automatically when the reference checkout is absent (the
framework is standalone; these tests are extra evidence when the
reference is around).
"""

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


def make_file(tmp_path, sig, prn, fs, ms, doppler, code_phase, coffset,
              cn0=47.0, scale=18.0):
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    n = int(fs * ms / 1000)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                 doppler_hz=doppler, code_phase=code_phase, cn0_dbhz=cn0,
                 carrier_ratio=sig.carrier_ratio,
                 rng=np.random.default_rng(11))
    x = x * np.exp(2j * np.pi * coffset / fs * np.arange(n))
    p = os.path.join(tmp_path, "ref_parity.iq")
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=scale))
    return p


def run_ref(script, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REF
    out = subprocess.run(
        [sys.executable, os.path.join(REF, script)] + args,
        capture_output=True, text=True, timeout=600, env=env, cwd=REF)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


def run_ours(script, args):
    # CPU backend: deterministic results and compile times
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script)] + args,
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


def test_acquire_gps_l1_matches_reference(tmp_path):
    """Same file through acquire-gps-l1.py (reference) and ours: identical
    doppler bin + code offset within one internal-rate sample, metric
    within a few percent (noise-floor statistics differ only via f32)."""
    from gnss_dsp.models import get_signal

    sig = get_signal("gps-l1")
    fs, coffset = 4.096e6, 12000.0
    path = make_file(tmp_path, sig, prn=17, fs=fs, ms=30, doppler=2400.0,
                     code_phase=400.25, coffset=coffset)
    args = ["--prn", "17,21", "--doppler-search", "1800,3000,200",
            "--time", "20", path, "%d" % fs, "%d" % coffset]
    ref_rows = run_ref("acquire-gps-l1.py", args)
    our_rows = run_ours("acquire-gps-l1.py", args)
    assert len(ref_rows) == len(our_rows) == 2

    def parse(row):
        t = row.split()
        return int(t[1]), float(t[3]), float(t[5]), float(t[7])

    for rr, ro in zip(ref_rows, our_rows):
        prn_r, dop_r, met_r, code_r = parse(rr)
        prn_o, dop_o, met_o, code_o = parse(ro)
        assert prn_r == prn_o
        assert dop_r == dop_o, (rr, ro)
        assert abs(code_r - code_o) <= 0.26, (rr, ro)   # one 4.096MHz sample
        assert abs(met_r - met_o) / met_r < 0.05, (rr, ro)


def test_track_gps_l1_matches_reference(tmp_path):
    """Same file through track-gps-l1.py both ways: the loops converge to
    the same carrier frequency and code phase trajectory."""
    from gnss_dsp.models import get_signal

    sig = get_signal("gps-l1")
    fs, coffset = 4.096e6, 5000.0
    path = make_file(tmp_path, sig, prn=21, fs=fs, ms=170, doppler=2400.0,
                     code_phase=817.5, coffset=coffset, cn0=50.0)
    args = ["--loop-dwells", "50,50", path, "%d" % fs, "%d" % coffset,
            "21", "2400", "817.5"]
    ref_rows = run_ref("track-gps-l1.py", args)
    our_rows = run_ours("track-gps-l1.py",
                        ["--blocks", "160"] + args)
    nb = min(len(ref_rows), len(our_rows))
    assert nb >= 150, (len(ref_rows), len(our_rows))

    ref = np.array([[float(v) for v in r.split()] for r in ref_rows[:nb]])
    ours = np.array([[float(v) for v in r.split()] for r in our_rows[:nb]])
    # col 3 = carrier_f: same convergence within 2 Hz over the last 30
    assert abs(np.mean(ref[-30:, 3]) - np.mean(ours[-30:, 3])) < 2.0
    # col 10 = code_p: phase trajectories aligned within 0.05 chips
    dcp = (ref[-30:, 10] - ours[-30:, 10] + 511.5) % 1023 - 511.5
    assert np.max(np.abs(dcp)) < 0.05, dcp[:5]
    # col 7 = prompt magnitude: same signal power within 5%
    assert abs(np.mean(ref[-30:, 7]) / np.mean(ours[-30:, 7]) - 1) < 0.05


def test_acquire_beidou_b1i_matches_reference(tmp_path):
    """The 2n-zero-padded sliding template (acquire-beidou-b1i.py)."""
    from gnss_dsp.models import get_signal

    sig = get_signal("beidou-b1i")
    fs, coffset = 8.192e6, -7000.0
    path = make_file(tmp_path, sig, prn=34, fs=fs, ms=30, doppler=-600.0,
                     code_phase=562.2, coffset=coffset)
    args = ["--prn", "34", "--doppler-search", "-1400,400,200",
            "--time", "20", path, "%d" % fs, "%d" % coffset]
    ref_rows = run_ref("acquire-beidou-b1i.py", args)
    our_rows = run_ours("acquire-beidou-b1i.py", args)
    rt = ref_rows[0].split()
    ot = our_rows[0].split()
    assert rt[1] == ot[1]                                   # prn
    assert float(rt[3]) == float(ot[3]), (ref_rows, our_rows)  # doppler
    assert abs(float(rt[7]) - float(ot[7])) <= 0.51, (ref_rows, our_rows)
    assert abs(float(rt[5]) - float(ot[5])) / float(rt[5]) < 0.05


def test_track_galileo_e1b_matches_reference(tmp_path):
    """CBOC tracking with 4 sub-blocks per 4 ms period
    (track-galileo-e1b.py) — 9-column rows."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("galileo-e1b")
    fs, coffset = 8.192e6, 3000.0
    n = int(fs * 0.100)
    x = synth_iq(sig.code_table((24,))[0], sig.chip_rate, fs, n,
                 doppler_hz=250.0, code_phase=2838.0, cn0_dbhz=50.0,
                 carrier_ratio=1540.0, subcarrier="cboc",
                 rng=np.random.default_rng(4))
    x = x * np.exp(2j * np.pi * coffset / fs * np.arange(n))
    path = os.path.join(tmp_path, "e1b.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=18.0))
    args = ["--loop-dwells", "30,30", path, "%d" % fs, "%d" % coffset,
            "24", "250.0", "2838.00"]
    ref_rows = run_ref("track-galileo-e1b.py", args)
    our_rows = run_ours("track-galileo-e1b.py", ["--blocks", "90"] + args)
    nb = min(len(ref_rows), len(our_rows))
    assert nb >= 80, (len(ref_rows), len(our_rows))
    ref = np.array([[float(v) for v in r.split()] for r in ref_rows[:nb]])
    ours = np.array([[float(v) for v in r.split()] for r in our_rows[:nb]])
    assert ref.shape[1] == ours.shape[1] == 9           # 9-column format
    assert abs(np.mean(ref[-25:, 3]) - np.mean(ours[-25:, 3])) < 3.0
    assert abs(np.mean(ref[-25:, 7]) / np.mean(ours[-25:, 7]) - 1) < 0.05


def test_track_glonass_l1_matches_reference(tmp_path):
    """FDMA tracking: the carrier wipeoff must include the channel's
    562500*chan offset on top of the channel-0 coffset
    (track-glonass-l1.py:161: fm = -(coffset+562500*chan)/fs).
    Regression for the sky-capture GLONASS code-lock failure."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("glonass-l1")
    fs, coffset, chan = 8.192e6, 4000.0, -2
    n = int(fs * 0.120)
    x = synth_iq(sig.code_table((0,))[0], sig.chip_rate, fs, n,
                 doppler_hz=-900.0 + 562500.0 * chan, code_phase=362.8,
                 cn0_dbhz=50.0, carrier_ratio=sig.track_carrier_ratio(chan),
                 code_doppler_hz=-900.0, rng=np.random.default_rng(17))
    x = x * np.exp(2j * np.pi * coffset / fs * np.arange(n))
    path = os.path.join(tmp_path, "glo_l1.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=18.0))
    args = ["--loop-dwells", "40,30", path, "%d" % fs, "%d" % coffset,
            "%d" % chan, "-900.0", "362.80"]
    ref_rows = run_ref("track-glonass-l1.py", args)
    our_rows = run_ours("track-glonass-l1.py", ["--blocks", "110"] + args)
    nb = min(len(ref_rows), len(our_rows))
    assert nb >= 100, (len(ref_rows), len(our_rows))
    ref = np.array([[float(v) for v in r.split()] for r in ref_rows[:nb]])
    ours = np.array([[float(v) for v in r.split()] for r in our_rows[:nb]])
    assert abs(np.mean(ref[-25:, 3]) - np.mean(ours[-25:, 3])) < 2.0
    assert abs(np.mean(ref[-25:, 7]) / np.mean(ours[-25:, 7]) - 1) < 0.05
    # both code-locked: prompt beats max(E, L) on the converged tail
    el = np.mean(np.maximum(ours[-25:, 6], ours[-25:, 8]))
    assert np.mean(ours[-25:, 7]) > 1.2 * el


def test_acquire_gps_l5i_matches_reference(tmp_path):
    """The 30.69 MHz upsampling front end + 2n-pad template
    (acquire-gps-l5i.py) against the reference on a 61.44 MHz capture."""
    from gnss_dsp.models import get_signal

    sig = get_signal("gps-l5i")
    fs, coffset = 61.44e6, -150000.0
    path = make_file(tmp_path, sig, prn=25, fs=fs, ms=18, doppler=-1600.0,
                     code_phase=9696.0, coffset=coffset, cn0=50.0, scale=14.0)
    args = ["--prn", "25", "--doppler-search", "-2200,-1000,200",
            "--time", "12", path, "%d" % fs, "%d" % coffset]
    ref_rows = run_ref("acquire-gps-l5i.py", args)
    our_rows = run_ours("acquire-gps-l5i.py", args)
    rt = ref_rows[0].split()
    ot = our_rows[0].split()
    assert float(rt[3]) == float(ot[3]), (ref_rows, our_rows)
    assert abs(float(rt[7]) - float(ot[7])) <= 0.5, (ref_rows, our_rows)
    assert abs(float(rt[5]) - float(ot[5])) / float(rt[5]) < 0.05


def test_acquire_l2cl_serial_matches_reference(tmp_path):
    """Assisted L2CL serial search (75 hypotheses given an L2CM fix)."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l2cl")
    fs = 4.096e6
    k_true, l2cm_phase = 31, 1234.0
    phase = float((k_true * 10230 + l2cm_phase) % sig.code_length)
    n = int(fs * 0.050)
    x = synth_iq(sig.code_table((5,))[0], sig.chip_rate, fs, n,
                 doppler_hz=250.0, code_phase=phase, cn0_dbhz=None,
                 subcarrier="rz_odd", carrier_ratio=2400.0)
    path = os.path.join(tmp_path, "l2cl.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=20.0))
    args = ["--time", "40", path, "%d" % fs, "0", "5", "250.0",
            "%f" % l2cm_phase]
    ref_rows = run_ref("acquire-gps-l2cl.py", args)
    our_rows = run_ours("acquire-gps-l2cl.py", args)
    # row: "code_phase metric" (acquire-gps-l2cl.py:76)
    rp, rm = (float(v) for v in ref_rows[-1].split())
    op, om = (float(v) for v in our_rows[-1].split())
    assert rp == op == k_true * 10230 + l2cm_phase, (ref_rows, our_rows)
    assert abs(rm - om) / rm < 0.05, (ref_rows, our_rows)


def test_acquire_glonass_matches_reference(tmp_path):
    """FDMA channel rows: our batched search vs the reference's
    channel loop (acquire-glonass-l1.py) on a 16.384 MHz capture."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("glonass-l1")
    fs = 16.384e6
    n = int(fs * 0.026)
    x = synth_iq(sig.code_table((0,))[0], sig.chip_rate, fs, n,
                 doppler_hz=1200.0 - 2 * 562500.0, code_phase=300.0,
                 cn0_dbhz=47.0, carrier_ratio=sig.track_carrier_ratio(-2),
                 code_doppler_hz=1200.0, rng=np.random.default_rng(9))
    path = os.path.join(tmp_path, "glo.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=18.0))
    args = ["--channel", "-2,0", "--doppler-search", "600,1800,200",
            "--time", "16", path, "%d" % fs, "0"]
    ref_rows = run_ref("acquire-glonass-l1.py", args)
    our_rows = run_ours("acquire-glonass-l1.py", args)
    assert len(ref_rows) == len(our_rows) == 2
    for rr, ro in zip(ref_rows, our_rows):
        rt, ot = rr.split(), ro.split()
        assert rt[1] == ot[1], (rr, ro)                     # chan
        assert float(rt[3]) == float(ot[3]), (rr, ro)       # doppler
        assert abs(float(rt[7]) - float(ot[7])) <= 0.26, (rr, ro)
        assert abs(float(rt[5]) - float(ot[5])) / float(rt[5]) < 0.05


def test_acquire_gps_l1cp_matches_reference(tmp_path):
    """10 ms coherent, BOC(1,1)-weighted reference, no-pad window 81920
    (acquire-gps-l1cp.py) — exercises the Weil codes + TMBOC synth."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1cp")
    fs = 8.192e6
    n = int(fs * 0.034)
    x = synth_iq(sig.code_table((18,))[0], sig.chip_rate, fs, n,
                 doppler_hz=-300.0, code_phase=512.0, cn0_dbhz=48.0,
                 carrier_ratio=1540.0, subcarrier="tmboc",
                 rng=np.random.default_rng(6))
    path = os.path.join(tmp_path, "l1cp.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=18.0))
    args = ["--prn", "18", "--doppler-search", "-340,-240,20",
            "--time", "20", path, "%d" % fs, "0"]
    ref_rows = run_ref("acquire-gps-l1cp.py", args)
    our_rows = run_ours("acquire-gps-l1cp.py", args)
    rt, ot = ref_rows[0].split(), our_rows[0].split()
    assert float(rt[3]) == float(ot[3]), (ref_rows, our_rows)
    assert abs(float(rt[7]) - float(ot[7])) <= 1.3, (ref_rows, our_rows)
    assert abs(float(rt[5]) - float(ot[5])) / float(rt[5]) < 0.05


def test_track_gps_l2cm_matches_reference(tmp_path):
    """RZ even-half-chip gating with 20 sub-blocks per 20 ms period
    (track-gps-l2cm.py)."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l2cm")
    fs, coffset = 4.096e6, -2000.0
    n = int(fs * 0.120)
    x = synth_iq(sig.code_table((29,))[0], sig.chip_rate, fs, n,
                 doppler_hz=1120.0, code_phase=4208.8, cn0_dbhz=52.0,
                 carrier_ratio=2400.0, subcarrier="rz_even",
                 rng=np.random.default_rng(8))
    x = x * np.exp(2j * np.pi * coffset / fs * np.arange(n))
    path = os.path.join(tmp_path, "l2cm.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=20.0))
    args = ["--loop-dwells", "40,30", path, "%d" % fs, "%d" % coffset,
            "29", "1120.0", "4208.80"]
    ref_rows = run_ref("track-gps-l2cm.py", args)
    our_rows = run_ours("track-gps-l2cm.py", ["--blocks", "100"] + args)
    nb = min(len(ref_rows), len(our_rows))
    assert nb >= 90, (len(ref_rows), len(our_rows))
    ref = np.array([[float(v) for v in r.split()] for r in ref_rows[:nb]])
    ours = np.array([[float(v) for v in r.split()] for r in our_rows[:nb]])
    assert abs(np.mean(ref[-25:, 3]) - np.mean(ours[-25:, 3])) < 3.0
    assert abs(np.mean(ref[-25:, 7]) / np.mean(ours[-25:, 7]) - 1) < 0.06


# ---------------------------------------------------------------------------
# Standalone utilities: cn0 / squaring subprocess
# diffs against the actual reference binaries; spectrum --text against an
# inline oracle of the reference math (the reference spectrum.py only ever
# renders into a matplotlib window — spectrum.py:49-57 — so its PSD values
# cannot be captured from a subprocess).

def _run_stdin(cmd, data, binary=False, env=None):
    out = subprocess.run(cmd, input=data, capture_output=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout if binary else out.stdout.decode()


def test_cn0_matches_reference():
    """cn0.py: identical '%.2f' lines from the same track rows
    (reference cn0.py:8-25, incl. its quirk of taking columns 1,2)."""
    rng = np.random.default_rng(3)
    nrows = 750   # 2 full 300 ms blocks + a discarded partial
    amp, sigma = 1200.0, 180.0
    rows = []
    for i in range(nrows):
        xi = amp * rng.choice([-1.0, 1.0]) + sigma * rng.standard_normal()
        xq = sigma * rng.standard_normal()
        rows.append("%d %f %f 0.0 0.0 0.0 1.0 2.0 1.0" % (i, xi, xq))
    data = ("\n".join(rows) + "\n").encode()

    env = dict(os.environ, PYTHONPATH=REF)
    ref = _run_stdin([sys.executable, os.path.join(REF, "cn0.py")],
                     data, env=env)
    ours = _run_stdin([sys.executable, os.path.join(REPO, "scripts", "cn0.py")],
                      data, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.strip() and ref.strip() == ours.strip(), (ref, ours)


def test_squaring_matches_reference(tmp_path):
    """squaring.py: identical int16 stream (reference squaring.py:22-42 —
    mix, boxcar-16, square, 100 sums, x20 round)."""
    rng = np.random.default_rng(4)
    nsamp = 2 * 1000 * 16 * 100          # two full output blocks
    x = 0.35 * (rng.standard_normal(nsamp) + 1j * rng.standard_normal(nsamp))
    x += 0.25 * np.exp(2j * np.pi * 0.013 * np.arange(nsamp))
    from gnss_dsp.utils.synth import to_int8_iq
    p = os.path.join(tmp_path, "squaring.iq")
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=40.0))

    args = [p, "4096000", "17000"]
    env = dict(os.environ, PYTHONPATH=REF)
    # numpy tofile(sys.stdout) needs a seekable stream — give the
    # reference a real file, not a pipe
    refout = os.path.join(tmp_path, "ref.out")
    with open(refout, "wb") as fh:
        done = subprocess.run(
            [sys.executable, os.path.join(REF, "squaring.py")] + args,
            stdout=fh, stderr=subprocess.PIPE, timeout=600, env=env)
    assert done.returncode == 0, done.stderr[-2000:]
    with open(refout, "rb") as fh:
        ref = fh.read()
    ours = _run_stdin(
        [sys.executable, os.path.join(REPO, "scripts", "squaring.py")] + args,
        b"", binary=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    r = np.frombuffer(ref, np.int16)
    o = np.frombuffer(ours, np.int16)
    assert r.shape == o.shape and len(r) == 2 * 2000
    # f32 accumulation vs the reference's float64 can flip the final
    # round-to-int16 by one count on a handful of bins
    d = np.abs(r.astype(np.int32) - o.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() > 0.9, (d.max(), (d == 0).mean())


def test_spectrum_text_matches_reference_math(tmp_path):
    """spectrum --text vs the reference PSD pipeline (spectrum.py:49-57:
    Hann window, |fft|^2/ns average, 10log10, fftshift; axis :18)."""
    rng = np.random.default_rng(5)
    n, ns, fc, fs = 512, 6, 1575.42e6, 4.096e6
    x = 0.5 * (rng.standard_normal(n * ns) + 1j * rng.standard_normal(n * ns))
    x += 0.3 * np.exp(2j * np.pi * 0.07 * np.arange(n * ns))
    from gnss_dsp.utils.synth import to_int8_iq
    p = os.path.join(tmp_path, "spec.iq")
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=50.0))

    out = run_ours("spectrum.py", ["--text", p, "%f" % fc, "%f" % fs,
                                   str(n), str(ns)])
    got = np.array([[float(v) for v in r.split()] for r in out])
    assert got.shape == (n, 2)

    # oracle: the reference's exact math on the same int8 stream
    xi = np.fromfile(p, np.int8).astype(np.float64)
    xq = (xi[0::2] + 1j * xi[1::2])[: n * ns]
    w = np.hanning(n)
    psd = np.zeros(n)
    for k in range(ns):
        z = np.fft.fft(xq[k * n:(k + 1) * n] * w)
        psd += np.real(z * np.conj(z)) / ns
    want = 10 * np.log10(np.fft.fftshift(psd))
    freqs = fc + fs * ((np.arange(n) - n / 2.0) / n)   # spectrum.py:18
    np.testing.assert_allclose(got[:, 0], freqs, atol=0.05)
    np.testing.assert_allclose(got[:, 1], want, atol=5e-3)
