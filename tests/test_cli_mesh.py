"""--mesh N on the acquire/track CLIs: the same
front doors users run route to the parallel/ sharded engines and
reproduce the single-device rows bit-for-bit on a virtual 8-device CPU
mesh (the engine-level value-equality lives in test_parallel.py; this
exercises the CLI wiring end to end, subprocess and all)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, args, mesh: int | None):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    extra = ["--mesh", str(mesh)] if mesh else []
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script)]
        + extra + args,
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _mkfile(tmp_path, prns_dops_cps, fname):
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1")
    fs = 4.096e6
    n = int(fs * 0.062)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in prns_dops_cps:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      carrier_ratio=1540.0)
    p = os.path.join(tmp_path, fname)
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=20.0))
    return p, fs


def test_acquire_cli_mesh_matches_single(tmp_path):
    path, fs = _mkfile(tmp_path, [(5, 1200.0, 300.25), (9, -800.0, 700.0)],
                       "acq.iq")
    args = ["--prn", "5,9,17", "--doppler-search", "-1400,1400,200",
            "--time", "30", path, "%d" % fs, "0"]
    single = _run("acquire-gps-l1.py", args, mesh=None)
    sharded = _run("acquire-gps-l1.py", args, mesh=8)
    assert single == sharded and len(single.splitlines()) == 3


def test_track_cli_mesh_matches_single(tmp_path):
    """Same 8 channels with and without --mesh 8 (equal channel count:
    XLA's f32 reduction order varies with the batch dimension, so a
    1-vs-8-channel comparison is only close, not bit-equal — the padded
    single-channel path is exercised separately below)."""
    path, fs = _mkfile(tmp_path, [(21, 900.0, 512.5), (5, -400.0, 100.0)],
                       "trk.iq")
    chans = ",".join(f"{p}:{d}:{c}" for p, d, c in
                     [(21, 900.0, 512.5), (5, -400.0, 100.0)] * 4)
    args = ["--loop-dwells", "10,10", "--blocks", "30",
            path, "%d" % fs, "0", chans]
    single = _run("track-gps-l1.py", args, mesh=None)
    sharded = _run("track-gps-l1.py", args, mesh=8)
    assert len(single.splitlines()) == len(sharded.splitlines()) == 30 * 8
    # float-wise: an unpartitioned vs partitioned XLA program may differ
    # by an ULP in reduction order (the bit-exact guarantee for the SAME
    # program sharded/unsharded lives in test_parallel.py); channel tags
    # and integer columns must be identical
    for ls, lm in zip(single.splitlines(), sharded.splitlines()):
        ts, tm = ls.split(), lm.split()
        assert ts[0] == tm[0]                       # chNN tag
        a = np.array([float(v) for v in ts[1:]])
        b = np.array([float(v) for v in tm[1:]])
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=5e-4)
        np.testing.assert_array_equal(a[[0, 9, 11, 13]], b[[0, 9, 11, 13]])

    # padded route: 1 channel on an 8-device mesh emits exactly its own
    # 30 rows (the 7 clone channels are computed but suppressed) and
    # stays locked on the planted signal (trajectory equality vs a
    # different channel batch is not expected — f32 loop recurrences
    # amplify ULP-level batch-layout differences)
    args1 = ["--loop-dwells", "10,10", "--blocks", "30",
             path, "%d" % fs, "0", "21", "900.0", "512.5"]
    padded = _run("track-gps-l1.py", args1, mesh=8)
    t = np.array([[float(v) for v in r.split()] for r in
                  padded.splitlines()])
    assert t.shape == (30, 14)
    assert abs(np.mean(t[-8:, 3]) - 900.0) < 6.0          # carrier pull-in
    assert np.mean(t[-8:, 7]) > np.mean(np.maximum(t[-8:, 6], t[-8:, 8]))
