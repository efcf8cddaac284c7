"""Multi-controller (DCN) story: the sharded grid
search run as TWO separate jax.distributed processes (4 virtual CPU
devices each) must match the single-process engine exactly."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_grid_search(tmp_path):
    import dataclasses

    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq
    from gnss_dsp.acquire.engine import acquire_signal

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=1.024e6)
    prns = list(range(1, 9))
    ms, dop_search, dop_chunk = 8, (-2000.0, 2000.0, 250.0), 8
    n = int(sig.acq_fs * 1e-3)
    x = synth_iq(sig.code_table((3,))[0], sig.chip_rate, sig.acq_fs,
                 (ms + 1) * n, doppler_hz=900.0, code_phase=77.0,
                 cn0_dbhz=43.0, rng=np.random.default_rng(3),
                 carrier_ratio=1540.0)
    single = acquire_signal(sig, x, prns, doppler_search=dop_search, ms=ms)

    in_npz = os.path.join(tmp_path, "in.npz")
    out_npz = os.path.join(tmp_path, "out.npz")
    np.savez(in_npz, sig="gps-l1", acq_fs=sig.acq_fs, x=x, prns=prns,
             dop_search=dop_search, ms=ms, dop_chunk=dop_chunk)

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)   # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "multihost_worker.py"),
             str(pid), "2", str(port), in_npz, out_npz],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        logs.append(out)
        assert p.returncode == 0, out[-2000:]
    got = np.load(out_npz)

    for i, r in enumerate(single):
        assert int(got["prn"][i]) == r.prn
        assert float(got["doppler"][i]) == r.doppler, (i, logs[0][-500:])
        assert float(got["code_offset"][i]) == r.code_offset
        np.testing.assert_allclose(float(got["metric"][i]), r.metric,
                                   rtol=1e-5)


def test_two_process_tracking(tmp_path):
    """Channel-sharded TRACKING as two jax.distributed processes (4
    virtual CPU devices each, 8 channels over the global sat axis) is
    VALUE-equal to the single-process scan."""
    import jax.numpy as jnp

    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    fs = 2.048e6
    C, nb, coffset = 8, 40, 1000.0
    prns = list(range(1, C + 1))
    dops = np.linspace(-3000.0, 3000.0, C)
    phases = np.linspace(10.0, 950.0, C)
    n = int(fs * 0.05)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, cp in zip(prns[:3], dops[:3], phases[:3]))
    tab = sig.code_table(tuple(prns)).astype(np.int8)
    ratios = np.linspace(1200.0, 1600.0, C).astype(np.float32)
    cdf = (np.arange(C) * 1000 - 250000).astype(np.int32)

    params = make_params(sig, fs, coffset=coffset, loop_dwells=(10, 10))
    st = init_state(code_p=phases, code_f_off=np.zeros(C),
                    carrier_p=np.zeros(C), carrier_f=dops)
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    st_a, rf_a, ri_a = track_scan(xd, jnp.int32(n), jnp.asarray(tab), st,
                                  params, nb, ratios=jnp.asarray(ratios),
                                  coffset_df=jnp.asarray(cdf))

    in_npz = os.path.join(tmp_path, "in.npz")
    out_npz = os.path.join(tmp_path, "out.npz")
    np.savez(in_npz, task="track", sig="gps-l1", fs=fs, x=x, prns=prns,
             phases=phases, dops=dops, tab=tab, ratios=ratios, cdf=cdf,
             coffset=coffset, n_blocks=nb)

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(REPO, "tools", "multihost_worker.py"),
             str(pid), "2", str(port), in_npz, out_npz],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=420)
        assert p.returncode == 0, out[-2000:]
    got = np.load(out_npz)
    np.testing.assert_array_equal(np.asarray(rf_a), got["rf"])
    np.testing.assert_array_equal(np.asarray(ri_a), got["ri"])
    np.testing.assert_array_equal(np.asarray(st_a.carrier_f),
                                  got["carrier_f"])
    np.testing.assert_array_equal(np.asarray(st_a.code_p_hi),
                                  got["code_p_hi"])
