"""Checkpoint/resume exactness, sharding determinism, and unknown-code
recovery (the aux subsystems SURVEY.md §5 says the framework must add)."""

from __future__ import annotations

import io as _io
import os

import numpy as np
import jax.numpy as jnp

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import TrackChannel, make_params, track_file
from gnss_dsp.track.engine import init_state, track_scan
from gnss_dsp.track import checkpoint
from gnss_dsp.utils.synth import synth_iq, to_int8_iq


def _setup(chans=2, ms=300, fs=2.048e6):
    sig = get_signal("gps-l1")
    params = make_params(sig, fs, coffset=1000.0, loop_dwells=(50, 50))
    x = sum(
        synth_iq(sig.code_table((p,))[0], sig.chip_rate, fs, int(fs * ms / 1000),
                 doppler_hz=500.0 * p, code_phase=100.0 * p, cn0_dbhz=None,
                 carrier_ratio=1540.0)
        for p in range(1, chans + 1)
    )
    x_dev = (jnp.asarray(x.real), jnp.asarray(x.imag))
    state = init_state(
        code_p=np.array([100.0 * (p + 1) for p in range(chans)]),
        code_f_off=np.zeros(chans),
        carrier_p=np.zeros(chans),
        carrier_f=np.array([500.0 * (p + 1) for p in range(chans)]),
    )
    code_tab = jnp.asarray(
        sig.code_table(tuple(range(1, chans + 1))).astype(np.int8))
    return params, x_dev, jnp.int32(len(x)), code_tab, state


def test_checkpoint_resume_bitexact(tmp_path):
    params, x, n, tab, st0 = _setup()

    st_a, rf_a, ri_a = track_scan(x, n, tab, st0, params, 100)

    st_1, rf_1, ri_1 = track_scan(x, n, tab, st0, params, 40)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, st_1, meta={"blocks": 40})
    st_loaded, host, meta = checkpoint.load(path)
    assert meta["blocks"] == 40
    st_2, rf_2, ri_2 = track_scan(x, n, tab, st_loaded, params, 60)

    np.testing.assert_array_equal(np.asarray(rf_a[:40]), np.asarray(rf_1))
    np.testing.assert_array_equal(np.asarray(rf_a[40:]), np.asarray(rf_2))
    np.testing.assert_array_equal(np.asarray(ri_a[40:]), np.asarray(ri_2))
    for f in st_a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(st_a, f)), np.asarray(getattr(st_2, f)), f)


def test_acquisition_sharding_determinism():
    """Same grid, 1-device jit vs 8-device mesh: identical results
    (the determinism tier standing in for race detection, SURVEY §5)."""
    import jax
    from gnss_dsp.acquire.engine import acquire_signal
    from gnss_dsp.parallel.acquire import acquire_signal_sharded
    from gnss_dsp.parallel.mesh import make_mesh

    sig = get_signal("gps-l1")
    import dataclasses
    sig = dataclasses.replace(sig, acq_fs=1.024e6)
    prns = list(range(1, 9))
    ms = 8
    n = int(sig.acq_fs * 1e-3)
    rng = np.random.default_rng(3)
    x = synth_iq(sig.code_table((3,))[0], sig.chip_rate, sig.acq_fs,
                 (ms + 1) * n, doppler_hz=900.0, code_phase=77.0,
                 cn0_dbhz=43.0, rng=rng, carrier_ratio=1540.0)
    kw = dict(doppler_search=(-2000.0, 2000.0, 250.0), ms=ms, dop_chunk=8)
    single = acquire_signal(sig, x, prns, **kw)
    mesh = make_mesh(8)
    sharded = acquire_signal_sharded(sig, x, prns, mesh, **kw)
    for a, b in zip(single, sharded):
        assert a.prn == b.prn
        assert a.doppler == b.doppler
        assert a.code_offset == b.code_offset
        np.testing.assert_allclose(a.metric, b.metric, rtol=1e-5)


def test_code_recovery():
    """Recover an 'unknown' B2b code from synthetic samples the way the
    reference captured the real ones (track-beidou-b2bi.py:46-53)."""
    from gnss_dsp.track.recover import CodeRecovery
    from gnss_dsp.ops import nco as nco_ops

    sig = get_signal("beidou-b2bi")
    prn = 25
    code = sig.code_table((prn,))[0]
    fs = 30.69e6
    n_ms = int(fs // 1000)
    rng = np.random.default_rng(5)
    rec = CodeRecovery(sig.code_length, warmup_blocks=2)
    cf = sig.chip_rate / fs
    for blk in range(40):
        bit = rng.choice([-1.0, 1.0])  # unknown data bits
        x = bit * synth_iq(code, sig.chip_rate, fs, n_ms, doppler_hz=0.0,
                           code_phase=0.0, cn0_dbhz=None)
        xs = (jnp.asarray(x.real), jnp.asarray(x.imag))
        p_re = float(np.sum(x.real * code[
            (np.arange(n_ms) * sig.chip_rate / fs).astype(np.int64)
            % sig.code_length]))
        rec.update(xs, code_p=0.0, cf=cf, p_prompt_re=p_re)
    got = rec.chips()
    assert np.array_equal(got, code), (got[:20], code[:20])
    assert rec.confidence() > 1.0


def test_cli_kill_resume_bitexact(tmp_path):
    """Fault injection through the REAL CLI: SIGKILL the tracker mid-run,
    resume from its --checkpoint file, and the combined output equals an
    uninterrupted run row-for-row (failure/elastic flow, SURVEY §5)."""
    import signal
    import subprocess
    import sys
    import time

    sig = get_signal("gps-l1")
    fs = 2.048e6
    prn, dop, cp0 = 21, 1200.0, 300.0
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs,
                 int(fs * 0.4), doppler_hz=dop, code_phase=cp0,
                 cn0_dbhz=None, carrier_ratio=1540.0)
    path = os.path.join(tmp_path, "kill.iq")
    with open(path, "wb") as f:
        f.write(to_int8_iq(x, scale=24.0))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "scripts", "track-gps-l1.py")
    ck = os.path.join(tmp_path, "ck.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    base = [sys.executable, "-u", script, "--loop-dwells", "50,50",
            "--chunk-ms", "100", path, "%d" % fs, "0",
            str(prn), str(dop), str(cp0)]

    # uninterrupted reference run
    a = subprocess.run(base, capture_output=True, text=True, timeout=300,
                       env=env)
    assert a.returncode == 0, a.stderr[-2000:]
    rows_a = a.stdout.strip().splitlines()
    assert len(rows_a) > 300

    # run with checkpoints, SIGKILL once a checkpoint exists mid-stream
    p = subprocess.Popen(base[:3] + ["--checkpoint", ck] + base[3:],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
    t0 = time.time()
    while time.time() - t0 < 290:
        if os.path.exists(ck) and os.path.getsize(ck) > 0:
            break
        if p.poll() is not None:
            break
        time.sleep(0.05)
    killed = p.poll() is None
    if killed:
        os.kill(p.pid, signal.SIGKILL)   # exact PID we spawned
    out_b, _ = p.communicate(timeout=60)
    rows_b = out_b.strip().splitlines()
    if rows_b and len(rows_b[-1].split()) != 14:
        rows_b = rows_b[:-1]             # partial line cut by the kill
    assert os.path.exists(ck)

    # resume from the checkpoint
    c = subprocess.run(base[:3] + ["--resume", ck] + base[3:],
                       capture_output=True, text=True, timeout=300, env=env)
    assert c.returncode == 0, c.stderr[-2000:]
    rows_c = c.stdout.strip().splitlines()
    assert rows_c, "resume emitted nothing"
    resume_block = int(rows_c[0].split()[0])
    combined = [r for r in rows_b if int(r.split()[0]) < resume_block]
    combined += rows_c
    assert combined == rows_a, (
        killed, resume_block, len(rows_b), len(rows_c), len(rows_a))


def test_mesh_checkpoint_resume_bitexact(tmp_path):
    """--mesh composes with --checkpoint/--resume: the sharded run's
    per-chunk checkpoints resume bit-exactly (rows keyed by block — a
    max_blocks break leaves the final chunk un-checkpointed, so the
    resumed run legitimately replays the tail with identical values)."""
    import io

    from gnss_dsp.parallel.mesh import make_mesh
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils.synth import to_int8_iq

    sig = get_signal("gps-l1")
    fs = 2.048e6
    x = synth_iq(sig.code_table((7,))[0], sig.chip_rate, fs,
                 int(fs * 0.1), doppler_hz=900.0, code_phase=5.0,
                 cn0_dbhz=None, carrier_ratio=1540.0)
    raw = to_int8_iq(x, scale=40.0)
    ck = os.path.join(tmp_path, "mesh.npz")

    def run(**kw):
        ch = [TrackChannel(prn=7, doppler=900.0, code_offset=5.0)]
        track_file(sig, io.BytesIO(raw), fs, 0.0, ch,
                   loop_dwells=(8, 8), **kw)
        return ch[0]

    mesh = make_mesh(8, time_shards=1)
    c1 = run(max_blocks=90, mesh=mesh)
    c2 = run(max_blocks=40, mesh=mesh, checkpoint_path=ck, chunk_ms=30.0)
    c3 = run(max_blocks=90, mesh=mesh, checkpoint_path=ck,
             resume_from=ck, chunk_ms=30.0)
    key = lambda r: (r["carrier_f"], r["code_p"], r["p_re"], r["p_im"])
    full = {r["block"]: key(r) for r in c1.rows}
    res = {r["block"]: key(r) for r in c2.rows}
    res.update({r["block"]: key(r) for r in c3.rows})
    ks = sorted(set(full) & set(res))
    assert len(ks) >= 80, len(ks)
    for k in ks:
        assert full[k] == res[k], (k, full[k], res[k])
