"""Mesh twins vs single-device engines on the 8-virtual-device CPU mesh
(sharded FDMA + serial search)."""

from __future__ import annotations

import numpy as np

from gnss_dsp.models import get_signal
from gnss_dsp.utils.synth import synth_iq


def make_iq(sig, prn, fs, ms, doppler, code_phase, cn0=None, chan=0):
    code = sig.code_table((prn,))[0]
    n = int(fs * ms / 1000.0)
    return synth_iq(
        code, sig.chip_rate, fs, n, doppler_hz=doppler + sig.fdma_hz * chan,
        code_phase=code_phase, cn0_dbhz=cn0,
        carrier_ratio=sig.track_carrier_ratio(chan),
        code_doppler_hz=doppler,
    )


def test_fdma_sharded_matches_single():
    """All 15 GLONASS L1 channels: channel-sharded mesh program equals the
    single-device all-channel grid program."""
    from gnss_dsp.acquire.engine import acquire_signal_fdma
    from gnss_dsp.parallel.acquire import acquire_signal_fdma_sharded
    from gnss_dsp.parallel.mesh import make_mesh

    import dataclasses
    sig = dataclasses.replace(get_signal("glonass-l1"), acq_fs=2.048e6)
    chans = list(range(-7, 8))
    ms = 8
    x = make_iq(sig, 0, sig.acq_fs, ms + 4, 1500.0, 100.0, chan=-3,
                cn0=45.0)
    kw = dict(doppler_search=(500.0, 2500.0, 250.0), ms=ms)
    single = acquire_signal_fdma(sig, x, chans, **kw)
    mesh = make_mesh(8)
    sharded = acquire_signal_fdma_sharded(sig, x, chans, mesh, **kw)
    assert len(single) == len(sharded) == 15
    for a, b in zip(single, sharded):
        assert a.prn == b.prn
        assert a.doppler == b.doppler, (a, b)
        assert a.code_offset == b.code_offset, (a, b)
        np.testing.assert_allclose(a.metric, b.metric, rtol=1e-5)
    # the planted channel wins
    best = max(sharded, key=lambda r: r.metric)
    assert best.prn == -3 and abs(best.doppler - 1500.0) <= 250.0


def test_serial_sharded_matches_single():
    """L2CL 75-hypothesis assisted search, hypotheses sharded over all 8
    devices: same winner and per-hypothesis metric as single-device."""
    from gnss_dsp.acquire.serial import serial_search
    from gnss_dsp.parallel.acquire import serial_search_sharded
    from gnss_dsp.parallel.mesh import make_mesh

    sig = get_signal("gps-l2cl")
    fs = 2.048e6
    k_true = 31
    phase = float((k_true * 10230 + 1234.0) % sig.code_length)
    x = make_iq(sig, 5, fs, 44, 250.0, phase)
    single = serial_search(sig, x, 5, 250.0, parent_code_phase=1234.0,
                           fs=fs, ms=40)
    mesh = make_mesh(8)
    sharded = serial_search_sharded(sig, x, 5, 250.0,
                                    parent_code_phase=1234.0, fs=fs,
                                    mesh=mesh, ms=40, k_chunk=5)
    assert sharded.k == single.k == k_true
    assert sharded.code_offset == single.code_offset
    np.testing.assert_allclose(sharded.metric, single.metric, rtol=1e-5)


def test_serial_sharded_glonass_p():
    """GLONASS P 1000 hypotheses sharded; exact-k recovery."""
    from gnss_dsp.parallel.acquire import serial_search_sharded
    from gnss_dsp.parallel.mesh import make_mesh

    sig = get_signal("glonass-l1-p")
    fs = 4.096e6
    k_true = 417
    ca_phase = 33.0
    phase = float((k_true * 5110 + 10 * ca_phase) % sig.code_length)
    x = make_iq(sig, 0, fs, 16, -700.0, phase, chan=2)
    r = serial_search_sharded(sig, x, 0, -700.0, parent_code_phase=ca_phase,
                              fs=fs, mesh=make_mesh(8), ms=12, chan=2)
    assert r.k == k_true, (r.k, k_true)
    assert abs(r.code_offset - phase) < 1e-6


def test_tracking_sharded_matches_single():
    """Channel-sharded tracking (parallel/track.track_scan_sharded) is
    VALUE-equal to the single-device scan — every row and every state
    leaf, not just shapes.  GLONASS-style per-channel
    ratios and FDMA coffset increments included so a replicated-vs-
    sharded mixup in either would be caught."""
    import jax.numpy as jnp

    from gnss_dsp.parallel.mesh import make_mesh
    from gnss_dsp.parallel.track import track_scan_sharded
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan

    sig = get_signal("gps-l1")
    fs = 2.048e6
    C = 8
    prns = list(range(1, C + 1))
    dops = np.linspace(-3000.0, 3000.0, C)
    phases = np.linspace(10.0, 950.0, C)
    n = int(fs * 0.05)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, cp in zip(prns[:3], dops[:3], phases[:3]))
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    params = make_params(sig, fs, coffset=1000.0, loop_dwells=(10, 10))
    tab = jnp.asarray(sig.code_table(tuple(prns)).astype(np.int8))
    ratios = jnp.asarray(np.linspace(1200.0, 1600.0, C).astype(np.float32))
    cdf = jnp.asarray((np.arange(C) * 1000 - 250000).astype(np.int32))

    def fresh():
        return init_state(code_p=phases, code_f_off=np.zeros(C),
                          carrier_p=np.zeros(C), carrier_f=dops)

    st_a, rf_a, ri_a = track_scan(xd, jnp.int32(n), tab, fresh(), params,
                                  40, ratios=ratios, coffset_df=cdf)
    mesh = make_mesh(8, time_shards=1)
    st_b, rf_b, ri_b = track_scan_sharded(
        mesh, xd, jnp.int32(n), tab, fresh(), params, 40, ratios=ratios,
        coffset_df=cdf)
    np.testing.assert_array_equal(np.asarray(rf_a), np.asarray(rf_b))
    np.testing.assert_array_equal(np.asarray(ri_a), np.asarray(ri_b))
    for name in st_a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(st_a, name)), np.asarray(getattr(st_b, name)),
            err_msg=name)
    # multihost placement path on the same (single-process) mesh: the
    # make_array_from_process_local_data + allgather route is exercised
    # without a second process (the 2-proc run lives in test_multihost)
    st_c, rf_c, ri_c = track_scan_sharded(
        mesh, xd, jnp.int32(n), tab, fresh(), params, 40, ratios=ratios,
        coffset_df=cdf, multihost=True)
    np.testing.assert_array_equal(np.asarray(rf_a), np.asarray(rf_c))
    np.testing.assert_array_equal(np.asarray(ri_a), np.asarray(ri_c))


def test_tracking_sharded_coherent_matches_single():
    """Extended-coherent tracking under the mesh: per-channel overlays,
    sigp lanes (coherent span M, overlay period) and carrier-offset
    increments shard with the channels through shard_map — rows and
    state bit-equal to the single-device coherent scan."""
    import jax.numpy as jnp

    from gnss_dsp.parallel.mesh import make_mesh
    from gnss_dsp.parallel.track import track_scan_sharded
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import (
        SIGP_COH, SIGP_NOV, init_state, sigp_from_params, track_scan)

    sig = get_signal("gps-l1")
    fs = 2.048e6
    C = 8
    M = 4
    prns = list(range(1, C + 1))
    dops = np.linspace(-3000.0, 3000.0, C)
    phases = np.linspace(10.0, 950.0, C)
    n = int(fs * 0.05)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=cp,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, cp in zip(prns[:3], dops[:3], phases[:3]))
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    params = make_params(sig, fs, coffset=1000.0, loop_dwells=(10, 10),
                         coherent_blocks=M)
    rng = np.random.default_rng(5)
    ovl = rng.choice([-1.0, 1.0], (C, 8)).astype(np.float32)
    sigp = np.array(sigp_from_params(params, C))
    # channels alternate coherent spans (M, 1) and overlay periods (8, 4)
    sigp[:, SIGP_COH] = np.where(np.arange(C) % 2 == 0, M, 1)
    sigp[:, SIGP_NOV] = np.where(np.arange(C) % 4 < 2, 8, 4)
    sigp = jnp.asarray(sigp)
    tab = jnp.asarray(sig.code_table(tuple(prns)).astype(np.int8))
    ratios = jnp.full((C,), 1540.0, jnp.float32)
    cdf = jnp.asarray((np.arange(C) * 1000 - 250000).astype(np.int32))

    def fresh():
        return init_state(code_p=phases, code_f_off=np.zeros(C),
                          carrier_p=np.zeros(C), carrier_f=dops)

    kw = dict(ratios=ratios, coffset_df=cdf, sigp=sigp,
              overlay=jnp.asarray(ovl))
    st_a, rf_a, ri_a = track_scan(xd, jnp.int32(n), tab, fresh(), params,
                                  30, **kw)
    assert float(np.abs(np.asarray(st_a.cacc)).max()) > 0.0
    mesh = make_mesh(8, time_shards=1)
    st_b, rf_b, ri_b = track_scan_sharded(
        mesh, xd, jnp.int32(n), tab, fresh(), params, 30, **kw)
    np.testing.assert_array_equal(np.asarray(rf_a), np.asarray(rf_b))
    np.testing.assert_array_equal(np.asarray(ri_a), np.asarray(ri_b))
    for name in st_a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(st_a, name)),
            np.asarray(getattr(st_b, name)), err_msg=name)
