"""Tracking engine: synthetic-signal convergence tests."""

import io

import numpy as np

from gnss_dsp.models import get_signal
from gnss_dsp.models.codes import gps_ca
from gnss_dsp.track import TrackChannel, track_file
from gnss_dsp.utils import synth


def _make_stream(prn, fs, seconds, doppler, code_phase, cn0=47.0, seed=11):
    x = synth.synth_iq(
        gps_ca.ca_code(prn).astype(np.float64), 1023000.0, fs,
        int(fs * seconds), doppler_hz=doppler, code_phase=code_phase,
        cn0_dbhz=cn0, rng=np.random.default_rng(seed), amplitude=8.0,
        carrier_ratio=1540.0,
    )
    return io.BytesIO(synth.to_int8_iq(x, scale=1.0))


def test_gps_l1_tracking_converges():
    sig = get_signal("gps-l1")
    fs = 4.096e6
    prn, doppler, code_phase = 21, 1200.0, 300.0
    fp = _make_stream(prn, fs, 1.0, doppler, code_phase)

    ch = TrackChannel(prn=prn, doppler=doppler + 40.0, code_offset=code_phase)
    track_file(sig, fp, fs, coffset=0.0, channels=[ch],
               loop_dwells=(100, 100), chunk_ms=500.0)

    rows = ch.rows
    assert len(rows) > 900
    tail = rows[-200:]
    cf = np.array([r["carrier_f"] for r in tail])
    # FLL+PLL pulls the carrier estimate to the true doppler
    assert abs(np.median(cf) - doppler) < 5.0
    # code frequency stays near nominal
    code_f_off = np.array([r["code_f_offset"] for r in tail])
    assert np.all(np.abs(code_f_off) < 50.0)
    # prompt sits on the correlation peak: at 0.05-chip spacing the
    # triangle autocorrelation gives E ~= L ~= 0.95 P, and the DLL nulls
    # the early/late imbalance
    pr = np.median([r["prompt"] for r in tail])
    el = np.median([max(r["early"], r["late"]) for r in tail])
    assert pr > 1.01 * el
    eml = np.median([(r["late"] - r["early"]) / (r["late"] + r["early"])
                     for r in tail])
    assert abs(eml) < 0.05
    # PLL locks: prompt power concentrates in I
    p_re = np.median(np.abs([r["p_re"] for r in tail]))
    p_im = np.median(np.abs([r["p_im"] for r in tail]))
    assert p_re > 3.0 * p_im
    # bookkeeping: samples consumed per block stay near one code period
    ns = np.diff([r["samp"] for r in tail])
    assert np.all((ns > fs * 0.0004) & (ns <= fs * 0.0016))


def test_two_channel_batched_tracking():
    """Two PRNs in one stream, tracked in one batched engine call."""
    sig = get_signal("gps-l1")
    fs = 4.096e6
    n = int(fs * 0.5)
    rng = np.random.default_rng(5)
    x = (
        synth.synth_iq(gps_ca.ca_code(3).astype(np.float64), 1023000.0, fs, n,
                       doppler_hz=800.0, code_phase=100.0, cn0_dbhz=None,
                       amplitude=8.0, carrier_ratio=1540.0)
        + synth.synth_iq(gps_ca.ca_code(17).astype(np.float64), 1023000.0, fs, n,
                         doppler_hz=-2500.0, code_phase=700.0, cn0_dbhz=47.0,
                         rng=rng, amplitude=8.0, carrier_ratio=1540.0)
    )
    fp = io.BytesIO(synth.to_int8_iq(x, scale=1.0))
    chans = [
        TrackChannel(prn=3, doppler=800.0, code_offset=100.0),
        TrackChannel(prn=17, doppler=-2500.0, code_offset=700.0),
    ]
    track_file(sig, fp, fs, 0.0, chans, loop_dwells=(50, 50), chunk_ms=250.0)
    for ch, dop in zip(chans, (800.0, -2500.0)):
        tail = ch.rows[-100:]
        assert len(ch.rows) > 400
        cf = np.median([r["carrier_f"] for r in tail])
        assert abs(cf - dop) < 5.0


# ---------------------------------------------------------------------------
# Loop-filter / engine unit coverage

def test_mode_schedule_edges():
    """FLL_WIDE -> FLL_NARROW -> PLL at exactly the dwell boundaries
    (track-gps-l1.py:155-158)."""
    import jax.numpy as jnp
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import _mode_of

    sig = get_signal("gps-l1")
    p = make_params(sig, 4.096e6, coffset=0.0, loop_dwells=(500, 300))
    for blk, want in ((0, 0), (499, 0), (500, 1), (799, 1), (800, 2),
                      (10_000, 2)):
        assert int(_mode_of(jnp.int32(blk), p)) == want, (blk, want)
    # --carrier-phase / Xona: straight to PLL from block 0
    p0 = make_params(sig, 4.096e6, coffset=0.0, pll_from_start=True)
    assert int(_mode_of(jnp.int32(0), p0)) == 2


def test_dll_zero_denominator_no_nan():
    """All-zero samples (E = P = L = 0) must not NaN the DLL
    (the reference would divide 0/0 at track-gps-l1.py:80)."""
    import jax.numpy as jnp
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan

    sig = get_signal("gps-l1")
    fs = 2.048e6
    params = make_params(sig, fs, coffset=0.0)
    n = int(fs * 0.05)
    x = (jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
    st = init_state(code_p=[0.0], code_f_off=[0.0], carrier_p=[0.0],
                    carrier_f=[1000.0])
    tab = jnp.asarray(sig.code_table((1,)).astype(np.int8))
    st2, rf, ri = track_scan(x, jnp.int32(n), tab, st, params, 20)
    assert np.isfinite(np.asarray(rf)).all()
    assert np.isfinite(np.asarray(st2.code_f_off)).all()


def test_stall_refill_matches_uninterrupted():
    """A channel that exhausts the chunk mid-scan freezes (stalled, no
    rows) and, after the host refills, produces bit-identical rows to an
    uninterrupted scan — the EOF/stall boundary the reference handles by
    blocking reads (track-gps-l1.py:165-167)."""
    import jax.numpy as jnp
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan

    sig = get_signal("gps-l1")
    fs = 2.048e6
    params = make_params(sig, fs, coffset=0.0, loop_dwells=(10, 10))
    x = synth.synth_iq(gps_ca.ca_code(7).astype(np.float64), sig.chip_rate,
                       fs, int(fs * 0.08), doppler_hz=900.0, code_phase=5.0,
                       cn0_dbhz=None, carrier_ratio=1540.0)
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))

    def fresh():
        return init_state(code_p=[5.0], code_f_off=[0.0], carrier_p=[0.0],
                          carrier_f=[900.0])

    tab = jnp.asarray(sig.code_table((7,)).astype(np.int8))
    # uninterrupted: 60 blocks over the whole chunk
    _, rf_a, ri_a = track_scan(xd, jnp.int32(len(x)), tab, fresh(),
                               params, 60)
    # interrupted: claim only 25 ms available -> ~24 blocks then stall
    st, rf_1, ri_1 = track_scan(xd, jnp.int32(int(fs * 0.025)), tab,
                                fresh(), params, 60)
    n1 = int((np.asarray(ri_1)[:, 0, 0] > 0).sum())
    assert 20 <= n1 < 30, n1
    assert bool(np.asarray(st.stalled)[0])
    # refill: full chunk visible again, scan the remaining blocks
    st = st._replace(stalled=jnp.zeros_like(st.stalled))
    _, rf_2, ri_2 = track_scan(xd, jnp.int32(len(x)), tab, st, params,
                               60 - n1)
    np.testing.assert_array_equal(np.asarray(rf_a[:n1]),
                                  np.asarray(rf_1[:n1]))
    np.testing.assert_array_equal(np.asarray(rf_a[n1:]), np.asarray(rf_2))
    np.testing.assert_array_equal(np.asarray(ri_a[n1:]), np.asarray(ri_2))


def test_checkpoint_mid_subblock_resume():
    """Checkpoint taken MID code period of a sub-divided signal (E1B,
    4 sub-blocks): resume is bit-exact including n_full/sub_j carry."""
    import jax.numpy as jnp
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan
    from gnss_dsp.track import checkpoint

    sig = get_signal("galileo-e1b")
    assert sig.sub_blocks == 4
    fs = 4.096e6
    params = make_params(sig, fs, coffset=0.0, loop_dwells=(20, 20))
    x = synth.synth_iq(sig.code_table((24,))[0].astype(np.float64),
                       sig.chip_rate, fs, int(fs * 0.30), doppler_hz=400.0,
                       code_phase=50.0, cn0_dbhz=None, subcarrier="cboc",
                       carrier_ratio=1540.0)
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    tab = jnp.asarray(sig.code_table((24,)).astype(np.int8))

    def fresh():
        return init_state(code_p=[50.0], code_f_off=[0.0], carrier_p=[0.0],
                          carrier_f=[400.0])

    _, rf_a, ri_a = track_scan(xd, jnp.int32(len(x)), tab, fresh(),
                               params, 48)
    cut = 26                      # 26 % 4 == 2: mid-period
    st1, rf_1, _ = track_scan(xd, jnp.int32(len(x)), tab, fresh(),
                              params, cut)
    assert int(np.asarray(st1.sub_j)[0]) == cut % 4
    import os
    path = os.path.join("/tmp", "mid_subblock_ckpt.npz")
    checkpoint.save(path, st1)
    st_l, _, _ = checkpoint.load(path)
    _, rf_2, ri_2 = track_scan(xd, jnp.int32(len(x)), tab, st_l,
                               params, 48 - cut)
    np.testing.assert_array_equal(np.asarray(rf_a[:cut]), np.asarray(rf_1))
    np.testing.assert_array_equal(np.asarray(rf_a[cut:]), np.asarray(rf_2))
    np.testing.assert_array_equal(np.asarray(ri_a[cut:]), np.asarray(ri_2))


def test_coherent_overlay_tracking():
    """Extended-coherent tracking with secondary wipeoff (framework
    extension; the carrier NCO is phase-continuous across blocks so the
    M-period complex sum is coherent): at 30 dB-Hz the NH20-wiped 20 ms
    integration tracks BeiDou B1I with ~4x less carrier jitter than the
    per-period loops, and omitting the overlay (data flips uncompensated)
    destroys the gain — proving the wipeoff is what's doing the work."""
    import dataclasses

    from gnss_dsp.track.driver import TrackChannel, track_file

    sig = get_signal("beidou-b1i")
    fs = 4.096e6
    prn, dop, cp0, cn0 = 34, 800.0, 700.0, 30.0
    sec = sig.secondary(prn)
    x = synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                       sig.chip_rate, fs, int(fs * 1.0), doppler_hz=dop,
                       code_phase=cp0, cn0_dbhz=cn0,
                       carrier_ratio=sig.track_carrier_ratio(0),
                       data_bits=sec, rng=np.random.default_rng(7))
    sigma = np.sqrt(fs / (2 * 10 ** (cn0 / 10)))
    raw = synth.to_int8_iq(x, scale=100.0 / (4 * sigma))
    sig_noovl = dataclasses.replace(sig, secondary=None)

    def run(s, **kw):
        ch = TrackChannel(prn=prn, doppler=dop, code_offset=cp0,
                          pll_from_start=True, overlay_phase=1)
        track_file(s, io.BytesIO(raw), fs, 0.0, [ch], **kw)
        cf = np.array([r["carrier_f"] for r in ch.rows[-300:]])
        return float(np.mean(cf)), float(np.std(cf))

    m_std, s_std = run(sig)
    m_coh, s_coh = run(sig, coherent_blocks=20)
    m_bad, s_bad = run(sig_noovl, coherent_blocks=20)

    assert abs(m_coh - dop) < 0.3, (m_coh, s_coh)
    assert s_coh < 0.5 * s_std, (s_coh, s_std)
    # without the wipeoff the overlay flips cancel the coherent sums
    assert abs(m_bad - dop) > 3 * abs(m_coh - dop) or s_bad > 2 * s_coh, (
        m_bad, s_bad, m_coh, s_coh)
