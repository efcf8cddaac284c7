"""Utility tiers: cn0 math, squaring op, ranges parser, correlation-shape
probe, profiling counters."""

import numpy as np
import jax.numpy as jnp

from gnss_dsp.cli.cn0 import cn0
from gnss_dsp.ops.squaring import squaring
from gnss_dsp.utils.ranges import parse_list_ranges, parse_list_floats


def test_cn0_formula(rng):
    """cn0 = 20*log10(mean|I| / (sqrt(2)*std(Q))) + 30 (cn0.py:20-25)."""
    n = 100000
    snr_amp = 50.0
    x = snr_amp + rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = cn0(x)
    want = 20 * np.log10(np.mean(np.abs(x.real))
                         / (np.sqrt(2) * np.std(x.imag))) + 30
    assert abs(got - want) < 1e-9


def test_squaring_matches_reference_loop(rng):
    """r[b] = sum_k (sum_l x[bnm+kn+l])^2 / n (gnsstools/squaring.py:13-23)."""
    b, n, m = 4, 8, 5
    x = rng.standard_normal(b * n * m) + 1j * rng.standard_normal(b * n * m)
    want = np.zeros(b, complex)
    for bi in range(b):
        for k in range(m):
            s = x[bi * n * m + k * n:(bi) * n * m + (k + 1) * n].sum()
            want[bi] += s * s / n
    rr, ri = squaring((jnp.asarray(x.real.astype(np.float32)),
                       jnp.asarray(x.imag.astype(np.float32))), n, m)
    np.testing.assert_allclose(np.asarray(rr), want.real, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ri), want.imag, rtol=1e-4)


def test_ranges_parser():
    assert parse_list_ranges("1,3,7-9") == [1, 3, 7, 8, 9]
    assert parse_list_ranges("-7:7", sep=":") == list(range(-7, 8))
    assert parse_list_ranges("5") == [5]
    assert parse_list_floats("1.5,-2,3e3") == [1.5, -2.0, 3000.0]


def test_correlation_shape_probe(rng):
    """The probe's peak sits at the true code offset."""
    from gnss_dsp.track.probe import correlation_shape
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    fs = 4.096e6
    code = sig.code_table((7,))[0]
    true_cp = 100.4
    x = synth_iq(code, sig.chip_rate, fs, 4096, doppler_hz=0.0,
                 code_phase=true_cp, cn0_dbhz=None)
    xs = (jnp.asarray(x.real), jnp.asarray(x.imag))
    n_lags = 81
    re, im = correlation_shape(
        xs, jnp.asarray(code.astype(np.int8)), jnp.float32(100.0),
        jnp.float32(sig.chip_rate / fs), jnp.float32(0.05), n_lags, 1023)
    mag = np.hypot(np.asarray(re), np.asarray(im))
    peak_lag = 0.05 * (int(np.argmax(mag)) - n_lags // 2)
    assert abs((100.0 + peak_lag) - true_cp) <= 0.05, peak_lag


def test_counters():
    from gnss_dsp.utils.profiling import Counters

    c = Counters()
    c.samples += 1000
    c.cells += 5000
    r = c.report()
    assert "Msamples/s" in r and "Gcells/s" in r


def test_from_int8_iq_bit_identical(rng):
    """Device-side int8 deinterleave (cplx.from_int8_iq — the CLI
    upload path) is bit-identical to the host-deinterleave +
    from_numpy route, including the device-side zero pad."""
    from gnss_dsp.ops import cplx
    from gnss_dsp.utils import io as uio

    raw = rng.integers(-128, 128, size=2 * 1000, dtype=np.int64
                       ).astype(np.int8)
    host = cplx.from_numpy(uio.bytes_to_complex(raw.tobytes()))
    dev = cplx.from_int8_iq(raw.tobytes(), pad=24)
    assert dev[0].shape[0] == 1024
    np.testing.assert_array_equal(np.asarray(host[0]),
                                  np.asarray(dev[0][:1000]))
    np.testing.assert_array_equal(np.asarray(host[1]),
                                  np.asarray(dev[1][:1000]))
    assert float(np.abs(np.asarray(dev[0][1000:])).max()) == 0.0


def test_synth_iq_chunked_continuation_exact():
    """synth_iq(t0) chunked == one-shot, exactly: all phase ramps are
    affine in the absolute sample index (the long-capture generator's
    correctness contract, tools/synth_sky.py)."""
    import numpy as np

    from gnss_dsp.utils.synth import synth_iq

    rng = np.random.default_rng(5)
    code = rng.choice([-1.0, 1.0], 1023)
    kw = dict(chip_rate=1.023e6, fs=4.096e6, doppler_hz=1234.5,
              code_phase=321.7, carrier_phase=0.3, cn0_dbhz=None,
              carrier_ratio=1540.0, subcarrier="cboc",
              data_bits=np.array([1.0, -1.0, -1.0, 1.0]))
    full = synth_iq(code, n=4096 * 4, **kw)
    parts = [synth_iq(code, n=4096, t0=k * 4096, **kw) for k in range(4)]
    np.testing.assert_array_equal(full, np.concatenate(parts))


def test_int4_pack_unpack_roundtrip():
    """pack_int4_host + from_int4_iq: device values = 8*clip(round(v/8))
    of the int8 stream, exactly."""
    import numpy as np

    from gnss_dsp.ops import cplx

    rng = np.random.default_rng(3)
    raw = rng.integers(-127, 128, 4096, dtype=np.int16).astype(np.int8)
    re, im = cplx.from_int4_iq(cplx.pack_int4_host(raw), pad=4)
    v4 = np.clip((raw.astype(np.int16) + 4) >> 3, -7, 7).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(re)[:2048], 8.0 * v4[0::2])
    np.testing.assert_array_equal(np.asarray(im)[:2048], 8.0 * v4[1::2])
    assert np.asarray(re)[2048:].sum() == 0


def test_int4_streaming_tracks(monkeypatch):
    """GNSS_DSP_UPLOAD_INT4 on the streaming path still locks (the
    4-bit front end costs ~0.2-0.5 dB, not lock)."""
    import io

    import numpy as np

    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import TrackChannel, track_file
    from gnss_dsp.utils import synth

    monkeypatch.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    sig = get_signal("gps-l1")
    fs = 4.096e6
    prn, dop, cp = 7, 1200.0, 300.0
    n = int(fs * 0.4)
    x = synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                       sig.chip_rate, fs, n, doppler_hz=dop,
                       code_phase=cp, cn0_dbhz=45.0,
                       carrier_ratio=1540.0, rng=np.random.default_rng(5))
    sigma = np.sqrt(fs / (2 * 10 ** 4.5))
    data = synth.to_int8_iq(x, scale=100.0 / (4 * sigma))
    ch = TrackChannel(prn=prn, doppler=dop + 30.0, code_offset=cp)
    track_file(sig, io.BytesIO(data), fs, 0.0, [ch],
               loop_dwells=(60, 60), chunk_ms=150.0)
    cf = np.median([r["carrier_f"] for r in ch.rows[-100:]])
    assert abs(cf - dop) < 5.0, cf
