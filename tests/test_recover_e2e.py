"""Unknown-code recovery end to end: synthesize B2bi IQ with random
navigation bits, run the drop-in scripts/track-beidou-b2bi.py, and check
that the per-chip bins in track-chips.dat recover the transmitted code —
the workflow the reference used to capture the B2b memory codes
(track-beidou-b2bi.py:47-53,181-184)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from gnss_dsp.models import get_signal
from gnss_dsp.utils.synth import synth_iq, to_int8_iq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_b2bi_file(tmp_path, prn, fs, ms, doppler, rng):
    sig = get_signal("beidou-b2bi")
    code = sig.code_table((prn,))[0].astype(np.float64)
    n = int(fs * ms / 1000)
    bits = rng.choice([-1.0, 1.0], size=ms + 2)
    # the recovery SNR budget is thin in a short test: at fs=22 MHz each
    # chip bin collects ~2.15 samples/block, so (ms-warmup) blocks at
    # cn0 give bin SNR ~ (ms-warmup)*2.15*10^(cn0/10)/fs — 60 dBHz over
    # ~90 blocks is ~9 (power), i.e. ~0.2% chip error.  The reference ran
    # this over seconds of real capture (track-beidou-b2bi.py:47-53).
    x = synth_iq(code, sig.chip_rate, fs, n, doppler_hz=doppler,
                 code_phase=0.0, cn0_dbhz=60.0, amplitude=8.0,
                 carrier_ratio=sig.carrier_ratio, rng=rng, data_bits=bits)
    p = os.path.join(tmp_path, "b2bi.iq")
    with open(p, "wb") as f:
        f.write(to_int8_iq(x, scale=1.0))
    return p, code


def test_b2bi_cli_recovers_code(tmp_path):
    fs = 22.0e6
    prn, doppler = 19, 800.0
    rng = np.random.default_rng(7)
    path, code = _make_b2bi_file(tmp_path, prn, fs, ms=100, doppler=doppler,
                                 rng=rng)
    chips_path = os.path.join(tmp_path, "track-chips.dat")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "track-beidou-b2bi.py"),
         "--loop-dwells", "10,10", "--recover-warmup", "10",
         "--recover-file", chips_path,
         path, str(fs), "0", str(prn), str(doppler), "0"],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = out.stdout.strip().splitlines()
    assert len(rows) > 60                      # tracked to EOF

    bins = np.loadtxt(chips_path)
    assert bins.shape == (10230, 2)
    rec = np.where(bins[:, 0] >= 0, 1.0, -1.0)
    hit = bins[:, 0] != 0.0                    # bins never visited stay 0
    assert hit.mean() > 0.95
    agree = (rec[hit] == code[hit]).mean()
    # sign convention: the Costas/FLL loop may lock 180 deg out of phase,
    # recovering the inverted code (the reference has the same ambiguity)
    assert max(agree, 1.0 - agree) > 0.98


def test_recovery_under_mesh_matches_single(tmp_path):
    """Unknown-code recovery composes with --mesh: the
    recovery bins ride the state pytree, which the sharded
    scan partitions over 'sat' like every other [C, ...] leaf — bins
    and rows bit-equal to the single-device run."""
    import io

    from gnss_dsp.parallel.mesh import make_mesh
    from gnss_dsp.track.driver import TrackChannel, track_file

    fs = 22.0e6
    prn, doppler = 19, 800.0
    rng = np.random.default_rng(7)
    path, code = _make_b2bi_file(tmp_path, prn, fs, ms=40, doppler=doppler,
                                 rng=rng)
    data = open(path, "rb").read()
    sig = get_signal("beidou-b2bi")

    def run(mesh):
        ch = TrackChannel(prn=prn, doppler=doppler, code_offset=0.0)
        track_file(sig, io.BytesIO(data), fs, 0.0, [ch],
                   loop_dwells=(10, 10), recover_after=10, mesh=mesh)
        return ch

    a = run(None)
    b = run(make_mesh(2, time_shards=1))
    np.testing.assert_array_equal(a.recovered, b.recovered)
    ra = [[r["block"], r["prompt"], r["carrier_f"]] for r in a.rows]
    rb = [[r["block"], r["prompt"], r["carrier_f"]] for r in b.rows]
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
    assert np.abs(a.recovered).sum() > 0


def test_multi_recovers_two_codes_one_pass(tmp_path):
    """B2bi + B2bq unknown-code recovery in ONE mixed scan:
    the reference captured the two B2b memory codes with two separate
    process runs; here both channels' per-chip bins fill in a single
    pass and each recovers its own planted code."""
    import io

    from gnss_dsp.track.driver import TrackChannel, track_file

    fs = 22.0e6
    ms = 100
    rng = np.random.default_rng(11)
    duo = [("beidou-b2bi", 19, 800.0), ("beidou-b2bq", 20, -1500.0)]
    n = int(fs * ms / 1000)
    x = np.zeros(n, np.complex64)
    codes = {}
    for name, prn, dop in duo:
        sig = get_signal(name)
        code = sig.code_table((prn,))[0].astype(np.float64)
        codes[name] = code
        bits = rng.choice([-1.0, 1.0], size=ms + 2)
        x += synth_iq(code, sig.chip_rate, fs, n, doppler_hz=dop,
                      code_phase=0.0, cn0_dbhz=None, amplitude=8.0,
                      carrier_ratio=sig.carrier_ratio, data_bits=bits)
    sigma = 8.0 * np.sqrt(fs / (2.0 * 10 ** 6.0))      # ~60 dB-Hz each
    x += sigma * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    data = to_int8_iq(x, scale=1.0)

    sigs = [get_signal(name) for name, *_ in duo]
    chans = [TrackChannel(prn=p, doppler=d, code_offset=0.0)
             for _, p, d in duo]
    track_file(sigs[0], io.BytesIO(data), fs, 0.0, chans,
               loop_dwells=(10, 10), sigs=sigs, recover_after=10)
    for (name, prn, dop), sig, ch in zip(duo, sigs, chans):
        bins = ch.recovered[: sig.code_length]
        rec = np.where(bins.real >= 0, 1.0, -1.0)
        hit = bins.real != 0.0
        assert hit.mean() > 0.95, (name, hit.mean())
        agree = (rec[hit] == codes[name][hit]).mean()
        assert max(agree, 1.0 - agree) > 0.97, (name, agree)
