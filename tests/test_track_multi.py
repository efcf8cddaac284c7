"""Mixed-constellation single-program tracking (driver sigs=[...]):
channels of different signals in ONE scan must reproduce each signal's
own single-signal trajectories.  Framework extension with no reference
analog (the reference runs one process per track script) — enabled by
the runtime sigp lanes.  The *_refills cases stream the capture in 4 ms
chunks, so every few blocks the driver refills, rebases the per-channel
pointers and re-enters the scan.
"""

import io

import numpy as np
import pytest

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import TrackChannel, track_file
from gnss_dsp.utils import synth

FS = 8.192e6
COFF = 900.0
# (signal, prn, doppler, code_phase): BPSK short code, CBOC x4 memory
# code, BPSK NH-carrying code — three different constellations/shapes
TRIO = [
    ("gps-l1", 7, 900.0, 317.25),
    ("galileo-e1b", 24, -1500.0, 2047.3),
    ("beidou-b1i", 34, 400.0, 1500.6),
]


def _scene(seconds=0.05):
    n = int(FS * seconds)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp in TRIO:
        sig = get_signal(name)
        code = sig.code_table((prn,))[0].astype(np.float64)
        x += synth.synth_iq(code, sig.chip_rate, FS, n, doppler_hz=dop,
                            code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(prn),
                            subcarrier=sig.subcarrier)
    x = x * np.exp(2j * np.pi * COFF / FS * np.arange(n))
    return synth.to_int8_iq(x, scale=24.0)


def _rows(rows, n=30):
    keys = ("block", "p_re", "p_im", "carrier_f", "code_f_offset",
            "early", "prompt", "late", "code_p")
    return np.array([[r[k] for k in keys] for r in rows[:n]])


def _run_single(data, blocks, chunk_ms=2000.0):
    out = []
    for name, prn, dop, cp in TRIO:
        sig = get_signal(name)
        chans = [TrackChannel(prn=prn, doppler=dop, code_offset=cp)]
        track_file(sig, io.BytesIO(data), FS, COFF, chans,
                   loop_dwells=(8, 8), max_blocks=blocks,
                   chunk_ms=chunk_ms)
        out.append(chans[0].rows)
    return out


def _run_multi(data, blocks, chunk_ms=2000.0):
    sigs = [get_signal(name) for name, *_ in TRIO]
    chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
             for _, p, d, cp in TRIO]
    track_file(sigs[0], io.BytesIO(data), FS, COFF, chans,
               loop_dwells=(8, 8), max_blocks=blocks, sigs=sigs,
               chunk_ms=chunk_ms)
    return [c.rows for c in chans]


def _compare(single, multi):
    for k, (name, prn, dop, cp) in enumerate(TRIO):
        a = _rows(single[k])
        b = _rows(multi[k])
        assert a.shape == b.shape and a.shape[0] >= 20, (name, a.shape)
        # same loop trajectories up to f32 scheduling noise (the shared
        # program runs a bigger window/more channels, so matmul shapes
        # and summation orders differ)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-2,
                                   err_msg=name)
        cf_tail = np.median(a[-8:, 3])
        # short runs with fast dwells: settled to within a few tens of
        # Hz is "locked" here; the exact-equality check above is the
        # real correctness assertion
        assert abs(cf_tail - dop) < 30.0, (name, cf_tail, dop)


def test_multi_matches_single_xla():
    data = _scene()
    _compare(_run_single(data, 40), _run_multi(data, 40))


def test_multi_matches_single_refills():
    data = _scene()
    # stalled steps at each chunk end count against max_blocks: give the
    # refilled run room to emit the compared rows
    _compare(_run_single(data, 32), _run_multi(data, 64, chunk_ms=4.0))


def test_multi_cli(capsys):
    """CLI front door: track multi FILE fs coffset SIG:prn:dop:code,..."""
    import os
    import tempfile

    from gnss_dsp.cli.track import main as track_main

    data = _scene()
    with tempfile.NamedTemporaryFile(suffix=".iq", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        spec = ",".join(f"{n}:{p}:{d}:{cp}" for n, p, d, cp in TRIO)
        rc = track_main("multi", ["--blocks", "20", "--loop-dwells", "6,6",
                                  path, str(FS), str(COFF), spec])
        assert rc in (0, None)
        lines = capsys.readouterr().out.strip().splitlines()
        for name, prn, *_ in TRIO:
            mine = [ln for ln in lines if ln.startswith(f"{name}:{prn} ")]
            assert len(mine) >= 15, (name, len(mine))
            # 9/14-column native formats after the prefix
            want = 14 if get_signal(name).row_format == 14 else 9
            assert len(mine[0].split()) == want + 1, mine[0]
    finally:
        os.unlink(path)


def test_multi_mesh_sharded():
    """Mixed-constellation tracking under --mesh: channels + their sigp
    rows shard over 'sat' under shard_map (parallel/track) — same
    trajectories as the unsharded multi run."""
    from gnss_dsp.parallel.mesh import make_mesh

    data = _scene()
    sigs = [get_signal(name) for name, *_ in TRIO]

    def run(mesh):
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp in TRIO]
        track_file(sigs[0], io.BytesIO(data), FS, COFF, chans,
                   loop_dwells=(8, 8), max_blocks=32, sigs=sigs,
                   mesh=mesh)
        return [c.rows for c in chans]

    a = run(None)
    b = run(make_mesh(8, time_shards=1))
    for k, (name, *_rest) in enumerate(TRIO):
        np.testing.assert_array_equal(_rows(a[k]), _rows(b[k]),
                                      err_msg=name)


def test_multi_coherent_mixed():
    """Mixed-constellation tracking with PER-CHANNEL coherent spans
    (runtime SIGP_COH/SIGP_NOV lanes): a B1I channel integrates 20
    NH20-wiped periods coherently while a GPS L1 channel (no overlay)
    runs non-coherently in the SAME compiled scan — each matching its
    own single-signal run."""
    duo = [("beidou-b1i", 34, 400.0, 1500.6), ("gps-l1", 7, 900.0, 317.25)]
    n = int(FS * 0.06)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp in duo:
        sig = get_signal(name)
        code = sig.code_table((prn,))[0].astype(np.float64)
        bits = (np.asarray(sig.secondary(prn), np.float64)
                if sig.secondary is not None else None)
        x += synth.synth_iq(code, sig.chip_rate, FS, n, doppler_hz=dop,
                            code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(prn),
                            data_bits=bits)
    x = x * np.exp(2j * np.pi * COFF / FS * np.arange(n))
    data = synth.to_int8_iq(x, scale=24.0)

    def single(name, prn, dop, cp, M):
        sig = get_signal(name)
        ch = [TrackChannel(prn=prn, doppler=dop, code_offset=cp)]
        track_file(sig, io.BytesIO(data), FS, COFF, ch,
                   loop_dwells=(8, 8), max_blocks=40, coherent_blocks=M)
        return ch[0].rows

    sgl = [single("beidou-b1i", 34, 400.0, 1500.6, -1),
           single("gps-l1", 7, 900.0, 317.25, 1)]
    # discriminator: the coherent B1I trajectory must DIFFER from its
    # non-coherent run (guards against -1 silently resolving to M=1 —
    # the multi-vs-single equality below would then pass vacuously)
    nc = _rows(single("beidou-b1i", 34, 400.0, 1500.6, 1))
    assert not np.allclose(_rows(sgl[0]), nc, rtol=2e-3, atol=2e-2)
    sigs = [get_signal(name) for name, *_ in duo]
    chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
             for _, p, d, cp in duo]
    track_file(sigs[0], io.BytesIO(data), FS, COFF, chans,
               loop_dwells=(8, 8), max_blocks=40, sigs=sigs,
               coherent_blocks=-1)
    for k, (name, *_rest) in enumerate(duo):
        a = _rows(sgl[k])
        b = _rows(chans[k].rows)
        assert a.shape == b.shape and a.shape[0] >= 30, (name, a.shape)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-2,
                                   err_msg=name)


# TMBOC in a mix: the slot gate is the runtime SIGP_TM lane,
# so gps-l1cp joins a tmboc-kind shared program whose other channels
# (BPSK, CBOC) carry tm = 0 — each must reproduce its single-signal run.
TMBOC_TRIO = [
    ("gps-l1cp", 3, 700.0, 5100.4),
    ("gps-l1", 7, 900.0, 317.25),
    ("galileo-e1b", 24, -1500.0, 2047.3),
]


def _scene_list(trio, seconds=0.05):
    n = int(FS * seconds)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp in trio:
        sig = get_signal(name)
        code = sig.code_table((prn,))[0].astype(np.float64)
        x += synth.synth_iq(code, sig.chip_rate, FS, n, doppler_hz=dop,
                            code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(prn),
                            subcarrier=sig.subcarrier)
    x = x * np.exp(2j * np.pi * COFF / FS * np.arange(n))
    return synth.to_int8_iq(x, scale=24.0)


def _run_trio(data, blocks, trio, multi, chunk_ms=2000.0):
    sigs = [get_signal(name) for name, *_ in trio]
    if multi:
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp in trio]
        track_file(sigs[0], io.BytesIO(data), FS, COFF, chans,
                   loop_dwells=(8, 8), max_blocks=blocks, sigs=sigs,
                   chunk_ms=chunk_ms)
        return [c.rows for c in chans]
    out = []
    for (name, prn, dop, cp), sig in zip(trio, sigs):
        chans = [TrackChannel(prn=prn, doppler=dop, code_offset=cp)]
        track_file(sig, io.BytesIO(data), FS, COFF, chans,
                   loop_dwells=(8, 8), max_blocks=blocks)
        out.append(chans[0].rows)
    return out


def _compare_trio(trio, single, multi):
    for k, (name, prn, dop, cp) in enumerate(trio):
        a = _rows(single[k])
        b = _rows(multi[k])
        assert a.shape == b.shape and a.shape[0] >= 20, (name, a.shape)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-2,
                                   err_msg=name)


def test_multi_tmboc_mixed_xla():
    data = _scene_list(TMBOC_TRIO)
    _compare_trio(TMBOC_TRIO, _run_trio(data, 40, TMBOC_TRIO, False),
                  _run_trio(data, 40, TMBOC_TRIO, True))


def test_multi_tmboc_mixed_refills():
    data = _scene_list(TMBOC_TRIO)
    _compare_trio(TMBOC_TRIO, _run_trio(data, 32, TMBOC_TRIO, False),
                  _run_trio(data, 64, TMBOC_TRIO, True, chunk_ms=4.0))


# Long codes in a mix: gps-l2cl (767250 chips) shares the program with
# a short code; the short code's table row is zero-padded to the long
# one (its gather index stays below its own runtime length).
STREAM_DUO = [
    # code phase near the period end: the driver discards samples
    # to the first code boundary, and l2cl's period is 1.5 s
    ("gps-l2cl", 7, 900.0, 767200.5),
    ("gps-l1", 21, -1200.0, 317.25),
]


def test_multi_streamed_long_code_xla():
    data = _scene_list(STREAM_DUO)
    _compare_trio(STREAM_DUO, _run_trio(data, 40, STREAM_DUO, False),
                  _run_trio(data, 40, STREAM_DUO, True))


def test_multi_streamed_long_code_refills():
    data = _scene_list(STREAM_DUO)
    _compare_trio(STREAM_DUO, _run_trio(data, 40, STREAM_DUO, False),
                  _run_trio(data, 48, STREAM_DUO, True, chunk_ms=4.0))
