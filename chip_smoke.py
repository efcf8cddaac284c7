#!/usr/bin/env python3
"""Smoke test of the receiver on one NVIDIA GPU, at full size.

    python chip_smoke.py                # phases A-F on one card
    python chip_smoke.py --four-cards   # only the mesh paths, on 4 cards
    python chip_smoke.py --phases B,D   # a subset of the one-card phases

Drives acquisition, tracking and the 3-band receiver through their
normal entry points on seeded synthetic data and compares each with a
plain numpy reference:

  A  the card, JAX/CUDA versions, the compile-cache directory
  B  GPS L1 sky search, the reference's grid (32 PRN x 70 Doppler bins x
     4096 code phases x 80 blocks) vs reference_search (bench.py), at
     Precision.HIGHEST and DEFAULT; memory_analysis of the step
  C  acquire-all on a synthesized 3-band 69.984 MHz sky (all 11 golden
     acquisitions), an L2CL serial search, and a GPS L5I NH10 extended-
     coherent search over the full PRN grid vs reference_search_coherent
  D  tracking: 32 GPS L1 channels (900 blocks) and one long code (L2CL):
     first-block E/P/L vs the numpy correlator of
     tools/baseline_track_numpy.py, card rows vs CPU rows, carrier hold,
     seconds per scan step and kernels per step
  E  the single-program receiver on all 11 golden channels over 2 s of
     the 3-band capture read from disk: lock and realtime multiple
  F  the card-only tests (pytest -m gpu), run as a child process before
     this process opens the card

Every phase prints one line; any failed phase makes the exit code
non-zero.  The script refuses to run without a GPU.  The last line of
standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# (channel tolerance of phase D: E/P/L vs the numpy correlator, relative
# to the channel's prompt magnitude; card rows vs CPU rows)
EPL_TOL = 1e-3
ROWS_RTOL, ROWS_ATOL = 2e-3, 2e-2
# phase B: metric relative error at HIGHEST / DEFAULT precision
ACQ_TOL = {"HIGHEST": 1e-4, "DEFAULT": 5e-3}
SKY_PLANTED = (5, 12, 21)             # bench.synth_sky's live PRNs
SYNTH_WORKERS = min(12, os.cpu_count() or 1)


class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def query_cards() -> list:
    """Each card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError("nvidia-smi found no GPU: " + r.stderr.strip())
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


def card_line() -> str:
    """The first card's name and power limit (tagged on every result)."""
    return query_cards()[0]


# --------------------------------------------------------------- phase F
def phase_f(card: str) -> str:
    """Card-only tests in a child process (this process has not opened
    the card yet, so the child may)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-n", "0", "-p", "no:cacheprovider", "-rs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    passed = re.search(r"(\d+) passed", tail)
    check(r.returncode == 0 and passed and "skipped" not in tail,
          f"pytest -m gpu rc={r.returncode}: {r.stdout[-3000:]}"
          f"{r.stderr[-2000:]}")
    return (f"F card tests: {passed.group(1)} passed in "
            f"{time.perf_counter() - t0:.1f} s [{card}]")


# ------------------------------------------------------------- captures
def synth_capture(path: str, ms: int, workers: int) -> None:
    from tools.synth_sky import write_capture

    write_capture(path, ms, progress=False, workers=workers)


def synth_bands(dest: str, ms: int, workers: int) -> dict:
    """Per-band int8 files of the synthetic sky (no container): the
    receiver reads each band from its own file."""
    import multiprocessing as mp

    from tools.synth_sky import CHUNK_MS, _band_chunk_int8, _malloc_tune

    FS = 69.984e6
    sigma = np.sqrt(FS / (2.0 * 10 ** 5.0))
    scale = 100.0 / (4.0 * sigma)
    paths = {b: os.path.join(dest, f"band{b}.iq") for b in (1, 2, 3)}
    chunks = [(c0, min(CHUNK_MS, ms - c0)) for c0 in range(0, ms, CHUNK_MS)]
    tasks = [(b, c0, cms, sigma, scale, False)
             for (c0, cms) in chunks for b in (1, 2, 3)]
    fps = {b: open(p, "wb") for b, p in paths.items()}
    try:
        with mp.get_context("spawn").Pool(
                workers, initializer=_malloc_tune) as pool:
            for (b, *_), data in zip(tasks, pool.imap(_band_chunk_int8,
                                                      tasks)):
                fps[b].write(data)
    finally:
        for f in fps.values():
            f.close()
    return paths


# --------------------------------------------------------------- phase A
def phase_a(card: str, cache_dir: str) -> str:
    import importlib.metadata as md

    import jax

    d = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi"], capture_output=True, text=True,
                         timeout=60).stdout
    cuda = re.search(r"CUDA Version:\s*([\d.]+)", smi)
    plugin = [f"{p}=={md.version(p)}" for p in
              ("jax-cuda12-plugin", "jax-cuda13-plugin")
              if _installed(p)]
    return (f"A card: {d.device_kind} x{len(jax.devices())}, "
            f"jax {jax.__version__}, {' '.join(plugin) or 'no plugin'}, "
            f"CUDA driver {cuda.group(1) if cuda else '?'}, "
            f"cache {cache_dir} [{card}]")


def _installed(pkg: str) -> bool:
    import importlib.metadata as md

    try:
        md.version(pkg)
        return True
    except md.PackageNotFoundError:
        return False


# --------------------------------------------------------------- phase B
def sky_search(sig, prns, dops_cfg, ms, precision):
    """(metric, code_idx, dop_idx, dops, compiled) of the production
    grid search on bench.synth_sky data, through search_inputs (the
    arguments acquire_signal passes)."""
    import jax

    import bench
    from gnss_dsp.acquire import engine as eng

    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    x = bench.synth_sky(sig, sig.acq_fs, (ms + 2) * n)
    args, kw, dops, _ = eng.search_inputs(sig, x, prns, dops_cfg, ms,
                                          precision=precision)
    compiled = eng.grid_search.lower(*args, **kw).compile()
    out = jax.block_until_ready(eng.grid_search(*args, **kw))
    return x, tuple(np.asarray(a) for a in out), dops, compiled


def phase_b(card: str, acq_fs: float | None = None, ms: int = 80,
            dops_cfg=(-7000.0, 7000.0, 200.0),
            prns=tuple(range(1, 33)), others=(1, 8, 30)) -> str:
    import jax

    import bench
    from gnss_dsp.acquire.engine import acquire_signal
    from gnss_dsp.models import get_signal

    sig = get_signal("gps-l1")
    if acq_fs:
        sig = dataclasses.replace(sig, acq_fs=acq_fs)
    P = jax.lax.Precision
    t0 = time.perf_counter()
    x, (m, ci, di), dops, compiled = sky_search(sig, prns, dops_cfg, ms,
                                                P.HIGHEST)
    t_first = time.perf_counter() - t0
    # the entry point a user calls: planted PRNs win
    res = acquire_signal(sig, x, list(prns), doppler_search=dops_cfg, ms=ms)
    t0 = time.perf_counter()
    acquire_signal(sig, x, list(prns), doppler_search=dops_cfg, ms=ms)
    t_warm = time.perf_counter() - t0
    top = {r.prn for r in sorted(res, key=lambda r: -r.metric)[:3]}
    check(top == set(SKY_PLANTED), f"planted PRNs lost: top {top}")

    cmp = list(SKY_PLANTED) + [p for p in others if p not in SKY_PLANTED]
    rows = [prns.index(p) for p in cmp]
    rm, rci, rdi = bench.reference_search(sig, x, cmp, dops, ms)
    err = np.abs(m[rows] - rm) / rm
    check((ci[rows] == rci).all() and (di[rows] == rdi).all(),
          f"HIGHEST cells differ: {ci[rows]} {rci} / {di[rows]} {rdi}")
    check(err.max() <= ACQ_TOL["HIGHEST"], f"HIGHEST metric err {err}")

    _, (md, cd, dd), _, _ = sky_search(sig, prns, dops_cfg, ms, P.DEFAULT)
    err_d = np.abs(md[rows] - rm) / rm
    check(err_d.max() <= ACQ_TOL["DEFAULT"], f"DEFAULT metric err {err_d}")
    planted = [prns.index(p) for p in SKY_PLANTED]
    check((cd[planted] == ci[planted]).all()
          and (dd[planted] == di[planted]).all(),
          "DEFAULT moved a planted PRN's winning cell")
    moved = [p for p, k in zip(cmp, rows)
             if (cd[k], dd[k]) != (ci[k], di[k])]
    mem = compiled.memory_analysis()
    memtxt = (f"temp {mem.temp_size_in_bytes / 2**20:.0f} MiB, args "
              f"{mem.argument_size_in_bytes / 2**20:.1f} MiB, out "
              f"{mem.output_size_in_bytes} B" if mem is not None
              else "memory_analysis n/a")
    return (f"B sky search {len(prns)}x{len(dops)}x"
            f"{int(sig.acq_fs * 1e-3)}x{ms}: planted {sorted(top)} win; "
            f"vs numpy on {cmp}: cells identical, metric rel err HIGHEST "
            f"{err.max():.2e} (<= {ACQ_TOL['HIGHEST']}), DEFAULT "
            f"{err_d.max():.2e} (<= {ACQ_TOL['DEFAULT']}; near-tie cells "
            f"moved for {moved}); first call {t_first:.1f} s incl. "
            f"compile, acquire_signal warm {t_warm:.3f} s; {memtxt} "
            f"[{card}]")


# --------------------------------------------------------------- phase C
def coherent_check(sig, xb, prns, cmp, dops_cfg, m_coh, ms, precision):
    """acquire_signal_coherent vs reference_search_coherent on the PRNs
    `cmp`; returns the worst metric relative error."""
    import bench
    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.acquire.coherent import acquire_signal_coherent

    res = acquire_signal_coherent(sig, xb, list(prns), dops_cfg,
                                  m_coh=m_coh, ms=ms, precision=precision)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    dops, fixed = eng.doppler_grid(sig, dops_cfg)
    xh = np.asarray(xb[0], np.float64) + 1j * np.asarray(xb[1], np.float64)
    cf = eng.build_code_ffts(sig, cmp, n, window)
    rm, rci, rdi, ral = bench.reference_search_coherent(
        xh, cf, (fixed.astype(np.int64) % 2**32) / 2**32, n, window,
        ms, m_coh, [sig.secondary(p) for p in cmp])
    got = {r.prn: r for r in res}
    errs = []
    for k, p in enumerate(cmp):
        r = got[p]
        code = (sig.code_length * float(rci[k]) / n) % sig.code_length
        check(r.doppler == dops[rdi[k]] and abs(r.code_offset - code) < 1e-6
              and r.align == ral[k],
              f"coherent cell differs for PRN {p}: {r} vs "
              f"({dops[rdi[k]]}, {code}, {ral[k]})")
        errs.append(abs(r.metric - rm[k]) / rm[k])
    return res, max(errs)


def phase_c(card: str, work: str, capture: str) -> str:
    import jax

    from gnss_dsp.acquire.serial import serial_search
    from gnss_dsp.cli.workload import run_acquire_all
    from gnss_dsp.models import get_signal
    from gnss_dsp.ops import cplx
    from gnss_dsp.utils.synth import synth_iq
    from tools.run_sky_workload import ACQ_EXPECT, check_acq

    dest = os.path.join(work, "acq")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        run_acquire_all(capture, dest)
        fails = check_acq(dest)
    t_acq = time.perf_counter() - t0
    check(not fails, f"acquire-all lost {fails}:\n{out.getvalue()}")

    # assisted serial search (GPS L2CL given an L2CM fix) at the
    # workload's native rate
    sig = get_signal("gps-l2cl")
    fs, k_true = 69.984e6, 31
    phase = float((k_true * 10230 + 1234.0) % sig.code_length)
    n = int(fs * 0.044)
    x = synth_iq(sig.code_table((5,))[0], sig.chip_rate, fs, n,
                 doppler_hz=250.0, code_phase=phase, cn0_dbhz=50.0,
                 subcarrier=sig.subcarrier,
                 carrier_ratio=sig.track_carrier_ratio(0),
                 code_doppler_hz=250.0, rng=np.random.default_rng(11))
    r = serial_search(sig, x, 5, 250.0, parent_code_phase=1234.0, fs=fs,
                      ms=40)
    check(r.k == k_true, f"L2CL serial search k={r.k}, want {k_true}")

    # extended-coherent GPS L5I NH10 over its full PRN grid, on a
    # capture whose L5I carries its NH10 overlay (the sky capture's
    # seeds carry no secondary codes)
    sig = get_signal("gps-l5i")
    ms, m_coh = 10, 10
    xb = cplx.from_numpy(synth_iq(
        sig.code_table((25,))[0], sig.chip_rate, sig.acq_fs,
        int(sig.acq_fs * (ms + 2) / 1000), doppler_hz=-1600.0,
        code_phase=9696.0, cn0_dbhz=45.0, carrier_ratio=sig.carrier_ratio,
        data_bits=np.roll(sig.secondary(25), -3),
        rng=np.random.default_rng(12)))
    dops_cfg = (-7000.0, 7000.0, 100.0)
    prns = sig.prns(sig.prn_default)
    t0 = time.perf_counter()
    res, e_hi = coherent_check(sig, xb, prns, [25, 3, 17], dops_cfg, m_coh,
                               ms, jax.lax.Precision.HIGHEST)
    t_coh = time.perf_counter() - t0
    best = max(res, key=lambda q: q.metric)
    check(best.prn == 25 and best.doppler == -1600.0
          and abs(best.code_offset - 9696.0) <= 1.0,
          f"L5I coherent winner {best}")
    _, e_def = coherent_check(sig, xb, prns, [25, 3, 17], dops_cfg, m_coh,
                              ms, jax.lax.Precision.DEFAULT)
    check(e_hi <= ACQ_TOL["HIGHEST"] and e_def <= ACQ_TOL["DEFAULT"],
          f"L5I coherent metric err HIGHEST {e_hi} DEFAULT {e_def}")
    return (f"C acquire-all {len(ACQ_EXPECT)}/{len(ACQ_EXPECT)} golden "
            f"acquisitions in {t_acq:.1f} s; L2CL serial k={r.k}; L5I NH10 "
            f"coherent {len(prns)} PRN x {len(np.arange(*dops_cfg))} bins: "
            f"PRN 25 at {best.doppler:.0f} Hz / {best.code_offset:.2f} "
            f"chips, cells match numpy, metric rel err HIGHEST {e_hi:.2e} "
            f"DEFAULT {e_def:.2e}, {t_coh:.1f} s incl. compile [{card}]")


# --------------------------------------------------------------- phase D
def track_scene(name, prns, fs, seconds, dops, phases, seed=0, cn0=50.0):
    """int8 I/Q bytes carrying `prns` of signal `name` + noise, and the
    complex samples they decode to."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal(name)
    n = int(fs * seconds)
    x = np.zeros(n, np.complex64)
    for p, d, cp in zip(prns, dops, phases):
        # FDMA channels sit fdma_hz * channel away from the band center
        x += synth_iq(sig.code_table((p,))[0], sig.chip_rate, fs, n,
                      doppler_hz=d + (sig.fdma_hz or 0.0) * p,
                      code_phase=cp, cn0_dbhz=None,
                      subcarrier=sig.subcarrier,
                      carrier_ratio=sig.track_carrier_ratio(p),
                      code_doppler_hz=d)
    sigma = np.sqrt(fs / (2.0 * 10 ** (cn0 / 10.0)))
    rng = np.random.default_rng(seed)
    x += sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    scale = 100.0 / (4.0 * sigma)
    raw = np.empty(2 * n, np.int8)
    raw[0::2] = np.clip(np.round(x.real * scale), -127, 127)
    raw[1::2] = np.clip(np.round(x.imag * scale), -127, 127)
    return raw.tobytes(), raw[0::2] + 1j * raw[1::2].astype(np.float64)


def first_block_epl(sig, fs, x, ch, row):
    """(E, P, L, slack) of a channel's first block from the numpy
    correlator (tools/baseline_track_numpy.mix_vec / correlate_vec), from
    the initial state track_file builds: the pointer at the first code
    boundary, carrier phase 0, the offset and carrier NCOs at the
    engine's fixed-point increments.

    The engine ramps the code phase in f32, so a sample within f32
    resolution of a chip (or subcarrier half-chip) edge may land on the
    other side of it; slack[k] = 2 * sum |x| over those samples of
    correlator k bounds what such a sample can move the sum."""
    from gnss_dsp.ops import nco
    from tools.baseline_track_numpy import correlate_vec, mix_vec

    L = sig.code_length
    n0 = int(fs * 0.001 * sig.code_period_ms * (L - ch.code_offset) / L)
    cp0 = ch.code_offset + n0 * (sig.chip_rate / fs)
    n = row["samp"]
    xs = x[n0:n0 + n]
    coff = nco.freq_to_fixed(-(sig.fdma_hz or 0.0) * ch.prn / fs) % 2**32
    f32 = np.float32
    carr = f32(np.mod(f32(-f32(ch.doppler) / f32(fs)), f32(1.0)))
    carr = int(np.float64(carr) * 2**32) % 2**32
    xm = mix_vec(mix_vec(xs, coff / 2**32, 0.0), carr / 2**32, 0.0)
    ratio = f32(sig.track_carrier_ratio(ch.prn))
    cf_dyn = (f32(0.0) + f32(ch.doppler) / ratio) / f32(fs)
    from gnss_dsp.utils.twofloat import tf_from_f64

    cf_hi, _ = tf_from_f64(np.float64(sig.chip_rate) / np.float64(fs))
    incr = float(f32(f32(cf_hi) + cf_dyn))
    mod = {"none": "bpsk"}.get(sig.subcarrier, sig.subcarrier)
    code = sig.code_table((ch.prn,))[0].astype(np.float64)
    lags = (-sig.el_spacing, 0.0, sig.el_spacing)
    epl = [correlate_vec(xm, code, L, cp0 + lag, incr, mod) for lag in lags]
    # f32 resolution of the engine's fractional ramp fr + i*cf (two
    # roundings, or one where the compiler fuses them)
    res = 1.5 * float(np.spacing(np.float32(n * incr + 2.0)))
    ramp = np.arange(n) * incr
    slack = []
    for lag in lags:
        cp = (cp0 + lag) % L + ramp
        amb = np.zeros(n, bool)
        for m in ((1,) if mod == "bpsk" else (1, 2, 12)):
            f = m * cp
            amb |= np.abs(f - np.round(f)) < m * res
        slack.append(2.0 * np.abs(xs[amb]).sum())
    return epl, slack


ROW_KEYS = ("early", "prompt", "late", "carrier_f", "code_f_offset")


def compare_rows(sig, a_rows, b_rows, nblk, x_max: float = 127 * 2**0.5):
    """Card rows vs CPU rows over the first nblk blocks, at rtol/atol;
    returns the number of chip-edge events.

    The two backends round division, sqrt and the trigonometric
    functions differently in the last bits, so the loop filters' carrier
    estimates differ by ~1e-7 relative, and while the FLL runs the
    carrier phase integrates that difference.  The prompt's I and Q
    therefore rotate apart; the row is compared as the correlator
    magnitudes (early, prompt, late; relative to the prompt, as in the
    first-block check), the loop states (carrier, code rate), and the
    carrier phase (mod 1 cycle) and code phase (mod the code length) it
    reports.  The slightly different code phases also
    put a sample on the other side of a chip edge now and then, which
    moves that block's correlators by at most 2 * x_max (the largest
    sample magnitude): at most 1% of the values may differ by that much
    more than rtol/atol allow."""
    a = np.array([[r[k] for k in ROW_KEYS] for r in a_rows[:nblk]])
    b = np.array([[r[k] for k in ROW_KEYS] for r in b_rows[:nblk]])
    check(a.shape == b.shape and len(a) == nblk, f"rows {a.shape} {b.shape}")
    err = np.abs(a - b)
    # correlators relative to the row's prompt magnitude (early and late
    # sit far below it on RZ and wide-spacing signals), loop states
    # relative to themselves
    tol = ROWS_ATOL + ROWS_RTOL * np.abs(np.concatenate(
        [np.repeat(b[:, 1:2], 3, axis=1), b[:, 3:]], axis=1))
    events = err > tol
    check(not events[:, 3:].any(), "loop states differ: "
          f"{a[:, 3:][events[:, 3:]][:5]} vs {b[:, 3:][events[:, 3:]][:5]}")
    check(events.sum() <= 0.01 * events.size
          and (err[events] <= tol[events] + 2 * x_max).all(),
          f"correlators differ at blocks {np.nonzero(events.any(1))[0][:10]}"
          f": {a[events][:5]} vs {b[events][:5]}")
    for key, period in (("carrier_p", 1.0), ("code_p", sig.code_length)):
        ca = np.array([r[key] for r in a_rows[:nblk]])
        cb = np.array([r[key] for r in b_rows[:nblk]])
        d = (ca - cb + period / 2) % period - period / 2
        check(np.abs(d).max() <= ROWS_ATOL,
              f"{key} differs by {np.abs(d).max()}")
    return int(events.sum())


def track_case(name, prns, fs, nblk, dops, phases, coffset=0.0,
               cmp_blocks=200, seed=0, dwells=(200, 200), devices=None):
    """One tracking case through track_file on the card and on the CPU.
    Returns (max E/P/L error over |P|, worst carrier error, seconds per
    step, kernels per step, channel count)."""
    import jax

    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import TrackChannel, track_file

    sig = get_signal(name)
    L = sig.code_length
    seconds = (nblk + 40) * sig.code_period_ms / sig.sub_blocks / 1000.0
    seconds += sig.code_period_ms / 1000.0 * max(
        (L - cp) / L for cp in phases)
    data, x = track_scene(name, prns, fs, seconds, dops, phases, seed)

    def run(nb, dev):
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for p, d, cp in zip(prns, dops, phases)]
        with jax.default_device(dev):
            track_file(sig, io.BytesIO(data), fs, coffset, chans,
                       loop_dwells=dwells, max_blocks=nb)
        return chans

    gpu = run(nblk, jax.devices()[0])
    for ch in gpu:
        check(len(ch.rows) >= nblk - 2, f"{name} rows {len(ch.rows)}")
    worst = 0.0
    for ch in gpu:
        (e, p, l), (se, sp, sl) = first_block_epl(sig, fs, x, ch,
                                                  ch.rows[0])
        r0 = ch.rows[0]
        pm = abs(p)
        got = (r0["early"], r0["p_re"], r0["p_im"], r0["prompt"],
               r0["late"])
        want = (abs(e), p.real, p.imag, pm, abs(l))
        slack = (se, sp, sp, sp, sl)
        err = max(max(abs(g - w) - s, 0.0)
                  for g, w, s in zip(got, want, slack)) / pm
        worst = max(worst, err)
    check(worst <= EPL_TOL, f"{name} first-block E/P/L err {worst:.2e}")
    cpu = run(cmp_blocks, jax.devices("cpu")[0])
    events = sum(compare_rows(sig, a.rows, b.rows, cmp_blocks,
                              x_max=np.abs(x).max())
                 for a, b in zip(gpu, cpu))
    cf_err = max(abs(np.median([r["carrier_f"] for r in ch.rows[-100:]])
                     - ch.doppler) for ch in gpu)
    check(cf_err <= 5.0, f"{name} carrier off by {cf_err:.2f} Hz")
    step, kernels = scan_step_cost(sig, fs, prns, dops, phases, x, nblk)
    return worst, cf_err, step, kernels, events


def scan_step_cost(sig, fs, prns, dops, phases, x, nblk):
    """Seconds per step of a warm track_scan over nblk blocks, and the
    kernels the compiled scan body launches per step."""
    import jax
    import jax.numpy as jnp

    from gnss_dsp.ops import cplx
    from gnss_dsp.track.driver import (
        TrackChannel, make_params, runtime_tables)
    from gnss_dsp.track.engine import init_state, track_scan

    chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
             for p, d, cp in zip(prns, dops, phases)]
    params = make_params(sig, fs, 0.0, (200, 200))
    params, sigp, _ = runtime_tables(params, [sig] * len(chans), chans, fs,
                                     1, 1)
    L = sig.code_length
    n0 = [int(fs * 0.001 * sig.code_period_ms * (L - c.code_offset) / L)
          for c in chans]
    st = init_state(
        code_p=[c.code_offset + k * sig.chip_rate / fs
                for c, k in zip(chans, n0)],
        code_f_off=np.zeros(len(chans)), carrier_p=np.zeros(len(chans)),
        carrier_f=np.array(dops, np.float64), ptr=np.array(n0))
    xd = cplx.from_numpy(np.concatenate(
        [x, np.zeros(params.nmax + 1024)]).astype(np.complex64))
    tab = jnp.asarray(sig.code_table(tuple(prns)).astype(np.int8))
    kw = dict(ratios=jnp.asarray([sig.track_carrier_ratio(p) for p in prns],
                                 jnp.float32),
              coffset_df=jnp.zeros(len(prns), jnp.int32), sigp=sigp)
    args = (xd, jnp.int32(len(x)), tab, st, params, nblk)
    jax.block_until_ready(track_scan(*args, **kw))
    t0 = time.perf_counter()
    jax.block_until_ready(track_scan(*args, **kw))
    step = (time.perf_counter() - t0) / nblk
    hlo = track_scan.lower(*args, **kw).compile().as_text()
    return step, count_loop_kernels(hlo)


# opcodes that launch no kernel of their own
_NO_KERNEL = {"parameter", "get-tuple-element", "tuple", "constant",
              "bitcast", "after-all", "partition-id", "replica-id",
              "opt-barrier"}


def count_loop_kernels(hlo_text: str) -> dict:
    """Opcode counts of the instructions in the body of the (outermost)
    while loop of a compiled HLO module that launch work: one entry per
    kernel the loop body issues each step."""
    comps, cur, name = {}, None, None
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and not line.startswith(" "):
            name, cur = m.group(1), []
            comps[name] = cur
        elif line.startswith("}"):
            cur = None
        elif cur is not None and "=" in line:
            cur.append(line)
    body = None
    for lines in comps.values():
        for ln in lines:
            m = re.search(r"\bwhile\(.*body=%?([\w.\-]+)", ln)
            if m:
                body = m.group(1)
                break
        if body:
            break
    counts: dict = {}
    for ln in comps.get(body, []):
        m = re.search(r"=\s*[^=]*?\s([a-z][a-z\-]*)\(", ln)
        if m and m.group(1) not in _NO_KERNEL:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def phase_d(card: str, nblk: int = 900, n_l1: int = 32, fs: float = 4.096e6,
            cmp_blocks: int = 200, long_code: bool = True) -> str:
    rng = np.random.default_rng(7)
    prns = list(range(1, n_l1 + 1))
    dops = rng.uniform(-4000, 4000, n_l1).round(1).tolist()
    phases = rng.uniform(0, 1023, n_l1).round(2).tolist()
    e1, cf1, step1, k1, ev1 = track_case("gps-l1", prns, fs, nblk, dops,
                                         phases, cmp_blocks=cmp_blocks)
    line = (f"D tracking gps-l1 {n_l1} ch x {nblk} blocks @ {fs / 1e6} MHz:"
            f" first-block E/P/L err {e1:.1e} of |P| (<= {EPL_TOL}), card "
            f"rows == CPU rows over {cmp_blocks} blocks (rtol {ROWS_RTOL}, "
            f"atol {ROWS_ATOL}; {ev1} chip-edge events), carrier within "
            f"{cf1:.2f} Hz; "
            f"{step1 * 1e6:.1f} us/step, {sum(k1.values())} kernels/step "
            f"{k1}")
    if long_code:
        e2, cf2, step2, k2, ev2 = track_case(
            "gps-l2cl", [7], fs, nblk, [900.0], [767200.5],
            cmp_blocks=cmp_blocks, seed=1)
        line += (f"; gps-l2cl 1 ch x {nblk} sub-blocks: E/P/L err "
                 f"{e2:.1e}, {ev2} chip-edge events, carrier within "
                 f"{cf2:.2f} Hz, "
                 f"{step2 * 1e6:.1f} us/step, {sum(k2.values())} "
                 f"kernels/step")
    return line + f" [{card}]"


# --------------------------------------------------------------- phase E
def phase_e(card: str, band_paths: dict, seconds: float,
            chunk_ms: float = 2000.0) -> str:
    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import TrackChannel
    from gnss_dsp.track.receiver import track_receiver
    from tools.run_long_receiver import BANDS, FS

    walls = []
    for _ in range(2):
        bands = []
        for b in (1, 2, 3):
            bands.append((open(band_paths[b], "rb"),
                          [get_signal(s) for s, *_ in BANDS[b]],
                          [TrackChannel(prn=p, doppler=d, code_offset=c)
                           for _, p, d, c, _co in BANDS[b]],
                          [co for *_x, co in BANDS[b]]))
        try:
            t0 = time.perf_counter()
            out = track_receiver(bands, FS, chunk_ms=chunk_ms)
            walls.append(time.perf_counter() - t0)
        finally:
            for fp, *_ in bands:
                fp.close()
    seeds = [row for b in (1, 2, 3) for row in BANDS[b]]
    fails = []
    for ch, (s, p, dop, *_r) in zip(out, seeds):
        tail = ch.rows[-100:]
        cf = float(np.median([r["carrier_f"] for r in tail]))
        pr = np.median([r["prompt"] for r in tail])
        ok = (len(ch.rows) >= 0.9 * seconds * 1000 and abs(cf - dop) <= 8.0
              and pr > np.median([r["early"] for r in tail])
              and pr > np.median([r["late"] for r in tail]))
        if not ok:
            fails.append(f"{s}:{p} rows {len(ch.rows)} carrier {cf:.2f}")
    check(not fails, f"receiver lost lock: {fails}")
    return (f"E receiver {len(seeds)} ch / 3 bands x {seconds:.2f} s @ "
            f"{FS / 1e6} MHz from disk: all locked (carrier within 8 Hz, "
            f"P > E, L); {seconds / walls[1]:.2f}x realtime warm "
            f"({walls[1]:.1f} s), {seconds / walls[0]:.2f}x incl. compile "
            f"[{card}]")


# ------------------------------------------------------------ four cards
def four_cards(card: str, n_dev: int = 4, acq_fs=None, ms: int = 80,
               dops_cfg=(-7000.0, 7000.0, 200.0), nblk: int = 900,
               n_l1: int = 32, fs: float = 4.096e6) -> list:
    """The mesh paths users run with --mesh, each against its one-card
    result on device 0."""
    import jax

    import bench
    from gnss_dsp.acquire.engine import acquire_signal
    from gnss_dsp.models import get_signal
    from gnss_dsp.parallel.acquire import acquire_signal_sharded
    from gnss_dsp.parallel.mesh import make_mesh
    from gnss_dsp.track.driver import TrackChannel, track_file

    lines = []
    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"{len(jax.devices())} devices")
    sig = get_signal("gps-l1")
    if acq_fs:
        sig = dataclasses.replace(sig, acq_fs=acq_fs)
    prns = list(range(1, 33))
    n = int(round(sig.acq_fs * 1e-3))
    x = bench.synth_sky(sig, sig.acq_fs, (ms + 2) * n)
    one = acquire_signal(sig, x, prns, doppler_search=dops_cfg, ms=ms)
    mesh = make_mesh(n_dev, devices=devs)
    t0 = time.perf_counter()
    four = acquire_signal_sharded(sig, x, prns, mesh,
                                  doppler_search=dops_cfg, ms=ms)
    t_acq = time.perf_counter() - t0
    err = max(abs(a.metric - b.metric) / a.metric for a, b in zip(one, four))
    check(all((a.doppler, a.code_offset) == (b.doppler, b.code_offset)
              for a, b in zip(one, four)) and err <= 1e-5,
          f"sharded acquisition differs (metric err {err})")
    lines.append(f"B4 sky search on a {mesh.shape['sat']}x"
                 f"{mesh.shape['time']} mesh: cells identical to one card, "
                 f"metric rel err {err:.1e} (<= 1e-5), {t_acq:.1f} s incl. "
                 f"compile [{card}]")

    rng = np.random.default_rng(7)
    tmesh = make_mesh(n_dev, time_shards=1, devices=devs)
    dops = rng.uniform(-4000, 4000, n_l1).round(1).tolist()
    phases = rng.uniform(0, 1023, n_l1).round(2).tolist()
    lsig = get_signal("gps-l1")
    secs = (nblk + 41) / 1000.0
    data, _ = track_scene("gps-l1", list(range(1, n_l1 + 1)), fs, secs,
                          dops, phases)

    def run(m):
        chans = [TrackChannel(prn=p + 1, doppler=d, code_offset=cp)
                 for p, (d, cp) in enumerate(zip(dops, phases))]
        track_file(lsig, io.BytesIO(data), fs, 0.0, chans,
                   loop_dwells=(200, 200), max_blocks=nblk, mesh=m)
        return chans

    a, b = run(None), run(tmesh)
    for ca, cb in zip(a, b):
        compare_rows(lsig, ca.rows, cb.rows, min(len(ca.rows), nblk - 2))
    lines.append(f"D4 {n_l1}-channel scan sharded over {n_dev} cards: rows "
                 f"match one card over {nblk} blocks (rtol {ROWS_RTOL}, "
                 f"atol {ROWS_ATOL}) [{card}]")

    # track multi --mesh --coherent -1: B1I (NH20, coherent) with GPS L1
    # (no overlay) in one program, channels sharded
    mix = [("beidou-b1i", 34, 400.0, 1500.6), ("gps-l1", 7, 900.0, 317.25)]
    mfs = 8.192e6
    nm = int(mfs * 0.3)
    xm = np.zeros(nm, np.complex64)
    from gnss_dsp.utils import synth

    for name, p, d, cp in mix:
        s = get_signal(name)
        bits = (np.asarray(s.secondary(p), np.float64)
                if s.secondary is not None else None)
        xm += synth.synth_iq(s.code_table((p,))[0].astype(np.float64),
                             s.chip_rate, mfs, nm, doppler_hz=d,
                             code_phase=cp, cn0_dbhz=None,
                             carrier_ratio=s.track_carrier_ratio(p),
                             data_bits=bits)
    mdata = synth.to_int8_iq(xm, scale=24.0)
    sigs = [get_signal(nme) for nme, *_ in mix]

    def run_mix(m):
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp in mix]
        track_file(sigs[0], io.BytesIO(mdata), mfs, 0.0, chans,
                   loop_dwells=(8, 8), max_blocks=200, sigs=sigs,
                   coherent_blocks=-1, mesh=m)
        return chans

    a, b = run_mix(None), run_mix(tmesh)
    for (name, *_r), ca, cb in zip(mix, a, b):
        compare_rows(get_signal(name), ca.rows, cb.rows,
                     min(len(ca.rows), 180))
    used = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in devs]
    check(devs[0].platform != "gpu" or all(u > 0 for u in used),
          f"idle devices: {used}")
    lines.append(f"M4 track multi --mesh --coherent -1 (B1I NH20 + GPS L1) "
                 f"over {n_dev} cards: rows match one card; peak bytes per "
                 f"card {[int(u) for u in used]} [{card}]")
    return lines


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths, on four cards")
    ap.add_argument("--phases", default="ABCDEF",
                    help="subset of the one-card phases (default ABCDEF)")
    args = ap.parse_args(argv)
    phases = set(args.phases.replace(",", "").upper())

    import gnss_dsp  # noqa: F401  (fails outside a checkout of the repo)

    cards = query_cards()
    for ln in cards:
        print(ln, flush=True)
    card = cards[0]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(args, phases, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, phases, card: str, work: str) -> int:
    failed = []

    def attempt(name, fn, *a):
        """Run one phase; a failure is reported and remembered, and the
        remaining phases still run."""
        try:
            out = fn(*a)
        except Exception as e:  # noqa: BLE001 — reported, then exit != 0
            import traceback

            traceback.print_exc()
            failed.append(name)
            print(f"{name} FAILED: {type(e).__name__}: {str(e)[:2000]}",
                  flush=True)
            return
        for ln in ([out] if isinstance(out, str) else out):
            print(ln, flush=True)

    if not args.four_cards and "F" in phases:
        attempt("F", phase_f, card)
    capture = os.path.join(work, "sky.pcap")
    band_paths, e_seconds = None, 2.2
    if not args.four_cards:
        # synthesize before this process opens the card (the pool's
        # workers are spawned fresh and never touch it)
        t0 = time.perf_counter()
        if "C" in phases:
            synth_capture(capture, 120, SYNTH_WORKERS)
        if "E" in phases:
            band_paths = synth_bands(work, int(e_seconds * 1000),
                                     SYNTH_WORKERS)
        print(f"(synthesized captures in {time.perf_counter() - t0:.1f} s)",
              flush=True)

    import jax

    from gnss_dsp.cli import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 2
    if args.four_cards:
        attempt("four-cards", four_cards, card)
    else:
        if "A" in phases:
            attempt("A", phase_a, card, cache_dir)
        if "B" in phases:
            attempt("B", phase_b, card)
        if "C" in phases:
            attempt("C", phase_c, card, work, capture)
        if "D" in phases:
            attempt("D", phase_d, card)
        if "E" in phases:
            attempt("E", phase_e, card, band_paths, e_seconds)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
