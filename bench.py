"""Benchmark suite, one JSON line per workload.

Headline (printed LAST): GPS L1 C/A full sky search: 32 PRNs x 70
doppler bins (+-7 kHz / 200 Hz) x 80 non-coherent 1-ms blocks at the
reference's 4.096 MHz internal rate (n = 4096 code-phase bins) — the
exact grid acquire-gps-l1.py searches over a process pool — measured in
steady state: one dispatch scans 16 successive 80-ms epochs of the
capture (each a full independent search on its own slice).
vs_baseline = ratio to the reference algorithm (reference_search, numpy
FFT path) measured live on this host's CPU, single core.

Sub-metric lines (printed first): acquisition search-cells/s per engine
shape through the production paths, each asserting the planted peak
wins; tracking Msamples/s per family, asserting carrier convergence;
the band-1 receiver's realtime multiple.

Every line is {"metric", "value", "unit", "vs_baseline"}.  The plain
numpy references used by chip_smoke.py and the tests live here too:
reference_search (acquire-gps-l1.py search()) and
reference_search_coherent (acquire/coherent.py's formula).
"""

from __future__ import annotations

import json
import time

import numpy as np


def synth_sky(sig, fs: float, n: int) -> np.ndarray:
    """A few live PRNs + noise, so the search has real peaks to find."""
    from gnss_dsp.utils.synth import synth_iq

    rng = np.random.default_rng(7)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in ((5, 2400.0, 101.25), (12, -3800.0, 512.0),
                         (21, 900.0, 887.5)):
        code = sig.code_table((prn,))[0]
        x += synth_iq(code, sig.chip_rate, fs, n, doppler_hz=dop,
                      code_phase=cp, cn0_dbhz=None,
                      subcarrier=sig.subcarrier,
                      carrier_ratio=sig.carrier_ratio)
    x += (0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    return x


def bench_sky_search(sig, x, prns, dops_cfg, ms, segments: int):
    """Sustained streaming search: one dispatch scans `segments`
    successive `ms`-block epochs of the capture (a continuous receiver's
    steady state), each epoch a full independent PRN x doppler x
    code-phase x block search on its own slice of x."""
    import jax as _jax
    import jax.numpy as jnp

    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.ops import cplx

    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = n
    blocks = ms
    dops, fixed = eng.doppler_grid(sig, dops_cfg)
    D = len(dops)
    dop_chunk = 70

    # the planted-PRN assert in main re-validates cells every bench run
    code_ffts = cplx.from_numpy(eng.build_code_ffts(sig, prns, n, window))
    xs = cplx.from_numpy(x)
    fixed_j = jnp.asarray(fixed)
    valid_j = jnp.ones(D, bool)
    seg_len = blocks * n                 # (blocks-1)*n + window

    @_jax.jit
    def run_all(x0, x1, cf0, cf1, fj, vj):
        def seg_body(_, s):
            xseg = (
                _jax.lax.dynamic_slice(x0, (s * seg_len,), (seg_len,)),
                _jax.lax.dynamic_slice(x1, (s * seg_len,), (seg_len,)),
            )
            out = eng.grid_search(
                xseg, (cf0, cf1), fj, vj, n=n, window=window,
                blocks=blocks, peak_mean=True, dop_chunk=dop_chunk,
                precision=_jax.lax.Precision.DEFAULT,
            )
            return 0, out
        _, (m, ci, di) = _jax.lax.scan(seg_body, 0, jnp.arange(segments))
        # one stacked f32 result; ci < W and di < D are exact f32
        return jnp.stack([m, ci.astype(jnp.float32),
                          di.astype(jnp.float32)], axis=1)

    args = (xs[0], xs[1], code_ffts[0], code_ffts[1], fixed_j, valid_j)
    out = np.asarray(run_all(*args))                    # compile + warmup
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        out = _jax.block_until_ready(run_all(*args))
        best = min(best, (time.perf_counter() - t0) / segments)
    out = np.asarray(out)
    cells = len(prns) * D * window * blocks
    return cells / best, (out[:, 0], out[:, 1].astype(np.int32),
                          out[:, 2].astype(np.int32)), dops, n


def _fft_mod(threads: bool = True):
    """scipy.fft (multi-threaded) where installed, else numpy.fft."""
    if threads:
        try:
            import scipy.fft as f

            return f, {"workers": -1}
        except ImportError:
            pass
    return np.fft, {}


def reference_search(sig, x, prns, dops, ms: int, threads: bool = True):
    """Float64 numpy transcription of the reference search() loop
    (acquire-gps-l1.py:18-40) for circular-window signals: per doppler
    bin, wipe each 1-period block with the reference's LUT oscillator
    (restarted at every block) at the bin's 32-bit fixed-point
    frequency (the engine's NCO increment, within 2**-32 cycles/sample
    of -dop/fs), then ms x (FFT -> multiply with the conjugated code FFT
    -> IFFT -> |.| accumulate); peak/mean or raw peak per the signal's
    metric.

    Returns per-PRN (metric [P], code_idx [P], dop_idx [P]) — the best
    cell over `dops` (Hz), first maximum on ties."""
    from gnss_dsp.models.codes import resample_host
    from gnss_dsp.ops import nco as nco_ops

    fft, kw = _fft_mod(threads)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    assert not (sig.acq_pad2 or sig.acq_sliding), sig.name
    fs = sig.acq_fs
    incr = sig.code_length / n
    C = fft.fft(np.stack([resample_host(sig.code_table((p,))[0], 0, 0,
                                        incr, n) for p in prns]),
                axis=-1, **kw)                                  # [P, n]
    xb = np.asarray(x[: n * ms], np.complex128).reshape(ms, n)
    best = np.full(len(prns), -np.inf)
    code_idx = np.zeros(len(prns), np.int64)
    dop_idx = np.zeros(len(prns), np.int64)
    for di, dop in enumerate(dops):
        f = (nco_ops.freq_to_fixed(-dop / fs) % 2**32) / 2**32
        w = nco_ops.nco_host(f, 0, n)
        X = np.conj(fft.fft(xb * w, axis=-1, **kw))             # [ms, n]
        q = np.abs(fft.ifft(C[:, None, :] * X[None], axis=-1,
                            **kw)).sum(axis=1)                  # [P, n]
        idx = q.argmax(axis=-1)
        peak = q[np.arange(len(prns)), idx]
        metric = (peak / q.mean(axis=-1) if sig.acq_metric == "peak_mean"
                  else peak)
        upd = metric > best
        best = np.where(upd, metric, best)
        code_idx = np.where(upd, idx, code_idx)
        dop_idx = np.where(upd, di, dop_idx)
    return best, code_idx, dop_idx


def reference_search_coherent(x, code_ffts, dops_cycles, n: int,
                              window: int, blocks: int, m_coh: int, secs):
    """Float64 numpy oracle of the extended-coherent search formula
    (acquire/coherent.py module docstring):

        q[p, d, w] = max_a sum_g | sum_m s_p[(a+m) mod N] rot_d(m) R[g*M+m] |

    with R the per-block complex correlations ifft(C conj(F)) of the
    stride-n, `window`-long block windows wiped by each bin's LUT
    oscillator, and rot_d(m) = exp(-2 pi i m n d) the constant residual
    rotation of a wipe restarted at every block.

    code_ffts: complex [P, window]; dops_cycles: cycles/sample per bin
    (the engine's fixed-point increments / 2**32); secs: one overlay per
    PRN (or one shared).  Returns per-PRN (metric, code_idx, dop_idx,
    align) — best over bins, first maximum on ties."""
    from gnss_dsp.ops import nco as nco_ops

    fft, kw = _fft_mod()
    P = code_ffts.shape[0]
    G = blocks // m_coh
    secs = [np.asarray(s, np.float64) for s in secs]
    secs = secs * P if len(secs) == 1 else secs
    N = len(secs[0])
    idx = (np.arange(blocks)[:, None] * n + np.arange(window)[None, :])
    xb = np.asarray(x, np.complex128)[idx]                      # [B, W]
    m_loc = np.arange(blocks) % m_coh
    wts = np.stack([s[(np.arange(N)[:, None] + m_loc[None, :]) % N]
                    for s in secs])                             # [P, A, B]
    best = np.full(P, -np.inf)
    out = np.zeros((3, P), np.int64)
    for di, f in enumerate(dops_cycles):
        F = fft.fft(xb * nco_ops.nco_host(f, 0, window), axis=-1, **kw)
        R = fft.ifft(code_ffts[:, None, :] * np.conj(F)[None], axis=-1,
                     **kw)                                      # [P, B, W]
        rot = np.exp(-2j * np.pi * ((f * n) % 1.0) * np.arange(blocks))
        q = np.zeros((P, N, window))
        for g in range(G):
            sl = slice(g * m_coh, (g + 1) * m_coh)
            q += np.abs(np.einsum("pam,pmw->paw",
                                  wts[:, :, sl] * rot[sl], R[:, sl]))
        a_idx = q.argmax(axis=1)                                # [P, W]
        qa = q.max(axis=1)
        ci = qa.argmax(axis=-1)
        peak = qa[np.arange(P), ci]
        upd = peak > best
        best = np.where(upd, peak, best)
        out[0] = np.where(upd, ci, out[0])
        out[1] = np.where(upd, di, out[1])
        out[2] = np.where(upd, a_idx[np.arange(P), ci], out[2])
    return best, out[0], out[1], out[2]


def bench_reference_numpy(sig, x, ms) -> float:
    """Single-core rate of reference_search, timed on 1 PRN x 8 bins
    and scaled by cells."""
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    dops = np.arange(-800.0, 800.0, 200.0)
    t0 = time.perf_counter()
    reference_search(sig, x, (1,), dops, ms, threads=False)
    dt = time.perf_counter() - t0
    return 1 * len(dops) * n * ms / dt


def bench_acquire_signal(name, prn, prns, dops, ms, subcarrier="none"):
    """One-shot acquisition through the production engine path (the
    2nd rep: compiled, device-resident), planted-peak asserted."""
    from gnss_dsp.acquire.engine import (
        acquire_signal, acquire_signal_fdma, doppler_grid, _block_count,
    )
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _block_count(sig, ms)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs,
                 int(sig.acq_fs * (ms + 4) / 1000), doppler_hz=1500.0,
                 code_phase=100.0, cn0_dbhz=45.0, subcarrier=subcarrier,
                 carrier_ratio=sig.track_carrier_ratio(0),
                 code_doppler_hz=1500.0, rng=np.random.default_rng(3))
    run = acquire_signal_fdma if sig.fdma_hz else acquire_signal
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        res = run(sig, x, prns, doppler_search=dops, ms=ms)
        if rep:
            dt = min(dt, time.perf_counter() - t0)
    hit = [r for r in res if r.prn == prn][0]
    assert abs(hit.doppler - 1500.0) <= dops[2], (name, hit)
    assert all(r.metric <= hit.metric for r in res), (name, hit)
    D = len(np.arange(*dops))
    cells = len(prns) * D * window * blocks
    return {
        "metric": f"{name.replace('-', '_')}_acq_cells_per_s",
        "value": round(cells / dt, 1),
        "unit": f"search-cells/s ({len(prns)} sat x {D} dop x {window}"
                f" x {blocks} blk, one-shot engine)",
        "vs_baseline": None,
    }


def bench_acquire_sustained(name, prns, dops_cfg, ms, segments=8):
    """Sustained streaming rate of one signal's search: one dispatch
    scans `segments` independent epochs (lax.scan), one stacked readback
    — same methodology as bench_sky_search, for any window shape."""
    import jax as _jax
    import jax.numpy as jnp

    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.models import get_signal
    from gnss_dsp.ops import cplx

    sig = get_signal(name)
    fs = sig.acq_fs
    n = int(round(fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = eng._block_count(sig, ms)
    dops, fixed = eng.doppler_grid(sig, dops_cfg)
    D = len(dops)

    code_ffts = cplx.from_numpy(eng.build_code_ffts(sig, prns, n, window))
    seg_len = blocks * n
    x = synth_sky(sig, fs, segments * seg_len + window)
    xs = cplx.from_numpy(x)
    per_dc = len(prns) * blocks * window * 16
    dop_chunk = int(np.clip(1.2e9 // per_dc, 1, D))
    Dp = -(-D // dop_chunk) * dop_chunk
    fj = jnp.asarray(np.pad(np.asarray(fixed, np.int32), (0, Dp - D)))
    vj = jnp.asarray(np.arange(Dp) < D)
    kw = dict(n=n, window=window, blocks=blocks,
              peak_mean=(sig.acq_metric == "peak_mean"),
              dop_chunk=dop_chunk, precision=_jax.lax.Precision.DEFAULT)

    @_jax.jit
    def run_all(x0, x1, cf0, cf1):
        def seg_body(_, s):
            xseg = (_jax.lax.dynamic_slice(x0, (s * seg_len,),
                                           (seg_len + window,)),
                    _jax.lax.dynamic_slice(x1, (s * seg_len,),
                                           (seg_len + window,)))
            m, ci, di = eng.grid_search(xseg, (cf0, cf1), fj, vj, **kw)
            return 0, jnp.stack([m, ci.astype(jnp.float32),
                                 di.astype(jnp.float32)], axis=0)
        _, out = _jax.lax.scan(seg_body, 0, jnp.arange(segments))
        return out

    args = (xs[0], xs[1], code_ffts[0], code_ffts[1])
    out = np.asarray(run_all(*args))
    for s in range(segments):     # planted PRNs win every epoch
        top = set(int(p) for p in np.argsort(out[s, 0])[-3:] + 1)
        assert top == {5, 12, 21}, (name, s, top)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        _jax.block_until_ready(run_all(*args))
        best = min(best, (time.perf_counter() - t0) / segments)
    cells = len(prns) * D * window * blocks
    return {
        "metric": f"{name.replace('-', '_')}_acq_cells_per_s_sustained",
        "value": round(cells / best, 1),
        "unit": f"search-cells/s sustained ({len(prns)} sat x {D} dop x "
                f"{window} x {blocks} blk, {segments} epochs/dispatch)",
        "vs_baseline": None,
    }


def bench_acquire_sustained_fdma(name="glonass-l1", segments=8,
                                 dops_cfg=(-7000.0, 7000.0, 200.0), ms=80):
    """Sustained one-program GLONASS FDMA search rate: all 15 channels'
    doppler bands in a single grid (one shared m-sequence code row, each
    channel's band one doppler chunk — acquire_signal_fdma's layout,
    acquire-glonass-l1.py:28 semantics), streamed over `segments` epochs
    per dispatch with one stacked readback."""
    import jax as _jax
    import jax.numpy as jnp

    from gnss_dsp.acquire import engine as eng
    from gnss_dsp.models import get_signal
    from gnss_dsp.ops import cplx
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal(name)
    fs = sig.acq_fs
    chans = list(range(-7, 8))
    n = int(round(fs * sig.acq_coherent_ms / 1000.0))
    window = n
    blocks = eng._block_count(sig, ms)
    dops_all, fixed_all = [], []
    for chan in chans:
        dops, fixed = eng.doppler_grid(sig, dops_cfg, chan)
        dops_all.append(dops)
        fixed_all.append(fixed)
    D = len(dops_all[0])
    fixed_p = jnp.asarray(np.concatenate(fixed_all).astype(np.int32))
    valid = jnp.ones(len(chans) * D, bool)

    code_ffts = cplx.from_numpy(eng.build_code_ffts(sig, (0,), n, window))
    seg_len = blocks * n
    ntot = segments * seg_len + window
    rng = np.random.default_rng(7)
    x = np.zeros(ntot, np.complex64)
    planted = ((-3, 2400.0, 101.25), (2, -3800.0, 312.0), (6, 900.0, 87.5))
    code = sig.code_table((0,))[0]
    for chan, dop, cp in planted:
        x += synth_iq(code, sig.chip_rate, fs, ntot,
                      doppler_hz=sig.fdma_hz * chan + dop, code_phase=cp,
                      cn0_dbhz=None, code_doppler_hz=dop,
                      carrier_ratio=sig.carrier_ratio)
    x += (0.5 * (rng.standard_normal(ntot) + 1j * rng.standard_normal(ntot))
          ).astype(np.complex64)
    xs = cplx.from_numpy(x)
    kw = dict(n=n, window=window, blocks=blocks,
              peak_mean=(sig.acq_metric == "peak_mean"), dop_chunk=D,
              precision=_jax.lax.Precision.DEFAULT, per_chunk=True)

    @_jax.jit
    def run_all(x0, x1, cf0, cf1):
        def seg_body(_, s):
            xseg = (_jax.lax.dynamic_slice(x0, (s * seg_len,),
                                           (seg_len + window,)),
                    _jax.lax.dynamic_slice(x1, (s * seg_len,),
                                           (seg_len + window,)))
            m, ci, di = eng.grid_search(xseg, (cf0, cf1), fixed_p, valid,
                                        **kw)
            return 0, jnp.stack([m[:, 0], ci[:, 0].astype(jnp.float32),
                                 di[:, 0].astype(jnp.float32)], axis=0)
        _, out = _jax.lax.scan(seg_body, 0, jnp.arange(segments))
        return out

    args = (xs[0], xs[1], code_ffts[0], code_ffts[1])
    out = np.asarray(run_all(*args))
    want = {chans.index(c) for c, _, _ in planted}
    for s in range(segments):     # planted channels win every epoch
        top = set(int(i) for i in np.argsort(out[s, 0])[-3:])
        assert top == want, (s, top, want)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        _jax.block_until_ready(run_all(*args))
        best = min(best, (time.perf_counter() - t0) / segments)
    cells = len(chans) * D * window * blocks
    return {
        "metric": "glonass_l1_fdma_acq_cells_per_s_sustained",
        "value": round(cells / best, 1),
        "unit": f"search-cells/s sustained ({len(chans)} chan x {D} dop x "
                f"{window} x {blocks} blk, one program, {segments} "
                "epochs/dispatch)",
        "vs_baseline": None,
    }


# Single-core CPU baselines of the reference algorithms, recorded on an
# x86 development host: the reference's numpy-FFT acquisition hot loop
# (the loop is FFT-bound, with or without numba) and the
# vectorized-numpy stand-ins for its mix_/correlate tracking kernels
# (tools/baseline_track_numpy.py).  Used as the vs_baseline denominator
# for the sub-metrics; the headline re-measures its own denominator
# live each run.
_CPU_ACQ_CELLS_S = 7.9e6
# Per-FAMILY tracking denominators: each family's vectorized-numpy
# baseline mirrors its own reference correlate semantics (CBOC/TMBOC/RZ
# subcarrier recurrences, long-code gather tables, overlay-wiped
# coherent accumulation), best of >= 3 runs
# (tools/baseline_track_numpy.py).
_CPU_TRACK_SAMPLES_S_FAMILY = {
    "gps-l1": 28.6e6,
    "beidou-b1i": 30.3e6,
    "galileo-e1b": 3.2e6,
    "gps-l1cp": 3.0e6,
    "gps-l2cm": 9.1e6,
    "gps-l2cl": 8.9e6,
    "glonass-l1-p": 25.2e6,
    "beidou-b1i-coh": 30.8e6,
    # the 2017 workload's NATIVE 69.984 MHz rate: the 1 ms blocks are
    # 69984 samples, so the vectorized-numpy baseline falls out of L2
    # (1.1 MB complex128 per temporary) — best-of-3 measured
    "gps-l1-hr": 19.1e6,
}
_CPU_TRACK_SAMPLES_S = _CPU_TRACK_SAMPLES_S_FAMILY["gps-l1"]


def bench_acquire_coherent(name="gps-l5i", m_coh=None,
                           dops_cfg=(-7000.0, 7000.0, 200.0)):
    """Extended-coherent acquisition cost (the sensitivity feature,
    acquire/coherent.py): full 32-PRN grid with NH-overlay wipeoff over
    all alignments, planted-peak asserted (the hardware-validated L5I
    NH10 case).  One-shot engine latency, 2nd rep."""
    from gnss_dsp.acquire.coherent import acquire_signal_coherent
    from gnss_dsp.models import get_signal
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal(name)
    sec = np.asarray(sig.secondary(1), np.float64)
    m = m_coh or len(sec)
    ms = int(2 * m * sig.acq_coherent_ms)
    n_samp = int(sig.acq_fs * (ms + 4) / 1000)
    x = synth_iq(sig.code_table((25,))[0], sig.chip_rate, sig.acq_fs,
                 n_samp, doppler_hz=1500.0, code_phase=100.0,
                 cn0_dbhz=38.0, carrier_ratio=sig.track_carrier_ratio(0),
                 code_doppler_hz=1500.0, data_bits=sec,
                 rng=np.random.default_rng(3))
    prns = list(range(1, 33))
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        res = acquire_signal_coherent(sig, x, prns, dops_cfg, m_coh=m,
                                      ms=ms)
        if rep:
            dt = min(dt, time.perf_counter() - t0)
    hit = [r for r in res if r.prn == 25][0]
    assert abs(hit.doppler - 1500.0) <= dops_cfg[2], (name, hit)
    assert all(r.metric <= hit.metric for r in res), (name, hit)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    D = len(np.arange(*dops_cfg))
    blocks = int(ms / sig.acq_coherent_ms)
    cells = len(prns) * D * n * blocks
    return {
        "metric": f"{name.replace('-', '_')}_coherent_acq_cells_per_s",
        "value": round(cells / dt, 1),
        "unit": f"search-cells/s ({len(prns)} sat x {D} dop x {n} x "
                f"{blocks} blk, {m}-period coherent with {len(sec)}-chip "
                "overlay wipeoff over all alignments, one-shot engine)",
        "vs_baseline": round(cells / dt / _CPU_ACQ_CELLS_S, 2),
    }


def bench_acquire_coherent_sustained(name="gps-l5i", segments=6,
                                     dops_cfg=(-7000.0, 7000.0, 200.0),
                                     nprn=32, plant=25, reps=5):
    """Steady-state rate of the extended-coherent engine: same
    multi-epoch one-dispatch methodology as bench_acquire_sustained.
    The planted PRN (on-bin doppler — the grid scallops a long coherent
    span, so off-bin plants are a sensitivity test, not a perf one) must
    win every epoch.  Per-PRN secondaries (CS100-class) get per-PRN
    overlays in the combine.

    Cells count the EVALUATED window lags (2n for pad2/sliding signals);
    the unit also states the reference-circular (n-lag) rate."""
    import jax as _jax
    import jax.numpy as jnp

    from gnss_dsp.acquire import coherent as coh, engine as eng
    from gnss_dsp.models import get_signal
    from gnss_dsp.ops import cplx
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal(name)
    prns = list(range(1, nprn + 1))
    secs = [np.asarray(sig.secondary(p), np.float64) for p in prns]
    per_prn = any(not np.array_equal(s, secs[0]) for s in secs[1:])
    sec = secs[prns.index(plant)]
    m = N = len(sec)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    ms = int(2 * m * sig.acq_coherent_ms)
    blocks = int(ms / sig.acq_coherent_ms)
    dops, fixed = eng.doppler_grid(sig, dops_cfg)
    D = len(dops)
    per_dc = len(prns) * (blocks // m) * N * window * 32
    dop_chunk = int(np.clip(1.2e9 // per_dc, 1, D))
    Dp = -(-D // dop_chunk) * dop_chunk
    fixed_p = np.zeros(Dp, np.int32)
    fixed_p[:D] = fixed
    valid_p = np.zeros(Dp, bool)
    valid_p[:D] = True
    seg_len = blocks * n
    x = synth_iq(sig.code_table((plant,))[0], sig.chip_rate, sig.acq_fs,
                 segments * seg_len + 2 * n, doppler_hz=1400.0,
                 code_phase=100.0, cn0_dbhz=42.0,
                 carrier_ratio=sig.track_carrier_ratio(0),
                 code_doppler_hz=1400.0, data_bits=sec,
                 rng=np.random.default_rng(3))
    xs = cplx.from_numpy(x)
    cf = cplx.from_numpy(eng.build_code_ffts(sig, prns, n, window))
    sec_mat = jnp.asarray(coh.overlay_matrix(secs if per_prn else [sec],
                                             blocks, m))
    fj = jnp.asarray(fixed_p)
    vj = jnp.asarray(valid_p)
    kw = dict(n=n, window=window, blocks=blocks, m_coh=m,
              dop_chunk=dop_chunk)

    @_jax.jit
    def run_all(x0, x1, cf0, cf1, sm):
        def seg_body(_, s):
            xseg = (_jax.lax.dynamic_slice(x0, (s * seg_len,),
                                           (seg_len + 2 * n,)),
                    _jax.lax.dynamic_slice(x1, (s * seg_len,),
                                           (seg_len + 2 * n,)))
            mt, ci, di, al = coh.grid_search_coherent(
                xseg, (cf0, cf1), fj, vj, sm, **kw)
            return 0, jnp.stack([mt, ci.astype(jnp.float32),
                                 di.astype(jnp.float32),
                                 al.astype(jnp.float32)], 0)
        _, out = _jax.lax.scan(seg_body, 0, jnp.arange(segments))
        return out

    args = (xs[0], xs[1], cf[0], cf[1], sec_mat)
    out = np.asarray(run_all(*args))
    pi = prns.index(plant)
    # the planted code drifts at code_doppler/ratio chips/s — long
    # (CS100) segments move a few chips between epochs
    drift = (blocks * sig.acq_coherent_ms / 1000.0
             * 1400.0 / sig.track_carrier_ratio(0))
    for s in range(segments):
        assert np.argmax(out[s, 0]) == pi, (s, np.argmax(out[s, 0]))
        code = float(out[s, 1, pi]) * sig.code_length / n % sig.code_length
        assert abs(code - (100.0 + s * drift)) < 2.0, (s, code)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _jax.block_until_ready(run_all(*args))
        best = min(best, (time.perf_counter() - t0) / segments)
    cells = len(prns) * D * window * blocks
    ref_cells = len(prns) * D * n * blocks
    return {
        "metric": f"{name.replace('-', '_')}"
                  "_coherent_acq_cells_per_s_sustained",
        "value": round(cells / best, 1),
        "unit": f"search-cells/s sustained ({len(prns)} sat x {D} dop x "
                f"{window} evaluated window lags x {blocks} blk; "
                f"= {ref_cells / best / 1e9:.2f} Gcells/s over the "
                f"reference's n={n} circular lags — {m}-period coherent, "
                f"{N}-chip {'per-PRN ' if per_prn else ''}overlay x all "
                f"alignments, {segments} epochs/dispatch)",
        "vs_baseline": round(cells / best / _CPU_ACQ_CELLS_S, 2),
    }


def bench_tracking_family(name, NB=900):
    """Per-family tracking rate (tools/bench_track_families):
    subcarrier, sub-block and long-code engine shapes each get a
    sustained number."""
    import os
    import sys

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_track_families import FAMILIES, bench_family

    rate = bench_family(name, NB=NB, repeats=2, quiet=True)
    from gnss_dsp.models import get_signal

    sig = get_signal(name)
    fs, cmax = FAMILIES[name]
    shape = f"{sig.subcarrier} sub={sig.sub_blocks} L={sig.code_length}"
    denom = _CPU_TRACK_SAMPLES_S_FAMILY[name]
    return {
        "metric": f"{name.replace('-', '_')}_tracking_msamples_per_s",
        "value": round(rate, 1),
        "unit": f"Msamples/s aggregate ({cmax} ch x {NB} sub-blocks, "
                f"{shape}; vs this family's own "
                f"CPU semantics at {denom / 1e6:.1f} Msamples/s)",
        "vs_baseline": round(rate * 1e6 / denom, 2),
    }


def bench_tracking(C=32, NB=900):
    """GPS L1 tracking throughput (track_scan), convergence-asserted."""
    import jax
    import jax.numpy as jnp

    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state, track_scan
    from gnss_dsp.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    fs = 4.096e6
    rng = np.random.default_rng(3)
    prns = (1 + np.arange(C) % 32).tolist()
    dops = rng.uniform(-4000, 4000, C).round(1)
    phases = rng.uniform(0, 1023, C).round(2)
    n = int(NB * fs * 0.001) + 8192
    code_np = sig.code_table(tuple(prns)).astype(np.int8)
    x = np.zeros(n, np.complex64)
    for k in range(8):
        x += synth_iq(code_np[k].astype(np.float64), sig.chip_rate, fs, n,
                      doppler_hz=float(dops[k]), code_phase=float(phases[k]),
                      cn0_dbhz=None, carrier_ratio=1540.0
                      ).astype(np.complex64)
    x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64) * 0.1
    params = make_params(sig, fs, coffset=0.0, loop_dwells=(200, 200))
    tail = params.nmax + (-(n + params.nmax)) % 1024
    xp = np.concatenate([x, np.zeros(tail, np.complex64)])
    xd = (jnp.asarray(np.ascontiguousarray(xp.real.astype(np.float32))),
          jnp.asarray(np.ascontiguousarray(xp.imag.astype(np.float32))))
    tab = jnp.asarray(code_np)
    args = dict(ratios=jnp.full((C,), 1540.0, jnp.float32),
                coffset_df=jnp.zeros((C,), jnp.int32))
    best = np.inf
    for rep in range(3):
        st = init_state(code_p=phases, code_f_off=np.zeros(C),
                        carrier_p=np.zeros(C), carrier_f=dops,
                        ptr=np.zeros(C, np.int32))
        t0 = time.perf_counter()
        _, rf, ri = jax.block_until_ready(
            track_scan(xd, jnp.int32(n), tab, st, params, NB, **args))
        if rep:
            best = min(best, time.perf_counter() - t0)
    rf = np.asarray(rf)
    cf_tail = np.nanmedian(rf[-50:, :8, 3], axis=0)
    assert np.abs(cf_tail - dops[:8]).max() < 5.0, cf_tail
    samples = float(np.asarray(ri)[..., 0].sum())
    return {
        "metric": "gps_l1_tracking_msamples_per_s",
        "value": round(samples / best / 1e6, 1),
        "unit": f"Msamples/s aggregate ({C} channels x {NB} blocks)",
        "vs_baseline": None,
    }


def bench_tracking_native_rate(NB=2000):
    """BPSK tracking at the 2017 workload's NATIVE 69.984 MHz rate
    (tools/bench_receiver_scan.py): 12 GPS L1 channels, one program,
    device-resident input — the RATE complement of the receiver_band1
    row (which runs the full streaming path and asserts locks on planted
    seeds)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    import bench_receiver_scan as brs

    best = brs.run_one("bench", [("gps-l1", 1 + k) for k in range(12)],
                       NB, reps=3, quiet=True)
    rate = 12 * brs.FS * (NB * 1e-3) / best / 1e6
    denom = _CPU_TRACK_SAMPLES_S_FAMILY["gps-l1-hr"]
    return {
        "metric": "gps_l1_tracking_msamples_per_s_native_rate",
        "value": round(rate, 1),
        "unit": f"Msamples/s aggregate (12 ch x {NB} blocks @ 69.984 "
                f"MHz — the workload's native rate; vs the same-rate "
                f"CPU semantics at "
                f"{denom / 1e6:.1f} Msamples/s)",
        "vs_baseline": round(rate * 1e6 / denom, 2),
    }


def bench_receiver_band1(seconds=1.0):
    """Sustained mixed-constellation receiver on real-rate data: 1 s of
    the 69.984 MHz sky band 1 (GPS L1 + GLONASS L1 + Galileo E1B +
    BeiDou B1I golden seeds, tools/synth_sky.py) tracked by ONE `track
    multi` program through the full streaming CLI path.  Reports the
    scan-side realtime multiple (scan+rows wall vs capture duration; the
    upload is measured separately by the GNSS_DSP_TIMING split and
    excluded).  All 4 channels must end locked to their seed
    dopplers."""
    import contextlib
    import io as _io
    import os
    import re
    import tempfile

    import sys as _sys

    sys_path0 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tools")
    if sys_path0 not in _sys.path:
        _sys.path.insert(0, sys_path0)
    from synth_sky import FRAME, FS, SEEDS, synth_band_chunk
    from gnss_dsp.cli.track import main_multi

    ms = int(seconds * 1000)
    n = ms * FRAME
    rng = np.random.default_rng([20170427, 1, 0])
    sigma = np.sqrt(FS / (2.0 * 10 ** 5.0))
    x = synth_band_chunk(1, 0, n, rng, sigma)
    raw = np.empty(2 * n, np.int8)
    scale = 100.0 / (4.0 * sigma)
    raw[0::2] = np.clip(np.round(x.real * scale), -127, 127).astype(np.int8)
    raw[1::2] = np.clip(np.round(x.imag * scale), -127, 127).astype(np.int8)
    with tempfile.NamedTemporaryFile(suffix=".iq", delete=False) as f:
        f.write(raw.tobytes())
        path = f.name
    spec = ",".join(f"{s}:{p}:{d}:{c}:{co}"
                    for b, s, p, d, c, co in SEEDS if b == 1)
    argv = ["--chunk-ms", "1000", path, str(int(FS)), "0", spec]
    os.environ["GNSS_DSP_TIMING"] = "1"
    try:
        best_scan = float("inf")
        for rep in range(2):
            out, err = _io.StringIO(), _io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main_multi(argv)
            assert rc in (0, None)
            m = re.search(r"scan\+rows (\d+\.\d+) s", err.getvalue())
            best_scan = min(best_scan, float(m.group(1)))
    finally:
        os.environ.pop("GNSS_DSP_TIMING", None)
        os.unlink(path)
    per = {}
    for line in out.getvalue().splitlines():
        key, rest = line.split(" ", 1)
        per.setdefault(key, []).append(rest.split())
    nch = 0
    for b, s, p, d, c, co in SEEDS:
        if b != 1:
            continue
        nch += 1
        tail = per[f"{s}:{p}"][-100:]
        cf = float(np.median([float(t[3]) for t in tail]))
        assert abs(cf - d) < 8.0, (s, p, cf, d)
    mult = seconds / best_scan
    agg = nch * FS * mult
    return {
        "metric": "receiver_band1_device_realtime_x",
        "value": round(mult, 2),
        "unit": f"x realtime, device-side ({nch} mixed-constellation "
                f"channels @ {FS/1e6} MHz in one program over "
                f"{seconds:.0f} s of band-1 sky; aggregate "
                f"{agg/1e6:.0f} Msamples/s)",
        "vs_baseline": round(agg / _CPU_TRACK_SAMPLES_S, 2),
    }


def _fill_acq_baseline(row):
    row["vs_baseline"] = round(row["value"] / _CPU_ACQ_CELLS_S, 2)
    return row


def _fill_track_baseline(row):
    row["vs_baseline"] = round(row["value"] * 1e6 / _CPU_TRACK_SAMPLES_S, 2)
    return row


def main():
    from gnss_dsp.cli import enable_compilation_cache
    from gnss_dsp.models import get_signal

    enable_compilation_cache()
    lines = []
    # --- one-shot engine rows (regression tripwires, full CLI path cost)
    lines.append(_fill_acq_baseline(bench_acquire_signal(
        "beidou-b1i", 34, list(range(1, 38)), (-7000.0, 7000.0, 200.0), 80)))
    lines.append(_fill_acq_baseline(bench_acquire_signal(
        "gps-l5i", 25, list(range(1, 33)), (-7000.0, 7000.0, 200.0), 80)))
    lines.append(_fill_acq_baseline(bench_acquire_signal(
        "galileo-e1b", 24, list(range(1, 51)), (-9000.0, 9000.0, 50.0), 40,
        subcarrier="cboc")))
    lines.append(_fill_acq_baseline(bench_acquire_signal(
        "glonass-l1", 0, list(range(-7, 8)), (-7000.0, 7000.0, 200.0), 80)))
    for ln in lines:
        print(json.dumps(ln), flush=True)
    # --- sustained acquisition, one row per distinct engine shape:
    # 2n window (B1I), 2n window at 30.69 MHz (L5I), sliding 2n
    # tall-doppler (E1B), FDMA one-program (GLONASS), extended-coherent
    # (L5I NH10)
    for row in (
        bench_acquire_sustained(
            "beidou-b1i", tuple(range(1, 33)), (-7000.0, 7000.0, 200.0), 80),
        bench_acquire_sustained(
            "gps-l5i", tuple(range(1, 33)), (-7000.0, 7000.0, 200.0), 80),
        bench_acquire_sustained(
            "galileo-e1b", tuple(range(1, 51)), (-9000.0, 9000.0, 50.0), 40),
        bench_acquire_sustained_fdma(),
        bench_acquire_coherent("gps-l5i"),
        bench_acquire_coherent_sustained("gps-l5i"),
        bench_acquire_coherent_sustained("beidou-b1i"),
        # the worst alignment count: E5aQ CS100 with PER-PRN overlays
        # (100 alignment surfaces; the per-PRN combine is an FFT over the
        # overlay axis) — a smaller grid keeps the cost row affordable
        bench_acquire_coherent_sustained(
            "galileo-e5aq", segments=2, dops_cfg=(-2000.0, 2000.0, 100.0),
            nprn=8, plant=2, reps=2),
    ):
        print(json.dumps(_fill_acq_baseline(row)), flush=True)
    # --- tracking: the BPSK anchor + one row per widened engine shape
    print(json.dumps(_fill_track_baseline(bench_tracking())),
          flush=True)
    # sustained variant: 4x the stream per dispatch
    sus = bench_tracking(C=32, NB=3600)
    sus["metric"] = "gps_l1_tracking_msamples_per_s_sustained"
    print(json.dumps(_fill_track_baseline(sus)), flush=True)
    for fam in ("beidou-b1i", "galileo-e1b", "gps-l1cp", "gps-l2cm",
                "gps-l2cl", "glonass-l1-p"):
        print(json.dumps(bench_tracking_family(fam)), flush=True)
    print(json.dumps(bench_tracking_native_rate()), flush=True)
    print(json.dumps(bench_receiver_band1()), flush=True)

    sig = get_signal("gps-l1")
    ms = 80
    segments = 16
    prns = tuple(range(1, 33))
    fs = sig.acq_fs
    x = synth_sky(sig, fs, (segments * ms + 1) * int(fs / 1000))

    cells_s, (metric, code_idx, dop_idx), dops, n = bench_sky_search(
        sig, x, prns, (-7000.0, 7000.0, 200.0), ms, segments
    )
    # sanity: the planted PRNs must be the top metrics in EVERY epoch
    m = np.asarray(metric)                      # [segments, P]
    for s in range(segments):
        top = set(int(p) for p in np.argsort(m[s])[-3:] + 1)
        assert top == {5, 12, 21}, (s, top, m[s].max())

    ref_cells_s = bench_reference_numpy(sig, x, ms)

    # headline LAST: the driver's parsed metric
    print(json.dumps({
        "metric": "gps_l1_sky_search_cells_per_s",
        "value": round(cells_s, 1),
        "unit": "search-cells/s (32 PRN x 70 doppler x 4096 x 80 blocks)",
        "vs_baseline": round(cells_s / ref_cells_s, 2),
    }))


if __name__ == "__main__":
    main()
