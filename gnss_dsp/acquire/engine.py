"""Batched FFT circular-correlation acquisition.

The reference searches one (PRN, doppler) cell at a time inside a process
pool (acquire-gps-l1.py:18-40,105-108).  Here the whole PRN x doppler x
code-phase grid is one jit program: a scan over doppler *chunks*, each
chunk batching [DC] oscillators, [blocks] coherent transforms and [P, DC]
correlation surfaces through the matmul FFT (ops/fft) — the PRN axis
shards cleanly over a device mesh (gnss_dsp.parallel).

All device data is split-complex (re, im) f32 (ops/cplx).

Template variants reproduced (SURVEY.md §2.4 acquisition table):
  * window = n (circular) or 2n (zero-padded code, sliding data window)
  * reference waveform optionally multiplied by a BOC(1,1) subcarrier
  * metric = peak/mean (gps-l1/xona family) or raw peak (all others)
  * block count: ms, ms//10, ms//20-1, ms//4-1 per signal (+ b2ad's 80)
  * FDMA channel frequency offsets folded into the doppler NCO (GLONASS)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.models.codes import resample_host
from gnss_dsp.ops import cplx, fft, nco


@dataclass
class AcqResult:
    prn: int
    doppler: float
    metric: float
    code_offset: float   # chips


def build_code_ffts(sig, prns, n: int, window: int) -> np.ndarray:
    """Host-side reference waveforms: resample each PRN's code to n samples
    (one coherent period), apply the BOC(1,1) subcarrier if the template
    demands it, zero-pad to `window`, FFT.  f64 host math, complex128 out."""
    table = sig.code_table(tuple(prns))
    incr = float(sig.code_length) / n
    c = resample_host(table, 0, 0, incr, n)  # [P, n] f64 ±1
    if sig.acq_boc_ref:
        boc = nco.boc11_host(0, 0, incr, n)
        c = c * boc
    if window > n:
        c = np.concatenate([c, np.zeros((c.shape[0], window - n))], axis=1)
    return np.fft.fft(c, axis=1)


def block_windows(x, n: int, window: int, blocks: int):
    """Stack the non-coherent block windows [B, W] (stride n; W = n for
    circular search, 2n for the sliding zero-padded templates).

    Built from reshape + slices, not a gather: window is always a
    multiple of the stride here, and the [B, W] jnp.take this used to be
    measured 3.6 ms/epoch on GPS L1 — ~20% of the whole device-side
    search — vs ~0 for the copy-free reshape."""
    if window % n == 0:
        m = window // n
        rows = blocks + m - 1
        xs = (x[0][: rows * n].reshape(rows, n),
              x[1][: rows * n].reshape(rows, n))
        if m == 1:
            return xs
        return (jnp.concatenate([xs[0][i:i + blocks] for i in range(m)],
                                axis=-1),
                jnp.concatenate([xs[1][i:i + blocks] for i in range(m)],
                                axis=-1))
    idx = (jnp.arange(blocks)[:, None] * n + jnp.arange(window)[None, :])
    return (jnp.take(x[0], idx), jnp.take(x[1], idx))


def chunk_q(xb, code_ffts, w, precision, bf16: bool = False):
    """Non-coherent grid for one doppler chunk: q [P, DC, W].

    xb [B, W] block windows; code_ffts [P, W]; w [DC, W] oscillators.
    One batched FFT over DC x B rows and one batched IFFT over
    P x DC x B rows — tall matmuls instead of `blocks` small
    sequential ones (this is the whole cost of acquisition).
    """
    F = fft.fft(cplx.cmul(
        (xb[0][None, :, :], xb[1][None, :, :]),
        (w[0][:, None, :], w[1][:, None, :]),
    ), precision=precision, bf16=bf16)                     # [DC, B, W]
    cf = code_ffts
    if bf16:
        cf = (cf[0].astype(jnp.bfloat16), cf[1].astype(jnp.bfloat16))
    prod = cplx.cmul_conj(
        (cf[0][:, None, None, :], cf[1][:, None, None, :]),
        (F[0][None, :, :, :], F[1][None, :, :, :]),
    )
    R = fft.ifft(prod, precision=precision, bf16=bf16)     # [P, DC, B, W]
    mag = jnp.sqrt(R[0].astype(jnp.float32) ** 2
                   + R[1].astype(jnp.float32) ** 2)
    return jnp.sum(mag, axis=2)                            # [P, DC, W]


@partial(
    jax.jit,
    static_argnames=("n", "window", "blocks", "peak_mean", "dop_chunk",
                     "precision", "bf16", "per_chunk"),
)
def grid_search(x, code_ffts, dopp_fixed, dopp_valid,
                n: int, window: int, blocks: int,
                peak_mean: bool, dop_chunk: int,
                precision=jax.lax.Precision.HIGHEST, bf16: bool = False,
                per_chunk: bool = False):
    """Search the full grid; returns per-PRN (metric, code_idx, dop_idx).

    x          : split-complex [>= (blocks-1)*n + window] internal-rate samples
    code_ffts  : split-complex [P, window]
    dopp_fixed : int32 [Dp] per-sample NCO increments (FDMA offset included),
                 padded to a multiple of dop_chunk
    dopp_valid : bool [Dp] False on padding entries
    per_chunk  : return [n_chunks, P] results, one per doppler chunk —
                 used to search all GLONASS FDMA channels in one program
                 (chunk == one channel's doppler band)
    """
    P = code_ffts[0].shape[0]
    Dp = dopp_fixed.shape[0]
    n_chunks = Dp // dop_chunk
    zero_p = jnp.zeros((), jnp.uint32)
    xb = block_windows(x, n, window, blocks)

    def chunk_body(carry, ci):
        best_metric, best_code, best_dop = carry
        d0 = ci * dop_chunk
        df = jax.lax.dynamic_slice(dopp_fixed, (d0,), (dop_chunk,))
        valid = jax.lax.dynamic_slice(dopp_valid, (d0,), (dop_chunk,))
        w = jax.vmap(lambda f: nco.nco_split(f, zero_p, window))(df)  # [DC, W]

        q = chunk_q(xb, code_ffts, w, precision, bf16)
        peak = jnp.max(q, axis=-1)                                    # [P, DC]
        code_idx = jnp.argmax(q, axis=-1).astype(jnp.int32)
        metric = peak / jnp.mean(q, axis=-1) if peak_mean else peak
        metric = jnp.where(valid[None, :], metric, -jnp.inf)

        ch_best = jnp.argmax(metric, axis=-1)                         # [P]
        ch_metric = jnp.take_along_axis(metric, ch_best[:, None], 1)[:, 0]
        ch_code = jnp.take_along_axis(code_idx, ch_best[:, None], 1)[:, 0]
        ch_dop = (d0 + ch_best).astype(jnp.int32)
        upd = ch_metric > best_metric
        return (
            jnp.where(upd, ch_metric, best_metric),
            jnp.where(upd, ch_code, best_code),
            jnp.where(upd, ch_dop, best_dop),
        ), (ch_metric, ch_code, ch_dop)

    init = (
        jnp.full((P,), -jnp.inf, jnp.float32),
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), jnp.int32),
    )
    (metric, code_idx, dop_idx), per = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks)
    )
    if per_chunk:
        return per
    return metric, code_idx, dop_idx


def _block_count(sig, ms: int) -> int:
    if sig.acq_blocks_override:   # b2ad quirk: range(80) (acquire-beidou-b2ad.py:29)
        return sig.acq_blocks_override
    coh = sig.acq_coherent_ms
    if sig.acq_sliding:           # galileo e1: ms//4 - 1 (acquire-galileo-e1b.py:19)
        return max(int(ms // coh) - 1, 1)
    if coh > 1 and sig.acq_pad2:  # l2cm: ms//20 - 1 (acquire-gps-l2cm.py:19)
        return max(int(ms // coh) - 1, 1)
    if coh > 1:                   # l1c/b1c: ms//10 (acquire-gps-l1cp.py:19)
        return max(int(ms // coh), 1)
    return int(ms)


def doppler_grid(sig, doppler_search, chan: int = 0):
    dmin, dmax, dinc = doppler_search
    dops = np.arange(dmin, dmax, dinc)
    offs = sig.fdma_hz * chan
    fixed = np.array(
        [nco.freq_to_fixed(-(d + offs) / sig.acq_fs) for d in dops],
        dtype=np.int64,
    ).astype(np.int32)
    return dops, fixed


# device-resident code-FFT LRU for the one-shot path; see
# acquire_signal.  ~5-26 MB per entry (B1I 37x16384 f32 pair .. E1B
# 50x65536), capped.
_CODE_FFTS_DEV: dict = {}
_CODE_FFTS_CAP = 4


def search_inputs(sig, x_int, prns, doppler_search=None, ms: int = 80,
                  chan: int = 0, dop_chunk: int | None = None,
                  precision=jax.lax.Precision.HIGHEST, bf16: bool = False):
    """(args, static kwargs, doppler bins, n) of the grid_search call
    that acquire_signal makes: grid_search(*args, **kwargs) returns the
    raw per-PRN (metric, code_idx, dop_idx)."""
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _block_count(sig, ms)
    dops, fixed = doppler_grid(sig, doppler_search, chan)

    if dop_chunk is None:
        # the chunk materializes [P, DC, B, W] surfaces (x ~4 temps);
        # size DC to keep that under ~1.2 GB of device memory
        per_dc = len(prns) * blocks * window * 16
        dop_chunk = int(np.clip(1.2e9 // per_dc, 1, len(dops)))
    Dp = -(-len(dops) // dop_chunk) * dop_chunk
    fixed_p = np.zeros(Dp, np.int32)
    fixed_p[: len(fixed)] = fixed
    valid = np.zeros(Dp, bool)
    valid[: len(fixed)] = True

    # device-resident code-FFT LRU: repeated acquire calls on the same
    # (signal, prns) — continuous receivers, sensitivity sweeps, the
    # CLI's warm path — skip the host FFT build AND the code upload
    key = (sig.name, tuple(prns), n, window)
    code_ffts = _CODE_FFTS_DEV.pop(key, None)
    if code_ffts is None:
        code_ffts = cplx.from_numpy(build_code_ffts(sig, prns, n, window))
    _CODE_FFTS_DEV[key] = code_ffts            # re-insert = MRU
    while len(_CODE_FFTS_DEV) > _CODE_FFTS_CAP:
        _CODE_FFTS_DEV.pop(next(iter(_CODE_FFTS_DEV)))
    x = cplx.from_numpy(x_int) if not isinstance(x_int, tuple) else x_int
    args = (x, code_ffts, jnp.asarray(fixed_p), jnp.asarray(valid))
    kwargs = dict(n=n, window=window, blocks=blocks,
                  peak_mean=(sig.acq_metric == "peak_mean"),
                  dop_chunk=dop_chunk, precision=precision, bf16=bf16)
    return args, kwargs, dops, n


def acquire_signal(sig, x_int, prns, doppler_search=None, ms: int = 80,
                   chan: int = 0, dop_chunk: int | None = None,
                   precision=jax.lax.Precision.HIGHEST, bf16: bool = False):
    """Run acquisition for one signal over `prns`.

    x_int: internal-rate samples covering >= ms+2 ms — host complex array
    or split-complex pair.
    precision: matmul precision for the DFT stages.  HIGHEST is exact
    f32; DEFAULT lets the backend use reduced-precision operands with
    f32 accumulation (TF32 on a GPU).  bf16=True additionally stores
    inter-stage tensors in bfloat16 (~2.4e-3 relative metric error).
    Returns list[AcqResult] in PRN order.
    """
    args, kwargs, dops, n = search_inputs(sig, x_int, prns, doppler_search,
                                          ms, chan, dop_chunk, precision,
                                          bf16)
    metric, code_idx, dop_idx = (np.asarray(a)
                                 for a in grid_search(*args, **kwargs))
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(AcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code,
        ))
    return out


def acquire_signal_fdma(sig, x_int, chans, doppler_search=None, ms: int = 80,
                        precision=jax.lax.Precision.HIGHEST):
    """All FDMA channels in ONE grid program (GLONASS L1/L2): the shared
    m-sequence is one code row and each channel's band is one doppler
    chunk, so per-chunk reductions ARE per-channel results — ~10x faster
    than the reference's channel loop on wide searches.

    Returns list[AcqResult] in channel order (prn field = channel)."""
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _block_count(sig, ms)

    dops_all, fixed_all = [], []
    for chan in chans:
        dops, fixed = doppler_grid(sig, doppler_search, chan)
        dops_all.append(dops)
        fixed_all.append(fixed)
    D = len(dops_all[0])
    fixed_p = np.concatenate(fixed_all).astype(np.int32)
    valid = np.ones(len(fixed_p), bool)

    code_ffts = cplx.from_numpy(build_code_ffts(sig, (chans[0],), n, window))
    x = cplx.from_numpy(x_int) if not isinstance(x_int, tuple) else x_int

    metric, code_idx, dop_idx = grid_search(
        x, code_ffts, jnp.asarray(fixed_p), jnp.asarray(valid),
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"),
        dop_chunk=D, precision=precision, per_chunk=True,
    )
    metric = np.asarray(metric)[:, 0]
    code_idx = np.asarray(code_idx)[:, 0]
    dop_idx = np.asarray(dop_idx)[:, 0]
    out = []
    for i, chan in enumerate(chans):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(AcqResult(
            prn=chan, doppler=float(dops_all[i][dop_idx[i] - i * D]),
            metric=float(metric[i]), code_offset=code,
        ))
    return out
