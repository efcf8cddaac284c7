"""Front-end conditioning: carrier-offset wipeoff, anti-alias lowpass,
zero-phase filtering, fractional resampling to the signal's internal rate.

Behavioral contract (acquire-gps-l1.py:85-96): mix(-coffset/fs) ->
firwin(161, cutoff/(fs/2), hann) -> filtfilt -> linear-interp resample.

Design (split-complex throughout):
  * the wipeoff runs segment-wise with exact host-computed segment phases
    so int32-DDS truncation never accumulates;
  * the 161-tap zero-phase FIR is two causal banded-matmul passes over
    odd-extension padding, matching scipy.signal.filtfilt edge
    semantics;
  * the fractional resampler is a two-point gather with host-f64-exact
    index/weight tables (f32 cannot address sample 6e6 sub-sample).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx, nco


def design_lowpass(fs: float, cutoff_hz: float, ntaps: int = 161) -> np.ndarray:
    """Hann-windowed-sinc lowpass, DC gain 1 — equivalent to
    scipy.signal.firwin(ntaps, cutoff/(fs/2), window='hann')."""
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    fc = cutoff_hz / (fs / 2.0)
    h = fc * np.sinc(fc * m)
    h *= np.hanning(ntaps)
    return h / np.sum(h)


def _fir_mats(h: np.ndarray) -> np.ndarray:
    """Banded [A, 2, 128, 128] matmul operands for the causal FIR.

    y[128f + r] = sum_k h[k] x[128f + r - k] decomposes over k = 128a + b
    into per-frame matmuls: y[f] = sum_a X[f-a] @ L_a + X[f-a-1] @ U_a,
    L_a[c, r] = h[128a + r - c] (r >= c), U_a[c, r] = h[128a + r - c + 128]
    (r < c).  A banded-matmul FIR instead of lax.conv: XLA's conv at
    multi-million spatial width compiled for minutes, while four
    [128, 128] matmuls compile in milliseconds."""
    ntaps = len(h)
    A = -(-ntaps // 128)
    c = np.arange(128)[:, None]
    r = np.arange(128)[None, :]
    h64 = np.asarray(h, np.float64)
    mats = np.zeros((A, 2, 128, 128), np.float32)
    for a in range(A):
        kl = 128 * a + r - c
        ku = kl + 128
        mats[a, 0] = np.where((r >= c) & (kl >= 0) & (kl < ntaps),
                              h64[np.clip(kl, 0, ntaps - 1)], 0.0)
        mats[a, 1] = np.where((r < c) & (ku >= 0) & (ku < ntaps),
                              h64[np.clip(ku, 0, ntaps - 1)], 0.0)
    return mats


@jax.jit
def _fir_causal_2ch(xri, mats):
    """Causal FIR (lfilter(h, [1], x)) on [2, n] planes via banded
    matmuls (see _fir_mats)."""
    A = mats.shape[0]
    n = xri.shape[1]
    F = -(-n // 128)
    x = jnp.pad(xri, ((0, 0), (A * 128, F * 128 - n)))
    X = x.reshape(2, A + F, 128)
    y = jnp.zeros((2, F, 128), jnp.float32)
    for a in range(A):
        y = y + jnp.einsum("pfc,cr->pfr", X[:, A - a: A - a + F],
                           mats[a, 0],
                           precision=jax.lax.Precision.HIGHEST)
        y = y + jnp.einsum("pfc,cr->pfr", X[:, A - a - 1: A - a - 1 + F],
                           mats[a, 1],
                           precision=jax.lax.Precision.HIGHEST)
    return y.reshape(2, F * 128)[:, :n]


def filtfilt_fir(h: np.ndarray, x, padlen: int | None = None):
    """Zero-phase FIR filtering of split-complex x with odd-extension edge
    padding (scipy.signal.filtfilt(h, [1], x) semantics)."""
    ntaps = len(h)
    if padlen is None:
        padlen = 3 * ntaps
    xr, xi = x
    n = xr.shape[0]

    def oddext(v):
        left = 2 * v[0] - v[1 : padlen + 1][::-1]
        right = 2 * v[-1] - v[-padlen - 1 : -1][::-1]
        return jnp.concatenate([left, v, right])

    xe = jnp.stack([oddext(xr), oddext(xi)])
    mats = jnp.asarray(_fir_mats(h))
    y = _fir_causal_2ch(xe, mats)
    y = _fir_causal_2ch(y[:, ::-1], mats)[:, ::-1]
    return (y[0, padlen : padlen + n], y[1, padlen : padlen + n])


def resample_linear(x, fs: float, fs_out: float, n_out: int):
    """Linear-interpolation resampler (np.interp equivalent for the uniform
    grid t_k = k*fs/fs_out), split-complex."""
    ratio = np.float64(fs) / np.float64(fs_out)
    t = np.arange(n_out, dtype=np.float64) * ratio
    n_in = int(x[0].shape[0])
    i0h = np.minimum(np.floor(t).astype(np.int64), n_in - 1)
    w = jnp.asarray((t - i0h).astype(np.float32))
    i0 = jnp.asarray(i0h.astype(np.int32))
    i1 = jnp.minimum(i0 + 1, n_in - 1)
    x0 = cplx.take(x, i0)
    x1 = cplx.take(x, i1)
    return (
        x0[0] * (1.0 - w) + x1[0] * w,
        x0[1] * (1.0 - w) + x1[1] * w,
    )


def mix_long(x, f: float, p: float = 0.0, seg_bits: int = 20):
    """Carrier wipeoff for multi-million-sample blocks with no phase drift:
    segment-start phases are exact host-side integer arithmetic, so int32
    DDS truncation never accumulates past one segment."""
    n = int(x[0].shape[0])
    seg = 1 << seg_bits
    nseg = -(-n // seg)
    pad = nseg * seg - n
    f_fix = int(np.floor(np.float64(f) % 1.0 * 2.0**32))
    p_fix = int(np.floor(np.float64(p) % 1.0 * 2.0**32))
    starts = np.array(
        [(p_fix + f_fix * seg * k) % (1 << 32) for k in range(nseg)],
        dtype=np.uint32,
    )
    xp = cplx.reshape(
        (jnp.pad(x[0], (0, pad)), jnp.pad(x[1], (0, pad))), (nseg, seg)
    )
    df = jnp.asarray(np.int32(f_fix - (1 << 32) if f_fix >= (1 << 31) else f_fix))
    wc, ws = jax.vmap(lambda p0: nco.nco_split(df, p0, seg))(jnp.asarray(starts))
    y = cplx.cmul(xp, (wc, ws))
    return (y[0].reshape(nseg * seg)[:n], y[1].reshape(nseg * seg)[:n])


def prepare_baseband(x_raw, fs: float, coffset: float, acq_fs: float,
                     cutoff_hz: float, ms_total: int, ntaps: int = 161):
    """Full acquisition front-end: wipeoff + zero-phase lowpass + resample.

    x_raw: host complex array at fs (>= ms_total ms worth) or split pair.
    Returns split-complex [ms_total * acq_fs / 1000] at the internal rate.
    """
    x = cplx.from_numpy(x_raw) if not isinstance(x_raw, tuple) else x_raw
    x = mix_long(x, -coffset / fs)
    h = design_lowpass(fs, cutoff_hz, ntaps)
    x = filtfilt_fir(h, x)
    n_out = int(round(ms_total * acq_fs / 1000.0))
    return resample_linear(x, fs, acq_fs, n_out)
