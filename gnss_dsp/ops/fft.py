"""Matmul FFT: recursive four-step (Cooley-Tukey) DFT built from real
matmuls on split-complex data.

An n = n1*n2 DFT is [n1,n1] and [n2,n2] dense matmuls around an
elementwise twiddle.  Radices are capped at MAX_DIRECT so every factor
becomes one dense DFT matrix; sizes with large prime factors recurse.
(Whether cuFFT through jnp.fft beats this on the GPU is an open
measurement; see ROADMAP.md.)

Supports any n whose prime factors are <= MAX_DIRECT (all reference
acquisition sizes: 4096..163840, incl. non-powers-of-two like 30690 =
165*186).  Accuracy is controlled by `precision` (jax.lax matmul passes).

Cost: n * (sum of radices) complex MACs, e.g. 61380-point = n*(220+279)
~= 245 MFLOP; a full 32-PRN x 70-doppler x 80-block GPS L1 acquisition
is ~15 TFLOP of DFT work.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx

MAX_DIRECT = 512  # largest dense DFT matrix (512x512x2 f32 = 2 MB)


def _best_split(n: int) -> int:
    """Largest divisor <= sqrt(n) (balanced four-step split)."""
    a = int(np.sqrt(n))
    while a > 1:
        if n % a == 0:
            return a
        a -= 1
    return 1


@lru_cache(maxsize=64)
def _dft_matrix(n: int, sign: int, dtype=np.float32):
    """Split DFT matrix W[j,k] = exp(sign*2i*pi*j*k/n), numpy constants
    (numpy, not jnp: device constants must not be cached across traces)."""
    j = np.arange(n)
    w = np.exp(sign * 2j * np.pi * np.outer(j, j) / n)
    return w.real.astype(dtype), w.imag.astype(dtype)


@lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, sign: int, dtype=np.float32):
    """Twiddle W_n^{k1*j2}, shape [n1, n2], numpy constants."""
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    w = np.exp(sign * 2j * np.pi * k1 * j2 / (n1 * n2))
    return w.real.astype(dtype), w.imag.astype(dtype)


def _cmatmul_last(x, m, precision):
    """Contract the last axis of split x [..., n] with split [n, n] matrix.

    3-multiplication (Karatsuba) complex product: the combined matrices
    (m is always a host-side numpy constant pair) cost nothing, and the
    matmul count drops from 4 to 3 — a 25% cut on acquisition's
    dominant cost."""
    xr, xi = x
    mr, mi = m
    m_sum = mr + mi
    m_diff = mi - mr
    m1 = jnp.matmul(xr + xi, mr, precision=precision)
    m2 = jnp.matmul(xi, m_sum, precision=precision)
    m3 = jnp.matmul(xr, m_diff, precision=precision)
    return (m1 - m2, m1 + m3)


def _dft_last(x, n: int, sign: int, precision, dtype=np.float32):
    """DFT along the last axis (length n), recursive four-step."""
    if n <= MAX_DIRECT:
        return _cmatmul_last(x, _dft_matrix(n, sign, dtype), precision)
    n1 = _best_split(n)
    if n1 == 1:
        raise ValueError(
            f"FFT size {n} has a prime factor > {MAX_DIRECT}; "
            "pad or choose a composite window"
        )
    n2 = n // n1
    batch = x[0].shape[:-1]
    # x[j1*n2 + j2] -> [.., n1, n2]
    x = cplx.reshape(x, batch + (n1, n2))
    # DFT over j1 (axis -2): move to last, transform, move back
    x = (jnp.swapaxes(x[0], -1, -2), jnp.swapaxes(x[1], -1, -2))   # [.., n2, n1]
    x = _dft_last(x, n1, sign, precision, dtype)                   # k1 on last
    x = (jnp.swapaxes(x[0], -1, -2), jnp.swapaxes(x[1], -1, -2))   # [.., k1, j2]
    # twiddle
    x = cplx.cmul(x, _twiddle(n1, n2, sign, dtype))
    # DFT over j2 (last axis)
    x = _dft_last(x, n2, sign, precision, dtype)                   # [.., k1, k2]
    # out[k] with k = k1 + n1*k2 -> transpose to [.., k2, k1] then flatten
    x = (jnp.swapaxes(x[0], -1, -2), jnp.swapaxes(x[1], -1, -2))
    return cplx.reshape(x, batch + (n,))


def fft(x, precision=jax.lax.Precision.HIGHEST, bf16: bool = False):
    """Forward DFT along the last axis of split-complex x.

    bf16=True keeps the inter-stage tensors (and DFT/twiddle constants)
    in bfloat16 — halves the stage-copy memory traffic that dominates big
    batched transforms, at ~0.5% amplitude error (matmul accumulation
    stays f32).  Output stays bf16; cast at the consumer."""
    if bf16:
        x = (x[0].astype(jnp.bfloat16), x[1].astype(jnp.bfloat16))
        return _dft_last(x, x[0].shape[-1], -1, precision, ml_dtypes_bf16())
    return _dft_last(x, x[0].shape[-1], -1, precision)


def ifft(x, precision=jax.lax.Precision.HIGHEST, bf16: bool = False):
    """Inverse DFT (with 1/n scaling) along the last axis."""
    n = x[0].shape[-1]
    if bf16:
        x = (x[0].astype(jnp.bfloat16), x[1].astype(jnp.bfloat16))
        y = _dft_last(x, n, +1, precision, ml_dtypes_bf16())
        return cplx.scale(y, jnp.bfloat16(1.0 / n))
    y = _dft_last(x, n, +1, precision)
    return cplx.scale(y, 1.0 / n)


@lru_cache(maxsize=1)
def ml_dtypes_bf16():
    import ml_dtypes

    return ml_dtypes.bfloat16

