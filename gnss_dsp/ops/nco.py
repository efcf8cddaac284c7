"""Numerically-controlled oscillator (NCO) and carrier mixers.

Behavioral contract (reference: gnsstools/nco.py:3-64): a 1024-entry
complex-exponential lookup table drives every oscillator; phases are
quantized to the table grid *before* evaluation, so implementations agree
exactly when their phase accumulators agree to better than 1/1024 cycle.

Design:
  * phase lives in uint32 "turns" (1 cycle = 2^32); per-sample phase is
    p0 + i*df with natural mod-2^32 wraparound (vs the reference's
    sequential int64 accumulator with 50 fractional bits, nco.py:30-38) —
    one iota, one multiply, one shift, fully vectorized.
  * instead of a table *gather*, the oscillator evaluates cos/sin at the
    quantized angle 2*pi*idx/1024 — numerically identical to the lookup,
    and pure elementwise work that XLA fuses into the mix.
  * all device functions use split-complex (re, im) f32 pairs (ops/cplx).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

NT = 1024  # LUT-equivalent quantization (nco.py:3)
_PHASE_BITS = 32
_LUT_SHIFT = _PHASE_BITS - 10  # top 10 bits = table index
_TWO_PI_OVER_NT = np.float32(2.0 * np.pi / NT)

# Host-side f64 table (oracle tier / host mixing).
NCO_TABLE = np.exp(2j * np.pi * np.arange(NT) / NT)


# ---------------------------------------------------------------- host side

def phase_to_fixed(p) -> np.uint32:
    """Phase in cycles (host float) -> uint32 fixed-point turns."""
    return np.uint32(np.mod(np.float64(p), 1.0) * 2.0**32)


def freq_to_fixed(f) -> int:
    """Cycles/sample (host float) -> int32 fixed-point increment (as python
    int with int32 wraparound semantics)."""
    v = int(np.floor(np.float64(f) % 1.0 * 2.0**32)) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def nco_host(f: float, p: float, n: int) -> np.ndarray:
    """Bit-compatible host oracle of the reference nco() (nco.py:6-10)."""
    idx = np.floor((p + f * np.arange(n)) * NT).astype(np.int64) % NT
    return NCO_TABLE[idx]


def boc11_host(chips: float, frac: float, incr: float, n: int) -> np.ndarray:
    """BOC(1,1) square-wave subcarrier sampler (reference nco.py:12-19)."""
    c = np.array([-1.0, 1.0])
    idx = ((chips % 2) + frac + incr * np.arange(n)) * 2
    idx = np.floor(idx).astype(np.int64) % 2
    return c[idx]


# -------------------------------------------------------------- device side

def freq_to_fixed_jnp(f):
    """Device-side cycles/sample -> int32 increment (f32 input, |f| small)."""
    frac = jnp.mod(f.astype(jnp.float32), 1.0)
    return (frac * jnp.float32(2.0**32)).astype(jnp.uint32).astype(jnp.int32)


def phase_indices(df_fixed, p0_fixed, n: int):
    """Quantized LUT indices (int32 in [0, NT)) for phase p0 + i*df."""
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
    ph = p0_fixed.astype(jnp.uint32) + (i * df_fixed.astype(jnp.int32)).astype(jnp.uint32)
    return jax.lax.shift_right_logical(ph, np.uint32(_LUT_SHIFT)).astype(jnp.int32)


def cos_sin_of_idx(idx):
    """Evaluate the LUT entries at quantized indices without a gather."""
    ang = idx.astype(jnp.float32) * _TWO_PI_OVER_NT
    return jnp.cos(ang), jnp.sin(ang)


def nco_split(df_fixed, p0_fixed, n: int):
    """Split-complex oscillator e^{2*pi*i(p0 + k*df)} via the quantized grid."""
    return cos_sin_of_idx(phase_indices(df_fixed, p0_fixed, n))


def mix_split(x, df_fixed, p0_fixed):
    """Carrier wipeoff of split-complex x with fixed-point freq/phase."""
    from gnss_dsp.ops import cplx

    return cplx.cmul(x, nco_split(df_fixed, p0_fixed, x[0].shape[-1]))


def accum_code_bins(x, cp0, incr, code_length: int):
    """Code-phase-binned accumulation (reference nco.accum, nco.py:58-64):
    a[floor(cp_i)] += x[i].  Split-complex in/out, [code_length] bins.
    Used for unknown-code recovery (track-beidou-b2bi.py:47-53)."""
    n = x[0].shape[-1]
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n).astype(jnp.float32)
    cp = jnp.mod(cp0 + i * incr, code_length)
    idx = jnp.floor(cp).astype(jnp.int32)
    return (
        jnp.zeros(code_length, jnp.float32).at[idx].add(x[0]),
        jnp.zeros(code_length, jnp.float32).at[idx].add(x[1]),
    )


# ------------------------------------------------- convenience (tests/host)

def nco(f: float, p: float, n: int):
    """Complex oscillator via the device path (for tests; combines split)."""
    from gnss_dsp.ops import cplx

    re, im = nco_split(
        jnp.asarray(np.int32(freq_to_fixed(f))),
        jnp.asarray(phase_to_fixed(p)),
        n,
    )
    return cplx.to_numpy((re, im))


def mix(x, f: float, p: float):
    """Functional equivalent of reference mix_ (nco.py:30-41) for host use."""
    return np.asarray(x) * nco_host(
        np.float64(f), np.float64(p), np.shape(x)[-1]
    ).astype(np.complex64)
