"""Two-float (double-float32) scalar arithmetic for loop-state accumulation.

The device state stays f32 (f64 is slow or disabled on accelerators); the
tracking loop's code-phase accumulator needs
~47 bits of mantissa (0.25 chips/sample over minutes with <1e-4 chip bias),
so per-block scalar state updates use Dekker/Knuth error-free transforms on
f32 pairs (hi, lo).  Only O(channels) scalars per block — negligible cost.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 for float32 (24-bit mantissa)


def two_sum(a, b):
    """Knuth two-sum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker product: a * b = p + e exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def tf_add(x, y):
    """(hi,lo) + (hi,lo) -> normalized (hi,lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return two_sum(s, e)


def tf_add_f(x, y):
    """(hi,lo) + f32 -> (hi,lo)."""
    s, e = two_sum(x[0], y)
    return two_sum(s, e + x[1])


def tf_mul_f(x, y):
    """(hi,lo) * f32 -> (hi,lo)."""
    p, e = two_prod(x[0], y)
    return two_sum(p, e + x[1] * y)


def tf_mod(x, m: float):
    """(hi,lo) mod m for values within a few multiples of m.

    Returns ((hi,lo) in [0, m), k) with k = number of whole m subtracted."""
    v = x[0] + x[1]
    k = jnp.floor(v / m)
    r = tf_add_f(x, -k * m)
    # guard rounding at the boundary
    under = (r[0] + r[1]) < 0
    over = (r[0] + r[1]) >= m
    k = k - jnp.where(under, 1.0, 0.0) + jnp.where(over, 1.0, 0.0)
    r = tf_add_f(r, jnp.where(under, m, 0.0) - jnp.where(over, m, 0.0))
    return r, k


def tf_from_f64(v) -> tuple:
    """Host float64 -> (hi, lo) python floats."""
    import numpy as np

    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)


def tf_value(x):
    return x[0] + x[1]
