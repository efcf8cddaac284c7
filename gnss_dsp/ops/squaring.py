"""Squaring detector: boxcar-decimate by n, square, m non-coherent sums.

Behavioral contract: gnsstools/squaring.py:13-23 —
  r[b] = sum_{k<m} (sum_{l<n} x[b*n*m + k*n + l])^2 / n.
The reference is a Numba triple loop; here it is two reshapes and a
squared complex sum — pure VPU work under jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx


@partial(jax.jit, static_argnames=("n", "m"))
def squaring(x, n: int, m: int):
    """x: split-complex [blocks*n*m]; returns split [blocks]."""
    blocks = x[0].shape[0] // (n * m)
    xr = x[0][: blocks * n * m].reshape(blocks, m, n)
    xi = x[1][: blocks * n * m].reshape(blocks, m, n)
    sr = jnp.sum(xr, axis=-1)
    si = jnp.sum(xi, axis=-1)
    s2 = cplx.cmul((sr, si), (sr, si))
    return (jnp.sum(s2[0], axis=-1) / n, jnp.sum(s2[1], axis=-1) / n)
