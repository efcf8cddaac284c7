"""Split-complex arithmetic: complex arrays as (re, im) float32 pairs.

The matmul DFT (ops/fft) works on real planes, and the engines were
written around it: all device-side code in this package uses (re, im)
tuples; host boundaries convert with `from_numpy` / `to_numpy`.  (Whether
complex64 with jnp.fft serves better on the GPU is an open measurement;
see ROADMAP.md.)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

C = tuple  # alias for readability: a split-complex value is (re, im)


def from_numpy(x: np.ndarray) -> C:
    x = np.asarray(x)
    return (
        jnp.asarray(np.ascontiguousarray(x.real).astype(np.float32)),
        jnp.asarray(np.ascontiguousarray(x.imag).astype(np.float32)),
    )


def to_numpy(a: C) -> np.ndarray:
    return np.asarray(a[0]) + 1j * np.asarray(a[1])


def _deinterleave_dev(a, p: int):
    f = a.astype(jnp.float32)
    re = f[0::2]
    im = f[1::2]
    if p:
        re = jnp.pad(re, (0, p))
        im = jnp.pad(im, (0, p))
    return re, im


def _deint4_dev(a, p: int, scale: float):
    # one packed byte per sample: I in the high nibble, Q in the low,
    # each 4-bit two's complement ((v ^ 8) - 8 sign-extends)
    u = a.astype(jnp.int32) & 255
    i4 = ((jnp.right_shift(u, 4) & 15) ^ 8) - 8
    q4 = ((u & 15) ^ 8) - 8
    re = i4.astype(jnp.float32) * jnp.float32(scale)
    im = q4.astype(jnp.float32) * jnp.float32(scale)
    if p:
        re = jnp.pad(re, (0, p))
        im = jnp.pad(im, (0, p))
    return re, im


_deinterleave_jit = None
_deint4_jit = None


_PACK4_LUT = None


def pack_int4_host(raw_int8: np.ndarray) -> np.ndarray:
    """Interleaved int8 I/Q -> one packed byte per sample (4-bit I/Q):
    v4 = round(v/8) clipped to +-7.  At the synthetic captures' AGC
    level (noise sigma ~25 int8 counts -> ~3.1 four-bit counts) this is
    the classic coarse-quantization GNSS front end (~0.2-0.5 dB C/N0
    loss); it HALVES the host-link bytes vs raw int8
    (GNSS_DSP_UPLOAD_INT4 on the streaming/receiver paths).

    Implemented as a 256-entry byte LUT: the arithmetic form promotes
    280 MB chunks to int16, which is far slower."""
    global _PACK4_LUT
    if _PACK4_LUT is None:
        v = np.arange(256, dtype=np.uint8).view(np.int8).astype(np.int16)
        _PACK4_LUT = (np.clip((v + 4) >> 3, -7, 7) & 15).astype(np.uint8)
    nib = _PACK4_LUT[raw_int8.view(np.uint8)]
    return (nib[0::2] << 4 | nib[1::2]).astype(np.uint8)


def from_int4_iq(packed, pad: int = 0, scale: float = 8.0) -> C:
    """Packed 4-bit I/Q (pack_int4_host) -> split-complex f32 on device:
    1 byte/sample over the host link (4x less than the old f32-pair
    route, 2x less than int8).  scale restores the int8 amplitude range
    so correlator magnitudes stay comparable."""
    global _deint4_jit
    if _deint4_jit is None:
        import functools

        import jax

        _deint4_jit = functools.partial(
            jax.jit, static_argnames=("p", "scale"))(_deint4_dev)
    if isinstance(packed, (bytes, bytearray, memoryview)):
        packed = np.frombuffer(packed, np.uint8)
    d = jnp.asarray(np.ascontiguousarray(packed))
    return _deint4_jit(d, int(pad), float(scale))


def from_int8_iq(raw, pad: int = 0) -> C:
    """Interleaved int8 I/Q -> split-complex f32 converted ON DEVICE:
    uploads 2 bytes/sample over the host link instead of the 8 the
    host-deinterleave + from_numpy route costs.  int8 -> f32 is exact,
    so values are bit-identical to
    from_numpy(utils.io.bytes_to_complex(raw)).  `pad` appends zero
    samples device-side."""
    global _deinterleave_jit
    if _deinterleave_jit is None:      # deferred: no jax at import time
        import functools

        import jax

        _deinterleave_jit = functools.partial(
            jax.jit, static_argnames="p")(_deinterleave_dev)
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, np.int8)
    d = jnp.asarray(np.ascontiguousarray(raw))     # [2n] int8 upload
    return _deinterleave_jit(d, int(pad))


def zeros(shape, dtype=jnp.float32) -> C:
    z = jnp.zeros(shape, dtype)
    return (z, z)


def cmul(a: C, b: C) -> C:
    ar, ai = a
    br, bi = b
    return (ar * br - ai * bi, ar * bi + ai * br)


def cmul_conj(a: C, b: C) -> C:
    """a * conj(b)"""
    ar, ai = a
    br, bi = b
    return (ar * br + ai * bi, ai * br - ar * bi)


def conj(a: C) -> C:
    return (a[0], -a[1])


def scale(a: C, s) -> C:
    return (a[0] * s, a[1] * s)


def add(a: C, b: C) -> C:
    return (a[0] + b[0], a[1] + b[1])


def cabs2(a: C):
    return a[0] * a[0] + a[1] * a[1]


def cabs(a: C):
    return jnp.sqrt(cabs2(a))


def angle(a: C):
    return jnp.arctan2(a[1], a[0])


def where(pred, a: C, b: C) -> C:
    return (jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1]))


def reshape(a: C, shape) -> C:
    return (a[0].reshape(shape), a[1].reshape(shape))


def take(a: C, idx, axis=0) -> C:
    return (jnp.take(a[0], idx, axis=axis), jnp.take(a[1], idx, axis=axis))


def sum(a: C, axis=None, where_mask=None) -> C:
    if where_mask is not None:
        return (
            jnp.sum(a[0], axis=axis, where=where_mask),
            jnp.sum(a[1], axis=axis, where=where_mask),
        )
    return (jnp.sum(a[0], axis=axis), jnp.sum(a[1], axis=axis))
