"""Assisted serial acquisition for long codes: GPS L2CL given an L2CM
fix (75 hypotheses of 10230 chips, acquire-gps-l2cl.py:15-30) and
GLONASS P given a C/A fix (1000 hypotheses of 5110 chips,
acquire-glonass-l1-p.py:15-33).

The reference evaluates one hypothesis x block at a time in Python.
Here all hypotheses are one jit program: the code windows become a
gathered [K, B, n] tensor (chunked over K to bound device memory) and
the per-block dot products one einsum.

Code-phase starts are split int32/f32 host-side — chip indices reach
5e6+ (GLONASS P), far beyond f32's exact-integer range, so the device
only ever sees small fractional residuals (same trick as the tracking
correlator, track/engine.py corr()).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx, nco


@dataclass
class SerialResult:
    prn: int
    doppler: float
    metric: float
    k: int
    code_offset: float


@dataclass
class HypothesisGeometry:
    """Host-side geometry of a serial search: blocks, sizes, and the
    int/frac-split start chips for every (hypothesis, block)."""
    blocks: int
    n: int
    incr: float
    L: int
    stride: float
    phase0: float
    s_int: np.ndarray    # int32 [K, B]
    s_frac: np.ndarray   # f32 [K, B]


def hypothesis_geometry(sig, fs: float, ms: int,
                        parent_code_phase: float) -> HypothesisGeometry:
    K = sig.acq_serial
    coh = sig.acq_serial_coh_ms
    blocks = max(int(ms // coh), 1)
    n = int(fs * coh / 1000.0)
    incr = sig.chip_rate / fs
    L = sig.code_length
    stride = sig.acq_serial_stride
    phase0 = sig.acq_serial_scale * parent_code_phase

    # hypothesis start chips: L2CL advances (k+b)*stride + phase
    # (acquire-gps-l2cl.py:24); GLONASS P advances k*stride + b*n*incr +
    # phase (acquire-glonass-l1-p.py:23-29) — both are k*stride + b*adv
    chips_per_block = coh * sig.chip_rate / 1000.0
    block_adv = stride if abs(chips_per_block - stride) < 1e-6 else n * incr
    kk = np.arange(K, dtype=np.float64)[:, None]
    bb = np.arange(blocks, dtype=np.float64)[None, :]
    starts = kk * stride + bb * block_adv + phase0
    s_int = np.floor(starts).astype(np.int64)
    s_frac = (starts - s_int).astype(np.float32)
    s_int = (s_int % L).astype(np.int32)
    return HypothesisGeometry(blocks=blocks, n=n, incr=incr, L=L,
                              stride=stride, phase0=phase0,
                              s_int=s_int, s_frac=s_frac)


def wipe_blocks(sig, x, doppler: float, fs: float, chan: int,
                geom: HypothesisGeometry):
    """Carrier wipe with one n-sample oscillator reused per block
    (acquire-gps-l2cl.py:21); returns split [B, n]."""
    xs = cplx.from_numpy(x) if not isinstance(x, tuple) else x
    w = nco.nco_split(
        jnp.asarray(np.int32(nco.freq_to_fixed(
            -(doppler + sig.fdma_hz * chan) / fs))),
        jnp.zeros((), jnp.uint32), geom.n)
    nb = geom.blocks * geom.n
    xb = cplx.reshape((xs[0][:nb], xs[1][:nb]), (geom.blocks, geom.n))
    return cplx.cmul(xb, (w[0][None, :], w[1][None, :]))


def hypothesis_q(xw, code_tab, s_int, s_frac, incr, n: int, L: int):
    """q[k] for one hypothesis chunk (traceable; used under jit here and
    under shard_map in parallel/acquire.serial_search_sharded).

    xw      : split [B, n] carrier-wiped data blocks
    code_tab: int8 [L]
    s_int   : int32 [Kc, B] integer chip starts
    s_frac  : f32 [Kc, B] fractional chip starts
    """
    i = jax.lax.broadcasted_iota(jnp.float32, (1, 1, n), 2)
    cp = s_frac[:, :, None] + i * incr
    idx = jnp.mod(s_int[:, :, None] + jnp.floor(cp).astype(jnp.int32), L)
    c = jnp.take(code_tab, idx, axis=0).astype(jnp.float32)     # [Kc, B, n]
    yr = jnp.einsum("kbn,bn->kb", c, xw[0],
                    precision=jax.lax.Precision.HIGHEST)
    yi = jnp.einsum("kbn,bn->kb", c, xw[1],
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(jnp.sqrt(yr * yr + yi * yi), axis=1)          # [Kc]


_serial_chunk = partial(jax.jit, static_argnames=("n", "L"))(hypothesis_q)


def serial_search(sig, x, prn: int, doppler: float, parent_code_phase: float,
                  fs: float, ms: int = 40, chan: int = 0,
                  k_chunk: int | None = None) -> SerialResult:
    """Search sig.acq_serial hypotheses at native rate fs.

    x: complex array (or split pair) of >= blocks*n samples, already
    carrier-offset-wiped to baseband (the CLI layer handles coffset).
    """
    K = sig.acq_serial
    geom = hypothesis_geometry(sig, fs, ms, parent_code_phase)
    blocks, n, L = geom.blocks, geom.n, geom.L
    xw = wipe_blocks(sig, x, doppler, fs, chan, geom)
    code_tab = jnp.asarray(sig.code_table((prn,))[0].astype(np.int8))

    if k_chunk is None:
        k_chunk = max(1, min(K, int(64 * 2**20 / (blocks * n * 4))))
    q = np.empty(K, np.float32)
    for k0 in range(0, K, k_chunk):
        k1 = min(k0 + k_chunk, K)
        q[k0:k1] = np.asarray(_serial_chunk(
            xw, code_tab,
            jnp.asarray(geom.s_int[k0:k1]), jnp.asarray(geom.s_frac[k0:k1]),
            jnp.float32(geom.incr), n=n, L=L,
        ))
    k_best = int(np.argmax(q))
    return SerialResult(
        prn=prn, doppler=doppler, metric=float(q[k_best]), k=k_best,
        code_offset=float((geom.stride * k_best + geom.phase0) % L),
    )
