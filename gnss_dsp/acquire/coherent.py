"""Extended-coherent acquisition with secondary-code wipeoff.

The reference carries a secondary (overlay) code for every pilot signal
but never consumes one — its acquisition is always 1-code-period coherent
+ non-coherent magnitude sums (acquire-gps-l1.py:30-39), which hits the
squaring loss well above the pilot signals' design sensitivity.  This
engine coherently integrates M consecutive code periods with the overlay
wiped off, trying every cyclic alignment of the secondary (the alignment
is unknown at acquisition):

    q[p, d, w] = max_a  sum_g | sum_m  s[(a+m) mod N] * R[g*M+m] |

where R are the COMPLEX per-block circular correlations (the same
batched FFT pipeline as engine.chunk_q, magnitude deferred), g indexes
non-coherent groups and s is the +-1 secondary.  ~sqrt(M) sensitivity
gain over M non-coherent sums, minus a boundary-straddle loss: block
windows are not code-aligned, so a block whose overlay chip flips
mid-peak loses part of its energy (up to 2*tau/n at code offset tau).
Acquiring deep below the non-coherent floor is still the point — see
tests/test_coherent.py.

Geometry is the signal's non-coherent search geometry: window = n
circular, or 2n for the zero-padded-code (pad2) and sliding templates.
The 2n LINEAR windows remove the straddle loss: each block's correlation
at lag j covers exactly one full code period starting at sample j, which
lies inside a single overlay chip (CoherentAcqResult.linear).

The overlay/rotation contraction runs in SPECTRAL space before the
inverse transform (the IDFT is linear in the data spectrum F):

    IDFT(C * conj(sum_m conj(w_am) F_m)) == sum_m w_am IDFT(C * conj(F_m))

so each (alignment, group) costs one inverse transform, the same count
as the per-block surfaces.  CS100-class overlays (N >= 25 alignments over
an N-block group) combine by a circular correlation over the overlay axis
(FFT_N), O(N log N) instead of O(N^2) per cell, and per-PRN overlays
(e5aq.py:13) combine per PRN on the shared data spectrum.

Doppler bins must shrink with the coherent span (~1/(M*T_code)); the
caller passes the finer grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx, fft, nco
from gnss_dsp.acquire import engine as _eng

# overlays this long, spanning a whole group, combine by FFT over the
# overlay axis instead of the [A, M] einsum
_FFT_COMBINE_MIN = 25


def overlay_matrix(secs, blocks: int, m_coh: int) -> np.ndarray:
    """f32 [NS, A, B]: sm[s, a, g*M + m] = secs[s][(a + m) mod N], the
    overlay sign of alignment a at block m of each group (the index
    restarts at every group, so any m_coh works)."""
    N = len(secs[0])
    m_loc = np.arange(blocks) % m_coh
    pat = (np.arange(N)[:, None] + m_loc[None, :]) % N
    return np.stack([np.asarray(s, np.float32)[pat] for s in secs])


@partial(jax.jit, static_argnames=("n", "window", "blocks", "m_coh",
                                   "dop_chunk", "precision"))
def grid_search_coherent(x, code_ffts, dopp_fixed, dopp_valid, sec_mat,
                         n: int, window: int, blocks: int, m_coh: int,
                         dop_chunk: int,
                         precision=jax.lax.Precision.HIGHEST):
    """Coherent twin of engine.grid_search.

    x          : split-complex [>= (blocks-1)*n + window]
    code_ffts  : split-complex [P, window] (code zero-padded to window)
    dopp_fixed : int32 [Dp], Dp % dop_chunk == 0
    dopp_valid : bool [Dp]
    sec_mat    : f32 [NS, A, B] from overlay_matrix; NS == 1 shares one
                 overlay across PRNs, NS == P gives each PRN its own
    blocks % m_coh == 0; groups = blocks // m_coh.
    Returns (metric [P], code_idx [P], dop_idx [P], align [P]) —
    metric is the raw coherent peak (the peak/mean normalization is
    meaningless across alignment maxima); align is the winning cyclic
    overlay alignment: block m correlated best with sec[(align+m) mod N].
    """
    P = code_ffts[0].shape[0]
    Dp = dopp_fixed.shape[0]
    n_chunks = Dp // dop_chunk
    G = blocks // m_coh
    NS, A, _ = sec_mat.shape
    zero_p = jnp.zeros((), jnp.uint32)
    xb = _eng.block_windows(x, n, window, blocks)
    code_c = jax.lax.complex(code_ffts[0], code_ffts[1])        # [P, W]
    m_f = jnp.arange(blocks, dtype=jnp.float32)
    fft_combine = A == m_coh and A >= _FFT_COMBINE_MIN
    if fft_combine:
        # sec_mat[s, a, 0] = s[a]: the raw chips; their spectra [NS, N]
        s_spec = jnp.fft.fft(sec_mat[:, :, 0].astype(jnp.complex64),
                             axis=-1)
    else:
        sg = sec_mat.reshape(NS, A, G, m_coh)

    def chunk_body(carry, ci):
        best_metric, best_code, best_dop, best_al = carry
        d0 = ci * dop_chunk
        df = jax.lax.dynamic_slice(dopp_fixed, (d0,), (dop_chunk,))
        valid = jax.lax.dynamic_slice(dopp_valid, (d0,), (dop_chunk,))
        w = jax.vmap(lambda f: nco.nco_split(f, zero_p, window))(df)
        F = fft.fft(cplx.cmul(
            (xb[0][None, :, :], xb[1][None, :, :]),
            (w[0][:, None, :], w[1][:, None, :]),
        ), precision=precision)                               # [DC, B, W]
        # the per-block doppler wipe restarts its phase at every block
        # start (engine.chunk_q semantics, acquire-gps-l1.py:28-30), so a
        # signal at this bin's frequency carries a CONSTANT residual
        # rotation of n*d/fs cycles per block: fold exp(-i*ang) into the
        # spectral weights (the correlation conjugates it back)
        blk_cyc = (df.astype(jnp.uint32) * jnp.uint32(n)).astype(
            jnp.float32) * jnp.float32(1.0 / 2**32)           # [DC] cycles
        ang = (2.0 * jnp.pi) * blk_cyc[:, None] * m_f[None, :]   # [DC, B]
        y = (jax.lax.complex(F[0], F[1])
             * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))[..., None])
        yg = y.reshape(dop_chunk, G, m_coh, window)
        if fft_combine:
            # z[a] = sum_m y[m] s[(a + m) mod N] = IFFT(N*IFFT(y) * FFT(s))
            yc = jnp.fft.ifft(yg, axis=2) * np.float32(A)
            fa = jnp.fft.ifft(yc[None] * s_spec[:, None, None, :, None],
                              axis=3)                     # [NS, DC, G, A, W]
        else:
            fa = jnp.einsum("sagm,dgmw->sdgaw", sg.astype(jnp.complex64),
                            yg, precision=precision)
        prod = code_c[:, None, None, None, :] * jnp.conj(fa)
        R = fft.ifft((jnp.real(prod), jnp.imag(prod)),
                     precision=precision)                 # [P, DC, G, A, W]
        qa = jnp.sqrt(R[0] * R[0] + R[1] * R[1]).sum(axis=2)  # [P, DC, A, W]
        a_idx = jnp.argmax(qa, axis=2).astype(jnp.int32)      # [P, DC, W]
        q = qa.max(axis=2)

        peak = jnp.max(q, axis=-1)
        code_idx = jnp.argmax(q, axis=-1).astype(jnp.int32)
        al = jnp.take_along_axis(a_idx, code_idx[:, :, None], 2)[:, :, 0]
        metric = jnp.where(valid[None, :], peak, -jnp.inf)
        ch_best = jnp.argmax(metric, axis=-1)
        ch_metric = jnp.take_along_axis(metric, ch_best[:, None], 1)[:, 0]
        ch_code = jnp.take_along_axis(code_idx, ch_best[:, None], 1)[:, 0]
        ch_al = jnp.take_along_axis(al, ch_best[:, None], 1)[:, 0]
        upd = ch_metric > best_metric
        return (
            jnp.where(upd, ch_metric, best_metric),
            jnp.where(upd, ch_code, best_code),
            jnp.where(upd, (d0 + ch_best).astype(jnp.int32), best_dop),
            jnp.where(upd, ch_al, best_al),
        ), None

    init = (jnp.full((P,), -jnp.inf, jnp.float32),
            jnp.zeros((P,), jnp.int32), jnp.zeros((P,), jnp.int32),
            jnp.zeros((P,), jnp.int32))
    (metric, code_idx, dop_idx, align), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks))
    return metric, code_idx, dop_idx, align


def acquire_signal_coherent(sig, x_int, prns, doppler_search,
                            m_coh: int | None = None, ms: int | None = None,
                            dop_chunk: int | None = None, chan: int = 0,
                            precision=jax.lax.Precision.HIGHEST):
    """Secondary-wiped extended-coherent acquisition of `sig`.

    m_coh defaults to the full secondary length (NH10 -> 10 ms, NH20 ->
    20 ms, CS25 -> 25 ms ...); ms defaults to one coherent group.
    Signals without a secondary get an all-ones overlay (plain extended
    coherent, alignment-free).  pad2/sliding signals search 2n LINEAR
    windows (module docstring).  Returns list[CoherentAcqResult].
    """
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    secs = [np.asarray(sig.secondary(p) if sig.secondary is not None
                       else np.ones(1, np.int8), np.float32)
            for p in prns]
    sec = secs[0]
    # CS100-class signals carry a DIFFERENT secondary per PRN
    # (e5aq.py:13, b2ap Weil-100, e6c ...): each PRN gets its own overlay
    per_prn = any(s.shape != sec.shape or not np.array_equal(s, sec)
                  for s in secs[1:])
    if m_coh is None:
        m_coh = len(sec)
    m_coh = int(m_coh)
    if ms is None:
        ms = int(m_coh * sig.acq_coherent_ms)
    blocks = int(ms / sig.acq_coherent_ms)
    blocks = max(blocks // m_coh, 1) * m_coh
    N = len(sec)

    dops, fixed = _eng.doppler_grid(sig, doppler_search, chan)
    if dop_chunk is None:
        # a chunk holds [P, DC, G, N, W] complex surfaces (x ~4 temps);
        # size DC to keep that under ~1.2 GB of device memory
        per_dc = len(prns) * (blocks // m_coh) * N * window * 32
        dop_chunk = int(np.clip(1.2e9 // per_dc, 1, len(dops)))
    Dp = -(-len(fixed) // dop_chunk) * dop_chunk
    fixed_p = np.zeros(Dp, np.int32)
    fixed_p[: len(fixed)] = fixed
    valid = np.zeros(Dp, bool)
    valid[: len(fixed)] = True

    x = cplx.from_numpy(x_int) if not isinstance(x_int, tuple) else x_int
    cf = cplx.from_numpy(_eng.build_code_ffts(sig, prns, n, window))
    sm = overlay_matrix(secs if per_prn else [sec], blocks, m_coh)
    metric, code_idx, dop_idx, align = (np.asarray(a) for a in
                                        grid_search_coherent(
        x, cf, jnp.asarray(fixed_p), jnp.asarray(valid), jnp.asarray(sm),
        n=n, window=window, blocks=blocks, m_coh=m_coh,
        dop_chunk=int(dop_chunk), precision=precision))
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(CoherentAcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code,
            align=int(align[i]), n_overlay=N, linear=window == 2 * n))
    return out


@dataclass
class CoherentAcqResult(_eng.AcqResult):
    """AcqResult + the winning overlay alignment: acquisition block m
    correlated best with overlay chip (align + m) mod n_overlay.
    linear=True marks the 2n-window search (pad2/sliding signals), where
    block m's winning correlation covers exactly the m-th full code
    period after the first code boundary (no straddle): align names the
    FIRST full period — the very period the track driver starts on —
    unconditionally."""
    align: int = 0
    n_overlay: int = 1
    linear: bool = False

    def track_overlay_phase(self, code_length: int) -> int:
        """Overlay chip index of the FIRST code period the track driver
        will process (TrackChannel.overlay_phase).  The driver discards
        samples up to the first code boundary (track-gps-l1.py:141-143),
        i.e. starts at capture period 1.  Linear (2n-window) search:
        block 0's winning window IS the first full period, so align
        names the tracker's first period directly.  Circular search:
        acquisition block 0 is DOMINATED by period 0 when the boundary
        falls in its second half (code_offset <= L/2) — then align
        names period 0's chip and period 1 carries align+1; otherwise
        block 0 is mostly period 1 and align already names it."""
        if self.linear:
            a = self.align
        else:
            a = self.align + (
                1 if self.code_offset <= code_length / 2 else 0)
        return a % self.n_overlay
