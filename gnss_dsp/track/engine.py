"""DLL/FLL/PLL tracking as a jit scan over code-period blocks.

Behavioral contract: track-gps-l1.py:13-94 —
  per block: carrier wipeoff with running LUT-NCO phase, doppler-aided code
  rate cf=(code_f+carrier_f/ratio)/fs, three correlations (E/P/L), an
  FLL_WIDE -> FLL_NARROW -> PLL mode schedule, a normalized-envelope EML
  DLL, and phase/cycle bookkeeping.

Design:
  * the reference reads a data-dependent number of samples per block
    (:160-163); XLA needs static shapes, so each scan step slices NMAX
    samples at a per-channel pointer and masks i >= n.  NMAX covers the
    worst case (1.5 code periods).
  * the per-sample Numba recurrences (nco.mix_, ca.correlate) become
    vectorized int32-DDS phase grids + code-table gathers + masked dots.
    The two LUT mixes (carrier offset, carrier NCO) fuse into ONE
    oscillator evaluation: table[i]*table[j] == table[(i+j) mod 1024]
    exactly (angle addition on the quantized grid), so the reference's
    double quantization is preserved with half the work.
  * all sample data is split-complex (re, im) f32 (ops/cplx).
  * channels are batched with vmap — throughput comes from the channel
    axis, not from parallelizing the (inherently sequential) time loop.
  * loop state is a NamedTuple pytree -> checkpointable, exact-resumable.
  * unbounded counters (total samples, integer code/carrier cycles) are
    emitted as small per-block deltas and accumulated host-side in int64,
    so the device state stays pure f32/int32.

Mode indices: 0=FLL_WIDE, 1=FLL_NARROW, 2=PLL (gains: :50-70).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import nco
from gnss_dsp.ops import discriminators as disc
from gnss_dsp.utils import twofloat as tf

# float row layout emitted per block (ints travel separately)
ROW_FIELDS = (
    "block", "p_re", "p_im", "carrier_f", "code_f_minus_nominal",
    "phase_deg", "early", "prompt", "late", "code_p", "carrier_p",
)
INT_FIELDS = ("n", "carrier_dcyc", "code_dcyc")


class TrackParams(NamedTuple):
    """Static per-run parameters (python scalars; hashed into the jit key)."""
    fs: float
    chip_rate: float
    cf_hi: float               # chip_rate/fs split to double-f32 (hi part)
    cf_lo: float               # ... lo part: f32 alone biases the code phase
    code_length: int
    carrier_ratio: float
    el_spacing: float
    coffset_df_fixed: int      # int32 DDS increment for -coffset/fs
    nmax: int                  # static slice width (>= 1.5 sub-blocks)
    fll_wide_blocks: int       # mode schedule (--loop-dwells)
    fll_narrow_blocks: int
    fll_wide_k: float = 3.0
    fll_narrow_k: float = 0.8
    pll_k1: float = 0.1
    pll_k2: float = 3.5
    dll_k1: float = 2e-5
    dll_k2: float = 0.2
    code_period_ms: float = 1.0
    sub: int = 1               # sub-blocks per code period (e1b: 4, l1c: 10,
                               # l2cm: 20, l2cl: 1500, glonass-p: 1000)
    subcarrier: str = "none"   # none|boc11|cboc|tmboc|rz_even|rz_odd
    recover_after: int = -1    # unknown-code recovery: accumulate wiped
                               # samples into per-chip bins once
                               # block > recover_after; -1 = off
                               # (track-beidou-b2bi.py:47-53)
    coh_blocks: int = 1        # extended-coherent tracking: accumulate
                               # overlay-wiped complex E/P/L over M code
                               # periods; loop filters update at the M
                               # boundary only (framework extension — the
                               # carrier NCO is phase-continuous across
                               # blocks, so the sum is truly coherent;
                               # sub == 1 signals only)


# TMBOC(6,1,4/33) slot pattern: BOC(6,1) in chips 0,4,6,29 of each 33
# (gps/l1cp.py:202); CBOC weights sqrt(10/11), sqrt(1/11) (e1b.py:52)
_TMBOC = np.zeros(33, np.float32)
_TMBOC[[0, 4, 6, 29]] = 1.0
_CBOC_W1 = np.float32(0.953463)
_CBOC_W6 = np.float32(0.301511)

# ---------------------------------------------------------------------------
# Per-channel RUNTIME signal constants ("sigp").  These used to be
# static TrackParams fields, which made every signal family its own
# jit/compile key — the track-all workload paid one full XLA compile per
# family.  As runtime data, families sharing shapes (nmax/W/code-row
# bucket/subcarrier kind) share ONE compiled program, and channels of
# DIFFERENT signals can in principle batch into one scan.
# Lanes (f32; L/SUB are exact integers <= 5.11e6 < 2^24):
SIGP_CF_HI, SIGP_CF_LO, SIGP_EL, SIGP_L, SIGP_SPP, SIGP_SUB, \
    SIGP_A0, SIGP_A1, SIGP_A6, SIGP_COH, SIGP_NOV, SIGP_TM = range(12)
SIGP_LANES = 12

# every non-TMBOC subcarrier factor is affine in the two square waves:
# factor = a0 + a1*boc1 + a6*boc6 (exact in f32 for the 0.5/1 weights):
#   boc11   = boc1                      (l1cd.py:102-113)
#   cboc    = w1*boc1 + w6*boc6        (e1b.py:46-58)
#   rz_even = 1-bp = 0.5 + 0.5*boc1    (l2cm.py:81-91)
#   rz_odd  = bp   = 0.5 - 0.5*boc1    (l2cl.py:45)
SUBC_COEF = {
    "boc11": (0.0, 1.0, 0.0),
    "cboc": (0.0, float(_CBOC_W1), float(_CBOC_W6)),
    "rz_even": (0.5, 0.5, 0.0),
    "rz_odd": (0.5, -0.5, 0.0),
}


def subc_kind(subcarrier: str) -> str:
    """The STATIC residue of the subcarrier: "none" (8-row correlator
    plan), "tmboc" (needs the chip-index slot plane), or "subc" (every
    affine-coefficient family — coefficients ride in sigp lanes)."""
    return subcarrier if subcarrier in ("none", "tmboc", "subc") \
        else "subc"


def sigp_row(cf_hi, cf_lo, el, L, spp, sub, subcarrier: str,
             coh: int = 1, nov: int = 0):
    # "none" carries the identity coefficients (1, 0, 0): ignored by a
    # "none" program, and exactly BPSK inside a "subc" program — which
    # is what lets channels of DIFFERENT signals batch into one
    # mixed-constellation scan (track_file sigs=[...]).  coh is the
    # channel's extended-coherent period count M (1 = non-coherent —
    # the coherent math reduces exactly); nov its overlay length in the
    # shared overlay table (0 = the table's full width) — both RUNTIME
    # so channels of different pilot signals can mix coherently.
    if subcarrier == "none":
        a0, a1, a6 = 1.0, 0.0, 0.0
    else:
        a0, a1, a6 = SUBC_COEF.get(subcarrier, (0.0, 0.0, 0.0))
    # TMBOC's slot gating is not affine in the square waves, so it rides
    # its own RUNTIME gate lane: factor = a0 + a1*boc + a6*boc6
    # + tm*(slot*boc6 + (1-slot)*boc).  A "tmboc"-kind program computes
    # the slot plane for every channel but tm = 0 reduces non-TMBOC
    # channels to the affine form exactly — which is what lets gps-l1cp /
    # beidou-b1cp join mixed-constellation scans (track multi).
    tm = 1.0 if subcarrier == "tmboc" else 0.0
    return np.array([cf_hi, cf_lo, el, L, spp, sub, a0, a1, a6,
                     coh, nov, tm], np.float32)


def sigp_from_params(p: "TrackParams", C: int):
    """Default sigp for callers that pass true per-family TrackParams
    (tests, tools); track_file passes explicit sigp + bucket-normalized
    params instead."""
    assert p.subcarrier != "subc", \
        "normalized params need an explicit sigp"
    row = sigp_row(p.cf_hi, p.cf_lo, p.el_spacing, p.code_length,
                   p.fs * 0.001 * p.code_period_ms, p.sub, p.subcarrier,
                   coh=p.coh_blocks)
    return jnp.asarray(np.tile(row, (C, 1)))


class TrackState(NamedTuple):
    """Per-channel loop state ([C]-shaped leaves under vmap)."""
    ptr: jnp.ndarray           # int32 sample index into the current chunk
    code_p_hi: jnp.ndarray     # two-float chips in [0, L): f32 alone cannot
    code_p_lo: jnp.ndarray     # ... hold sub-1e-4-chip precision at ~1023
    code_f_off: jnp.ndarray    # f32 Hz offset from nominal chip_rate (f32 at
                               # 1.023e6 has 0.0625 Hz steps — the DLL's 1e-6 Hz
                               # corrections would vanish in absolute form)
    carrier_p: jnp.ndarray     # f32 cycles in [0, 1)
    carrier_f: jnp.ndarray     # f32 Hz
    coffset_p: jnp.ndarray     # uint32 fixed-point turns
    prompt1_re: jnp.ndarray    # f32 previous prompt (FLL memory)
    prompt1_im: jnp.ndarray
    carrier_e1: jnp.ndarray    # f32 previous PLL error
    code_e1: jnp.ndarray       # f32 previous DLL error
    block: jnp.ndarray         # int32 block counter
    stalled: jnp.ndarray       # bool: ran out of chunk samples
    n_full: jnp.ndarray        # int32 samples in the current code period
    sub_j: jnp.ndarray         # int32 sub-block index within the period
    acc_re: jnp.ndarray        # f32 [*, bins] code-recovery accumulator
    acc_im: jnp.ndarray        # ... ([*, 1] dummies when recovery is off)
    cacc: jnp.ndarray          # f32 [*, 6] coherent E/P/L accumulator
                               # (re, im x E/P/L; zeros when coh_blocks=1)


def init_state(code_p, code_f_off, carrier_p, carrier_f, ptr=0,
               recover_bins: int = 1) -> TrackState:
    c = np.shape(np.atleast_1d(code_p))[0]

    def as1(v, dt):
        a = np.atleast_1d(np.asarray(v))
        if a.shape[0] != c:
            a = np.full(c, a[0] if a.shape[0] else 0)
        return jnp.asarray(a.astype(dt))

    zeros = np.zeros(c)
    code_p64 = np.atleast_1d(np.asarray(code_p, np.float64))
    cp_hi = code_p64.astype(np.float32)
    cp_lo = (code_p64 - cp_hi.astype(np.float64)).astype(np.float32)
    return TrackState(
        ptr=as1(ptr, np.int32),
        code_p_hi=as1(cp_hi, np.float32),
        code_p_lo=as1(cp_lo, np.float32),
        code_f_off=as1(code_f_off, np.float32),
        carrier_p=as1(carrier_p, np.float32),
        carrier_f=as1(carrier_f, np.float32),
        coffset_p=as1(zeros, np.uint32),
        prompt1_re=as1(zeros, np.float32),
        prompt1_im=as1(zeros, np.float32),
        carrier_e1=as1(zeros, np.float32),
        code_e1=as1(zeros, np.float32),
        block=as1(zeros, np.int32),
        stalled=as1(zeros, bool),
        n_full=as1(zeros, np.int32),
        sub_j=as1(zeros, np.int32),
        acc_re=jnp.zeros((c, int(recover_bins)), jnp.float32),
        acc_im=jnp.zeros((c, int(recover_bins)), jnp.float32),
        cacc=jnp.zeros((c, 6), jnp.float32),
    )


def _sub_block_len(sub_j, n_full, sub: int):
    """int(((j+1)*nf)/sub) - int((j*nf)/sub) (the reference's sub-window
    boundaries, track-galileo-e1b.py:164-166) WITHOUT the j*nf product:
    at sub = 1500 (L2CL) and nf ~ 3.5e7 samples that product overflows
    int32 past j ~ 60.  Split nf = q*sub + r: the q part contributes q
    per sub-block exactly, and the r products are < sub^2 <= 2.25e6."""
    q = n_full // sub
    r = n_full - q * sub
    return q + ((sub_j + 1) * r) // sub - (sub_j * r) // sub


def _mode_of(block, p: TrackParams):
    """0 until fll_wide_blocks, 1 until +fll_narrow_blocks, then 2
    (track-gps-l1.py:155-158)."""
    m = jnp.where(block >= p.fll_wide_blocks, 1, 0)
    return jnp.where(block >= p.fll_wide_blocks + p.fll_narrow_blocks, 2, m)


def _cf_pieces(cf):
    """Split f32 cf into four f32 pieces of <= 7 significant bits each
    (sign, exponent and the top 6 mantissa bits; the remainders are
    exact), so i * piece is exact for i < 2**17 samples: a fused
    multiply-add then rounds exactly as a multiply followed by an add."""
    pieces = []
    r = cf
    for _ in range(4):
        bits = jax.lax.bitcast_convert_type(r, jnp.uint32)
        h = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFE0000),
                                         jnp.float32)
        pieces.append(h)
        r = r - h
    return pieces


def _track_block(x_chunk, chunk_len, code_tab, ratio, st: TrackState,
                 p: TrackParams, s_ovl=1.0, coffset_df=None, sp=None):
    """One tracking sub-block for one channel.  `ratio` is the per-channel
    carrier-aiding divisor, `coffset_df` the per-channel int32 DDS
    increment for the carrier-offset wipeoff (GLONASS FDMA channels each
    get their own: -(coffset + 562500*chan)/fs, track-glonass-l1.py:38-40,
    161), and `sp` the per-channel sigp lane row (runtime signal
    constants).  Returns (new_state, row_f [11], row_i [3])."""
    fs = p.fs
    Lf = sp[SIGP_L]
    Li = Lf.astype(jnp.int32)
    spp = sp[SIGP_SPP]
    sub_i = sp[SIGP_SUB].astype(jnp.int32)
    el = sp[SIGP_EL]

    # --- adaptive block length targeting the next code boundary (:160-163),
    # computed once per period; long periods run in sub sub-slices with
    # the reference's int(j*n/sub) boundaries (track-galileo-e1b.py:164-166).
    # One unified formula: sub == 1 reduces to n = n_full exactly.
    code_p = st.code_p_hi + st.code_p_lo
    n_f = jnp.where(
        code_p < Lf / 2,
        spp * (Lf - code_p) / Lf,
        spp * (2 * Lf - code_p) / Lf,
    )
    at_start = st.sub_j == 0
    n_full = jnp.where(at_start, n_f.astype(jnp.int32), st.n_full)
    n = _sub_block_len(st.sub_j, n_full, sub_i)
    sub_j_next = jnp.where(st.sub_j + 1 == sub_i, 0, st.sub_j + 1)

    ok = jnp.logical_and(jnp.logical_not(st.stalled), st.ptr + n <= chunk_len)

    i = jax.lax.broadcasted_iota(jnp.int32, (p.nmax, 1), 0).reshape(p.nmax)
    mask = i < n
    xb = (
        jax.lax.dynamic_slice(x_chunk[0], (st.ptr,), (p.nmax,)),
        jax.lax.dynamic_slice(x_chunk[1], (st.ptr,), (p.nmax,)),
    )

    # --- fused double LUT mix: offset NCO x carrier NCO == one LUT angle
    if coffset_df is None:
        coffset_df = jnp.int32(p.coffset_df_fixed)
    ph1 = st.coffset_p + (i * coffset_df).astype(jnp.uint32)
    carr_df = nco.freq_to_fixed_jnp(-st.carrier_f / fs)
    carr_p0 = (jnp.mod(st.carrier_p, 1.0) * jnp.float32(2.0**32)).astype(jnp.uint32)
    ph2 = carr_p0 + (i * carr_df).astype(jnp.uint32)
    idx = (
        jax.lax.shift_right_logical(ph1, np.uint32(22))
        + jax.lax.shift_right_logical(ph2, np.uint32(22))
    ).astype(jnp.int32) & (nco.NT - 1)
    wc, ws = nco.cos_sin_of_idx(idx)
    xm = (xb[0] * wc - xb[1] * ws, xb[0] * ws + xb[1] * wc)

    # --- doppler-aided code rate and E/P/L correlations (:44-48):
    # cf = (code_f + carrier_f/ratio)/fs, split as exact base + dynamic part
    cf_dyn = (st.code_f_off + st.carrier_f / ratio) / fs
    cf = sp[SIGP_CF_HI] + cf_dyn                             # chips/sample

    # the ramp i*cf as a sum of EXACT products (see _cf_pieces), added
    # small-to-large: every backend rounds it identically, so the chip
    # each sample lands on does not depend on where it is compiled
    i_f = i.astype(jnp.float32)
    c1, c2, c3, c4 = _cf_pieces(cf)
    ramp_lo = (i_f * c4 + i_f * c3) + i_f * c2
    ramp_hi = i_f * c1

    def corr(lag_chips, want_cidx=False):
        # int/frac split keeps the gather exact for multi-million-chip
        # codes (GLONASS P, L2CL) where raw f32 code phase cannot: the
        # residual fr is an error-free two-float remainder, and the
        # fractional recurrence fr + i*cf stays small
        v = tf.tf_add_f((st.code_p_hi, st.code_p_lo), lag_chips)
        vint = jnp.floor(v[0] + v[1])
        fr = tf.tf_value(tf.tf_add_f(v, -vint))
        cp_i = (ramp_lo + fr) + ramp_hi
        vint_i = vint.astype(jnp.int32)
        cidx = jnp.mod(vint_i + jnp.floor(cp_i).astype(jnp.int32), Li)
        chips = jnp.take(code_tab, cidx, axis=0).astype(jnp.float32)

        kind = subc_kind(p.subcarrier)
        if kind != "none":
            # floor(2*cp) mod 2 == floor(2*cp_i) mod 2 because 2*vint is
            # even; same for the 12x phase (cf. e1b.py:48-56)
            bp = jnp.mod(jnp.floor(2.0 * cp_i).astype(jnp.int32), 2)
            boc = (1 - 2 * bp).astype(jnp.float32)
            bp6 = jnp.mod(jnp.floor(12.0 * cp_i).astype(jnp.int32), 2)
            boc6 = (1 - 2 * bp6).astype(jnp.float32)
            if kind == "tmboc":
                # runtime form (see sigp_row): non-TMBOC channels in a
                # tmboc-kind mixed program carry tm = 0
                slot = jnp.take(jnp.asarray(_TMBOC), jnp.mod(cidx, 33))
                chips = chips * (sp[SIGP_A0] + sp[SIGP_A1] * boc
                                 + sp[SIGP_A6] * boc6
                                 + sp[SIGP_TM]
                                 * (slot * boc6 + (1.0 - slot) * boc))
            else:
                chips = chips * (sp[SIGP_A0] + sp[SIGP_A1] * boc
                                 + sp[SIGP_A6] * boc6)

        chips = jnp.where(mask, chips, 0.0)
        out = (jnp.sum(xm[0] * chips), jnp.sum(xm[1] * chips))
        return (out + (cidx,)) if want_cidx else out

    p_early = corr(-el)
    pp_re, pp_im, cidx_p = corr(jnp.float32(0.0), want_cidx=True)
    p_prompt = (pp_re, pp_im)
    p_late = corr(el)

    new, row_f, row_i = _post_block(p_early, p_prompt, p_late, n, sub_j_next,
                                    n_full, ok, cf_dyn, st, p,
                                    s_ovl=s_ovl, coffset_df=coffset_df,
                                    sp=sp)

    if p.recover_after >= 0:
        # unknown-code recovery (track-beidou-b2bi.py:47-53): once
        # block > recover_after, scatter the data-wiped samples into
        # their code-phase bins, sign-corrected by the prompt's I arm
        sgn = jnp.where(p_prompt[0] > 0, jnp.float32(1.0), jnp.float32(-1.0))
        gate = sgn * jnp.logical_and(st.block > p.recover_after,
                                     ok).astype(jnp.float32)
        w = jnp.where(mask, gate, 0.0)
        new = new._replace(
            acc_re=st.acc_re.at[cidx_p].add(xm[0] * w),
            acc_im=st.acc_im.at[cidx_p].add(xm[1] * w),
        )
    return new, row_f, row_i


def _post_block(p_early, p_prompt, p_late, n, sub_j_next, n_full_new, ok,
                cf_dyn, st: TrackState, p: TrackParams,
                s_ovl=1.0, coffset_df=None, sp=None):
    """Loop-filter updates + bookkeeping after the three correlations
    (track-gps-l1.py:50-92).

    s_ovl: this code period's secondary-overlay chip (+-1; 1 when
    overlay tracking is off).  With p.coh_blocks = M > 1 the overlay-
    wiped complex E/P/L accumulate in st.cacc and the loop filters see
    the M-period coherent sums, updating only at period M boundaries —
    the carrier NCO phase is continuous across blocks (:38-42), so the
    cross-block sum is truly coherent."""
    L = sp[SIGP_L]
    fs = p.fs

    coh = p.coh_blocks > 1
    if coh:
        # per-block wiped correlators feed the output row; the loop
        # filters see the accumulated sums at the boundary
        p_early = (s_ovl * p_early[0], s_ovl * p_early[1])
        p_prompt = (s_ovl * p_prompt[0], s_ovl * p_prompt[1])
        p_late = (s_ovl * p_late[0], s_ovl * p_late[1])
        acc = st.cacc + jnp.stack([
            p_early[0], p_early[1], p_prompt[0], p_prompt[1],
            p_late[0], p_late[1]])
        # M is RUNTIME (sigp lane): a mixed-constellation scan carries a
        # different coherent span per channel; M = 1 reduces exactly to
        # the non-coherent update (u always true, acc = wiped block)
        M_c = jnp.maximum(sp[SIGP_COH].astype(jnp.int32), 1)
        u = ((st.block + 1) % M_c) == 0
        cacc_new = jnp.where(u, 0.0, acc)
        f_early = (acc[0], acc[1])
        f_prompt = (acc[2], acc[3])
        f_late = (acc[4], acc[5])
    else:
        u = True
        cacc_new = st.cacc
        f_early, f_prompt, f_late = p_early, p_prompt, p_late

    # --- carrier phase bookkeeping (:38-42); dcyc counts whole cycles
    carrier_p_new = st.carrier_p - n.astype(jnp.float32) * st.carrier_f / fs
    t = jnp.mod(carrier_p_new, 1.0)
    carrier_dcyc = jnp.round(carrier_p_new - t).astype(jnp.int32)
    if coffset_df is None:
        coffset_df = jnp.int32(p.coffset_df_fixed)
    coffset_p_new = st.coffset_p + (n * coffset_df).astype(jnp.uint32)

    # --- carrier loop (:50-70); prompt1 only refreshed in FLL modes
    mode = _mode_of(st.block, p)
    e_fll = disc.fll_atan(f_prompt, (st.prompt1_re, st.prompt1_im))
    e_pll = disc.pll_costas(f_prompt)
    fll_k = jnp.where(mode == 0, p.fll_wide_k, p.fll_narrow_k)
    carrier_f_new = jnp.where(
        mode == 2,
        st.carrier_f + p.pll_k1 * e_pll + p.pll_k2 * (e_pll - st.carrier_e1),
        st.carrier_f + fll_k * e_fll,
    )
    carrier_e1_new = jnp.where(mode == 2, e_pll, st.carrier_e1)
    prompt1_re_new = jnp.where(mode == 2, st.prompt1_re, f_prompt[0])
    prompt1_im_new = jnp.where(mode == 2, st.prompt1_im, f_prompt[1])

    # --- code loop: normalized-envelope EML DLL (:74-86)
    early = jnp.sqrt(p_early[0] ** 2 + p_early[1] ** 2)
    prompt = jnp.sqrt(p_prompt[0] ** 2 + p_prompt[1] ** 2)
    late = jnp.sqrt(p_late[0] ** 2 + p_late[1] ** 2)
    f_e = jnp.sqrt(f_early[0] ** 2 + f_early[1] ** 2)
    f_l = jnp.sqrt(f_late[0] ** 2 + f_late[1] ** 2)
    denom = f_l + f_e
    e_dll = jnp.where(denom == 0, 0.0,
                      (f_l - f_e) / jnp.where(denom == 0, 1.0, denom))
    code_f_off_new = st.code_f_off + p.dll_k1 * e_dll + p.dll_k2 * (e_dll - st.code_e1)

    if coh:
        # loop filters advance only at the M-period boundary
        carrier_f_new = jnp.where(u, carrier_f_new, st.carrier_f)
        carrier_e1_new = jnp.where(u, carrier_e1_new, st.carrier_e1)
        prompt1_re_new = jnp.where(u, prompt1_re_new, st.prompt1_re)
        prompt1_im_new = jnp.where(u, prompt1_im_new, st.prompt1_im)
        code_f_off_new = jnp.where(u, code_f_off_new, st.code_f_off)
        e_dll = jnp.where(u, e_dll, st.code_e1)

    # --- code phase advance (:88-92) in two-float so per-block f32 rounding
    # of n*cf (~1e-4 chips) cannot accumulate into a phase bias; dcyc counts
    # whole chips (ref quirk: code_cyc sums code_p-t, multiples of L)
    n_f = n.astype(jnp.float32)
    adv = tf.tf_mul_f((sp[SIGP_CF_HI], sp[SIGP_CF_LO]), n_f)
    adv = tf.tf_add_f(adv, n_f * cf_dyn)
    cp_new = tf.tf_add((st.code_p_hi, st.code_p_lo), adv)
    (cp_hi, cp_lo), wraps = tf.tf_mod(cp_new, L)
    tc = cp_hi + cp_lo
    code_dcyc = (wraps * L).astype(jnp.int32)

    new = TrackState(
        ptr=st.ptr + n,
        code_p_hi=cp_hi,
        code_p_lo=cp_lo,
        code_f_off=code_f_off_new,
        carrier_p=t,
        carrier_f=carrier_f_new,
        coffset_p=coffset_p_new,
        prompt1_re=prompt1_re_new,
        prompt1_im=prompt1_im_new,
        carrier_e1=carrier_e1_new,
        code_e1=e_dll,
        block=st.block + 1,
        stalled=st.stalled,
        n_full=n_full_new,
        sub_j=sub_j_next,
        acc_re=st.acc_re,          # recovery bins updated by the caller
        acc_im=st.acc_im,          # (gated on ok there)
        cacc=cacc_new,
    )
    # freeze the channel if the chunk ran dry (host refills and resumes)
    new = jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, st)
    new = new._replace(stalled=jnp.logical_not(ok))

    row_f = jnp.stack([
        st.block.astype(jnp.float32),
        p_prompt[0], p_prompt[1],
        carrier_f_new, code_f_off_new,
        (180.0 / jnp.pi) * jnp.arctan2(p_prompt[1], p_prompt[0]),
        early, prompt, late, tc, t,
    ])
    row_i = jnp.stack([n, carrier_dcyc, code_dcyc])
    row_f = jnp.where(ok, row_f, jnp.nan)
    row_i = jnp.where(ok, row_i, 0)
    return new, row_f, row_i


@partial(jax.jit, static_argnames=("params", "n_blocks"))
def track_scan(x_chunk, chunk_len, code_tab, state: TrackState,
               params: TrackParams, n_blocks: int, ratios=None,
               overlay=None, coffset_df=None, sigp=None):
    """Run up to n_blocks tracking sub-blocks for C channels over one
    device chunk.  x_chunk: split-complex pair; code_tab: int8 [C, L];
    state leaves are [C]-shaped; ratios: f32 [C] carrier-aiding divisors
    (defaults to params.carrier_ratio for every channel).  overlay: f32
    [C, N] per-channel secondary chips for coherent tracking
    (params.coh_blocks > 1).  sigp: f32 [C, SIGP_LANES] runtime signal
    constants (defaults from params; track_file passes explicit rows with
    bucket-normalized params so families share compiled programs).

    Returns (state, rows_f [n_blocks, C, 11], rows_i [n_blocks, C, 3]);
    rows are NaN/0 once a channel exhausts the chunk (host refills and
    re-enters).

    chunk_len: scalar, or [C] i32 PER-CHANNEL data ends — the
    single-program multi-band receiver packs each band's stream into
    its own segment of one device chunk and gives every channel its
    band's segment end."""
    chunk_len = jnp.broadcast_to(jnp.asarray(chunk_len, jnp.int32),
                                 state.block.shape)
    if ratios is None:
        ratios = jnp.full(state.block.shape, params.carrier_ratio,
                          jnp.float32)
    if coffset_df is None:
        coffset_df = jnp.full(state.block.shape,
                              jnp.int32(params.coffset_df_fixed))
    if sigp is None:
        sigp = sigp_from_params(params, state.block.shape[0])

    def step(st, _):
        if params.coh_blocks > 1 and overlay is not None:
            # per-channel overlay period (SIGP_NOV; 0 = table width)
            novs = sigp[:, SIGP_NOV].astype(jnp.int32)
            novs = jnp.where(novs > 0, novs,
                             jnp.int32(overlay.shape[1]))
            s_ovl = jnp.take_along_axis(
                overlay, (st.block % novs)[:, None], axis=1)[:, 0]
        else:
            s_ovl = jnp.ones(st.block.shape, jnp.float32)
        new, row_f, row_i = jax.vmap(
            lambda s, cl, ct, r, so, cdf, spr: _track_block(
                x_chunk, cl, ct, r, s, params, s_ovl=so,
                coffset_df=cdf, sp=spr)
        )(st, chunk_len, code_tab, ratios, s_ovl, coffset_df, sigp)
        return new, (row_f, row_i)

    state, (rows_f, rows_i) = jax.lax.scan(step, state, None, length=n_blocks)
    return state, rows_f, rows_i
