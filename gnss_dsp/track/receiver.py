"""Single-program multi-band receiver.

`track multi` runs every channel of ONE stream in one compiled scan;
this module goes the rest of the way: every channel of EVERY band in
one scan per chunk.  Each band's int8 stream is packed into its own
fixed-capacity SEGMENT of one shared device chunk, and each channel
carries its band's segment end as its PER-CHANNEL data end
(track_scan's vector chunk_len) — the per-channel ptr state needs no
other changes, since channels always addressed the shared chunk
independently.

Why: the 2017 reference workload is 11 channels over 3 bands.  Run as
three per-band programs the receiver pays 3x the per-chunk fixed costs
(dispatch, readback, scan tails); packed into ONE program it is one
dispatch chain and one readback per chunk.

Scope: tracking incl. per-channel extended-coherent spans (the
overlay/coh sigp lanes ride along); no recovery/checkpoint/mesh (use
the per-band `track multi` programs for those).

Setup mirrors track/driver.track_file's multi branch (runtime sigp
lanes, shape envelope, per-channel code rows); the streaming loop is
the per-band generalization of its int8 streaming loop.
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import cplx, nco
from gnss_dsp.track.driver import (
    _PrefetchReader, coherent_static, make_params, runtime_tables,
)
from gnss_dsp.track.engine import init_state, track_scan


def track_receiver(bands, fs: float, loop_dwells=(500, 500),
                   chunk_ms: float = 2000.0, emit=None,
                   max_blocks: int | None = None,
                   coherent_blocks: int = 1):
    """Track every channel of every band in ONE compiled program.

    bands: list of (fp, sigs, channels, coffsets) — one entry per band
    stream (fp: binary int8 I/Q stream; sigs/channels/coffsets: same
    per-channel contracts as track_file's multi mode).  All bands share
    one sample rate `fs`.

    coherent_blocks: extended-coherent span per channel, track_file
    semantics (-1 = each signal's own overlay length; overlay-free
    signals stay non-coherent; channels use their overlay_phase).

    emit(global_channel_index, row) as in track_file; returns the
    channel list (band-major order).  Rows accumulate on the channels
    when emit is None.
    """
    sigs, channels, coffsets, band_of = [], [], [], []
    for b, (fp, bs, bc, bco) in enumerate(bands):
        assert len(bs) == len(bc) == len(bco)
        sigs += list(bs)
        channels += list(bc)
        coffsets += list(bco)
        band_of += [b] * len(bc)
    B = len(bands)
    C = len(channels)

    coh_static = coherent_static(sigs, coherent_blocks)
    params = make_params(sigs[0], fs, 0.0, loop_dwells,
                         pll_from_start=all(c.pll_from_start
                                            for c in channels),
                         coherent_blocks=coh_static)
    params = params._replace(nmax=max(make_params(s, fs, 0.0).nmax
                                      for s in sigs))
    params, sigp, overlay = runtime_tables(params, sigs, channels, fs,
                                          coherent_blocks, coh_static)

    tabs = [np.asarray(s.code_table((c.prn,))[0], np.int8)
            for s, c in zip(sigs, channels)]
    Lmax = max(t.shape[0] for t in tabs)
    code_np = np.zeros((C, Lmax), np.int8)
    for k, t in enumerate(tabs):
        code_np[k, : t.shape[0]] = t
    code_tab = jnp.asarray(code_np)
    ratios = jnp.asarray(np.array(
        [s.track_carrier_ratio(c.prn) for s, c in zip(sigs, channels)],
        np.float32))
    coffset_df = jnp.asarray(np.array(
        [nco.freq_to_fixed(-(co + (s.fdma_hz or 0.0) * c.prn) / fs)
         for s, c, co in zip(sigs, channels, coffsets)], np.int32))
    pad_extra = params.nmax

    chunk_samples = int(fs * chunk_ms / 1000.0)
    # fixed per-band segment capacity: buffered data (chunk + nmax)
    # plus the window margin, rounded to a multiple of 1024
    seg_cap = chunk_samples + params.nmax + pad_extra
    seg_cap += (-seg_cap) % 1024
    seg_off = [b * seg_cap for b in range(B)]
    sub_ms = min(s.code_period_ms / s.sub_blocks for s in sigs)
    blocks_per_scan = int(chunk_ms / sub_ms) + 2

    # per-channel alignment to the first code boundary, segment-offset
    ptr0 = np.zeros(C, np.int32)
    code_p0 = np.zeros(C, np.float64)
    for k, ch in enumerate(channels):
        s = sigs[k]
        Lk = s.code_length
        n0 = int(fs * 0.001 * s.code_period_ms * (Lk - ch.code_offset) / Lk)
        ptr0[k] = seg_off[band_of[k]] + n0
        code_p0[k] = ch.code_offset + n0 * (s.chip_rate / fs)
    state = init_state(
        code_p=code_p0, code_f_off=np.zeros(C),
        carrier_p=np.array([c.carrier_phase for c in channels]),
        carrier_f=np.array([c.doppler for c in channels]),
        ptr=ptr0)

    def emit_rows(rows_f, rows_i, nb):
        rows_f = np.asarray(rows_f)
        rows_i = np.asarray(rows_i)
        any_row = False
        for blk in range(nb):
            for k, ch in enumerate(channels):
                nn = int(rows_i[blk, k, 0])
                if nn == 0:
                    continue
                any_row = True
                ch.samp += nn
                ch.carrier_cyc += int(rows_i[blk, k, 1])
                ch.code_cyc += int(rows_i[blk, k, 2])
                f = rows_f[blk, k]
                row = {
                    "block": int(f[0]), "p_re": float(f[1]),
                    "p_im": float(f[2]), "carrier_f": float(f[3]),
                    "code_f_offset": float(f[4]), "phase_deg": float(f[5]),
                    "early": float(f[6]), "prompt": float(f[7]),
                    "late": float(f[8]), "code_cyc": ch.code_cyc,
                    "code_p": float(f[9]), "carrier_cyc": ch.carrier_cyc,
                    "carrier_p": float(f[10]), "samp": ch.samp,
                }
                if emit is not None:
                    emit(k, row)
                else:
                    ch.rows.append(row)
        return any_row

    readers = [_PrefetchReader(fp, chunk_samples + pad_extra)
               for fp, *_ in bands]
    bufs = [np.zeros(0, np.int8) for _ in range(B)]
    total_blocks = 0
    timing = bool(os.environ.get("GNSS_DSP_TIMING"))
    t_read = t_up = t_scan = 0.0
    while True:
        t0 = time.perf_counter()
        nbufs = []
        for b in range(B):
            want = chunk_samples + params.nmax - len(bufs[b]) // 2
            if want > 0:
                xx = readers[b].take(want)
                if xx is not None and len(xx):
                    bufs[b] = np.concatenate([bufs[b], xx])
            nbufs.append(len(bufs[b]) // 2)
        if not any(nbufs):
            break
        t_read += time.perf_counter() - t0

        nb = blocks_per_scan
        if max_blocks is not None:
            nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break

        # assemble the segmented chunk: band b's bytes at its fixed
        # offset, zero margin after each band's data (the int8 zero
        # pad converts to 0.0 samples on device)
        t0 = time.perf_counter()
        assembled = np.zeros(2 * B * seg_cap, np.int8)
        for b in range(B):
            assembled[2 * seg_off[b]:2 * seg_off[b] + len(bufs[b])] = bufs[b]
        if os.environ.get("GNSS_DSP_UPLOAD_INT4"):
            # opt-in 4-bit front end: halves the host-link bytes again
            # (1 B/sample) at the classic coarse-quantization C/N0 cost
            x_dev = cplx.from_int4_iq(cplx.pack_int4_host(assembled))
        else:
            x_dev = cplx.from_int8_iq(assembled)
        chunk_end = jnp.asarray(
            np.array([seg_off[band_of[k]] + nbufs[band_of[k]]
                      for k in range(C)], np.int32))
        if timing:
            jax.block_until_ready(x_dev)
            t_up += time.perf_counter() - t0
            t0 = time.perf_counter()
        state = state._replace(stalled=jnp.zeros_like(state.stalled))
        state, rows_f, rows_i = track_scan(
            x_dev, chunk_end, code_tab, state, params, nb,
            ratios=ratios, coffset_df=coffset_df, sigp=sigp,
            overlay=overlay)
        emitted_any = emit_rows(rows_f, rows_i, nb)
        if timing:
            t_scan += time.perf_counter() - t0
        total_blocks += nb
        if max_blocks is not None and total_blocks >= max_blocks:
            break

        # per-band rebase: drop each band's fully-consumed samples
        ptrs = np.asarray(state.ptr)
        new_ptrs = ptrs.copy()
        for b in range(B):
            ks = [k for k in range(C) if band_of[k] == b]
            consumed = int(min(ptrs[k] for k in ks) - seg_off[b])
            consumed = max(consumed, 0)
            bufs[b] = bufs[b][2 * consumed:]
            for k in ks:
                new_ptrs[k] = ptrs[k] - consumed
        state = state._replace(ptr=jnp.asarray(new_ptrs, jnp.int32))

        if all(r.done for r in readers) and not emitted_any:
            break
        if (all(r.done for r in readers)
                and bool(np.asarray(state.stalled).all())):
            break
    if timing:
        import sys as _sys

        print(f"[track_receiver timing] read-wait {t_read:.2f} s  "
              f"upload+convert {t_up:.2f} s  scan+rows {t_scan:.2f} s",
              file=_sys.stderr)
    return channels
