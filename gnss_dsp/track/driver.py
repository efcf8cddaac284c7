"""Host driver for the tracking engine: chunked streaming, multi-channel
batching, row accumulation and reference-format output.

Behavioral contract: track-gps-l1.py:125-180 (single channel, blocking
reads); here N channels share one device-resident sample chunk, each with
its own pointer, and the unbounded counters (samp, code_cyc, carrier_cyc)
are accumulated host-side in int64 from per-block deltas.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.ops import nco
from gnss_dsp.track.engine import (
    TrackParams, init_state, track_scan,
)


class _PrefetchReader:
    """Double-buffered host ingest: the next chunk's file read runs on a
    worker thread while the device scans the current chunk (SURVEY.md §7
    'Host I/O' hard part — the reference blocks on every read,
    track-gps-l1.py:165).  Yields RAW interleaved int8 I/Q bytes — the
    int8->f32 deinterleave happens ON DEVICE (cplx.from_int8_iq), so the
    host link carries 2 bytes/sample instead of 8."""

    def __init__(self, fp, ahead_samples: int):
        import queue
        import threading

        self.fp = fp
        self.q = queue.Queue(maxsize=2)
        self.leftover = np.zeros(0, np.int8)
        self.done = False
        self._chunk = int(ahead_samples)
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            raw = self.fp.read(2 * self._chunk)
            if not raw:
                self.q.put(None)
                return
            n2 = 2 * (len(raw) // 2)
            self.q.put(np.frombuffer(raw, np.int8, count=n2))
            if n2 < 2 * self._chunk:
                self.q.put(None)
                return

    def take(self, want: int):
        """Up to `want` SAMPLES of int8 I/Q bytes (short only at EOF);
        None when drained."""
        parts = []
        got = len(self.leftover) // 2
        if got:
            parts.append(self.leftover)
            self.leftover = np.zeros(0, np.int8)
        while got < want and not self.done:
            nxt = self.q.get()
            if nxt is None:
                self.done = True
                break
            parts.append(nxt)
            got += len(nxt) // 2
        if not parts:
            return None
        x = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if len(x) > 2 * want:
            self.leftover = x[2 * want:]
            x = x[: 2 * want]
        return x


@dataclass
class TrackChannel:
    prn: int
    doppler: float
    code_offset: float
    carrier_phase: float = 0.0
    pll_from_start: bool = False   # --carrier-phase given (:135-137)
    overlay_phase: int = 0         # secondary-overlay chip index of the
                                   # first tracked code period (coherent
                                   # tracking; from coherent acquisition)
    # host-side accumulators
    samp: int = 0
    code_cyc: int = 0
    carrier_cyc: int = 0
    rows: list = field(default_factory=list)
    recovered: np.ndarray | None = None   # complex per-chip recovery bins


def make_params(sig, fs: float, coffset: float, loop_dwells=(500, 500),
                pll_from_start: bool = False, chan: int = 0,
                recover_after: int = -1,
                coherent_blocks: int = 1) -> TrackParams:
    period_ms = sig.code_period_ms
    sub = sig.sub_blocks
    nmax = int(fs * 0.001 * period_ms / sub * 1.5) + 4
    fw, fn = loop_dwells
    if pll_from_start or sig.track_mode_initial == "PLL":
        # --carrier-phase runs (:135-137) and the Xona scripts
        # (track-xona-x1p.py:151) start directly in PLL
        fw = fn = 0
    from gnss_dsp.utils.twofloat import tf_from_f64

    cf_hi, cf_lo = tf_from_f64(np.float64(sig.chip_rate) / np.float64(fs))
    return TrackParams(
        fs=float(fs),
        chip_rate=float(sig.chip_rate),
        cf_hi=cf_hi,
        cf_lo=cf_lo,
        code_length=int(sig.code_length),
        carrier_ratio=float(sig.track_carrier_ratio(chan)),
        el_spacing=float(sig.el_spacing),
        # NOTE: this static field is a fallback default only — track_file
        # always passes the per-channel runtime coffset_df array, so the
        # compiled program is identical for every carrier offset.  Keep
        # the true value here (used when track_scan is called without
        # coffset_df, e.g. in unit tests); cli paths that want cross-
        # offset cache hits pass coffset_df explicitly.
        coffset_df_fixed=int(nco.freq_to_fixed(-coffset / fs)),
        nmax=nmax,
        fll_wide_blocks=int(fw),
        fll_narrow_blocks=int(fn),
        pll_k1=float(sig.pll_k1),
        pll_k2=float(sig.pll_k2),
        code_period_ms=float(period_ms),
        sub=int(sub),
        subcarrier=str(sig.subcarrier),
        recover_after=int(recover_after),
        coh_blocks=int(coherent_blocks),
    )


def _coherent_span(s, coherent_blocks: int) -> int:
    """Per-channel coherent span: -1 = the signal's own overlay length
    (1 = non-coherent for overlay-free signals in a mix)."""
    if coherent_blocks == -1:
        return len(s.secondary(1)) if s.secondary is not None else 1
    return int(coherent_blocks)


def coherent_static(sigs, coherent_blocks: int) -> int:
    """The program's static coherent span: the longest channel span."""
    if not (coherent_blocks == -1 or coherent_blocks > 1):
        return 1
    # the M-period accumulator indexes overlay chips by whole code
    # periods; sub-divided signals would need sub-aware indexing —
    # asserted per CHANNEL (a mix may carry M = 1 sub-divided ones)
    for s in sigs:
        if _coherent_span(s, coherent_blocks) > 1:
            assert s.sub_blocks == 1, (s.name, s.sub_blocks)
    return max(_coherent_span(s, coherent_blocks) for s in sigs)


def runtime_tables(params: TrackParams, sigs, channels, fs: float,
                   coherent_blocks: int, coh_static: int):
    """(params, sigp, overlay) for a scan over `channels` of `sigs`.

    Every per-signal value moves out of the STATIC jit key into the
    runtime sigp lanes (ratios and coffset_df travel separately), so
    signal families sharing shapes (nmax / subcarrier kind) share ONE
    compiled program, and CLI invocations hit the persistent cache
    across carrier offsets and families.  overlay: f32 [C, Nmax]
    per-channel secondary rows for coherent tracking (None when
    coh_static == 1); each channel's true period rides the SIGP_NOV lane
    (the zero padding is never indexed: block % nov_c < nov_c)."""
    from gnss_dsp.track.engine import SIGP_COH, SIGP_NOV, sigp_row, subc_kind
    from gnss_dsp.utils.twofloat import tf_from_f64

    def _row(s):
        cf_hi_t, cf_lo_t = tf_from_f64(
            np.float64(s.chip_rate) / np.float64(fs))
        return sigp_row(cf_hi_t, cf_lo_t, s.el_spacing, s.code_length,
                        fs * 0.001 * s.code_period_ms, s.sub_blocks,
                        str(s.subcarrier))

    sigp = np.stack([_row(s) for s in sigs])
    kinds = {subc_kind(str(s.subcarrier)) for s in sigs}
    kind = "tmboc" if "tmboc" in kinds else (
        "subc" if kinds - {"none"} else "none")
    params = params._replace(
        coffset_df_fixed=0, carrier_ratio=1.0,
        chip_rate=0.0, cf_hi=0.0, cf_lo=0.0,
        code_length=0, el_spacing=0.0, code_period_ms=0.0,
        sub=0, subcarrier=kind)
    overlay = None
    if coh_static > 1:
        spans = [_coherent_span(s, coherent_blocks) for s in sigs]
        secs = []
        for s, ch, m in zip(sigs, channels, spans):
            sec = (s.secondary(ch.prn) if m > 1 and s.secondary is not None
                   else np.ones(1, np.int8))
            # block b uses chip (overlay_phase + b) mod N
            secs.append(np.roll(np.asarray(sec, np.float32),
                                -int(ch.overlay_phase)))
        overlay = np.zeros((len(channels), max(len(r) for r in secs)),
                           np.float32)
        for k, r in enumerate(secs):
            overlay[k, :len(r)] = r
        overlay = jnp.asarray(overlay)
        sigp[:, SIGP_COH] = spans
        sigp[:, SIGP_NOV] = [len(r) for r in secs]
    return params, jnp.asarray(sigp), overlay


def track_file(sig, fp, fs: float, coffset: float, channels,
               loop_dwells=(500, 500), chunk_ms: float = 2000.0,
               max_blocks: int | None = None, emit=None,
               recover_after: int | None = None,
               checkpoint_path: str | None = None,
               resume_from: str | None = None,
               coherent_blocks: int = 1, mesh=None,
               preloaded=None, sigs=None, coffsets=None):
    """Track `channels` (list[TrackChannel]) through the stream `fp`.

    emit(channel_index, row_dict) is called once per completed block, in
    block order per chunk.  Returns the channels (rows accumulated when
    emit is None).

    recover_after: run unknown-code recovery starting after that many
    blocks (None = signal default: 200 for B2b, off otherwise —
    track-beidou-b2bi.py:47-53); recovered complex bins land on each
    channel's .recovered.

    checkpoint_path: save the full loop state + host counters after
    every device chunk (atomic rename); resume_from: restart from such
    a file — `fp` must be seekable (the file is repositioned to the
    checkpoint's stream offset) and the run continues bit-exactly
    (failure/elastic flow, SURVEY.md §5; fault-injection test
    tests/test_checkpoint.py::test_cli_kill_resume_bitexact).

    preloaded: (x_dev_pair, n_samples) — a DEVICE-RESIDENT padded chunk
    holding the ENTIRE stream (single-chunk mode; `fp` is ignored).  The
    batched workload runner shares one upload per band across every
    script on that band.  The pair's padded length must be a
    multiple of 1024 with >= the engine's per-family margin beyond
    n_samples (the runner pads generously); incompatible with
    checkpoint/resume/mesh.
    """
    multi = sigs is not None and len({s.name for s in sigs}) > 1
    if sigs is None:
        sigs = [sig] * len(channels)
    else:
        sigs = list(sigs)
        assert len(sigs) == len(channels)
    # multi: mixed-constellation single-program mode (enabled by the
    # runtime sigp lanes): every channel carries its own signal's
    # constants; the shared program is the shape envelope.  A
    # tmboc-kind program computes the TMBOC slot plane for every
    # channel (tm = 0 reduces the others to the affine form exactly).
    # Unknown-code recovery mixes too: the per-chip bins are [C, Lmax]
    # state and the correlator scatters each channel's wiped samples
    # modulo its OWN runtime code length — e.g. B2bi + B2bq recover both
    # memory codes in one pass (the reference ran two processes).
    L = max(s.code_length for s in sigs)
    if recover_after is None:
        recover_after = (200 if all(s.recover_default for s in sigs)
                         else -1)

    coh_static = coherent_static(sigs, coherent_blocks)
    if coh_static == 1:
        coherent_blocks = 1           # -1 resolved to "nothing coherent"
    n_emit = len(channels)
    if mesh is not None:
        # channel-sharded scan (parallel/track.track_scan_sharded): pad
        # the channel list to a multiple of the sat axis with clones of
        # channel 0 (their rows are computed but never emitted)
        nsat = mesh.shape["sat"]
        pad = (-len(channels)) % nsat
        if pad:
            c0 = channels[0]
            channels = list(channels) + [
                TrackChannel(prn=c0.prn, doppler=c0.doppler,
                             code_offset=c0.code_offset,
                             carrier_phase=c0.carrier_phase,
                             pll_from_start=c0.pll_from_start)
                for _ in range(pad)]
            sigs = sigs + [sigs[0]] * pad
    params = make_params(sig, fs, coffset, loop_dwells,
                         pll_from_start=all(c.pll_from_start for c in channels),
                         recover_after=recover_after,
                         coherent_blocks=coh_static)
    if multi:
        # shared-program shape envelope over the mixed families
        params = params._replace(nmax=max(
            make_params(s, fs, coffset).nmax for s in sigs))
    params, sigp, overlay = runtime_tables(params, sigs, channels, fs,
                                          coherent_blocks, coh_static)

    # --- alignment to the first code boundary (:141-143), per channel:
    # the reference discards n0 samples; with a shared stream we keep them
    # and start each channel's pointer at its own n0.
    abs_buf0 = 0          # absolute sample index of buf[0] in the stream
    resumed_blocks = 0
    if resume_from is not None:
        from gnss_dsp.track import checkpoint as _ckpt

        state, host, meta = _ckpt.load(resume_from)
        abs_buf0 = int(meta["abs_buf0"])
        resumed_blocks = int(meta["total_blocks"])
        fp.seek(2 * abs_buf0)
        for k, ch in enumerate(channels):
            ch.samp = int(host["samp"][k])
            ch.code_cyc = int(host["code_cyc"][k])
            ch.carrier_cyc = int(host["carrier_cyc"][k])
    else:
        ptr0 = np.zeros(len(channels), np.int32)
        code_p0 = np.zeros(len(channels), np.float64)
        for k, ch in enumerate(channels):
            s = sigs[k]
            Lk = s.code_length
            n0 = int(fs * 0.001 * s.code_period_ms
                     * (Lk - ch.code_offset) / Lk)
            ptr0[k] = n0
            code_p0[k] = ch.code_offset + n0 * (s.chip_rate / fs)

        state = init_state(
            code_p=code_p0,
            code_f_off=np.zeros(len(channels)),
            carrier_p=np.array([c.carrier_phase for c in channels]),
            carrier_f=np.array([c.doppler for c in channels]),
            ptr=ptr0,
            recover_bins=L if recover_after >= 0 else 1,
        )
    tabs = None
    if multi:
        tabs = [np.asarray(s.code_table((c.prn,))[0], np.int8)
                for s, c in zip(sigs, channels)]
        Lmax = max(t.shape[0] for t in tabs)
        code_np = np.zeros((len(channels), Lmax), np.int8)
        for k, t in enumerate(tabs):
            code_np[k, : t.shape[0]] = t     # gather index < L_k always
    else:
        code_np = sig.code_table(
            tuple(c.prn for c in channels)).astype(np.int8)
    code_tab = jnp.asarray(code_np)
    ratios = jnp.asarray(
        np.array([s.track_carrier_ratio(c.prn)
                  for s, c in zip(sigs, channels)], np.float32)
    )
    # per-channel carrier-offset wipeoff: GLONASS FDMA channels sit
    # fdma_hz*chan away from the channel-0 coffset the CLI passes
    # (track-glonass-l1.py:161: fm = -(coffset+562500*chan)/fs);
    # mixed-constellation channels may each carry their own band-center
    # offset (coffsets list)
    if coffsets is None:
        coffsets = [coffset] * len(channels)
    else:
        coffsets = list(coffsets) + [coffset] * (len(channels)
                                                 - len(coffsets))
    coffset_df = jnp.asarray(np.array(
        [nco.freq_to_fixed(-(co + (s.fdma_hz or 0.0) * c.prn) / fs)
         for s, c, co in zip(sigs, channels, coffsets)], np.int32))
    pad_extra = params.nmax

    chunk_samples = int(fs * chunk_ms / 1000.0)
    sub_ms = min(s.code_period_ms / s.sub_blocks for s in sigs)
    blocks_per_scan = int(chunk_ms / sub_ms) + 2

    def emit_rows(rows_f, rows_i, nb):
        rows_f = np.asarray(rows_f)
        rows_i = np.asarray(rows_i)
        any_row = False
        for b in range(nb):
            for k, ch in enumerate(channels):
                nn = int(rows_i[b, k, 0])
                if nn == 0:
                    continue
                any_row = True
                if k >= n_emit:        # mesh-padding clone of channel 0
                    continue
                ch.samp += nn
                ch.carrier_cyc += int(rows_i[b, k, 1])
                ch.code_cyc += int(rows_i[b, k, 2])
                f = rows_f[b, k]
                row = {
                    "block": int(f[0]), "p_re": float(f[1]),
                    "p_im": float(f[2]),
                    "carrier_f": float(f[3]), "code_f_offset": float(f[4]),
                    "phase_deg": float(f[5]), "early": float(f[6]),
                    "prompt": float(f[7]), "late": float(f[8]),
                    "code_cyc": ch.code_cyc, "code_p": float(f[9]),
                    "carrier_cyc": ch.carrier_cyc,
                    "carrier_p": float(f[10]),
                    "samp": ch.samp,
                }
                if emit is not None:
                    emit(k, row)
                else:
                    ch.rows.append(row)
        return any_row

    if preloaded is not None:
        # compatibility gate — fall back to the streaming reader when
        # the preloaded pad is too small for this family's margins or a
        # stateful mode is requested
        x_dev, n_file = preloaded
        if (resume_from is not None or checkpoint_path is not None
                or mesh is not None or x_dev[0].shape[0] % 1024 != 0
                or x_dev[0].shape[0] < n_file + pad_extra):
            preloaded = None
    if preloaded is not None:
        # single-chunk mode: the whole (padded) stream is already
        # device-resident and shared across callers — no reader, no
        # refills, no rebasing; scan until every channel stalls at the
        # data end or max_blocks is reached
        x_dev, n_file = preloaded
        file_blocks = int(n_file / fs * 1000.0 / sub_ms) + 2
        total_blocks = 0
        while True:
            nb = min(blocks_per_scan, file_blocks)
            if max_blocks is not None:
                nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break
            state = state._replace(stalled=jnp.zeros_like(state.stalled))
            state, rows_f, rows_i = track_scan(
                x_dev, jnp.int32(n_file), code_tab, state, params, nb,
                ratios=ratios, overlay=overlay, coffset_df=coffset_df,
                sigp=sigp,
            )
            emitted_any = emit_rows(rows_f, rows_i, nb)
            total_blocks += nb
            if not emitted_any:
                break
            if bool(np.asarray(state.stalled).all()):
                break
        if recover_after >= 0:
            acc_re = np.asarray(state.acc_re)
            acc_im = np.asarray(state.acc_im)
            for k, ch in enumerate(channels):
                ch.recovered = acc_re[k] + 1j * acc_im[k]
        return channels

    buf = np.zeros(0, np.int8)         # interleaved int8 I/Q bytes
    total_blocks = resumed_blocks
    reader = _PrefetchReader(fp, chunk_samples + pad_extra)
    from gnss_dsp.ops import cplx as _cplx

    # GNSS_DSP_TIMING=1: per-stage wall split of the streaming loop
    # (host-read wait / upload+convert / scan+row-readback), printed to
    # stderr at stream end — the long-capture receiver's attribution.
    # Waiting for each upload serializes it with the scan, so the split
    # is measure-only (off by default).
    timing = bool(os.environ.get("GNSS_DSP_TIMING"))
    t_read = t_up = t_scan = 0.0
    import time as _time

    while True:
        # refill device chunk (the next file read was already started on
        # the prefetch thread while the previous scan ran)
        t0 = _time.perf_counter()
        nbuf = len(buf) // 2
        want = chunk_samples + params.nmax - nbuf
        if want > 0:
            xx = reader.take(want)
            if xx is not None and len(xx):
                buf = np.concatenate([buf, xx])
                nbuf = len(buf) // 2
        if nbuf == 0:
            break
        t_read += _time.perf_counter() - t0

        nb = blocks_per_scan
        if max_blocks is not None:
            nb = min(nb, max_blocks - total_blocks)
            if nb <= 0:
                break

        # pad so per-channel windows are in range for any valid ptr; total
        # length rounded to a multiple of 1024 so the chunk length (a
        # compile-key shape) repeats across chunks.  The raw int8 bytes
        # upload as-is and the zero pad is appended DEVICE-side
        # (from_int8_iq): 2 bytes/sample on the host link
        t0 = _time.perf_counter()
        tail = pad_extra + (-(nbuf + pad_extra)) % 1024
        if os.environ.get("GNSS_DSP_UPLOAD_INT4"):
            # opt-in 4-bit front end (1 B/sample on the host link; see
            # cplx.pack_int4_host for the quantization budget)
            x_dev = _cplx.from_int4_iq(_cplx.pack_int4_host(buf),
                                       pad=tail)
        else:
            x_dev = _cplx.from_int8_iq(buf, pad=tail)
        if timing:
            jax.block_until_ready(x_dev)
            t_up += _time.perf_counter() - t0
            t0 = _time.perf_counter()
        state = state._replace(stalled=jnp.zeros_like(state.stalled))
        if mesh is not None:
            from gnss_dsp.parallel.track import track_scan_sharded

            state, rows_f, rows_i = track_scan_sharded(
                mesh, x_dev, jnp.int32(nbuf), code_tab, state, params,
                nb, ratios=ratios, coffset_df=coffset_df, sigp=sigp,
                overlay=overlay,
            )
        else:
            state, rows_f, rows_i = track_scan(
                x_dev, jnp.int32(nbuf), code_tab, state, params, nb,
                ratios=ratios, overlay=overlay, coffset_df=coffset_df,
                sigp=sigp,
            )
        emitted_any = emit_rows(rows_f, rows_i, nb)
        if timing:
            t_scan += _time.perf_counter() - t0
        total_blocks += nb
        if max_blocks is not None and total_blocks >= max_blocks:
            break

        # drop fully-consumed samples, rebase pointers (buf is int8
        # interleaved I/Q: 2 bytes per sample)
        ptrs = np.asarray(state.ptr)
        consumed = int(ptrs.min())
        buf = buf[2 * consumed:]
        state = state._replace(ptr=jnp.asarray(ptrs - consumed, jnp.int32))
        abs_buf0 += consumed

        if checkpoint_path is not None:
            # atomic per-chunk checkpoint: state ptrs are relative to
            # buf[0] = stream sample abs_buf0, so resume only needs a
            # seek — no buffered samples are serialized
            from gnss_dsp.track import checkpoint as _ckpt
            import os as _os

            tmp = checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                _ckpt.save(f, state, channels,
                           meta={"abs_buf0": abs_buf0,
                                 "total_blocks": total_blocks})
            _os.replace(tmp, checkpoint_path)

        if reader.done and not emitted_any:
            break
        if reader.done and bool(np.asarray(state.stalled).all()):
            # every channel is frozen at the data end and no samples can
            # ever arrive: rebasing cannot unstall them (ptr and
            # chunk_len shift together), so a re-scan would emit nothing.
            # Breaking now (after this iteration's checkpoint) instead of
            # after a no-op scan matters because the residual buffer has
            # a different padded length — that extra scan was a second
            # full XLA compile per signal family (track-all paid it x11)
            break

    if timing:
        import sys as _sys

        print(f"[track_file timing] read-wait {t_read:.2f} s  "
              f"upload+convert {t_up:.2f} s  scan+rows {t_scan:.2f} s",
              file=_sys.stderr)
    if recover_after >= 0:
        acc_re = np.asarray(state.acc_re)
        acc_im = np.asarray(state.acc_im)
        for k, ch in enumerate(channels):
            ch.recovered = acc_re[k] + 1j * acc_im[k]
    return channels


def format_row_14(row: dict) -> str:
    """The reference 14-column text row (track-gps-l1.py:176-177)."""
    return "%d %f %f %f %f %f %f %f %f %d %f %d %f %d" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"], row["code_cyc"], row["code_p"], row["carrier_cyc"],
        row["carrier_p"], row["samp"],
    )


def format_row_9(row: dict) -> str:
    """The reference 9-column row (e.g. track-galileo-e1b.py:166-167)."""
    return "%d %f %f %f %f %f %f %f %f" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"],
    )
