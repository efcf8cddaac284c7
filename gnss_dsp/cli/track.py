"""Tracking CLI dispatcher.

Usage (mirrors track-gps-l1.py:100-137):
  python -m gnss_dsp.cli.track SIGNAL [options] input_file sample_rate \
      carrier_offset prn doppler code_offset

Prints one row per tracked (sub-)block in the reference's 9- or 14-column
text format (track-gps-l1.py:176-177, track-galileo-e1b.py:166-167).
Supports multiple channels at once via comma syntax "21:2400:817.5,5:..."
(an extension; single prn/doppler/code_offset argv is reference-exact).
"""

from __future__ import annotations

import optparse
import os
import sys

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import (
    TrackChannel, track_file, format_row_9, format_row_14,
)


def _preload_chunk(path: str, fs: float, chunk_ms: float, cache: dict):
    """Device-resident whole-file chunk shared across CLI calls (the
    batched workload runner's per-band upload cache — mirrors
    cli.acquire's x_cache).  Returns (split_pair, n_samples) or None
    when the file exceeds one chunk (streaming path handles it)."""
    import os as _os

    import numpy as np

    n = _os.path.getsize(path) // 2
    if n > int(fs * chunk_ms / 1000.0):
        return None
    if path in cache:
        return cache[path]
    from gnss_dsp.ops import cplx

    raw = np.fromfile(path, np.int8)
    # generous shared tail: covers every family's window margin
    # (track_file falls back to streaming if it ever doesn't);
    # int8 upload + on-device convert/pad — 2 bytes/sample over the
    # host link instead of 8 (cplx.from_int8_iq)
    pad = int(fs * 0.006) + 16384
    pad += (-(n + pad)) % 1024
    dev = cplx.from_int8_iq(raw[: 2 * n], pad=pad)
    cache[path] = (dev, n)
    return cache[path]


def main_multi(argv=None, x_cache: dict | None = None) -> int:
    """Mixed-constellation single-program tracking (framework extension
    enabled by the runtime sigp lanes — no reference analog; the
    reference runs one process per signal):

      track multi [options] input_file sample_rate carrier_offset \\
          SIG:prn:doppler:code_offset[,SIG:prn:doppler:code_offset...]

    Every channel (possibly of a DIFFERENT signal) runs in ONE compiled
    scan over one pass of the stream.  Rows print with a "SIG:prn "
    prefix in each signal's native 9/14-column format.  TMBOC channels
    (gps-l1cp, beidou-b1cp) mix via the runtime slot-gate lane, and long
    codes (gps-l2cl, glonass-l1-p/l2-p) mix with short ones."""
    import optparse

    from gnss_dsp.models import get_signal

    from gnss_dsp.cli import enable_compilation_cache

    enable_compilation_cache()
    parser = optparse.OptionParser(
        usage="track multi [options] input_filename sample_rate "
              "carrier_offset SIG:prn:doppler:code[,SIG:prn:doppler:code]")
    parser.disable_interspersed_args()
    parser.add_option("--loop-dwells", default="500,500")
    parser.add_option("--blocks", type="int", default=0)
    parser.add_option("--chunk-ms", type="float", default=2000.0)
    parser.add_option("--coherent", type="int", default=1, metavar="M",
                      help="extended-coherent tracking per channel: -1 "
                      "integrates each signal's own overlay length "
                      "(overlay-free signals stay non-coherent); an "
                      "explicit M applies to every channel")
    parser.add_option("--recover", action="store_true", default=False,
                      help="unknown-code recovery for EVERY channel "
                           "(e.g. B2bi + B2bq recover both "
                           "memory codes in one pass); bins land in "
                           "RECOVER_FILE-SIG-PRN.dat per channel")
    parser.add_option("--recover-warmup", type="int", default=200)
    parser.add_option("--recover-file", default="track-chips.dat")
    options, args = parser.parse_args(
        sys.argv[1:] if argv is None else argv)
    if len(args) != 4:
        parser.error("expected file fs coffset SIG:prn:dop:code[,...]")
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    sigs, channels, coffsets = [], [], []
    for spec in args[3].split(","):
        parts = spec.split(":")
        name, p, d, co = parts[:4]
        sigs.append(get_signal(name))
        # optional 6th field: the channel's overlay phase for --coherent
        # (from coherent acquisition's track_overlay_phase)
        channels.append(TrackChannel(
            prn=int(p), doppler=float(d), code_offset=float(co),
            overlay_phase=int(parts[5]) if len(parts) > 5 else 0))
        # optional 5th field: this channel's own carrier offset (mixed
        # bands / band-center differences within one stream)
        coffsets.append(float(parts[4]) if len(parts) > 4 else coffset)
    dwells = tuple(int(v) for v in options.loop_dwells.split(","))
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer

    fmts = [format_row_14 if s.row_format == 14 else format_row_9
            for s in sigs]

    def emit(k, row):
        print(f"{sigs[k].name}:{channels[k].prn} " + fmts[k](row))

    preloaded = None
    if x_cache is not None and filename != "-":
        preloaded = _preload_chunk(filename, fs, options.chunk_ms, x_cache)
    recover_after = options.recover_warmup if options.recover else -1
    track_file(sigs[0], fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit,
               recover_after=recover_after, preloaded=preloaded, sigs=sigs,
               coffsets=coffsets, coherent_blocks=options.coherent)
    if options.recover:
        base, ext = os.path.splitext(options.recover_file)
        for s, ch in zip(sigs, channels):
            with open(f"{base}-{s.name}-{ch.prn}{ext}", "w") as f:
                for v in ch.recovered[: s.code_length]:
                    f.write("%f %f\n" % (v.real, v.imag))
    return 0


def main(signal: str, argv=None, x_cache: dict | None = None) -> int:
    if signal == "multi":
        return main_multi(argv, x_cache)
    from gnss_dsp.cli import enable_compilation_cache

    enable_compilation_cache()
    sig = get_signal(signal)
    fdma = bool(sig.fdma_hz)
    label = "chan" if fdma else "prn"
    parser = optparse.OptionParser(
        usage=f"track {signal} [options] input_filename sample_rate "
              f"carrier_offset {label} doppler code_offset")
    parser.disable_interspersed_args()
    parser.add_option("--loop-dwells", default="500,500",
                      help="wide-FLL,narrow-FLL dwell in ms (default %default)")
    parser.add_option("--carrier-phase",
                      help="initial carrier phase in cycles (PLL from start)")
    parser.add_option("--blocks", type="int", default=0,
                      help="stop after N blocks (0 = run to EOF)")
    parser.add_option("--recover", action="store_true", default=None,
                      help="unknown-code recovery: accumulate data-wiped "
                           "samples into per-chip bins and write "
                           "track-chips.dat at EOF (default on for B2b, "
                           "as in track-beidou-b2bi.py:47-53)")
    parser.add_option("--no-recover", action="store_true", default=False,
                      help="disable unknown-code recovery")
    parser.add_option("--recover-warmup", type="int", default=200,
                      help="blocks to track before accumulating "
                           "(default %default, track-beidou-b2bi.py:47)")
    parser.add_option("--recover-file", default="track-chips.dat",
                      help="recovered-bins output path (default %default)")
    parser.add_option("--coherent", type="int", default=1, metavar="M",
                      help="extended-coherent tracking: accumulate "
                           "secondary-wiped complex E/P/L over M code "
                           "periods, loop updates at the M boundary; "
                           "-1 = the signal's own overlay length "
                           "(framework extension; sub-divided signals "
                           "excluded)")
    parser.add_option("--overlay-phase", type="int", default=0,
                      help="secondary-overlay chip index of the first "
                           "tracked code period (from coherent "
                           "acquisition; default %default)")
    parser.add_option("--chunk-ms", type="float", default=2000.0,
                      help="device chunk length in ms (default %default; "
                           "also the checkpoint cadence)")
    parser.add_option("--checkpoint", metavar="FILE", default=None,
                      help="save resumable loop state to FILE after every "
                           "device chunk (atomic; framework extension — the "
                           "reference can only re-seed argv manually, "
                           "track-gps-l1.py:121,133-135)")
    parser.add_option("--mesh", type="int", default=0, metavar="N",
                      help="shard channels over an N-device jax mesh "
                      "(framework extension; 0 = single device, -1 = all "
                      "devices; channel count padded up to the mesh)")
    parser.add_option("--resume", metavar="FILE", default=None,
                      help="resume from a --checkpoint file (input must be "
                           "a seekable file, not a pipe); continues "
                           "bit-exactly and re-emits from the checkpointed "
                           "block")
    options, args = parser.parse_args(argv)
    dwells = tuple(int(v) for v in options.loop_dwells.split(","))
    carrier_phase = (float(options.carrier_phase)
                     if options.carrier_phase is not None else 0.0)
    pll = options.carrier_phase is not None

    if len(args) == 4 and ":" in args[3]:
        # multi-channel extension: "prn:doppler:code[,prn:doppler:code...]"
        filename, fs, coffset = args[0], float(args[1]), float(args[2])
        channels = []
        for spec in args[3].split(","):
            p, d, co = spec.split(":")
            channels.append(TrackChannel(
                prn=int(p), doppler=float(d), code_offset=float(co),
                carrier_phase=carrier_phase, pll_from_start=pll,
                overlay_phase=options.overlay_phase))
    elif len(args) == 6:
        filename, fs, coffset = args[0], float(args[1]), float(args[2])
        channels = [TrackChannel(
            prn=int(args[3]), doppler=float(args[4]),
            code_offset=float(args[5]),
            carrier_phase=carrier_phase, pll_from_start=pll,
            overlay_phase=options.overlay_phase)]
    else:
        parser.error(f"expected file fs coffset {label} doppler code_offset"
                     f" (or file fs coffset prn:dop:code,prn:dop:code,...)")

    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    fmt = format_row_14 if sig.row_format == 14 else format_row_9
    multi = len(channels) > 1

    def emit(k, row):
        prefix = f"ch{channels[k].prn} " if multi else ""
        print(prefix + fmt(row))

    if options.no_recover:
        recover_after = -1
    elif options.recover:
        recover_after = options.recover_warmup
    else:
        recover_after = options.recover_warmup if sig.recover_default else -1

    if options.resume and filename == "-":
        parser.error("--resume needs a seekable input file, not stdin")
    if options.coherent > 1 and sig.sub_blocks != 1:
        parser.error(f"--coherent needs a whole-period signal; "
                     f"{signal} tracks in {sig.sub_blocks} sub-blocks")
    mesh = None
    if options.mesh:
        from gnss_dsp.parallel.mesh import make_mesh

        mesh = make_mesh(None if options.mesh < 0 else options.mesh,
                         time_shards=1)
    preloaded = None
    if (x_cache is not None and filename != "-" and mesh is None
            and options.checkpoint is None and options.resume is None):
        preloaded = _preload_chunk(filename, fs, options.chunk_ms, x_cache)
    track_file(sig, fp, fs, coffset, channels, loop_dwells=dwells,
               chunk_ms=options.chunk_ms,
               max_blocks=options.blocks or None, emit=emit,
               recover_after=recover_after,
               checkpoint_path=options.checkpoint,
               resume_from=options.resume,
               coherent_blocks=options.coherent, mesh=mesh,
               preloaded=preloaded)
    if recover_after >= 0:
        # reference dumps the raw complex bins, one "%f %f" row per chip
        # (track-beidou-b2bi.py:181-184)
        with open(options.recover_file, "w") as f:
            for v in channels[0].recovered:
                f.write("%f %f\n" % (v.real, v.imag))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp.cli.track SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


def _entry():
    if len(sys.argv) < 2:
        print("usage: gnss-track SIGNAL ...", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))
