"""Acquisition CLI dispatcher.

Usage (mirrors acquire-gps-l1.py:46-61 argv/option layout):
  python -m gnss_dsp.cli.acquire SIGNAL [options] input_file sample_rate carrier_offset
  python -m gnss_dsp.cli.acquire gps-l2cl [options] input_file fs coffset prn doppler l2cm_code_phase
  python -m gnss_dsp.cli.acquire glonass-l1-p [options] input_file fs coffset chan doppler ca_code_phase

Output rows are byte-compatible with the reference workers
(acquire-gps-l1.py:102, acquire-glonass-l1.py:96-97, acquire-gps-l2cl.py:76).
"""

from __future__ import annotations

import optparse
import os
import sys

from gnss_dsp.models import get_signal
from gnss_dsp.acquire.engine import acquire_signal, acquire_signal_fdma
from gnss_dsp.acquire.serial import serial_search
from gnss_dsp.ops.frontend import prepare_baseband, mix_long
from gnss_dsp.ops import cplx
from gnss_dsp.utils import io as uio


def read_samples(filename, n: int, cache: dict | None = None):
    """n complex samples from `filename` as a DEVICE split-complex pair
    (raw int8 uploaded, converted on-device — 2 bytes/sample over the
    host link instead of 8, cplx.from_int8_iq).  With `cache`, the
    batched workload runner uploads each demuxed band ONCE and every
    script on that band slices it on-device."""
    from gnss_dsp.ops import cplx

    if cache is not None and filename != "-":
        ent = cache.get(filename)
        if ent is None:
            with open(filename, "rb") as fp:
                z = fp.read(2 * (os.path.getsize(filename) // 2))
            ent = cache[filename] = cplx.from_int8_iq(z)
        if ent[0].shape[0] < n:
            return None
        return (ent[0][:n], ent[1][:n])
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    z = fp.read(2 * int(n))
    if filename != "-":
        fp.close()
    if len(z) != 2 * int(n):
        return None
    return cplx.from_int8_iq(z)


def _fmt_row(sig, r) -> str:
    if sig.fdma_hz:
        return "chan % 2d doppler % 7.1f metric % 7.1f code_offset %7.2f" % (
            r.prn, r.doppler, r.metric, r.code_offset)
    if sig.acq_metric == "peak_mean":
        return "prn %3d doppler % 7.1f metric % 5.2f code_offset %6.1f" % (
            r.prn, r.doppler, r.metric, r.code_offset)
    return "prn %3d doppler % 7.1f metric % 7.1f code_offset %7.2f" % (
        r.prn, r.doppler, r.metric, r.code_offset)


def main(signal: str, argv=None, x_cache: dict | None = None) -> int:
    from gnss_dsp.cli import enable_compilation_cache

    enable_compilation_cache()
    sig = get_signal(signal)
    if sig.acq_serial:
        return _main_serial(sig, argv, x_cache)

    fdma = bool(sig.fdma_hz)
    usage = (f"acquire {signal} [options] input_filename sample_rate "
             "carrier_offset")
    parser = optparse.OptionParser(usage=usage)
    parser.disable_interspersed_args()
    opt_name = "--channel" if fdma else "--prn"
    parser.add_option(opt_name, dest="prn", default=sig.prn_default,
                      help="PRNs/channels to search (default %default)")
    parser.add_option("--doppler-search", metavar="MIN,MAX,INCR",
                      default="%g,%g,%g" % sig.doppler_default,
                      help="Doppler search grid (default %default)")
    parser.add_option("--time", type="int", default=sig.acq_ms_default,
                      help="integration time in ms (default %default)")
    parser.add_option("--coherent", type="int", default=0, metavar="M",
                      help="extended-coherent mode: integrate M code "
                      "periods coherently with the secondary overlay "
                      "wiped off (M=-1: full overlay length); needs a "
                      "correspondingly finer --doppler-search grid "
                      "(framework extension — the reference never "
                      "consumes its secondary codes)")
    parser.add_option("--mesh", type="int", default=0, metavar="N",
                      help="shard the search over an N-device jax mesh "
                      "(framework extension; 0 = single device, -1 = all "
                      "devices; routes to the parallel/ sharded twins)")
    options, args = parser.parse_args(argv)
    if len(args) != 3:
        parser.error("expected input_filename sample_rate carrier_offset")
    if options.mesh and options.coherent:
        parser.error("--mesh and --coherent are mutually exclusive")
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    ms = options.time
    dops = tuple(float(v) for v in options.doppler_search.split(","))
    prns = sig.prns(options.prn)

    import time as _time

    timing = os.environ.get("GNSS_DSP_TIMING")
    t0 = _time.perf_counter()
    x = read_samples(filename, int((ms + 5) * fs / 1000), x_cache)
    if x is None:
        print("insufficient samples", file=sys.stderr)
        return 1
    t1 = _time.perf_counter()

    xb = prepare_baseband(x, fs, coffset, sig.acq_fs, sig.acq_lowpass_hz,
                          ms + 2)
    if timing:
        import numpy as _np

        _np.asarray(xb[0][:1])        # force the front-end readback point
        t2 = _time.perf_counter()
        print(f"[timing] {signal}: read+upload {t1-t0:.2f}s "
              f"frontend {t2-t1:.2f}s", file=sys.stderr)
        t1 = t2
    if options.mesh:
        from gnss_dsp.parallel.mesh import make_mesh
        from gnss_dsp.parallel.acquire import (
            acquire_signal_sharded, acquire_signal_fdma_sharded,
        )

        mesh = make_mesh(None if options.mesh < 0 else options.mesh)
        run = (acquire_signal_fdma_sharded if fdma
               else acquire_signal_sharded)
        for r in run(sig, xb, prns, mesh, doppler_search=dops, ms=ms):
            print(_fmt_row(sig, r))
        return 0

    if fdma:
        if options.coherent:
            # extended-coherent per FDMA channel: each channel's band
            # offset folds into its own doppler grid (the channels
            # share one compiled program — only the NCO array differs)
            from gnss_dsp.acquire.coherent import (
                acquire_signal_coherent)

            m = None if options.coherent < 0 else options.coherent
            for chan in prns:
                for r in acquire_signal_coherent(sig, xb, [chan], dops,
                                                 m_coh=m, ms=ms,
                                                 chan=chan):
                    print(_fmt_row(sig, r))
            return 0
        # all channels in one grid program (each channel's band is one
        # doppler chunk of the shared m-sequence search)
        for r in acquire_signal_fdma(sig, xb, prns, doppler_search=dops,
                                     ms=ms):
            print(_fmt_row(sig, r))
        return 0

    if options.coherent:
        from gnss_dsp.acquire.coherent import acquire_signal_coherent

        m = None if options.coherent < 0 else options.coherent
        for r in acquire_signal_coherent(sig, xb, prns, dops, m_coh=m,
                                         ms=ms):
            print(_fmt_row(sig, r))
        return 0

    for r in acquire_signal(sig, xb, prns, doppler_search=dops, ms=ms):
        print(_fmt_row(sig, r))
    if timing:
        print(f"[timing] {signal}: search {_time.perf_counter()-t1:.2f}s",
              file=sys.stderr)
    return 0


def _main_serial(sig, argv, x_cache: dict | None = None) -> int:
    fdma = bool(sig.fdma_hz)
    label = "chan" if fdma else "prn"
    parser = optparse.OptionParser(
        usage=f"acquire {sig.name} [options] input_filename sample_rate "
              f"carrier_offset {label} doppler parent_code_phase")
    parser.disable_interspersed_args()
    parser.add_option("--time", type="int",
                      default=40 if sig.acq_serial == 75 else 80,
                      help="integration time in ms (default %default)")
    options, args = parser.parse_args(argv)
    if len(args) != 6:
        parser.error("expected file fs coffset %s doppler code_phase" % label)
    filename, fs, coffset = args[0], float(args[1]), float(args[2])
    prn, doppler, phase = int(args[3]), float(args[4]), float(args[5])
    ms = options.time

    x = read_samples(filename, int((ms + 2) * fs / 1000), x_cache)
    if x is None:
        print("insufficient samples", file=sys.stderr)
        return 1
    xs = mix_long(x if isinstance(x, tuple) else cplx.from_numpy(x),
                  -coffset / fs)
    r = serial_search(sig, xs, prn, doppler, parent_code_phase=phase,
                      fs=fs, ms=ms, chan=prn if fdma else 0)
    # reference row: code_phase metric (acquire-gps-l2cl.py:76)
    print("%f %f" % (sig.acq_serial_stride * r.k
                     + sig.acq_serial_scale * phase, r.metric))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("usage: python -m gnss_dsp.cli.acquire SIGNAL ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))


def _entry():
    if len(sys.argv) < 2:
        print("usage: gnss-acquire SIGNAL ...", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))
