"""Batched single-process workload runner (cold-path closer).

The reference workload (`acquire-all.sh`, `track-all-gnss-2017-L1L2L5.sh`)
spawns ONE PYTHON PROCESS PER SCRIPT — 21 acquisitions + 11 tracks, each
paying JAX runtime startup, device init, compile-cache load, and a fresh
demux pipe; for a 120 ms capture those fixed costs dwarf the device
work.

This module runs the SAME calls — the same `cli.acquire.main` /
`cli.track.main` entry points with the same argv the shell scripts build,
producing byte-identical output files — inside one process: one runtime,
one in-memory demux per band, warm compile cache across all scripts.

    python -m gnss_dsp.cli.workload acquire-all DATA DEST_DIR
    python -m gnss_dsp.cli.workload track-all   DATA DEST_DIR
    python -m gnss_dsp.cli.workload all         DATA DEST_DIR

Stage wall times print to stderr.
"""

from __future__ import annotations

import contextlib
import io as _io
import os
import sys
import time

_FS = "69984000"
_FRAME = 2 * int(69.984e6 // 1000)      # one band, one 1 ms frame, int8 I/Q

# (band, signal, coffset, outfile) — acquire-all.sh rows, in order
ACQUIRE_ALL = [
    (1, "gps-l1", "-9334875", "acq-gps-l1.dat"),
    (1, "glonass-l1", "17245125", "acq-glonass-l1.dat"),
    (1, "galileo-e1b", "-9334875", "acq-galileo-e1b.dat"),
    (1, "galileo-e1c", "-9334875", "acq-galileo-e1c.dat"),
    (1, "beidou-b1i", "-23656875", "acq-beidou-b1i.dat"),
    (2, "gps-l2cm", "-127126", "acq-gps-l2cm.dat"),
    (2, "glonass-l2", "18272874", "acq-glonass-l2.dat"),
    (2, "glonass-l3ocd", "-25702126", "acq-glonass-l3ocd.dat"),
    (2, "glonass-l3ocp", "-25702126", "acq-glonass-l3ocp.dat"),
    (2, "galileo-e5bi", "-20587126", "acq-galileo-e5bi.dat"),
    (2, "galileo-e5bq", "-20587126", "acq-galileo-e5bq.dat"),
    (2, "beidou-b2i", "-20587126", "acq-beidou-b2i.dat"),
    (3, "gps-l5i", "-15191625", "acq-gps-l5i.dat"),
    (3, "gps-l5q", "-15191625", "acq-gps-l5q.dat"),
    (3, "galileo-e5ai", "-15191625", "acq-galileo-e5ai.dat"),
    (3, "galileo-e5aq", "-15191625", "acq-galileo-e5aq.dat"),
    (3, "glonass-l3ocd", "10383375", "acq-glonass-l3ocd-ch3.dat"),
    (3, "glonass-l3ocp", "10383375", "acq-glonass-l3ocp-ch3.dat"),
    (3, "galileo-e5bi", "15498375", "acq-galileo-e5bi-ch3.dat"),
    (3, "galileo-e5bq", "15498375", "acq-galileo-e5bq-ch3.dat"),
    (3, "beidou-b2i", "15498375", "acq-beidou-b2i-ch3.dat"),
]

# (band, signal, coffset, prn, doppler, code_phase, outfile) —
# track-all-gnss-2017-L1L2L5.sh rows (the 2017-04-27 golden seeds)
TRACK_ALL = [
    (1, "gps-l1", "-9334875", "21", "2400.0", "817.50",
     "track-gps-l1-prn21.dat"),
    (1, "glonass-l1", "17245125", "-3", "-1200.0", "362.82",
     "track-glonass-l1-m3.dat"),
    (1, "galileo-e1b", "-9334875", "24", "250.0", "2838.00",
     "track-galileo-e1b-prn24.dat"),
    (1, "beidou-b1i", "-23656875", "34", "-600.0", "562.20",
     "track-beidou-b1i-prn34.dat"),
    (2, "gps-l2cm", "-127126", "29", "1120.0", "4208.80",
     "track-gps-l2cm-prn29.dat"),
    (2, "glonass-l2", "18272874", "-2", "-1800.0", "470.98",
     "track-glonass-l2-m2.dat"),
    (2, "glonass-l3ocd", "-25702126", "9", "-1800.0", "9429.00",
     "track-glonass-l3ocd-prn9.dat"),
    (2, "galileo-e5bi", "-20587126", "24", "200.0", "7919.00",
     "track-galileo-e5bi-prn24.dat"),
    (2, "beidou-b2i", "-20587126", "14", "-600.0", "1682.90",
     "track-beidou-b2i-prn14.dat"),
    (3, "gps-l5i", "-15191625", "25", "-1600.0", "9696.00",
     "track-gps-l5i-prn25.dat"),
    (3, "galileo-e5ai", "-15191625", "24", "200.0", "7919.00",
     "track-galileo-e5ai-prn24.dat"),
]


def demux_bands(data_path: str, dest_dir: str, bands=(1, 2, 3)) -> dict:
    """One pass over the 3-band container -> per-band int8 files (the
    packet2wav_3ch stand-in's slicing, without 21 subprocess pipes)."""
    t0 = time.perf_counter()
    outs = {b: open(os.path.join(dest_dir, f"band{b}.iq"), "wb")
            for b in bands}
    with open(data_path, "rb") as src:
        while True:
            frame = src.read(3 * _FRAME)
            if len(frame) < 3 * _FRAME:
                break
            for b in bands:
                outs[b].write(frame[(b - 1) * _FRAME: b * _FRAME])
    paths = {}
    for b, f in outs.items():
        f.close()
        paths[b] = f.name
    print(f"[workload] demux: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return paths


def _run_to_file(main_fn, signal, argv, outfile, **kw):
    t0 = time.perf_counter()
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(signal, argv, **kw)
    assert rc in (0, None), (signal, rc)
    with open(outfile, "w") as f:
        f.write(buf.getvalue())
    print(f"[workload] {os.path.basename(outfile):34s} "
          f"{time.perf_counter() - t0:6.1f} s", file=sys.stderr)


def run_acquire_all(data: str, dest: str) -> None:
    from gnss_dsp.cli.acquire import main as acquire_main

    os.makedirs(dest, exist_ok=True)
    bands = demux_bands(data, dest)
    t0 = time.perf_counter()
    x_cache: dict = {}       # band file -> device-resident split pair
    for band, signal, coffset, outfile in ACQUIRE_ALL:
        _run_to_file(acquire_main, signal, [bands[band], _FS, coffset],
                     os.path.join(dest, outfile), x_cache=x_cache)
    print(f"[workload] acquire-all: {len(ACQUIRE_ALL)} scripts in "
          f"{time.perf_counter() - t0:.1f} s (one process)",
          file=sys.stderr)


def run_track_all(data: str, dest: str) -> None:
    from gnss_dsp.cli.track import main as track_main

    os.makedirs(dest, exist_ok=True)
    bands = demux_bands(data, dest)
    t0 = time.perf_counter()
    # x_cache: ONE device upload per band shared by every script on that
    # band (cli.track._preload_chunk)
    x_cache: dict = {}
    for band, signal, coffset, prn, dop, phase, outfile in TRACK_ALL:
        _run_to_file(track_main, signal,
                     [bands[band], _FS, coffset, prn, dop, phase],
                     os.path.join(dest, outfile), x_cache=x_cache)
    print(f"[workload] track-all: {len(TRACK_ALL)} scripts in "
          f"{time.perf_counter() - t0:.1f} s (one process)",
          file=sys.stderr)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    what, data = argv[0], argv[1]
    dest = argv[2] if len(argv) > 2 else what.replace("all", "out")
    if what in ("acquire-all", "all"):
        run_acquire_all(data, dest)
    if what in ("track-all", "all"):
        run_track_all(data, dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
