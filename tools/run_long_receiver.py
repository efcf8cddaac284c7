"""Sustained long-capture receiver run.

Streams a MULTI-SECOND synthetic 3-band 69.984 MHz sky capture (the
2017-04-27 golden-seed constellation, tools/synth_sky.py) through the
production tracking path and reports the END-TO-END realtime multiple —
wall time vs capture duration, INCLUDING host file I/O, the int8 band
uploads over the host link, device compute, and row readback/formatting
— per band and aggregate.

Per band, all of that band's golden channels run as ONE mixed-
constellation `track multi` program (cli/track.py main_multi — band 1:
GPS L1 + GLONASS L1 + Galileo E1B + BeiDou B1I; band 2: five signals;
band 3: two), exercising _PrefetchReader streaming, per-chunk int8
device uploads, and the tracking scan over the full capture.
Every channel must stay locked to its seed doppler to the last rows —
a multi-second hold, not the 120 ms workload's 100-block convergence.

    python tools/run_long_receiver.py [capture.pcap] [seconds] [--repeat N]

With GNSS_DSP_TIMING=1 the driver prints the read/upload/scan wall split
(waiting for each upload serializes it with the scan, so the default run
measures the pipelined wall without it).

Reference anchor: the reference Makefile:3-20 (the real capture is
7.9 min at this exact rate), track-all-gnss-2017-L1L2L5.sh:9-25 (seeds).
"""

import contextlib
import io as _io
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FS = 69.984e6

# band -> [(signal, prn/chan, doppler, code_phase, coffset)]
# (tools/synth_sky.SEEDS regrouped; the track-all golden seeds)
BANDS = {
    1: [("gps-l1", 21, 2400.0, 817.50, -9334875.0),
        ("glonass-l1", -3, -1200.0, 362.82, 17245125.0),
        ("galileo-e1b", 24, 250.0, 2838.00, -9334875.0),
        ("beidou-b1i", 34, -600.0, 562.20, -23656875.0)],
    2: [("gps-l2cm", 29, 1120.0, 4208.80, -127126.0),
        ("glonass-l2", -2, -1800.0, 470.98, 18272874.0),
        ("glonass-l3ocd", 9, -1800.0, 9429.00, -25702126.0),
        ("galileo-e5bi", 24, 200.0, 7919.00, -20587126.0),
        ("beidou-b2i", 14, -600.0, 1682.90, -20587126.0)],
    3: [("gps-l5i", 25, -1600.0, 9696.00, -15191625.0),
        ("galileo-e5ai", 24, 200.0, 7919.00, -15191625.0)],
}


def band_argv(band: int, path: str, chunk_ms: float):
    specs = ",".join(f"{s}:{p}:{d}:{c}:{co}"
                     for s, p, d, c, co in BANDS[band])
    return ["--chunk-ms", str(chunk_ms), path, str(int(FS)), "0", specs]


def validate(rows_text: str, band: int, seconds: float):
    """Every channel locked to its seed doppler over the LAST second of
    rows, prompt above early/late."""
    per = {f"{s}:{p}": [] for s, p, *_ in BANDS[band]}
    for line in rows_text.splitlines():
        key, rest = line.split(" ", 1)
        per[key].append(rest)
    fails = []
    for (s, p, dop, *_1) in BANDS[band]:
        key = f"{s}:{p}"
        rows = per[key]
        want_rows = seconds * 1000 * 0.9
        tail = [r.split() for r in rows[-200:]]
        cf = np.median([float(t[3]) for t in tail])
        pr = np.median([float(t[7]) for t in tail])
        el = np.median([max(float(t[6]), float(t[8])) for t in tail])
        ok = (len(rows) >= want_rows and abs(cf - dop) < 8.0 and pr > el)
        print(f"    {key:18s} rows {len(rows):6d} carrier {cf:9.2f} "
              f"(want {dop:7.1f}) P/EL {pr / max(el, 1e-9):.2f} "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(key)
    return fails


def run_one_program(bands_paths, seconds, chunk_ms, repeat):
    """All 11 channels of all 3 bands in ONE compiled program
    (track/receiver.py): per-band segments of one device chunk,
    per-channel segment ends."""
    from gnss_dsp.models import get_signal
    from gnss_dsp.track.driver import TrackChannel
    from gnss_dsp.track.receiver import track_receiver

    best = np.inf
    for rep in range(repeat):
        bands = []
        for b in (1, 2, 3):
            sigs = [get_signal(s) for s, *_ in BANDS[b]]
            chans = [TrackChannel(prn=p, doppler=d, code_offset=c)
                     for _, p, d, c, _co in BANDS[b]]
            bands.append((open(bands_paths[b], "rb"), sigs, chans,
                          [co for *_x, co in BANDS[b]]))
        t0 = time.perf_counter()
        out = track_receiver(bands, FS, chunk_ms=chunk_ms)
        wall = time.perf_counter() - t0
        best = min(best, wall)
        print(f"  ALL bands, ONE program (11 ch): {wall:7.1f} s "
              f"= {seconds / wall:5.2f}x realtime "
              f"[{11 * FS * seconds / wall / 1e6:6.0f} Msamples/s "
              f"incl. host I/O]")
    fails = []
    k = 0
    for b in (1, 2, 3):
        for (s, p, dop, *_1) in BANDS[b]:
            rows = out[k].rows
            tail = rows[-200:]
            cf = np.median([r["carrier_f"] for r in tail])
            pr = np.median([r["prompt"] for r in tail])
            el = np.median([max(r["early"], r["late"]) for r in tail])
            ok = (len(rows) >= seconds * 1000 * 0.9
                  and abs(cf - dop) < 8.0 and pr > el)
            print(f"    {s}:{p:<4d} rows {len(rows):6d} carrier "
                  f"{cf:9.2f} (want {dop:7.1f}) "
                  f"P/EL {pr / max(el, 1e-9):.2f} "
                  f"{'OK' if ok else 'FAIL'}")
            if not ok:
                fails.append(f"{s}:{p}")
            k += 1
    return best, fails


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    repeat = 2 if "--repeat" in " ".join(sys.argv) else 1
    one_program = "--one-program" in sys.argv
    import tempfile

    data = args[0] if args else os.path.join(tempfile.gettempdir(),
                                             "gnss-sky-10s.pcap")
    seconds = float(args[1]) if len(args) > 1 else 10.0
    chunk_ms = 2000.0

    if not os.path.exists(data):
        from tools.synth_sky import write_capture

        print(f"synthesizing {seconds:.0f} s capture -> {data}")
        t0 = time.perf_counter()
        write_capture(data, int(seconds * 1000))
        print(f"  synthesized in {time.perf_counter() - t0:.0f} s")
    cap_bytes = os.path.getsize(data)
    seconds = cap_bytes / (3 * 2 * FS)     # trust the file
    print(f"capture: {data} = {cap_bytes/1e9:.2f} GB "
          f"= {seconds:.2f} s x 3 bands @ {FS/1e6} MHz")

    from gnss_dsp.cli.workload import demux_bands
    from gnss_dsp.cli.track import main_multi

    dest = os.path.join(tempfile.gettempdir(), "long-receiver")
    os.makedirs(dest, exist_ok=True)
    t0 = time.perf_counter()
    bands = demux_bands(data, dest)
    t_demux = time.perf_counter() - t0

    if one_program:
        best, fails = run_one_program(bands, seconds, chunk_ms, repeat)
        print(f"\n== {seconds:.1f} s, ONE program, 11 channels ==")
        print(f"wall {best:.1f} s = {seconds / best:.2f}x realtime incl. "
              f"host I/O")
        if fails:
            print("FAILURES:", fails)
            sys.exit(1)
        print("ALL channels held lock to the last rows")
        return

    walls = {}
    fails = []
    for band in (1, 2, 3):
        nch = len(BANDS[band])
        for rep in range(repeat):
            buf = _io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main_multi(band_argv(band, bands[band], chunk_ms))
            wall = time.perf_counter() - t0
            assert rc in (0, None), rc
            walls[band] = min(walls.get(band, np.inf), wall)
            print(f"  band {band} ({nch} ch, one program): {wall:7.1f} s "
                  f"= {seconds / wall:5.2f}x realtime "
                  f"[{nch * FS * seconds / wall / 1e6:6.0f} Msamples/s "
                  f"incl. host I/O]")
        fails += validate(buf.getvalue(), band, seconds)

    total = sum(walls.values())
    agg = seconds / total
    print(f"\n== {seconds:.1f} s of 3-band capture ==")
    print(f"demux (host, one pass): {t_demux:.1f} s")
    for band in (1, 2, 3):
        print(f"band {band}: {walls[band]:7.1f} s wall = "
              f"{seconds / walls[band]:5.2f}x realtime "
              f"({len(BANDS[band])} channels)")
    print(f"all 11 channels (3 sequential programs): {total:.1f} s wall "
          f"= {agg:.2f}x realtime, "
          f"{11 * FS * seconds / total / 1e6:.0f} Msamples/s aggregate "
          f"incl. host I/O")
    if fails:
        print("FAILURES:", fails)
        sys.exit(1)
    print("ALL channels held lock to the last rows")


if __name__ == "__main__":
    main()
