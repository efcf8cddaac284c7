"""Run the full reference workload (acquire-all.sh + track-all-gnss-
2017-L1L2L5.sh) end-to-end on the synthetic 3-band sky capture and
validate every golden seed.

    python tools/run_sky_workload.py [capture.pcap] [ms]

Synthesizes the capture if absent (tools/synth_sky.py), puts tools/ on
PATH for the packet2wav_3ch stand-in, executes the two UNMODIFIED
workload scripts, then checks:
  * each acquire output whose signal was planted reports the seed PRN at
    the seed doppler/code phase with the top metric
  * each track output converges to the seed doppler with prompt > E,L
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.synth_sky import SEEDS, FS  # noqa: E402

# acquire-all.sh output file -> (signal, prn, doppler, code, grid step)
ACQ_EXPECT = {
    "acq-gps-l1.dat": (21, 2400.0, 817.50),
    "acq-glonass-l1.dat": (-3, -1200.0, 362.82),
    "acq-galileo-e1b.dat": (24, 250.0, 2838.00),
    "acq-beidou-b1i.dat": (34, -600.0, 562.20),
    "acq-gps-l2cm.dat": (29, 1120.0, 4208.80),
    "acq-glonass-l2.dat": (-2, -1800.0, 470.98),
    "acq-glonass-l3ocd.dat": (9, -1800.0, 9429.00),
    "acq-galileo-e5bi.dat": (24, 200.0, 7919.00),
    "acq-beidou-b2i.dat": (14, -600.0, 1682.90),
    "acq-gps-l5i.dat": (25, -1600.0, 9696.00),
    "acq-galileo-e5ai.dat": (24, 200.0, 7919.00),
}

TRACK_EXPECT = {
    "track-gps-l1-prn21.dat": 2400.0,
    "track-glonass-l1-m3.dat": -1200.0,
    "track-galileo-e1b-prn24.dat": 250.0,
    "track-beidou-b1i-prn34.dat": -600.0,
    "track-gps-l2cm-prn29.dat": 1120.0,
    "track-glonass-l2-m2.dat": -1800.0,
    "track-glonass-l3ocd-prn9.dat": -1800.0,
    "track-galileo-e5bi-prn24.dat": 200.0,
    "track-beidou-b2i-prn14.dat": -600.0,
    "track-gps-l5i-prn25.dat": -1600.0,
    "track-galileo-e5ai-prn24.dat": 200.0,
}


def sh(script, data, dest):
    # the workload scripts start one process per script, one after the
    # other: each holds the device alone while it runs
    env = dict(os.environ, PATH=os.path.join(REPO, "tools")
               + os.pathsep + os.environ["PATH"])
    r = subprocess.run(["sh", os.path.join(REPO, script), data, dest],
                       env=env, capture_output=True, text=True,
                       timeout=21600)
    assert r.returncode == 0, (script, r.stderr[-3000:])


def check_acq(dest):
    fails = []
    for fn, (prn, dop, code) in ACQ_EXPECT.items():
        rows = []
        for line in open(os.path.join(dest, fn)):
            t = line.split()
            rows.append((int(t[1]), float(t[3]), float(t[5]), float(t[7])))
        best = max(rows, key=lambda r: r[2])
        ok = (best[0] == prn and abs(best[1] - dop) <= 251.0
              and abs(best[3] - code) <= 1.0)
        print(f"  {fn:28s} want prn {prn:3d} dop {dop:7.1f} code {code:8.2f}"
              f" -> got {best[0]:3d} {best[1]:7.1f} {best[3]:8.2f} "
              f"metric {best[2]:.2f} {'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(fn)
    return fails


def check_track(dest):
    fails = []
    for fn, dop in TRACK_EXPECT.items():
        rows = np.loadtxt(os.path.join(dest, fn))
        tail = rows[-20:]
        cf = float(np.mean(tail[:, 3]))
        pr = float(np.mean(tail[:, 7]))
        el = float(np.mean(np.maximum(tail[:, 6], tail[:, 8])))
        ok = len(rows) >= 60 and abs(cf - dop) < 8.0 and pr > el
        print(f"  {fn:32s} rows {len(rows):4d} carrier {cf:8.2f} "
              f"(want {dop:7.1f}) P/EL {pr/max(el,1e-9):.2f} "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(fn)
    return fails


def main():
    flags = {a for a in sys.argv[1:] if a.startswith("--")}
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batched = "--batched" in flags
    real = "--real" in flags
    import tempfile

    tmp = tempfile.gettempdir()
    acq_out = os.path.join(tmp, "sky-acq-out")
    track_out = os.path.join(tmp, "sky-track-out")
    data = args[0] if args else os.path.join(tmp, "gnss-sky-synth.pcap")
    ms = int(args[1]) if len(args) > 1 else 120
    if real:
        # `make verify` mode: the REAL 2017-04-27 sky recording (network-
        # gated — `make gnss-20170427-L1L2L5.pcap` downloads it when
        # egress exists).  Never synthesizes; checksums the capture
        # (recorded on first use) so reruns validate the same bytes; the
        # golden expectations below are the reference's own seeds
        # (track-all-gnss-2017-L1L2L5.sh:9-25).
        if not os.path.exists(data):
            print(f"real capture {data} not present — download it with "
                  "`make gnss-20170427-L1L2L5.pcap` (needs network egress;"
                  " this environment has none).  The synthetic fallback "
                  "is `python tools/run_sky_workload.py --batched`.")
            sys.exit(3)
        import hashlib

        h = hashlib.sha256()
        with open(data, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        digest = h.hexdigest()
        rec = os.path.join(REPO, "tools", "sky_capture.sha256")
        if os.path.exists(rec):
            want = open(rec).read().split()[0]
            assert digest == want, (
                f"capture checksum mismatch: {digest} != recorded {want}")
            print(f"capture sha256 OK ({digest[:16]}...)")
        else:
            with open(rec, "w") as f:
                f.write(f"{digest}  {os.path.basename(data)}\n")
            print(f"capture sha256 recorded: {digest[:16]}...")
    elif not os.path.exists(data):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "synth_sky.py"),
                        data, str(ms)], check=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if batched:
        # single-process runner: same CLI entry points, same argv, same
        # output files — one JAX runtime, one demux + upload per band
        # (gnss_dsp/cli/workload)
        def sh_batched(what, dest):
            r = subprocess.run(
                [sys.executable, "-m", "gnss_dsp.cli.workload",
                 what, data, dest],
                cwd=REPO, capture_output=True, text=True, timeout=21600)
            sys.stderr.write(r.stderr[-4000:])
            assert r.returncode == 0, (what, r.stderr[-3000:])

        print("== acquire-all (batched single-process) ==")
        sh_batched("acquire-all", acq_out)
        f1 = check_acq(acq_out)
        print("== track-all (batched single-process) ==")
        sh_batched("track-all", track_out)
        f2 = check_track(track_out)
        if f1 or f2:
            print("FAILURES:", f1 + f2)
            sys.exit(1)
        print(f"ALL {len(ACQ_EXPECT)} acquisitions + {len(TRACK_EXPECT)} "
              "tracks recovered their golden seeds (batched)")
        return
    print("== acquire-all.sh ==")
    sh("acquire-all.sh", data, acq_out)
    f1 = check_acq(acq_out)
    print("== track-all-gnss-2017-L1L2L5.sh ==")
    sh("track-all-gnss-2017-L1L2L5.sh", data, track_out)
    f2 = check_track(track_out)
    if f1 or f2:
        print("FAILURES:", f1 + f2)
        sys.exit(1)
    print(f"ALL {len(ACQ_EXPECT)} acquisitions + {len(TRACK_EXPECT)} tracks"
          " recovered their golden seeds")


if __name__ == "__main__":
    main()
