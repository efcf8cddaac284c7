"""Synthetic sky-capture container + workload plumbing.  The FULL
acquire-all.sh / track-all-gnss-2017-L1L2L5.sh run takes about an hour
on a CPU and is driven by tools/run_sky_workload.py; this default-suite
test
proves the container format, the packet2wav_3ch stand-in, and one
band-1 pipeline end to end on a small capture.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_container_demux_and_gps_l1_pipeline(tmp_path, monkeypatch):
    import tools.synth_sky as sky

    # small capture: 30 ms, all golden seeds planted
    cap = os.path.join(tmp_path, "cap.pcap")
    monkeypatch.setattr(sys, "argv", ["synth_sky.py", cap, "30"])
    sky.main()
    frame = 2 * sky.FRAME
    assert os.path.getsize(cap) == 3 * 30 * frame

    # demux band 1 exactly reproduces the interleaved frames
    raw = open(cap, "rb").read()
    want_b2 = b"".join(raw[(3 * m + 1) * frame: (3 * m + 2) * frame]
                       for m in range(30))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "packet2wav_3ch"), "2"],
        input=raw, capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout == want_b2

    # the sh-style pipeline: demux band 1 | acquire-gps-l1 at the
    # acquire-all.sh offset finds the golden seed (PRN 21, 2400 Hz,
    # 817.5 chips; track-all-gnss-2017-L1L2L5.sh:9)
    p1 = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "packet2wav_3ch"), "1"],
        stdin=open(cap, "rb"), stdout=subprocess.PIPE)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "acquire-gps-l1.py"),
         "--prn", "21", "--time", "20",
         "/dev/stdin", "69984000", "-9334875"],
        stdin=p1.stdout, capture_output=True, text=True, timeout=400,
        env=env)
    p1.stdout.close()     # drop the parent's read end so p1 sees EPIPE
    p1.wait(timeout=60)
    assert p2.returncode == 0, p2.stderr[-2000:]
    t = p2.stdout.split()
    assert int(t[1]) == 21
    assert abs(float(t[3]) - 2400.0) <= 200.0, p2.stdout
    assert abs(float(t[7]) - 817.5) <= 1.0, p2.stdout
