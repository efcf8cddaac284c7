"""Acquisition sensitivity curve: non-coherent vs extended-coherent.

Sweeps C/N0 and measures the lock rate (code error < 1 chip AND doppler
within one bin) of
  (a) the reference-style search — 1 ms coherent + `ms` non-coherent
      magnitude sums (acquire_signal; acquire-gps-l1.py:26-39 semantics),
  (b) the secondary-wiped extended-coherent engine over the same data
      span (acquire_signal_coherent).

K independent noise draws per point, random planted code phase and
overlay alignment each trial.  Prints a markdown table.

Usage: python tools/sensitivity_curve.py [signal] [trials]
       (default beidou-b1i, 10 trials/point)
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from gnss_dsp.models import get_signal                     # noqa: E402
from gnss_dsp.acquire.engine import acquire_signal         # noqa: E402
from gnss_dsp.acquire.coherent import acquire_signal_coherent  # noqa: E402
from gnss_dsp.utils.synth import synth_iq                  # noqa: E402


def run(signame="beidou-b1i", trials=10, cn0s=(24, 26, 28, 30, 32, 34),
        fs=4.096e6):
    sig = dataclasses.replace(get_signal(signame), acq_fs=fs)
    prn = 34 if signame == "beidou-b1i" else 25
    sec = sig.secondary(prn)
    m = len(sec)
    ms = 2 * m
    grid = (-100.0, 101.0, 25.0)
    n = int(fs * (ms + 4) / 1000)
    rng = np.random.default_rng(42)

    def locked(r, cp0, dop0):
        e = abs(r.code_offset - cp0)
        return (min(e, sig.code_length - e) < 1.0
                and abs(r.doppler - dop0) <= grid[2])

    rows = []
    for cn0 in cn0s:
        hits_nc = hits_co = 0
        t0 = time.time()
        for _ in range(trials):
            cp0 = float(rng.uniform(1.0, sig.code_length - 1.0))
            dop0 = float(rng.choice(np.arange(*grid)))
            roll = int(rng.integers(0, m))
            x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                         doppler_hz=dop0, code_phase=cp0, cn0_dbhz=cn0,
                         carrier_ratio=sig.carrier_ratio,
                         data_bits=np.roll(sec, -roll), rng=rng)
            nc = acquire_signal(sig, x, [prn], doppler_search=grid, ms=ms)[0]
            co = acquire_signal_coherent(sig, x, [prn], grid, ms=ms)[0]
            hits_nc += locked(nc, cp0, dop0)
            hits_co += locked(co, cp0, dop0)
        rows.append((cn0, hits_nc, hits_co, time.time() - t0))
        print(f"  cn0 {cn0} dB-Hz: non-coherent {hits_nc}/{trials}, "
              f"coherent {hits_co}/{trials}  ({rows[-1][3]:.0f} s)",
              flush=True)

    print(f"\n{signame} ({m}-chip overlay, {ms} ms of data, {trials} "
          "trials/point, random phase/doppler/alignment):\n")
    print("| C/N0 (dB-Hz) | non-coherent lock | extended-coherent lock |")
    print("|---|---|---|")
    for cn0, hn, hc, _ in rows:
        print(f"| {cn0} | {hn}/{trials} | {hc}/{trials} |")


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "beidou-b1i"
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    run(name, k)
