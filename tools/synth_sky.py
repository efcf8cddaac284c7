"""Synthesize the 2017-04-27 3-band sky capture, of any length (chunked
generation).

The reference Makefile downloads a 7.9-minute 69.984 MHz 3-band recording
(Makefile:18-20) and demuxes it with the external `packet2wav_3ch` tool
(not shipped there either).  That multi-GB fetch is infeasible here (no
network), so this synthesizes a capture carrying every golden seed from
track-all-gnss-2017-L1L2L5.sh:9-25 — same PRNs, dopplers, code phases and
per-band carrier offsets — in the container format tools/packet2wav_3ch
demuxes (1 ms per-band frames, int8 interleaved I/Q).

    python tools/synth_sky.py out.pcap [ms] [cn0]     # default 120 ms

Long captures (the round-5 sustained-receiver workload) are generated in
125 ms band-parallel chunks that never materialize the full capture in RAM: synth_iq's
phase ramps are affine in the ABSOLUTE sample index (utils/synth.py t0),
so chunked generation is exactly continuous — code phase, carrier phase
and the doppler-scaled code rate all carry across chunk boundaries, and
the tracking loops hold lock over the whole file.  ~420 MB of capture
per second of sky (3 bands x 69.984 MHz x 2 B).

Captures <= 500 ms draw the shared noise rng in the same order as the
pre-round-5 generator up to exp() factorization (the carrier-offset
rotation is now folded into the synth carrier instead of applied as a
second complex exponential — one fewer 70 MHz-wide exp per seed).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gnss_dsp.models import get_signal
from gnss_dsp.utils.synth import synth_iq

FS = 69.984e6
FRAME = int(FS // 1000)          # samples per band per 1 ms frame
CHUNK_MS = 125                   # generation granularity (allocator-reuse sweet spot)

# (band, signal, prn/chan, doppler Hz, code phase chips, carrier offset Hz)
# — the golden seeds of track-all-gnss-2017-L1L2L5.sh:9-25 at the
# acquire-all.sh:9-35 band offsets
SEEDS = [
    (1, "gps-l1",         21,  2400.0,  817.50,  -9334875.0),
    (1, "glonass-l1",     -3, -1200.0,  362.82,  17245125.0),
    (1, "galileo-e1b",    24,   250.0, 2838.00,  -9334875.0),
    (1, "beidou-b1i",     34,  -600.0,  562.20, -23656875.0),
    (2, "gps-l2cm",       29,  1120.0, 4208.80,   -127126.0),
    (2, "glonass-l2",     -2, -1800.0,  470.98,  18272874.0),
    (2, "glonass-l3ocd",   9, -1800.0, 9429.00, -25702126.0),
    (2, "galileo-e5bi",   24,   200.0, 7919.00, -20587126.0),
    (2, "beidou-b2i",     14,  -600.0, 1682.90, -20587126.0),
    (3, "gps-l5i",        25, -1600.0, 9696.00, -15191625.0),
    (3, "galileo-e5ai",   24,   200.0, 7919.00, -15191625.0),
]

SUBC = {"galileo-e1b": "cboc", "gps-l2cm": "rz_even"}


def synth_band_chunk(band: int, t0: int, n: int, rng, sigma: float,
                     verbose: bool = False) -> np.ndarray:
    """Samples [t0, t0+n) of one band: planted seeds + noise from this
    (band, chunk)'s own deterministic rng stream."""
    x = np.zeros(n, np.complex64)
    for b, name, prn, dop, cp, coff in SEEDS:
        if b != band:
            continue
        sig = get_signal(name)
        chan = prn if name.startswith("glonass-l") and sig.fdma_hz else 0
        # the band-center offset + FDMA channel IF ride the synth carrier
        # directly; only the true doppler drives the code rate
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop + sig.fdma_hz * chan + coff,
                      code_phase=cp, cn0_dbhz=None,
                      subcarrier=SUBC.get(name, "none"),
                      carrier_ratio=sig.track_carrier_ratio(chan),
                      code_doppler_hz=dop, t0=t0)
        if verbose:
            print(f"  band {band}: {name} prn/chan {prn} dop {dop} "
                  f"code {cp} @ {coff/1e6:+.3f} MHz")
    sg = np.float32(sigma)
    x.real += sg * rng.standard_normal(n, dtype=np.float32)
    x.imag += sg * rng.standard_normal(n, dtype=np.float32)
    return x


def to_int8(x: np.ndarray, scale: float) -> np.ndarray:
    y = np.empty(2 * len(x), np.int8)
    y[0::2] = np.clip(np.round(x.real * scale), -127, 127).astype(np.int8)
    y[1::2] = np.clip(np.round(x.imag * scale), -127, 127).astype(np.int8)
    return y


def _malloc_tune():
    """Keep numpy's big temporaries on the reused heap instead of fresh
    mmaps: the chunked synthesis was page-fault-bound (sys > user)
    without this (measured 2x on this host's 4 cores)."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)     # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)     # M_TRIM_THRESHOLD
    except OSError:
        pass


def _band_chunk_int8(args) -> bytes:
    """Pool worker: one (band, chunk) -> int8 frame bytes.  The noise rng
    is derived from (seed, band, chunk index) so results are independent
    of scheduling order."""
    band, c0, cms, sigma, scale, verbose = args
    rng = np.random.default_rng([20170427, band, c0])
    xb = synth_band_chunk(band, c0 * FRAME, cms * FRAME, rng, sigma,
                          verbose=verbose)
    return to_int8(xb, scale).tobytes()


def write_capture(out: str, ms: int, cn0: float = 50.0,
                  progress: bool = True, workers: int = 3):
    """Chunked, band-parallel capture writer (~420 MB / capture-second).

    Seeds are exactly phase-continuous across chunks (synth_iq t0); the
    noise stream is per-(band, chunk) deterministic."""
    import multiprocessing as mp

    # one shared noise floor giving each unit-amplitude signal ~cn0 dB-Hz
    sigma = np.sqrt(FS / (2.0 * 10 ** (cn0 / 10.0)))
    scale = 100.0 / (4.0 * sigma)     # noise 4-sigma at ~int8 100
    chunks = [(c0, min(CHUNK_MS, ms - c0)) for c0 in range(0, ms, CHUNK_MS)]
    tasks = [(band, c0, cms, sigma, scale,
              progress and c0 == 0 and band == 1)
             for (c0, cms) in chunks for band in (1, 2, 3)]
    # spawned (not forked) workers: the caller may hold threads or an
    # open accelerator backend
    ctx = mp.get_context("spawn")
    with open(out, "wb") as f, ctx.Pool(workers,
                                        initializer=_malloc_tune) as pool:
        it = pool.imap(_band_chunk_int8, tasks)
        for (c0, cms) in chunks:
            frames = np.empty((cms, 3, 2 * FRAME), np.int8)
            for bi in range(3):
                frames[:, bi, :] = np.frombuffer(
                    next(it), np.int8).reshape(cms, 2 * FRAME)
            f.write(frames.tobytes())
            if progress and ms > CHUNK_MS:
                print(f"  ... {min(c0 + cms, ms)}/{ms} ms", flush=True)
    return os.path.getsize(out)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "gnss-sky-synth.pcap"
    ms = int(sys.argv[2]) if len(sys.argv) > 2 else 120
    cn0 = float(sys.argv[3]) if len(sys.argv) > 3 else 50.0
    size = write_capture(out, ms, cn0)
    print(f"wrote {out}: {ms} ms x 3 bands @ {FS/1e6} MHz "
          f"({size/1e6:.0f} MB), per-signal C/N0 ~{cn0} dB-Hz")


if __name__ == "__main__":
    main()
