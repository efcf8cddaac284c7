"""Device-only A/B of the single-program receiver scan vs per-band
programs: no file I/O — x is jax-PRNG noise, so the scan does identical
per-channel work while we time ONLY the scan.

Configs (the 2017 receiver at 69.984 MHz):
  per-band : band1 C=4, band2 C=5, band3 C=2 — three programs, summed
  one-prog : all 11 channels in one program
  one-bpsk : 12 BPSK-only channels

Usage: python tools/bench_receiver_scan.py [NB]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from gnss_dsp.models import get_signal
from gnss_dsp.ops import nco
from gnss_dsp.track.driver import (
    TrackChannel, make_params, runtime_tables)
from gnss_dsp.track.engine import init_state, track_scan

FS = 69.984e6

BANDS = {
    1: [("gps-l1", 21), ("glonass-l1", -3), ("galileo-e1b", 24),
        ("beidou-b1i", 34)],
    2: [("gps-l2cm", 29), ("glonass-l2", -2), ("glonass-l3ocd", 9),
        ("galileo-e5bi", 24), ("beidou-b2i", 14)],
    3: [("gps-l5i", 25), ("galileo-e5ai", 24)],
}


def setup(specs, NB):
    """One scan program for `specs` = [(signal, prn)]."""
    sigs = [get_signal(nm) for nm, _ in specs]
    C = len(specs)
    params = make_params(sigs[0], FS, 0.0, (200, 200))
    params = params._replace(nmax=max(make_params(s, FS, 0.0).nmax
                                      for s in sigs))
    chans = [TrackChannel(prn=p, doppler=1000.0, code_offset=0.0)
             for _, p in specs]
    params, sigp, _ = runtime_tables(params, sigs, chans, FS, 1, 1)
    tabs = [np.asarray(s.code_table((p,))[0], np.int8)
            for s, (_, p) in zip(sigs, specs)]
    Lmax = max(t.shape[0] for t in tabs)
    code_np = np.zeros((C, Lmax), np.int8)
    for k, t in enumerate(tabs):
        code_np[k, : t.shape[0]] = t
    n = int(NB * FS * 0.001) + params.nmax
    n += (-n) % 1024
    key = jax.random.PRNGKey(0)
    xd = (jax.random.normal(key, (n,), jnp.float32),
          jax.random.normal(key, (n,), jnp.float32))
    st = init_state(code_p=np.zeros(C), code_f_off=np.zeros(C),
                    carrier_p=np.zeros(C),
                    carrier_f=np.full(C, 1000.0), ptr=np.zeros(C, np.int32))
    kw = dict(ratios=jnp.asarray(
        [s.track_carrier_ratio(p) for s, (_, p) in zip(sigs, specs)],
        jnp.float32),
        coffset_df=jnp.asarray(
            [nco.freq_to_fixed(-(s.fdma_hz or 0.0) * p / FS)
             for s, (_, p) in zip(sigs, specs)], jnp.int32),
        sigp=sigp)
    return xd, code_np, st, params, kw, C, params.subcarrier


def run_one(label, specs, NB, reps=3, quiet=False):
    xd, code_np, st, params, kw, C, kind = setup(specs, NB)
    tab = jnp.asarray(code_np)
    n_len = jnp.int32(xd[0].shape[0])
    jax.block_until_ready(track_scan(xd, n_len, tab, st, params, NB, **kw))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        _, rf, ri = jax.block_until_ready(
            track_scan(xd, n_len, tab, st, params, NB, **kw))
        best = min(best, time.perf_counter() - t0)
    samples = float(np.asarray(ri)[..., 0].sum())
    if not quiet:
        print(f"{label:22s} C={C:2d} kind={kind:5s} NB={NB} "
              f"{best*1e3:8.1f} ms  {samples/best/1e6:7.0f} Msamples/s",
              flush=True)
    return best


def main():
    NB = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    tot = 0.0
    for b, specs in BANDS.items():
        tot += run_one(f"band{b} ({len(specs)} ch)", list(specs), NB)
    print(f"{'3 programs total':22s} {'':22s} {tot*1e3:8.1f} ms")
    allspecs = [s for b in (1, 2, 3) for s in BANDS[b]]
    run_one("one-program (11 ch)", allspecs, NB)
    run_one("one-bpsk x12",
            [("gps-l1", 1 + k) for k in range(12)], NB)


if __name__ == "__main__":
    main()
