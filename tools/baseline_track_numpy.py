"""Fair CPU tracking baselines, one per engine family, and the plain
numpy correlator (mix_vec / correlate_vec) that chip_smoke.py and the
tests hold the tracking engine's E/P/L against.

The reference's tracking tier is Numba-JIT per-sample loops
(gnsstools/gps/ca.py:120-128 `correlate`, nco.py:30-38 `mix_`); without
numba this measures the best honest CPU stand-in: fully VECTORIZED
numpy implementations of the same
per-sample semantics (int64 fixed-point LUT mix; float64 code-phase ramp
+ gather + dot for E/P/L; the per-family subcarrier recurrences).
Vectorized numpy is the same memory-bound ballpark as scalar Numba for
this op mix — every sample is touched a handful of times either way — so
the ratio against it is a fair "vs best CPU core" number, unlike the
reference's pure-Python fallback (~0.3 Msamples/s).

A CBOC/TMBOC/RZ CPU correlator is slower than BPSK, so each family
here mirrors its own reference semantics:

  gps-l1        BPSK                  gps/ca.py:120-128
  beidou-b1i    BPSK, L=2046, 8.192M  beidou/b1i.py
  galileo-e1b   CBOC two-subcarrier   galileo/e1b.py:46-58
  gps-l1cp      TMBOC slot-gated BOC  gps/l1cp.py:210-228
  gps-l2cm      RZ even half-chips    gps/l2cm.py:81-91
  gps-l2cl      RZ odd, 767250-chip gather table   gps/l2cl.py
  glonass-l1-p  BPSK, 5.11M-chip gather table      glonass/p.py
  beidou-b1i-coh  B1I + NH20 overlay wipe + 20-block coherent
                  accumulation (the extended-coherent track mode —
                  no reference analog; same correlator cost + the
                  per-block overlay/accumulate bookkeeping)

Per sub-block the cost structure mirrors the track scripts exactly:
coffset mix + carrier NCO mix (2 full-vector LUT mixes,
track-gps-l1.py:170-172 + :37-42) + three E/P/L correlations.  Families
with sub-divided code periods (e1b x4 ... glonass-p x1000,
track-galileo-e1b.py:164-170) do the coffset mix once per PERIOD over
sub x n samples — identical per-sample cost to once per sub-block, so
the 2-mix structure is cost-faithful for every family.

Run: python tools/baseline_track_numpy.py [family ...]   (default: all)
Emits one line per family plus a python dict literal for bench.py.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np

NT = 1024
TAB = np.exp(2j * np.pi * np.arange(NT) / NT).astype(np.complex128)
FIX = 1 << 50

# reference gps/l1cp.py:202
TMBOC_PATTERN = np.array([1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0,
                          0], np.float64)
CBOC_W1, CBOC_W6 = 0.953463, 0.301511      # galileo/e1b.py:53

# name -> (fs, chip_rate, code_length, sub-blocks/period, mod, C, el)
FAMILIES = {
    "gps-l1":        (4.096e6, 1.023e6, 1023, 1, "bpsk", 32, 0.05),
    "beidou-b1i":    (8.192e6, 2.046e6, 2046, 1, "bpsk", 32, 0.5),
    "galileo-e1b":   (4.096e6, 1.023e6, 4092, 4, "cboc", 32, 0.2),
    "gps-l1cp":      (4.096e6, 1.023e6, 10230, 10, "tmboc", 32, 0.2),
    "gps-l2cm":      (4.096e6, 511.5e3, 10230, 20, "rz_even", 32, 0.5),
    "gps-l2cl":      (4.096e6, 511.5e3, 767250, 1500, "rz_odd", 32, 0.5),
    "glonass-l1-p":  (12.288e6, 5.11e6, 5110000, 1000, "bpsk", 8, 0.5),
    "beidou-b1i-coh": (8.192e6, 2.046e6, 2046, 1, "bpsk", 32, 0.5),
    # the 2017 workload's NATIVE rate (Makefile: 69.984 MHz capture):
    # per-sample semantics identical to gps-l1, 17x more samples per
    # 1 ms block — the receiver-rate denominator (fewer per-block
    # overheads per sample for both the CPU and the device)
    "gps-l1-hr": (69.984e6, 1.023e6, 1023, 1, "bpsk", 12, 0.05),
}


def mix_vec(x, f, p):
    """Vectorized reference nco.mix_ (int64 fixed-point, 50 frac bits)."""
    n = len(x)
    dp = np.int64(np.floor(p * NT * FIX))
    df = np.int64(np.floor(f * NT * FIX))
    idx = ((dp + np.arange(n, dtype=np.int64) * df) >> 50) & (NT - 1)
    return x * TAB[idx]


def correlate_vec(x, code_pm1, L, cp0, incr, mod):
    """Vectorized reference correlate with the family's subcarrier.

    cp0/incr follow the float64 recurrence cp = (cp + incr) % L; the
    subcarrier phases bp/bp6/rzp follow their own (p + k*incr) % 2
    recurrences with boc11 = [1,-1] / rz = [1,0] or [0,1] table lookups
    (galileo/e1b.py:46-58, gps/l1cp.py:210-228, gps/l2cm.py:81-91).
    """
    n = len(x)
    i = np.arange(n, dtype=np.float64)
    cpv = (cp0 % L) + i * incr
    ci = np.floor(cpv).astype(np.int64) % L
    c = code_pm1[ci]
    if mod == "bpsk":
        return np.dot(x, c)
    if mod == "boc11":
        bp = ((2.0 * cp0) % 2.0 + i * (2.0 * incr)) % 2.0
        return np.dot(x, c * (1.0 - 2.0 * np.floor(bp)))
    if mod == "cboc":
        bp = ((2.0 * cp0) % 2.0 + i * (2.0 * incr)) % 2.0
        bp6 = ((12.0 * cp0) % 2.0 + i * (12.0 * incr)) % 2.0
        s1 = 1.0 - 2.0 * np.floor(bp)
        s6 = 1.0 - 2.0 * np.floor(bp6)
        return np.dot(x, c * (CBOC_W1 * s1 + CBOC_W6 * s6))
    if mod == "tmboc":
        bp = ((2.0 * cp0) % 2.0 + i * (2.0 * incr)) % 2.0
        bp6 = ((12.0 * cp0) % 2.0 + i * (12.0 * incr)) % 2.0
        s1 = 1.0 - 2.0 * np.floor(bp)
        s6 = 1.0 - 2.0 * np.floor(bp6)
        sel = TMBOC_PATTERN[ci % 33]
        return np.dot(x, c * (sel * s6 + (1.0 - sel) * s1))
    if mod in ("rz_even", "rz_odd"):
        rzp = ((2.0 * cp0) % 2.0 + i * (2.0 * incr)) % 2.0
        gate = np.floor(rzp)                       # 0 first half, 1 second
        if mod == "rz_even":
            gate = 1.0 - gate                      # rz = [1, 0]
        return np.dot(x, c * gate)
    raise ValueError(mod)


def run_family(name, NB=900, seconds_cap=60.0):
    fs, chip_rate, L, sub, mod, C, el = FAMILIES[name]
    coherent = name.endswith("-coh")
    rng = np.random.default_rng(0)
    n = int(fs * 0.001)                            # 1 ms sub-block
    code = rng.choice([-1.0, 1.0], L)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex128)
    sec = rng.choice([-1.0, 1.0], 20)              # NH20 overlay (coh)
    incr = chip_rate / fs

    t0 = time.perf_counter()
    acc = 0.0 + 0.0j
    cacc = 0.0 + 0.0j
    done = 0
    for c in range(C):
        cp = 0.0
        for b in range(NB):
            xm = mix_vec(x, -1e-3, 0.1)            # coffset (:170-172)
            xm = mix_vec(xm, 2.4e-4, 0.3)          # carrier NCO (:37-42)
            for lag in (-el, 0.0, el):
                p = correlate_vec(xm, code, L, cp + lag, incr, mod)
                if lag == 0.0 and coherent:
                    # overlay wipe + M-period coherent accumulation
                    cacc += p * sec[b % 20]
                    if b % 20 == 19:
                        acc += cacc / 20
                        cacc = 0.0
                else:
                    acc += p
            cp = (cp + n * incr) % L
            done += n
        if time.perf_counter() - t0 > seconds_cap:
            break
    dt = time.perf_counter() - t0
    rate = done / dt / 1e6
    print(f"baseline[{name}]: mod={mod} L={L} n={n} C<= {C} "
          f"dt={dt:.1f}s -> {rate:.1f} Msamples/s (1 core) "
          f"[checksum {abs(acc):.3e}]", flush=True)
    return rate


def main():
    fams = sys.argv[1:] or list(FAMILIES)
    out = {}
    for name in fams:
        out[name] = round(run_family(name), 1)
    print("# paste into bench.py _CPU_TRACK_SAMPLES_S_FAMILY:")
    print(out)


if __name__ == "__main__":
    main()
