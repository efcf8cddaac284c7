"""Per-family tracking throughput: every distinct tracking engine shape
gets a sustained number, not just the GPS L1 BPSK path.

Families benched (engine shape in parens):
  gps-l1        BPSK, sub=1
  beidou-b1i    BPSK, sub=1, L=2046
  galileo-e1b   CBOC, sub=4           (track-galileo-e1b.py:164-170)
  gps-l1cp      TMBOC, sub=10         (track-gps-l1cp.py:176-181)
  gps-l2cm      RZ-even, sub=20       (track-gps-l2cm.py:164-171)
  gps-l2cl      RZ-odd, sub=1500, 767250-chip code
  glonass-l1-p  BPSK, sub=1000, 5.11M-chip code

Each family synthesizes C channels at a per-family fs (~2-4x chip rate,
matching how the reference tracks at >= Nyquist of the code), runs
track_scan for NB sub-blocks, and reports aggregate Msamples/s
best-of-3 with a carrier-convergence self-check.

Usage: [BENCH_C=32] [BENCH_NB=900] [BENCH_FAMS=gps-l1,...]
       python tools/bench_track_families.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

from gnss_dsp.models import get_signal
from gnss_dsp.track.driver import make_params
from gnss_dsp.track.engine import init_state, track_scan
from gnss_dsp.utils import synth
from gnss_dsp.ops import nco as _nco

# signal -> (fs, default C cap)
FAMILIES = {
    "gps-l1": (4.096e6, 32),
    "beidou-b1i": (8.192e6, 32),
    "galileo-e1b": (4.096e6, 32),
    "gps-l1cp": (4.096e6, 32),
    "gps-l2cm": (4.096e6, 32),
    "gps-l2cl": (4.096e6, 32),
    "glonass-l1-p": (12.288e6, 8),
}


def bench_family(signame: str, C: int | None = None, NB: int = 900,
                 repeats: int = 3, quiet: bool = False) -> float:
    """Aggregate Msamples/s for one signal family."""
    fs, cmax = FAMILIES[signame]
    C = min(C or cmax, cmax)
    sig = get_signal(signame)
    rng = np.random.default_rng(3)
    if sig.fdma_hz:
        prns = [0] * C                     # FDMA: one physical channel
    else:
        lo, hi = 1, 32
        prns = (lo + np.arange(C) % (hi - lo + 1)).tolist()
    dops = rng.uniform(-4000, 4000, C).round(1)
    phases = rng.uniform(0, sig.code_length - 1, C).round(2)

    sub = sig.sub_blocks
    # x1.55: a code phase just under L/2 makes the first period (and so
    # every sub-block) run at up to 1.5x the nominal period length
    n = int(NB * fs * 0.001 * sig.code_period_ms / sub * 1.55) + 8 * 8192
    code_np = sig.code_table(tuple(prns)).astype(np.int8)
    x = np.zeros(n, np.complex64)
    for k in range(min(C, 8)):     # 8 real signals + noise is enough
        x += synth.synth_iq(code_np[k].astype(np.float64), sig.chip_rate,
                            fs, n, doppler_hz=float(dops[k]),
                            code_phase=float(phases[k]), cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(prns[k]),
                            subcarrier=sig.subcarrier).astype(np.complex64)
    x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64) * 0.1

    params = make_params(sig, fs, coffset=0.0, loop_dwells=(200, 200),
                         chan=prns[0])
    tail = params.nmax + (-(n + params.nmax)) % 1024
    xp = np.concatenate([x, np.zeros(tail, np.complex64)])
    xd = (jnp.asarray(np.ascontiguousarray(xp.real.astype(np.float32))),
          jnp.asarray(np.ascontiguousarray(xp.imag.astype(np.float32))))
    tab = jnp.asarray(code_np)
    ratios = jnp.asarray([sig.track_carrier_ratio(p) for p in prns],
                         jnp.float32)
    cdf = jnp.asarray(
        [_nco.freq_to_fixed(-((sig.fdma_hz or 0.0) * p) / fs)
         for p in prns], jnp.int32)

    def one(p, label):
        st0 = dict(code_p=phases, code_f_off=np.zeros(C),
                   carrier_p=np.zeros(C), carrier_f=dops,
                   ptr=np.zeros(C, np.int32))
        t0 = time.perf_counter()
        _, rf, ri = track_scan(xd, jnp.int32(n), tab, init_state(**st0), p,
                               NB, ratios=ratios, coffset_df=cdf)
        rf = np.asarray(rf)
        compile_s = time.perf_counter() - t0
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            _, rf2, ri2 = track_scan(xd, jnp.int32(n), tab,
                                     init_state(**st0), p, NB,
                                     ratios=ratios, coffset_df=cdf)
            rf2 = np.asarray(rf2)
            best = min(best, time.perf_counter() - t0)
        samples = float(np.asarray(ri2)[..., 0].sum())
        rate = samples / best / 1e6
        cf_tail = np.nanmedian(rf2[-50:, :min(C, 8), 3], axis=0)
        err = np.abs(cf_tail - dops[:min(C, 8)]).max()
        if not quiet:
            print(f"{signame:13s} {label}: C={C} NB={NB} {best*1e3:8.1f} ms"
                  f"  {rate:7.0f} Msamples/s (compile+1st {compile_s:.1f}s)"
                  f"  max|cf err| {err:.2f} Hz", flush=True)
        if not os.environ.get("BENCH_NOASSERT"):
            assert err < 5.0, (signame, cf_tail, dops[:8])
        return rate

    return one(params, "scan")


if __name__ == "__main__":
    C = os.environ.get("BENCH_C")
    NB = int(os.environ.get("BENCH_NB", "900"))
    fams = os.environ.get("BENCH_FAMS")
    fams = fams.split(",") if fams else list(FAMILIES)
    for name in fams:
        bench_family(name, C=int(C) if C else None, NB=NB)
