"""Squaring-detector filter (behavioral contract: squaring.py:10-42):
read raw int8 I/Q, wipe the carrier offset, boxcar-decimate by 16,
square, 100 non-coherent sums, emit int16 I/Q to stdout (baudline food).

argv = input_file sample_rate carrier_offset
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("usage: squaring file sample_rate carrier_offset",
              file=sys.stderr)
        return 2
    from gnss_dsp.cli import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from gnss_dsp.ops import cplx
    from gnss_dsp.ops.frontend import mix_long
    from gnss_dsp.ops.squaring import squaring
    from gnss_dsp.utils import io as uio
    filename, fs, coffset = argv[0], float(argv[1]), float(argv[2])
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    out = sys.stdout.buffer

    b, n, m = 1000, 16, 100
    coffset_phase = 0.0
    y = np.zeros(2 * b, np.int16)
    while True:
        x = uio.get_samples_complex(fp, b * n * m)
        if x is None:
            return 0
        xs = mix_long(cplx.from_numpy(x), -coffset / fs, coffset_phase)
        coffset_phase = float(np.mod(coffset_phase - len(x) * coffset / fs, 1))
        rr, ri = squaring(xs, n, m)
        # one readback of both planes
        rr, ri = jax.device_get((rr, ri))
        y[0::2] = np.round(20 * rr).astype(np.int16)
        y[1::2] = np.round(20 * ri).astype(np.int16)
        y.tofile(out)


if __name__ == "__main__":
    sys.exit(main())


def _entry():
    sys.exit(main(sys.argv[1:]))
