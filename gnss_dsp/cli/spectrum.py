"""Averaged PSD utility (behavioral contract: spectrum.py:39-57):
argv = file fc fs fftlen nblocks.  Welch-style Hann-windowed average of
nblocks FFTs, repeated until EOF.

The reference live-plots with matplotlib; plotting is kept optional
(--text prints `freq_hz psd_db` rows — usable headless and in tests;
matplotlib is used when available and --text is not given).
"""

from __future__ import annotations

import sys

import numpy as np

from gnss_dsp.utils import io as uio


def psd_block(fp, n: int, ns: int):
    """One averaged spectrum, or None at EOF."""
    p = np.zeros(n)
    w = np.hanning(n)
    for _ in range(ns):
        x = uio.get_samples_complex(fp, n)
        if x is None:
            return None
        z = np.fft.fft(x * w)
        p += np.real(z * np.conj(z)) / ns
    return 10 * np.log10(np.fft.fftshift(p))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    text = "--text" in argv
    if text:
        argv.remove("--text")
    if len(argv) != 5:
        print("usage: spectrum [--text] file fc fs fftlen nblocks",
              file=sys.stderr)
        return 2
    filename, fc, fs, n, ns = (argv[0], float(argv[1]), float(argv[2]),
                               int(argv[3]), int(argv[4]))
    fp = open(filename, "rb") if filename != "-" else sys.stdin.buffer
    freqs = fc + np.fft.fftshift(np.fft.fftfreq(n, 1.0 / fs))

    plot = None
    if not text:
        try:
            import matplotlib.pyplot as plt  # noqa: F401
            plot = plt
        except Exception:
            text = True
    line = ax = None
    while True:
        y = psd_block(fp, n, ns)
        if y is None:
            return 0
        if text:
            for f, v in zip(freqs, y):
                print("%.1f %.3f" % (f, v))
            return 0
        if line is None:
            fig, ax = plot.subplots()
            (line,) = ax.plot(freqs, y)
            ax.set_xlabel("Frequency (Hz)")
            ax.set_ylabel("Power spectral density (dB)")
            ax.set_title("Spectrum")
            ax.grid(True)
        else:
            line.set_ydata(y)
            ax.relim()
            ax.autoscale_view(True, True, True)
        plot.pause(0.1)


if __name__ == "__main__":
    sys.exit(main())


def _entry():
    sys.exit(main(sys.argv[1:]))
