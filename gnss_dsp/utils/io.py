"""Raw IQ sample ingest.

Format contract (gnsstools/io.py:3-12): interleaved signed int8 I/Q pairs;
a short read means EOF and yields None.

Additions over the reference:
  * zero-copy int8 view + single vectorized complex64 conversion
  * chunked streaming reader with bounded lookahead for the tracking
    engine (fixed-size device blocks, variable-size consumption is
    handled on-device with masking)
  * optional native (C++) deinterleave via utils/native.py when built
"""

from __future__ import annotations

import numpy as np


def get_samples_complex(fp, n: int):
    """Read n complex samples (2n int8 bytes); None at EOF (io.py:3-12)."""
    z = fp.read(2 * int(n))
    if len(z) != 2 * int(n):
        return None
    return bytes_to_complex(z)


def bytes_to_complex(z: bytes) -> np.ndarray:
    from gnss_dsp.utils import native

    return native.deinterleave_c64(z)


def bytes_to_split(z: bytes):
    """int8 I/Q bytes -> planar (re, im) f32 — the device layout, skipping
    the complex64 round-trip entirely."""
    from gnss_dsp.utils import native

    return native.deinterleave_f32(z)


class SampleStream:
    """Chunked streaming reader over an int8 I/Q file or pipe.

    Yields fixed-size numpy complex64 blocks of `block` samples; the final
    partial block is dropped (matching the reference's EOF-on-short-read
    semantics, io.py:5-6)."""

    def __init__(self, fp, block: int):
        self.fp = fp
        self.block = int(block)

    def __iter__(self):
        while True:
            x = get_samples_complex(self.fp, self.block)
            if x is None:
                return
            yield x

    def read(self, n: int):
        return get_samples_complex(self.fp, n)
