"""Native I/O helper: correctness vs the numpy fallback."""

import numpy as np

from gnss_dsp.utils import io as uio
from gnss_dsp.utils import native


def test_deinterleave_matches_numpy(rng):
    raw = rng.integers(-127, 128, size=20002).astype(np.int8).tobytes()
    s = np.frombuffer(raw, np.int8).reshape(-1, 2)
    re, im = native.deinterleave_f32(raw)
    assert np.array_equal(re, s[:, 0].astype(np.float32))
    assert np.array_equal(im, s[:, 1].astype(np.float32))
    x = native.deinterleave_c64(raw)
    assert x.dtype == np.complex64
    assert np.array_equal(x.real, re)
    assert np.array_equal(x.imag, im)


def test_io_uses_native(tmp_path, rng):
    raw = rng.integers(-127, 128, size=4096).astype(np.int8).tobytes()
    p = tmp_path / "x.iq"
    p.write_bytes(raw)
    with open(p, "rb") as f:
        x = uio.get_samples_complex(f, 2048)
    s = np.frombuffer(raw, np.int8).reshape(-1, 2)
    assert np.array_equal(x.real, s[:, 0].astype(np.float32))
    re, im = uio.bytes_to_split(raw)
    assert np.array_equal(re, x.real)
