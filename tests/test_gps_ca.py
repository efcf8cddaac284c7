"""GPS C/A code tables vs IS-GPS-200 test vectors."""

import numpy as np
import pytest

from gnss_dsp.models.codes import gps_ca, resample_host

# IS-GPS-200 Table 3-Ia/3-Ib "First 10 Chips" (octal).  Spot set spans
# GPS (1-32), SBAS (120-158), QZSS (193-202) and the extension range.
FIRST_10_CHIPS_OCTAL = {
    1: 0o1440, 2: 0o1620, 3: 0o1710, 4: 0o1744, 5: 0o1133,
    10: 0o1504, 21: 0o1746, 32: 0o1712,
    120: 0o0671, 131: 0o1226, 138: 0o1327, 193: 0o0727, 210: 0o1046,
}


def test_first_10_chips_icd():
    for prn, expect in FIRST_10_CHIPS_OCTAL.items():
        got = gps_ca.first_10_chips(prn)
        assert got == expect, f"PRN {prn}: got {got:04o}, want {expect:04o}"


def test_code_properties():
    c = gps_ca.ca_code(1)
    assert c.shape == (1023,)
    assert set(np.unique(c)) == {-1, 1}
    # Gold code balance: 512 chips of one sign, 511 of the other
    assert abs(int(np.sum(c))) == 1
    # distinct PRNs have low cross-correlation
    c2 = gps_ca.ca_code(2)
    assert abs(int(np.dot(c.astype(np.int64), c2.astype(np.int64)))) <= 65


def test_code_table_shape():
    t = gps_ca.code_table(range(1, 33))
    assert t.shape == (32, 1023)
    assert t.dtype == np.int8


def test_resample_host_floor_indexing():
    c = gps_ca.ca_code(7).astype(np.float64)
    n = 4096
    incr = 1023.0 / n
    r = resample_host(gps_ca.ca_code(7), 0, 0, incr, n)
    idx = np.floor(incr * np.arange(n)).astype(int) % 1023
    assert np.array_equal(r, c[idx])


@pytest.mark.parametrize("prn", [1, 9, 33, 64, 150])
def test_parity_vs_reference(prn):
    """Full-table parity against the reference implementation when the
    read-only reference checkout is present (CI convenience, not a runtime
    dependency)."""
    import os, sys
    if os.path.isdir("/root/reference/gnsstools") and "/root/reference" not in sys.path:
        sys.path.append("/root/reference")
    ref = pytest.importorskip("gnsstools.gps.ca")
    ours = gps_ca.ca_code(prn)
    theirs = 1 - 2 * ref.ca_code(prn).astype(np.int8)
    assert np.array_equal(ours, theirs)
