"""Data-fidelity tests: every PRN code generator must reproduce the
reference's chip sequences exactly.

gnss_dsp/models/codes/data/reference_code_hashes.json holds sha256
digests of every {0,1} chip sequence the reference implementation
generates (produced by tools/extract_icd_tables.py; packaged so the
per-module `python -m ...codes.<module>` ICD self-checks can reach it).  These are the strongest available golden
vectors: a single flipped chip anywhere in any code fails the test.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from gnss_dsp.models.codes import (
    beidou, galileo, glonass, gps_ca, gps_l1c, gps_l2c, gps_l5, gps_p, xona,
)

from gnss_dsp.models.codes import selftest

HASHES = selftest.HASHES


def bits_of(pm1: np.ndarray) -> np.ndarray:
    return ((1 - pm1.astype(np.int16)) // 2).astype(np.uint8)


def sha(bits: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(bits, np.uint8).tobytes()).hexdigest()


def check_family(signal: str, table_fn, prns=None):
    ref = HASHES[signal]
    prns = prns if prns is not None else [int(k) for k in sorted(ref, key=int)]
    got = table_fn(prns)
    bad = []
    for i, p in enumerate(prns):
        if sha(bits_of(got[i])) != ref[str(p)]:
            bad.append(p)
    assert not bad, f"{signal}: chip mismatch for prns {bad[:10]}"


# ---------------- GPS

def test_gps_ca():
    check_family("gps-ca", gps_ca.code_table)


def test_gps_l2cm():
    check_family("gps-l2cm", gps_l2c.cm_table)


def test_gps_l2cl():
    check_family("gps-l2cl", gps_l2c.cl_table)


def test_gps_l2cm_end_states():
    from gnss_dsp.models.codes.data import pairs

    ends = pairs("gps_l2cm_end_state")
    for prn in (1, 32, 63, 159, 210):
        assert gps_l2c.end_state(prn) == ends[prn], prn


def test_gps_l5():
    check_family("gps-l5i", gps_l5.l5i_table)
    check_family("gps-l5q", gps_l5.l5q_table)


def test_gps_l1c_primary():
    check_family("gps-l1cp", gps_l1c.l1cp_table)
    check_family("gps-l1cd", gps_l1c.l1cd_table)


def test_gps_l1cp_secondary():
    ref = HASHES["gps-l1cp-sec"]
    for prn in (1, 37, 63, 64, 100, 139, 198, 210):
        assert sha(gps_l1c.secondary_bits(prn)) == ref[str(prn)], prn


def test_gps_p_window():
    ref = HASHES["gps-p-first10230"]
    for prn in [int(k) for k in sorted(ref, key=int)]:
        assert sha(gps_p.window(prn, 0, 10230)) == ref[str(prn)], prn
    ref_end = HASHES["gps-p-endweek"]
    end = gps_p.code_length - 5115
    for prn in (1, 2, 3):
        assert sha(gps_p.window(prn, end, 10230)) == ref_end[str(prn)], prn


# ---------------- Galileo

def test_galileo_e1():
    check_family("galileo-e1b", galileo.e1b_table)
    check_family("galileo-e1c", galileo.e1c_table)


def test_galileo_e5():
    check_family("galileo-e5ai", galileo.e5ai_table)
    check_family("galileo-e5aq", galileo.e5aq_table)
    check_family("galileo-e5bi", galileo.e5bi_table)
    check_family("galileo-e5bq", galileo.e5bq_table)


def test_galileo_e6():
    check_family("galileo-e6b", galileo.e6b_table)
    check_family("galileo-e6c", galileo.e6c_table)


def test_galileo_secondaries():
    assert galileo.e1c_secondary(1).shape == (25,)
    assert galileo.e5ai_secondary(1).shape == (20,)
    assert galileo.e5bi_secondary(1).shape == (4,)
    assert galileo.e5aq_secondary(1).shape == (100,)
    assert galileo.e5bq_secondary(50).shape == (100,)
    assert galileo.e6c_secondary(25).shape == (100,)
    # CS25 from the OS SIS ICD (e1c.py:14)
    cs25 = bits_of(galileo.e1c_secondary(1))
    assert "".join(map(str, cs25)) == "0011100000001010110110010"


# ---------------- BeiDou

def test_beidou_b1i():
    check_family("beidou-b1i", beidou.b1i_table)


def test_beidou_b1c():
    check_family("beidou-b1cd", beidou.b1cd_table)
    check_family("beidou-b1cp", beidou.b1cp_table)
    ref = HASHES["beidou-b1cp-sec"]
    for prn in (1, 33, 63):
        assert sha(bits_of(beidou.b1cp_secondary(prn))) == ref[str(prn)], prn


def test_beidou_b2a():
    check_family("beidou-b2ad", beidou.b2ad_table)
    check_family("beidou-b2ap", beidou.b2ap_table)
    ref = HASHES["beidou-b2ap-sec"]
    for prn in (1, 30, 63):
        assert sha(bits_of(beidou.b2ap_secondary(prn))) == ref[str(prn)], prn


def test_beidou_b2b():
    check_family("beidou-b2bi", beidou.b2bi_table)
    check_family("beidou-b2bq", beidou.b2bq_table)
    check_family("beidou-b2bd", beidou.b2bd_table)
    check_family("beidou-b2bp", beidou.b2bp_table)


def test_beidou_b2b_generator_matches_memory():
    """The generator and memory tiers agree where they overlap (the
    reference keeps b2bd as a cross-check of b2bi; b2bd.py:1)."""
    from gnss_dsp.models.codes import data

    gen_prns = set(int(p) for p in data.table("bds_b2bd_init_prns"))
    prns = [p for p in beidou.b2b_prns() if p in gen_prns][:6]
    assert prns
    mem = beidou.b2bi_table(prns)
    gen = beidou.b2bd_table(prns)
    for i in range(len(prns)):
        # the reference exhibits a per-PRN global sign flip between its
        # memory and generator tiers (BPSK sign ambiguity in the ICD
        # listing); equality holds up to that sign
        assert (np.array_equal(mem[i], gen[i])
                or np.array_equal(mem[i], -gen[i])), prns[i]


def test_beidou_b3i():
    check_family("beidou-b3i", beidou.b3i_table)


# ---------------- GLONASS

def test_glonass_ca():
    assert sha(glonass.ca_bits()) == HASHES["glonass-ca"]["0"]


def test_glonass_l3oc():
    check_family("glonass-l3ocd", glonass.l3ocd_table)
    check_family("glonass-l3ocp", glonass.l3ocp_table)


@pytest.mark.slow
def test_glonass_p():
    assert sha(glonass.p_bits()) == HASHES["glonass-p"]["0"]


# ---------------- Xona

def test_xona():
    check_family("xona-x1p", xona.x1p_table)
    check_family("xona-x1d", xona.x1d_table)
    check_family("xona-x5p", xona.x5p_table)
    check_family("xona-x5d", xona.x5d_table)
    assert xona.x1p_secondary(0).shape == (100,)
    assert xona.x5p_secondary(0).shape == (100,)


# ---------------- standalone-module ICD self-check UX

def test_module_selftest_entrypoint():
    """`python -m gnss_dsp.models.codes.gps_ca` mirrors the
    reference's per-module `__main__` ICD checks (gps/ca.py:135-149)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "gnss_dsp.models.codes.gps_ca"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-1000:]
    assert "ALL OK" in out.stdout and "210 PRNs OK" in out.stdout
