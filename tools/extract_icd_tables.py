"""One-time extraction of public ICD constant tables from the reference
checkout into binary assets, plus reference-derived golden hashes.

The per-PRN initial-state/Weil-parameter tables and the E1/E6/B2b/Xona
memory-code bit strings are interface-control-document constants (IS-GPS-200,
IS-GPS-705, Galileo OS SIS ICD, BeiDou ICDs, Xona ICD) — data, not code.
This script reads them out of /root/reference (which transcribes those ICD
tables) and packs them into:

  gnss_dsp/models/codes/data/icd_tables.npz   construction constants
  gnss_dsp/models/codes/data/reference_code_hashes.json            sha256 of every full
      {0,1} chip sequence the reference generates, per (signal, prn) —
      the cross-implementation golden vectors for tests/test_codes.py.

Run from the repo root with the reference checkout present:
  python tools/extract_icd_tables.py
The committed assets are the artifact; this script is only needed to
regenerate them.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

REF = os.environ.get("GNSS_REF", "/root/reference")
sys.path.insert(0, REF)

OUT_NPZ = os.path.join(os.path.dirname(__file__), "..",
                       "gnss_dsp", "models", "codes", "data",
                       "icd_tables.npz")
OUT_JSON = os.path.join(os.path.dirname(__file__), "..",
                        "gnss_dsp", "models", "codes", "data", "reference_code_hashes.json")

tables: dict[str, np.ndarray] = {}
hashes: dict[str, dict[str, str]] = {}


def dict_to_pairs(d, width=1):
    """{prn: int} or {prn: tuple} -> int64 [n, 1+width] (prn, values...)."""
    rows = []
    for k in sorted(d):
        v = d[k]
        v = list(v) if isinstance(v, (tuple, list)) else [v]
        v = v + [-1] * (width - len(v))
        rows.append([k] + v)
    return np.array(rows, dtype=np.int64)


def bitstr_rows(d):
    """{prn: '0101...'} -> (prns int64 [n], bits uint8 [n, len])."""
    prns = np.array(sorted(d), np.int64)
    bits = np.array([[int(c) for c in d[k]] for k in sorted(d)], np.uint8)
    return prns, bits


def hex_to_bits(s: str, n: int) -> np.ndarray:
    nib = np.array([int(c, 16) for c in s], np.uint8)
    bits = ((nib[:, None] >> np.array([3, 2, 1, 0], np.uint8)) & 1).reshape(-1)
    return bits[:n].astype(np.uint8)


B64 = {c: i for i, c in enumerate(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/")}


def b64_to_bits(s: str, n: int) -> np.ndarray:
    v = np.array([B64[c] for c in s], np.uint8)
    bits = ((v[:, None] >> np.array([5, 4, 3, 2, 1, 0], np.uint8)) & 1).reshape(-1)
    return bits[:n].astype(np.uint8)


def pack(name: str, prns, bits):
    """Store a memory-code family as packed bits."""
    bits = np.asarray(bits, np.uint8)
    tables[name + "_prns"] = np.asarray(prns, np.int64)
    tables[name + "_shape"] = np.array(bits.shape, np.int64)
    tables[name + "_bits"] = np.packbits(bits, axis=None)


def record_hashes(signal: str, fn, prns):
    out = {}
    for p in prns:
        c = np.asarray(fn(p)).astype(np.uint8)
        out[str(p)] = hashlib.sha256(c.tobytes()).hexdigest()
    hashes[signal] = out
    print(f"  hashed {signal}: {len(prns)} prns")


def main():
    # ---------------- GPS
    import gnsstools.gps.ca as ca
    record_hashes("gps-ca", lambda p: ca.ca_code(p), range(1, 211))

    import gnsstools.gps.l2cm as l2cm
    import gnsstools.gps.l2cl as l2cl
    tables["gps_l2cm_init"] = dict_to_pairs(l2cm.l2cm_init)
    tables["gps_l2cl_init"] = dict_to_pairs(l2cl.l2cl_init)
    tables["gps_l2cm_end_state"] = dict_to_pairs(l2cm.l2cm_end_state)
    if hasattr(l2cl, "l2cl_end_state"):
        tables["gps_l2cl_end_state"] = dict_to_pairs(l2cl.l2cl_end_state)
    prns_l2 = sorted(l2cm.l2cm_init)
    record_hashes("gps-l2cm", lambda p: l2cm.l2cm_code(p), prns_l2)
    record_hashes("gps-l2cl", lambda p: l2cl.l2cl_code(p), prns_l2[:40])

    import gnsstools.gps.l5i as l5i
    import gnsstools.gps.l5q as l5q
    tables["gps_l5i_init"] = dict_to_pairs(l5i.l5i_init)
    tables["gps_l5q_init"] = dict_to_pairs(l5q.l5q_init)
    record_hashes("gps-l5i", lambda p: l5i.l5i_code(p), range(1, 211))
    record_hashes("gps-l5q", lambda p: l5q.l5q_code(p), range(1, 211))

    import gnsstools.gps.l1cp as l1cp
    import gnsstools.gps.l1cd as l1cd
    tables["gps_l1cp_params"] = dict_to_pairs(l1cp.l1cp_params, 2)
    tables["gps_l1cd_params"] = dict_to_pairs(l1cd.l1cd_params, 2)
    tables["gps_l1cp_sec_params"] = dict_to_pairs(l1cp.l1cp_secondary_params, 3)
    record_hashes("gps-l1cp", lambda p: l1cp.l1cp_code(p), range(1, 211))
    record_hashes("gps-l1cd", lambda p: l1cd.l1cd_code(p), range(1, 211))
    record_hashes("gps-l1cp-sec", lambda p: l1cp.secondary_code(p), range(1, 211))

    import gnsstools.gps.p as gpsp
    record_hashes("gps-p-first10230",
                  lambda p: gpsp.p_code(p, 0, 10230), range(1, 38))
    # day-boundary window: chips 6.19e12-ish (end of week wraparound zone)
    end = gpsp.code_length - 5115
    record_hashes("gps-p-endweek",
                  lambda p: gpsp.p_code(p, end, 10230), range(1, 4))

    # ---------------- Galileo
    from gnsstools.galileo.e1b_strings import e1b_strings
    from gnsstools.galileo.e1c_strings import e1c_strings
    pack("gal_e1b", sorted(e1b_strings),
         [hex_to_bits(e1b_strings[k], 4092) for k in sorted(e1b_strings)])
    pack("gal_e1c", sorted(e1c_strings),
         [hex_to_bits(e1c_strings[k], 4092) for k in sorted(e1c_strings)])
    import gnsstools.galileo.e1b as e1b
    import gnsstools.galileo.e1c as e1c
    record_hashes("galileo-e1b", lambda p: e1b.e1b_code(p), sorted(e1b_strings))
    record_hashes("galileo-e1c", lambda p: e1c.e1c_code(p), sorted(e1c_strings))
    tables["gal_e1c_sec"] = ((1 - e1c.secondary_code) / 2).astype(np.uint8)

    import gnsstools.galileo.e5ai as e5ai
    import gnsstools.galileo.e5aq as e5aq
    import gnsstools.galileo.e5bi as e5bi
    import gnsstools.galileo.e5bq as e5bq
    tables["gal_e5ai_init"] = dict_to_pairs(e5ai.e5ai_init)
    tables["gal_e5aq_init"] = dict_to_pairs(e5aq.e5aq_init)
    tables["gal_e5bi_init"] = dict_to_pairs(e5bi.e5bi_init)
    tables["gal_e5bq_init"] = dict_to_pairs(e5bq.e5bq_init)
    tables["gal_e5ai_sec"] = ((1 - e5ai.secondary_code) / 2).astype(np.uint8)
    tables["gal_e5bi_sec"] = ((1 - e5bi.secondary_code) / 2).astype(np.uint8)
    def sec_dict_to_bits(d):
        """{prn: value} where value is a 25-hex-digit string or an already
        parsed +-1 array (the reference converts in place at import)."""
        prns = sorted(d)
        rows = []
        for k in prns:
            v = d[k]
            if isinstance(v, str):
                rows.append(hex_to_bits(v, 100))
            else:
                rows.append(((1 - np.asarray(v)) / 2).astype(np.uint8))
        return np.array(prns, np.int64), np.stack(rows)

    for nm, mod in (("gal_e5aq_sec", e5aq), ("gal_e5bq_sec", e5bq)):
        prns, bits = sec_dict_to_bits(mod.secondary_code)
        tables[nm + "_prns"] = prns
        tables[nm] = bits
    record_hashes("galileo-e5ai", lambda p: e5ai.e5ai_code(p), range(1, 51))
    record_hashes("galileo-e5aq", lambda p: e5aq.e5aq_code(p), range(1, 51))
    record_hashes("galileo-e5bi", lambda p: e5bi.e5bi_code(p), range(1, 51))
    record_hashes("galileo-e5bq", lambda p: e5bq.e5bq_code(p), range(1, 51))

    from gnsstools.galileo.e6b_strings import e6b_strings
    from gnsstools.galileo.e6c_strings import e6c_strings
    pack("gal_e6b", sorted(e6b_strings),
         [b64_to_bits(e6b_strings[k], 5115) for k in sorted(e6b_strings)])
    pack("gal_e6c", sorted(e6c_strings),
         [b64_to_bits(e6c_strings[k], 5115) for k in sorted(e6c_strings)])
    import gnsstools.galileo.e6b as e6b
    import gnsstools.galileo.e6c as e6c
    record_hashes("galileo-e6b", lambda p: e6b.e6b_code(p), sorted(e6b_strings))
    record_hashes("galileo-e6c", lambda p: e6c.e6c_code(p), sorted(e6c_strings))
    prns, bits = sec_dict_to_bits(e6c.secondary_code)
    tables["gal_e6c_sec_prns"] = prns
    tables["gal_e6c_sec"] = bits

    # ---------------- BeiDou
    import gnsstools.beidou.b1i as b1i
    tables["bds_b1i_taps"] = dict_to_pairs(b1i.b1i_g2_taps, 3)
    record_hashes("beidou-b1i", lambda p: b1i.b1i_code(p), range(1, 64))

    import gnsstools.beidou.b1cd as b1cd
    import gnsstools.beidou.b1cp as b1cp
    tables["bds_b1cd_params"] = dict_to_pairs(b1cd.b1cd_params, 2)
    tables["bds_b1cp_params"] = dict_to_pairs(b1cp.b1cp_params, 2)
    tables["bds_b1cp_sec_params"] = dict_to_pairs(b1cp.b1cp_secondary_params, 2)
    record_hashes("beidou-b1cd", lambda p: b1cd.b1cd_code(p), range(1, 64))
    record_hashes("beidou-b1cp", lambda p: b1cp.b1cp_code(p), range(1, 64))
    record_hashes("beidou-b1cp-sec", lambda p: b1cp.secondary_code(p), range(1, 64))

    import gnsstools.beidou.b2ad as b2ad
    import gnsstools.beidou.b2ap as b2ap
    p_, b_ = bitstr_rows(b2ad.b2ad_g2_initial)
    tables["bds_b2ad_init_prns"], tables["bds_b2ad_init"] = p_, b_
    p_, b_ = bitstr_rows(b2ap.b2ap_g2_initial)
    tables["bds_b2ap_init_prns"], tables["bds_b2ap_init"] = p_, b_
    tables["bds_b2ap_sec_params"] = dict_to_pairs(b2ap.b2ap_secondary_params, 2)
    record_hashes("beidou-b2ad", lambda p: b2ad.b2ad_code(p), range(1, 64))
    record_hashes("beidou-b2ap", lambda p: b2ap.b2ap_code(p), range(1, 64))
    record_hashes("beidou-b2ap-sec", lambda p: b2ap.secondary_code(p), range(1, 64))

    from gnsstools.beidou.b2bi_strings import b2bi_strings
    from gnsstools.beidou.b2bq_strings import b2bq_strings
    pack("bds_b2bi", sorted(b2bi_strings),
         [b64_to_bits(b2bi_strings[k], 10230) for k in sorted(b2bi_strings)])
    pack("bds_b2bq", sorted(b2bq_strings),
         [b64_to_bits(b2bq_strings[k], 10230) for k in sorted(b2bq_strings)])
    import gnsstools.beidou.b2bi as b2bi
    import gnsstools.beidou.b2bq as b2bq
    record_hashes("beidou-b2bi", lambda p: b2bi.b2bi_code(p), sorted(b2bi_strings))
    record_hashes("beidou-b2bq", lambda p: b2bq.b2bq_code(p), sorted(b2bq_strings))

    import gnsstools.beidou.b2bd as b2bd
    import gnsstools.beidou.b2bp as b2bp
    p_, b_ = bitstr_rows(b2bd.b2bd_g2_initial)
    tables["bds_b2bd_init_prns"], tables["bds_b2bd_init"] = p_, b_
    p_, b_ = bitstr_rows(b2bp.b2bp_g2_initial)
    tables["bds_b2bp_init_prns"], tables["bds_b2bp_init"] = p_, b_
    record_hashes("beidou-b2bd", lambda p: b2bd.b2bd_code(p),
                  sorted(b2bd.b2bd_g2_initial))
    record_hashes("beidou-b2bp", lambda p: b2bp.b2bp_code(p),
                  sorted(b2bp.b2bp_g2_initial))

    import gnsstools.beidou.b3i as b3i
    p_, b_ = bitstr_rows(b3i.b3i_g2_initial)
    tables["bds_b3i_init_prns"], tables["bds_b3i_init"] = p_, b_
    record_hashes("beidou-b3i", lambda p: b3i.b3i_code(p), range(1, 64))

    # ---------------- GLONASS
    import gnsstools.glonass.ca as gca
    record_hashes("glonass-ca", lambda p: gca.ca_code(), [0])
    import gnsstools.glonass.l3ocd as l3ocd
    import gnsstools.glonass.l3ocp as l3ocp
    record_hashes("glonass-l3ocd", lambda p: l3ocd.l3ocd_code(p), range(0, 64))
    record_hashes("glonass-l3ocp", lambda p: l3ocp.l3ocp_code(p), range(0, 64))
    import gnsstools.glonass.p as gp
    record_hashes("glonass-p", lambda p: gp.p_code(), [0])

    # ---------------- Xona
    from gnsstools.xona.x1p_strings import x1p_strings
    from gnsstools.xona.x1d_strings import x1d_strings
    from gnsstools.xona.x5p_strings import x5p_strings
    # reference quirk: x5d_strings.py names its dict x5p_strings (upstream
    # copy-paste slip), which also breaks x5d.x5d_code at call time
    import gnsstools.xona.x5d_strings as _x5dmod
    x5d_strings = getattr(_x5dmod, "x5d_strings", None) or _x5dmod.x5p_strings
    pack("xona_x1p", sorted(x1p_strings),
         [hex_to_bits(x1p_strings[k], 1023) for k in sorted(x1p_strings)])
    pack("xona_x1d", sorted(x1d_strings),
         [hex_to_bits(x1d_strings[k], 1023) for k in sorted(x1d_strings)])
    pack("xona_x5p", sorted(x5p_strings),
         [hex_to_bits(x5p_strings[k], 10230) for k in sorted(x5p_strings)])
    pack("xona_x5d", sorted(x5d_strings),
         [hex_to_bits(x5d_strings[k], 10230) for k in sorted(x5d_strings)])
    import gnsstools.xona.x1p as x1p
    import gnsstools.xona.x5p as x5p
    tables["xona_x1p_sec"] = ((1 - x1p.secondary_code) / 2).astype(np.uint8)
    tables["xona_x5p_sec"] = ((1 - x5p.secondary_code) / 2).astype(np.uint8)
    import gnsstools.xona.x1d as x1d
    record_hashes("xona-x1p", lambda p: x1p.x1p_code(p), sorted(x1p_strings))
    record_hashes("xona-x1d", lambda p: x1d.x1d_code(p), sorted(x1d_strings))
    record_hashes("xona-x5p", lambda p: x5p.x5p_code(p), sorted(x5p_strings))
    # x5d.x5d_code raises NameError (the strings quirk above); hash the
    # parsed bits directly — same hex-parse semantics as x5p (x5d.py:13-21)
    hashes["xona-x5d"] = {
        str(k): hashlib.sha256(
            hex_to_bits(x5d_strings[k], 10230).tobytes()).hexdigest()
        for k in sorted(x5d_strings)
    }
    print("  hashed xona-x5d:", len(x5d_strings), "prns (direct parse)")

    os.makedirs(os.path.dirname(OUT_NPZ), exist_ok=True)
    np.savez_compressed(OUT_NPZ, **tables)
    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON, "w") as f:
        json.dump(hashes, f, indent=0, sort_keys=True)
    print(f"wrote {OUT_NPZ} ({os.path.getsize(OUT_NPZ)} bytes), "
          f"{OUT_JSON} ({os.path.getsize(OUT_JSON)} bytes)")


if __name__ == "__main__":
    main()
