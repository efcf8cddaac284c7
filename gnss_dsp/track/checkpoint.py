"""Checkpoint / exact resume for tracking state.

The reference's only "resume" is manually re-seeding argv with
--carrier-phase and a code offset (track-gps-l1.py:121,133-135).  Here
the loop state is a flat pytree of arrays, so a checkpoint is one npz and
resume is bit-exact: scanning N blocks equals scanning k, saving,
loading, and scanning N-k (tests/test_checkpoint.py asserts bitwise
equality of every output row).
"""

from __future__ import annotations

import json

import numpy as np
import jax.numpy as jnp

from gnss_dsp.track.engine import TrackState


def state_to_arrays(state: TrackState) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in TrackState._fields}


def save(path: str, state: TrackState, channels=None, meta: dict | None = None):
    """Write state (+ per-channel host accumulators) to one npz."""
    arrays = state_to_arrays(state)
    if channels is not None:
        arrays["host_samp"] = np.array([c.samp for c in channels], np.int64)
        arrays["host_code_cyc"] = np.array([c.code_cyc for c in channels],
                                           np.int64)
        arrays["host_carrier_cyc"] = np.array(
            [c.carrier_cyc for c in channels], np.int64)
        arrays["host_prn"] = np.array([c.prn for c in channels], np.int64)
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str):
    """Returns (TrackState, host dict, meta dict)."""
    z = np.load(path)
    state = TrackState(**{
        f: jnp.asarray(z[f]) for f in TrackState._fields
    })
    host = {k[5:]: z[k] for k in z.files if k.startswith("host_")}
    meta = json.loads(bytes(z["meta_json"]).decode() or "{}")
    return state, host, meta
