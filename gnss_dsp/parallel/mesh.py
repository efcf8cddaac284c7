"""Mesh construction for the GNSS engines.

Axes (SURVEY.md §2.5 mapping of the reference's parallel axes):
  sat   — PRN/satellite axis (embarrassingly parallel; like DP)
  time  — non-coherent time-block axis (psum reduction; like gradient DP)

Doppler could be a third axis but is better kept on one device: a
doppler chunk is the natural working set, and sharding it would split
the per-PRN argmax reduction across devices for no bandwidth win.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_ids=None) -> None:
    """Join this process to a multi-controller run (DCN story, SURVEY.md
    §2.5): after this, jax.devices() is GLOBAL and make_mesh() builds a
    cross-host mesh.  Pass the coordinator address (host:port), the
    process count and this process's id explicitly, as the 2-process
    CPU test does (tests/test_multihost.py)."""
    import jax as _jax

    _jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_mesh(n_devices: int | None = None, time_shards: int | None = None,
              devices=None) -> Mesh:
    """Build a (sat, time) mesh over `n_devices` (default: all).

    time_shards defaults to 2 when the device count is even, else 1 —
    non-coherent integration scales well but the psum is the only
    collective, so most chips go to the embarrassingly-parallel sat axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    nd = len(devices)
    if time_shards is None:
        time_shards = 2 if nd % 2 == 0 and nd > 1 else 1
    assert nd % time_shards == 0, (nd, time_shards)
    arr = np.array(devices).reshape(nd // time_shards, time_shards)
    return Mesh(arr, ("sat", "time"))
