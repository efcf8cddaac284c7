"""Channel-sharded tracking: N channels spread over the mesh's sat axis.

Tracking is sequential in time (the loop filters feed forward,
track-gps-l1.py:33-94) so the only scalable axis is channels — exactly the
reference's "one process per track script" usage, but as one jit program.
Every per-channel operand (state, code tables, carrier-aiding ratios,
carrier-offset increments, sigp lanes, overlays, data ends) shards over
'sat'; the sample chunk is replicated (every channel reads the same
stream).  Each device runs the single-device scan on its channel shard
under shard_map: there are no collectives in the step, so scaling is
linear.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gnss_dsp.track.engine import sigp_from_params, track_scan


@partial(jax.jit, static_argnames=("mesh", "params", "n_blocks"))
def _scan_sharded(x0, x1, chunk_len, code_tab, state, ratios, coffset_df,
                  sigp, overlay, *, mesh, params, n_blocks: int):
    def local(x0, x1, cl, tab, st, rat, cdf, sp, ovl):
        return track_scan((x0, x1), cl, tab, st, params, n_blocks,
                          ratios=rat, coffset_df=cdf, sigp=sp, overlay=ovl)

    chan = P("sat")
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P()) + (chan,) * 7,
        out_specs=(chan, P(None, "sat"), P(None, "sat")),
        check_vma=False,
    )(x0, x1, chunk_len, code_tab, state, ratios, coffset_df, sigp, overlay)


def track_scan_sharded(mesh, x_chunk, chunk_len, code_tab, state, params,
                       n_blocks: int, ratios=None, coffset_df=None,
                       sigp=None, overlay=None, multihost: bool = False):
    """track_scan with channel-sharded operands; same returns.  The
    channel count must be a multiple of the sat-axis size (track_file
    pads with clones of channel 0).

    multihost=True runs the same program multi-controller: every process
    passes the full host copy of each operand (only its addressable
    shards are materialized) and the sharded outputs are allgathered, so
    every process returns identical full rows/state — same contract as
    parallel/acquire.acquire_signal_sharded."""
    C = state.ptr.shape[0]
    # shard_map takes concrete per-channel operands: materialize the
    # defaults track_scan would otherwise synthesize
    chunk_len = jnp.broadcast_to(jnp.asarray(chunk_len, jnp.int32), (C,))
    if ratios is None:
        ratios = jnp.full((C,), params.carrier_ratio, jnp.float32)
    if coffset_df is None:
        coffset_df = jnp.full((C,), params.coffset_df_fixed, jnp.int32)
    if sigp is None:
        sigp = sigp_from_params(params, C)
    if overlay is None:
        overlay = jnp.ones((C, 1), jnp.float32)
    per_chan = (chunk_len, code_tab, state, ratios, coffset_df, sigp,
                overlay)
    if multihost:
        def place(spec, a):
            # every process passes the FULL host copy; jax slices each
            # device's shard from it (make_array_from_process_local_data
            # would instead CONCATENATE the per-process copies)
            a = np.asarray(a)
            return jax.make_array_from_callback(
                a.shape, NamedSharding(mesh, spec), lambda idx: a[idx])
    else:
        def place(spec, a):
            return jax.device_put(a, NamedSharding(mesh, spec))
    x_chunk = tuple(place(P(), a) for a in x_chunk)
    per_chan = jax.tree.map(lambda a: place(P("sat"), a), per_chan)
    out = _scan_sharded(*x_chunk, *per_chan, mesh=mesh, params=params,
                        n_blocks=n_blocks)
    if multihost:
        # replicate on-device (multihost_utils.process_allgather mangles
        # the middle-axis-sharded [B, C, 11] rows), then read locally
        rep = NamedSharding(mesh, P())
        out = jax.jit(lambda t: t, out_shardings=rep)(out)
        return jax.tree.map(np.asarray, out)
    return out
