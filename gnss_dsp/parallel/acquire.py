"""Sharded acquisition: the full PRN x doppler x code-phase search over a
(sat, time) device mesh.

Mapping (SURVEY.md §2.5): the PRN axis shards like data parallelism (each
chip owns P/nsat reference-code FFTs and their correlation surfaces); the
non-coherent block sum — the reference's `q += abs(r)` loop
(acquire-gps-l1.py:30-33) — becomes a `psum` over the `time` axis; the
per-PRN peak/argmax reduction stays on-chip because each PRN's grid lives
on exactly one sat-shard.

Samples are replicated across the mesh: one coherent window is <= 2*163840
f32 pairs (~2.6 MB), and every (prn, doppler) cell reads every sample, so
replication is the bandwidth-optimal layout (scaling-book style: shard the
big broadcast axis, replicate the small shared operand).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gnss_dsp.ops import cplx, nco
from gnss_dsp.acquire import engine as _eng


@partial(
    jax.jit,
    static_argnames=("n", "window", "blocks", "peak_mean", "dop_chunk", "mesh"),
)
def grid_search_sharded(x, code_ffts, dopp_fixed, dopp_valid,
                        n: int, window: int, blocks: int,
                        peak_mean: bool, dop_chunk: int, mesh):
    """Sharded twin of acquire.engine.grid_search.

    x          : split-complex [>= (blocks-1)*n + window] (replicated)
    code_ffts  : split-complex [P, window]; P % mesh('sat') == 0
    dopp_fixed : int32 [Dp], Dp % dop_chunk == 0 (padded, see engine)
    dopp_valid : bool [Dp] shared by every PRN, or [P, Dp] per-PRN (the
                 FDMA twin: each channel's band is its own valid window)
    Returns per-PRN (metric [P], code_idx [P], dop_idx [P]).
    """
    nsat = mesh.shape["sat"]
    ntime = mesh.shape["time"]
    assert code_ffts[0].shape[0] % nsat == 0
    blocks_local = -(-blocks // ntime)
    Dp = dopp_fixed.shape[0]
    n_chunks = Dp // dop_chunk

    def local_fn(x, cf, dopp_fixed, dopp_valid):
        Pl = cf[0].shape[0]
        t_idx = jax.lax.axis_index("time")
        zero_p = jnp.zeros((), jnp.uint32)

        # this shard's block windows [B_local, W]; rows past the global
        # block count zeroed (their |R| contribution is then zero)
        gb = t_idx * blocks_local + jnp.arange(blocks_local)
        live = (gb < blocks)[:, None]
        idx = jnp.where(live, gb[:, None] * n + jnp.arange(window)[None, :], 0)
        xb = (jnp.where(live, jnp.take(x[0], idx), 0.0),
              jnp.where(live, jnp.take(x[1], idx), 0.0))

        def chunk_body(carry, ci):
            best_metric, best_code, best_dop = carry
            d0 = ci * dop_chunk
            df = jax.lax.dynamic_slice(dopp_fixed, (d0,), (dop_chunk,))
            if dopp_valid.ndim == 2:       # per-PRN bands (FDMA)
                valid = jax.lax.dynamic_slice(
                    dopp_valid, (0, d0), (Pl, dop_chunk))
            else:
                valid = jax.lax.dynamic_slice(
                    dopp_valid, (d0,), (dop_chunk,))[None, :]
            w = jax.vmap(lambda f: nco.nco_split(f, zero_p, window))(df)

            q = _eng.chunk_q(xb, cf, w, jax.lax.Precision.HIGHEST)
            # the non-coherent accumulation is the only cross-shard term
            q = jax.lax.psum(q, "time")

            peak = jnp.max(q, axis=-1)
            code_idx = jnp.argmax(q, axis=-1).astype(jnp.int32)
            metric = peak / jnp.mean(q, axis=-1) if peak_mean else peak
            metric = jnp.where(valid, metric, -jnp.inf)
            ch_best = jnp.argmax(metric, axis=-1)
            ch_metric = jnp.take_along_axis(metric, ch_best[:, None], 1)[:, 0]
            ch_code = jnp.take_along_axis(code_idx, ch_best[:, None], 1)[:, 0]
            upd = ch_metric > best_metric
            return (
                jnp.where(upd, ch_metric, best_metric),
                jnp.where(upd, ch_code, best_code),
                jnp.where(upd, (d0 + ch_best).astype(jnp.int32), best_dop),
            ), None

        init = (
            jnp.full((Pl,), -jnp.inf, jnp.float32),
            jnp.zeros((Pl,), jnp.int32),
            jnp.zeros((Pl,), jnp.int32),
        )
        (metric, code_idx, dop_idx), _ = jax.lax.scan(
            chunk_body, init, jnp.arange(n_chunks)
        )
        return metric, code_idx, dop_idx

    valid_spec = P("sat", None) if dopp_valid.ndim == 2 else P()
    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            (P(), P()),                  # x replicated
            (P("sat", None), P("sat", None)),  # code FFTs sharded by PRN
            P(), valid_spec,
        ),
        out_specs=(P("sat"), P("sat"), P("sat")),
        check_vma=False,
    )
    return shard(x, code_ffts, dopp_fixed, dopp_valid)


def _as_global(mesh, spec, a):
    """Process-local numpy -> global array on `mesh` (every process holds
    the full host copy; only its addressable shards are materialized)."""
    from jax.sharding import NamedSharding

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.asarray(a))


def _gather(y):
    """Global (possibly non-fully-addressable) array -> full numpy."""
    if getattr(y, "is_fully_addressable", True):
        return np.asarray(y)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(y, tiled=True))


def acquire_signal_sharded(sig, x_int, prns, mesh, doppler_search=None,
                           ms: int = 80, chan: int = 0,
                           dop_chunk: int | None = None,
                           multihost: bool = False):
    """Mesh-parallel twin of acquire.engine.acquire_signal.

    Pads the PRN list to a multiple of the sat-axis size (results for the
    padding PRNs are dropped).

    multihost=True runs the same program multi-controller (SPMD over
    `jax.distributed`-initialized processes; mesh built over global
    jax.devices()): every process computes identical host-side prep, the
    device arrays are assembled from process-local data, and the sharded
    outputs are allgathered so every process returns the same results.
    Single-process meshes accept multihost=True too (same code path).
    Returns list[AcqResult] in PRN order.
    """
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _eng._block_count(sig, ms)
    dops, fixed = _eng.doppler_grid(sig, doppler_search, chan)

    nsat = mesh.shape["sat"]
    prns_pad = list(prns) + [prns[0]] * ((-len(prns)) % nsat)

    if dop_chunk is None:
        Pl = max(len(prns_pad) // nsat, 1)
        # chunk_q materializes [Pl, DC, B, W] IFFT temps (x ~4) per
        # shard — same sizing as acquire_signal's heuristic
        per_dc = Pl * blocks * window * 16
        dop_chunk = int(np.clip(1.2e9 // per_dc, 1, len(dops)))
    Dp = -(-len(dops) // dop_chunk) * dop_chunk
    fixed_p = np.zeros(Dp, np.int32)
    fixed_p[: len(fixed)] = fixed
    valid = np.zeros(Dp, bool)
    valid[: len(fixed)] = True

    cf_host = _eng.build_code_ffts(sig, prns_pad, n, window)
    if multihost:
        cf_np = [np.ascontiguousarray(cf_host.real).astype(np.float32),
                 np.ascontiguousarray(cf_host.imag).astype(np.float32)]
        code_ffts = tuple(_as_global(mesh, P("sat", None), a) for a in cf_np)
        if isinstance(x_int, tuple):
            x_np = tuple(np.asarray(a) for a in x_int)
        else:
            x_np = (np.ascontiguousarray(np.real(x_int)).astype(np.float32),
                    np.ascontiguousarray(np.imag(x_int)).astype(np.float32))
        x = tuple(_as_global(mesh, P(), a) for a in x_np)
        fixed_a = _as_global(mesh, P(), fixed_p)
        valid_a = _as_global(mesh, P(), valid)
    else:
        code_ffts = cplx.from_numpy(cf_host)
        x = cplx.from_numpy(x_int) if not isinstance(x_int, tuple) else x_int
        fixed_a = jnp.asarray(fixed_p)
        valid_a = jnp.asarray(valid)
    metric, code_idx, dop_idx = grid_search_sharded(
        x, code_ffts, fixed_a, valid_a,
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"),
        dop_chunk=dop_chunk, mesh=mesh,
    )
    metric = _gather(metric)
    code_idx = _gather(code_idx)
    dop_idx = _gather(dop_idx)
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(_eng.AcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code,
        ))
    return out


def acquire_signal_fdma_sharded(sig, x_int, chans, mesh, doppler_search=None,
                                ms: int = 80, dop_chunk: int | None = None):
    """Mesh twin of acquire.engine.acquire_signal_fdma (GLONASS L1/L2).

    FDMA channels share ONE m-sequence (glonass/ca.py:10-22), so the
    "sat" axis shards CHANNELS: the single code-FFT row is replicated
    per channel and each channel's band becomes a per-row validity
    window over the concatenated doppler grid — grid_search_sharded's
    2-D dopp_valid.  psum over 'time' is unchanged.
    Returns list[AcqResult] in channel order (prn field = channel).
    """
    doppler_search = doppler_search or sig.doppler_default
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    window = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    blocks = _eng._block_count(sig, ms)

    dops_all, fixed_all = [], []
    for chan in chans:
        dops, fixed = _eng.doppler_grid(sig, doppler_search, chan)
        dops_all.append(dops)
        fixed_all.append(fixed)
    D = len(dops_all[0])
    nsat = mesh.shape["sat"]
    C = len(chans)
    Cp = C + (-C) % nsat

    if dop_chunk is None:
        Cl = max(Cp // nsat, 1)
        # chunk_q materializes [Cl, DC, B, W] IFFT temps (x ~4)
        per_dc = Cl * blocks * window * 16
        dop_chunk = int(np.clip(1.2e9 // per_dc, 1, C * D))
    Dp = -(-(C * D) // dop_chunk) * dop_chunk
    fixed_p = np.zeros(Dp, np.int32)
    fixed_p[: C * D] = np.concatenate(fixed_all).astype(np.int32)
    valid2 = np.zeros((Cp, Dp), bool)
    for i in range(Cp):
        j = min(i, C - 1)          # padding rows mirror the last channel
        valid2[i, j * D: (j + 1) * D] = True

    cf_host = np.tile(_eng.build_code_ffts(sig, (chans[0],), n, window),
                      (Cp, 1))
    code_ffts = cplx.from_numpy(cf_host)
    x = cplx.from_numpy(x_int) if not isinstance(x_int, tuple) else x_int
    metric, code_idx, dop_idx = grid_search_sharded(
        x, code_ffts, jnp.asarray(fixed_p), jnp.asarray(valid2),
        n=n, window=window, blocks=blocks,
        peak_mean=(sig.acq_metric == "peak_mean"),
        dop_chunk=dop_chunk, mesh=mesh,
    )
    metric = np.asarray(metric)
    code_idx = np.asarray(code_idx)
    dop_idx = np.asarray(dop_idx)
    out = []
    for i, chan in enumerate(chans):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(_eng.AcqResult(
            prn=chan, doppler=float(dops_all[i][dop_idx[i] - i * D]),
            metric=float(metric[i]), code_offset=code,
        ))
    return out


def serial_search_sharded(sig, x, prn: int, doppler: float,
                          parent_code_phase: float, fs: float, mesh,
                          ms: int = 40, chan: int = 0, k_chunk: int = 25):
    """Mesh twin of acquire.serial.serial_search: the K code-phase
    hypotheses (75 for L2CL, 1000 for GLONASS P) shard over EVERY mesh
    device (both axes flattened — hypotheses are embarrassingly
    parallel and there is no cross-shard reduction; the host argmaxes
    the gathered q).
    """
    from gnss_dsp.acquire import serial as _ser

    ndev = mesh.shape["sat"] * mesh.shape["time"]
    geom = _ser.hypothesis_geometry(sig, fs, ms, parent_code_phase)
    K = sig.acq_serial
    Kp = -(-K // (ndev * k_chunk)) * (ndev * k_chunk)
    s_int = np.zeros((Kp, geom.blocks), np.int32)
    s_frac = np.zeros((Kp, geom.blocks), np.float32)
    s_int[:K] = geom.s_int
    s_frac[:K] = geom.s_frac

    xw = _ser.wipe_blocks(sig, x, doppler, fs, chan, geom)
    code_tab = jnp.asarray(sig.code_table((prn,))[0].astype(np.int8))
    incr = jnp.float32(geom.incr)

    def local_fn(xw, code_tab, s_int, s_frac):
        kl = s_int.shape[0]
        si3 = s_int.reshape(kl // k_chunk, k_chunk, geom.blocks)
        sf3 = s_frac.reshape(kl // k_chunk, k_chunk, geom.blocks)
        return jax.lax.map(
            lambda sc: _ser.hypothesis_q(xw, code_tab, sc[0], sc[1], incr,
                                         n=geom.n, L=geom.L),
            (si3, sf3),
        ).reshape(kl)

    shard = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=((P(), P()), P(), P(("sat", "time"), None),
                  P(("sat", "time"), None)),
        out_specs=P(("sat", "time")),
        check_vma=False,
    )
    q = np.asarray(shard(xw, code_tab, jnp.asarray(s_int),
                         jnp.asarray(s_frac)))[:K]
    k_best = int(np.argmax(q))
    return _ser.SerialResult(
        prn=prn, doppler=doppler, metric=float(q[k_best]), k=k_best,
        code_offset=float((geom.stride * k_best + geom.phase0) % geom.L),
    )
