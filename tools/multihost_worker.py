"""One process of a multi-controller grid search (driven by
tests/test_multihost.py, runnable by hand for N CPU 'hosts'):

    python tools/multihost_worker.py <pid> <nproc> <port> <in.npz> <out.npz>

Each process owns 4 virtual CPU devices; the (sat, time) mesh spans all
nproc*4.  Process 0 writes the gathered results.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
in_npz, out_npz = sys.argv[4], sys.argv[5]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from gnss_dsp.models import get_signal  # noqa: E402
from gnss_dsp.parallel.mesh import init_multihost, make_mesh  # noqa: E402
from gnss_dsp.parallel.acquire import acquire_signal_sharded  # noqa: E402

init_multihost(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc

import dataclasses  # noqa: E402

data = np.load(in_npz)
task = str(data["task"]) if "task" in data else "acquire"

if task == "track":
    import jax.numpy as jnp

    from gnss_dsp.parallel.track import track_scan_sharded
    from gnss_dsp.track.driver import make_params
    from gnss_dsp.track.engine import init_state

    sig = get_signal(str(data["sig"]))
    fs = float(data["fs"])
    x = data["x"]
    xd = (jnp.asarray(x.real.astype(np.float32)),
          jnp.asarray(x.imag.astype(np.float32)))
    params = make_params(sig, fs, coffset=float(data["coffset"]),
                         loop_dwells=(10, 10))
    prns = [int(p) for p in data["prns"]]
    st = init_state(code_p=data["phases"], code_f_off=0 * data["dops"],
                    carrier_p=0 * data["dops"], carrier_f=data["dops"])
    mesh = make_mesh(time_shards=1)
    st2, rf, ri = track_scan_sharded(
        mesh, xd, jnp.int32(len(x)), data["tab"], st, params,
        int(data["n_blocks"]), ratios=jnp.asarray(data["ratios"]),
        coffset_df=jnp.asarray(data["cdf"]), multihost=True)
    if pid == 0:
        np.savez(out_npz, rf=rf, ri=ri,
                 carrier_f=np.asarray(st2.carrier_f),
                 code_p_hi=np.asarray(st2.code_p_hi))
else:
    sig = dataclasses.replace(get_signal(str(data["sig"])),
                              acq_fs=float(data["acq_fs"]))
    x = data["x"]
    prns = [int(p) for p in data["prns"]]

    mesh = make_mesh()          # all global devices
    res = acquire_signal_sharded(
        sig, x, prns, mesh,
        doppler_search=tuple(float(v) for v in data["dop_search"]),
        ms=int(data["ms"]), dop_chunk=int(data["dop_chunk"]),
        multihost=True,
    )
    if pid == 0:
        np.savez(out_npz,
                 prn=[r.prn for r in res],
                 doppler=[r.doppler for r in res],
                 metric=[r.metric for r in res],
                 code_offset=[r.code_offset for r in res])
print(f"proc {pid}/{nproc} done over {len(jax.devices())} devices")
