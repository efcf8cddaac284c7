"""Compile-cache primer.

Pre-compiles every program the 2017 sky workload uses — the shared
tracking programs, the acquisition grids of all 21 acquire-all scripts,
and the tiny glue ops — into the persistent compilation cache
(JAX_COMPILATION_CACHE_DIR, else <checkout>/.cache/jax; see
gnss_dsp.cli.enable_compilation_cache) by running the batched workload
against a locally-synthesized 120 ms capture.  Run it once after a fresh
clone, a JAX upgrade, or a cache wipe; subsequent cold CLI processes
then LOAD executables instead of compiling.  What remains of a cold run
is jit tracing on the host, device/runtime start-up and the cache load.

    python tools/warm_cache.py [capture.pcap]
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    data = sys.argv[1] if len(sys.argv) > 1 else None
    if data is None or not os.path.exists(data):
        data = os.path.join(tempfile.gettempdir(), "gnss-warm-120ms.pcap")
        if not os.path.exists(data):
            print("synthesizing 120 ms priming capture ...")
            subprocess.run(
                [sys.executable, os.path.join(REPO, "tools", "synth_sky.py"),
                 data, "120"],
                check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    dest = os.path.join(tempfile.gettempdir(), "gnss-warm-out")
    print("priming: batched acquire-all + track-all (every workload "
          "program compiles into the persistent cache) ...")
    r = subprocess.run(
        [sys.executable, "-m", "gnss_dsp.cli.workload", "all",
         data, dest], cwd=REPO)
    sys.exit(r.returncode)


if __name__ == "__main__":
    main()
