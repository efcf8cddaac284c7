"""gnss_dsp — a JAX GNSS acquisition/tracking framework.

A from-scratch JAX/XLA re-design with the capabilities of
pmonta/GNSS-DSP-tools (the reference implementation is numpy/Numba;
see SURVEY.md for the capability inventory).

Architecture: one *engine*, many *signal descriptors*.  The reference
ships 65 near-identical CLI scripts (32 acquire + 33 track); here a
signal is data (`gnss_dsp.models.Signal`) and acquisition/tracking
are two batched, jit-compiled engines that consume descriptors.

Layers:
  models/    signal descriptors + PRN code-table builders (host, numpy)
  ops/       device DSP primitives (NCO/mixers, correlators, FFT search,
             discriminators, front-end resampler)
  acquire/   batched FFT acquisition engine (PRN x doppler x time grid)
  track/     scan-based DLL/FLL/PLL tracking engine (channels batched)
  parallel/  mesh construction + sharded multi-device acquisition and
             tracking
  utils/     sample I/O, CLI range parsing, float-float scalar math
  cli/       argv-compatible front doors mirroring the reference scripts
"""

__version__ = "0.1.0"
