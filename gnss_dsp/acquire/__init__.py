"""Batched FFT acquisition engine."""

from gnss_dsp.acquire.engine import acquire_signal, grid_search, AcqResult  # noqa: F401
