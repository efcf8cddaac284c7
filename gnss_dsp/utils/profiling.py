"""Profiling & throughput counters (SURVEY.md §5: the reference has no
tracing/profiling tier; this is the framework's).

- `trace(dir)`: context manager around jax.profiler for device traces
  viewable in TensorBoard/XProf.
- `Counters`: lightweight throughput accounting — samples, search cells,
  blocks — with wall-time buckets; text report in one line per metric.
  Wait for device work with jax.block_until_ready before reading one.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (open with XProf/TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Counters:
    """Accumulate throughput metrics across engine calls."""
    t0: float = field(default_factory=time.perf_counter)
    samples: int = 0
    cells: int = 0
    blocks: int = 0

    def report(self) -> str:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        parts = [f"wall {dt:.3f}s"]
        if self.samples:
            parts.append(f"{self.samples/dt/1e6:.1f} Msamples/s")
        if self.cells:
            parts.append(f"{self.cells/dt/1e9:.2f} Gcells/s")
        if self.blocks:
            parts.append(f"{self.blocks/dt:.0f} blocks/s")
        return "  ".join(parts)
