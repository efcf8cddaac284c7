"""Multi-chip scaling: device meshes + sharded acquisition/tracking.

The reference's only parallelism is a fork-based process pool over PRNs
(acquire-gps-l1.py:105-108).  Here the same axes become mesh axes
(SURVEY.md §2.5): satellites/PRNs shard like data parallelism, the
time-block axis of non-coherent integration is a `psum` reduction over
ICI, and tracking channels shard 1:1 onto chips.
"""

from gnss_dsp.parallel.mesh import make_mesh  # noqa: F401
