"""Scan-based DLL/FLL/PLL tracking engine."""

from gnss_dsp.track.engine import (  # noqa: F401
    TrackState, TrackParams, init_state, track_scan,
)
from gnss_dsp.track.driver import track_file, TrackChannel  # noqa: F401
