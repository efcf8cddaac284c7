#!/usr/bin/env python
# Drop-in replacement for the reference script of the same name.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gnss_dsp.cli.track import main
sys.exit(main('beidou-b1cp', sys.argv[1:]))
