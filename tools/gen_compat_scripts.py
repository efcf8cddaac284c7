"""Generate the drop-in compatibility wrappers in scripts/ — one per
reference CLI script name (32 acquire + 33 track + 3 utilities), each a
three-liner delegating to the dispatcher with its registry signal."""

from __future__ import annotations

import os
import stat

HERE = os.path.dirname(__file__)
OUT = os.path.join(HERE, "..", "scripts")

ACQUIRE = [
    "gps-l1", "gps-l1cd", "gps-l1cp", "gps-l2cl", "gps-l2cm", "gps-l5i",
    "gps-l5q",
    "galileo-e1b", "galileo-e1c", "galileo-e5ai", "galileo-e5aq",
    "galileo-e5bi", "galileo-e5bq", "galileo-e6b", "galileo-e6c",
    "beidou-b1cd", "beidou-b1cp", "beidou-b1i", "beidou-b2ad",
    "beidou-b2ap", "beidou-b2bi", "beidou-b2bq", "beidou-b2i",
    "beidou-b3i",
    "glonass-l1", "glonass-l1-p", "glonass-l2", "glonass-l2-p",
    "glonass-l3ocd", "glonass-l3ocp",
]
# reference name quirks: acquire-xona-x1.py searches the x1p code
ACQUIRE_ALIASES = {"xona-x1": "xona-x1p", "xona-x5p": "xona-x5p"}

TRACK = ACQUIRE.copy()
TRACK.remove("gps-l2cl")  # has its own entry below with identical name
TRACK.append("gps-l2cl")
TRACK_ALIASES = {"xona-x1d": "xona-x1d", "xona-x1p": "xona-x1p",
                 "xona-x5p": "xona-x5p"}

TEMPLATE = """#!/usr/bin/env python
# Drop-in replacement for the reference script of the same name.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gnss_dsp.cli.{mod} import main
sys.exit(main({sig!r}, sys.argv[1:]))
"""

UTIL_TEMPLATE = """#!/usr/bin/env python
# Drop-in replacement for the reference script of the same name.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gnss_dsp.cli.{mod} import main
sys.exit(main(sys.argv[1:]))
"""


def write(name: str, text: str):
    path = os.path.join(OUT, name)
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)


def main():
    os.makedirs(OUT, exist_ok=True)
    for sig in ACQUIRE:
        write(f"acquire-{sig}.py", TEMPLATE.format(mod="acquire", sig=sig))
    for name, sig in ACQUIRE_ALIASES.items():
        write(f"acquire-{name}.py", TEMPLATE.format(mod="acquire", sig=sig))
    for sig in TRACK:
        write(f"track-{sig}.py", TEMPLATE.format(mod="track", sig=sig))
    for name, sig in TRACK_ALIASES.items():
        write(f"track-{name}.py", TEMPLATE.format(mod="track", sig=sig))
    write("cn0.py", UTIL_TEMPLATE.format(mod="cn0"))
    write("spectrum.py", UTIL_TEMPLATE.format(mod="spectrum"))
    write("squaring.py", UTIL_TEMPLATE.format(mod="squaring"))
    print("wrote", len(os.listdir(OUT)), "scripts to", OUT)


if __name__ == "__main__":
    main()
