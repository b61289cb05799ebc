#!/usr/bin/env python
"""Generate the four standard input configurations locally.

Reproduces the reference's shipped inputs (same params and obstacle
geometries — SURVEY.md §2.1) so the framework runs standalone:

    python examples/generate_inputs.py [outdir]

writes input_{SIZE}.params + obstacles_{SIZE}.dat for
128x128, 128x256, 256x256, 1024x1024.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lbm_tpu.utils.decks import CONFIGS, write_deck  # noqa: E402


def main(outdir: str = ".") -> int:
    os.makedirs(outdir, exist_ok=True)
    for size in CONFIGS:
        write_deck(size, outdir)
        print(f"wrote input_{size}.params + obstacles_{size}.dat")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
