"""The harness's tests: ``python -m pytest perfbench/tests`` from the root
of the checkout (the card's tests carry the ``gpu`` marker and skip without
a CUDA device)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
