"""The benchmark's own tests: run them from the checkout's root with
``python -m pytest perfbench/tests`` (the ``cuda`` ones on the card with
``-m cuda``)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent), str(HERE.parents[1] / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
