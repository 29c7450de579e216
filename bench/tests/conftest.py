"""The program under test lives in ``src/`` of the checkout, as
``bench.run`` finds it."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
