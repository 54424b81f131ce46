"""The benchmark's own tests (not collected by the repository's tests/):
`python -m pytest benchmarks/tests -q`. Tests marked `cuda` decide inside
the test whether a card is present."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(Path(__file__).resolve().parent), str(BENCH),
                str(BENCH.parent)]
