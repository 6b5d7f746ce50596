"""The benchmark's own tests: its files, its arithmetic and its drivers at a
tiny size on the CPU.  Run from the root of the repository:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
