"""idle_pct.large: ``idle_pct.solve`` (``idle_pct.solve.py``) in the cells that
report ``solve_s.large``, the warm solve of a BAL-scale problem, where the
device holds the wall and the runs spread far less than at kitti00 scale."""

import os

from benchmark.run import load_reader

BENCHMARK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_reader("idle_pct.solve", BENCHMARK_DIR)
