"""read_wait_ms_per_attempt.large: ``read_wait_ms_per_attempt``
(``read_wait_ms_per_attempt.py``) in the cells that report ``solve_s.large``, the warm
solve of a BAL-scale problem, where the device holds the wall."""

import os

from benchmark.run import load_reader

BENCHMARK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_reader("read_wait_ms_per_attempt", BENCHMARK_DIR)
