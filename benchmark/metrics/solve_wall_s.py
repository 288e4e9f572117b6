"""solve_wall_s: ``solve_s`` (``solve_s.py``) in the cells that report
``solve_device_s``, where the host holds the wall back and its runs spread
too widely for an end-to-end bound: the window's solve walls, summed over
their number."""

import os

from benchmark.run import load_reader

BENCHMARK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_reader("solve_s", BENCHMARK_DIR)
