"""lm_host_ms_per_attempt.device: ``lm_host_ms_per_attempt``
(``lm_host_ms_per_attempt.py``) in the cells that report ``solve_device_s``, the
warm solve whose wall the host holds back."""

import os

from benchmark.run import load_reader

BENCHMARK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_reader("lm_host_ms_per_attempt", BENCHMARK_DIR)
