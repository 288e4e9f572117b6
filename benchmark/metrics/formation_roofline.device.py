"""formation_roofline.device: ``formation_roofline``
(``formation_roofline.py``) in the cells that report ``solve_device_s``, the
warm solve whose wall the host holds back."""

import os

from benchmark.run import load_reader

BENCHMARK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_reader("formation_roofline", BENCHMARK_DIR)
