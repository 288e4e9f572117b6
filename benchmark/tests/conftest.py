"""Fixtures of the benchmark's CPU tests: a checkout-like root that holds
the benchmark's data files and one small configuration, ``tiny``, with a
cell for each traffic mix (limits copied from the kitti00-loop cells)."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(num_poses=150, num_landmarks=3000)
MIXES = {"solve": "kitti00-loop.solve", "fresh": "kitti00-loop.fresh",
         "solve-fp64": "kitti00-loop.solve-fp64"}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), root / "benchmark" / sub)
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "kitti00-loop.json")))
    cfg["name"] = "tiny"
    cfg["generator"].update(TINY)
    json.dump(cfg, open(root / "benchmark" / "configs" / "tiny.json", "w"))
    bench["configs"].append({"name": "tiny", "source": "kitti00-loop, cut", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "CPU tests"})
    for mix, like in MIXES.items():
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
                                   "chips": 1, "why": "CPU tests"})
        shutil.copy(root / "benchmark" / "limits" / f"{like}.json",
                    root / "benchmark" / "limits" / f"tiny.{mix}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(f"tiny.{mix}")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return str(root)
