"""The port's multi-device and parity tools against ``cuba_tpu`` on the CPU.

``bench_multichip_mxu``: a one-rank gloo group in this process, its mesh
trajectory the single-device one's bit for bit on both routes;
``mc_parity``: its single-device side against ``cuba_tpu``'s fp64 engine
(the XLA path) to 1e-6 (its 8-rank spawn runs in ``test_torch_tools.py``);
``parity_kitti00``: ``--phase fp64`` at a small size writes a record whose
trajectories match ``cuba_tpu``'s fp64 engine to 1e-6, ``--phase fp32``
writes a PASS table against it, and the committed ``cuba_tpu`` record is
read, never written.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import robust as tpu_robust
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.solver import rows
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import bench_multichip_mxu, graphs, mc_parity, parity_kitti00

SMALL = dict(num_poses=12, num_landmarks=300)
# the parity table's size: at 12-16 poses the loop closure's graph is so
# small that fp32 LM leaves fp64's trajectory for another (the port by 8e-3
# to 4e-2, cuba_tpu's own XLA engine by 0.11-0.17 at iteration 9); from 24
# poses both fp32 runs stay within ~4e-6 of fp64, as at full size
PARITY = dict(num_poses=24, num_landmarks=600)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tpu_chis(params, iters):
    """cuba_tpu's fp64 XLA engine (``mxu="off"``) on the generator's graph."""
    prob = tpu_synthetic.generate(**params)
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fp = np.zeros(P, bool)
    fp[prob.fixed_poses] = True
    s = tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fp, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    kernels = ((tpu_robust.HUBER, float(np.sqrt(5.991))),
               (tpu_robust.HUBER, float(np.sqrt(7.815))))
    eng = tpu_engine.BlockSolverEngine(s, kernels,
                                       cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off"))
    res = eng.optimize(None, iters)
    return np.asarray(res.chis)[: int(res.niters)], eng.solver


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_rank_mesh_equals_the_single_device_bit_for_bit(dtype, monkeypatch):
    """bench_multichip_mxu's three engines on kitti07 at 12 P / 300 L over a
    one-rank gloo group: the rows route's trajectory is the single-device
    engine's bit for bit, and the AoS body's is the single-device engine's
    on its AoS path (the planner closed) bit for bit."""
    s = graphs.structure_of(synthetic.generate(**dict(graphs.KITTI07, **SMALL)))
    config = BAConfig(dtype=dtype, device="cpu")
    with graphs.one_rank_group("cpu") as group:
        res = bench_multichip_mxu.run(s, graphs.KERNELS, config, group, 4, 1)
    assert (res["mesh S=1 rows"]["path"], res["mesh S=1 aos"]["path"]) == ("v2", "aos")
    assert bench_multichip_mxu.report(res, 4, "cpu")
    with monkeypatch.context() as mp:
        mp.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
        single_aos = BlockSolverEngine(s, graphs.KERNELS, config)
    assert single_aos.path == "aos"
    chis = np.asarray(single_aos.optimize(single_aos.state, 4).chis, np.float64)
    assert np.array_equal(res["mesh S=1 aos"]["chis"], chis)
    assert all(r["wall"] > 0 for r in res.values())


def test_mc_parity_single_side_matches_cuba_tpu_fp64():
    params = dict(graphs.KITTI07, **SMALL)
    s = graphs.structure_of(synthetic.generate(**params))
    chis, wall = mc_parity.single(s, torch.float64, "cpu")
    want, _solver = _tpu_chis(params, mc_parity.ITERS)
    assert wall > 0 and len(chis) == len(want) == mc_parity.ITERS
    np.testing.assert_allclose(chis, want, rtol=1e-6)
    assert mc_parity.max_rel(chis, want) < mc_parity.RTOL
    assert mc_parity.max_rel(chis[:-1], want) == float("inf")


def test_parity_kitti00_record_and_table(tmp_path, monkeypatch, capsys):
    """--phase fp64 at 24 P / 600 L: each shape's record within 1e-6 of
    cuba_tpu's fp64 engine a step, keyed by shape, size and device;
    --phase fp32: a PASS table against the record and cuba_tpu's (a
    record of the same runs standing in for the committed one, which
    holds only the full sizes); the committed record untouched."""
    record, tpu_record = tmp_path / "record.json", tmp_path / "tpu.json"
    committed = parity_kitti00.TPU_RECORD
    before = (os.stat(committed).st_mtime_ns, open(committed, "rb").read())
    monkeypatch.setattr(parity_kitti00, "RECORD", str(record))
    monkeypatch.setattr(parity_kitti00, "OUT", str(tmp_path / "PARITY.md"))
    size = ["--poses", "24", "--landmarks", "600", "--device", "cpu"]
    assert parity_kitti00.main(["--phase", "fp64"] + size) == 0
    assert 'CHI2_FP64_FINAL' in capsys.readouterr().out
    rec = json.loads(record.read_text())
    tpu = {}
    for shape, graph in parity_kitti00.SHAPES.items():
        params = dict(graphs.GRAPHS[graph], **PARITY)
        key = parity_kitti00.key_of(shape, params)
        assert key == f"{shape} (24 P / 600 L)" and set(rec[key]) == {"cpu"}
        want, solver = _tpu_chis(params, parity_kitti00.NITERS)
        got = rec[key]["cpu"]
        assert got["solver"] == solver and len(got["chis"]) == len(want) == 10
        np.testing.assert_allclose(got["chis"], want, rtol=1e-6)
        tpu[key] = dict(chis=want.tolist(), solver=solver, backend="cpu", date="test")
    tpu_record.write_text(json.dumps(tpu))
    monkeypatch.setattr(parity_kitti00, "TPU_RECORD", str(tpu_record))
    assert parity_kitti00.main(["--phase", "fp32"] + size) == 0
    text = (tmp_path / "PARITY.md").read_text()
    assert text.startswith(parity_kitti00.TITLE) and "**Overall: PASS**" in text
    assert text.count("— PASS") == 3 and "cuba_tpu fp64" in text
    assert (os.stat(committed).st_mtime_ns, open(committed, "rb").read()) == before


def test_parity_kitti00_needs_a_record(tmp_path, monkeypatch):
    """--phase fp32 without the shape's host fp64 record exits 2 and writes
    no table."""
    monkeypatch.setattr(parity_kitti00, "RECORD", str(tmp_path / "none.json"))
    monkeypatch.setattr(parity_kitti00, "OUT", str(tmp_path / "PARITY.md"))
    assert parity_kitti00.main(["--phase", "fp32", "--shapes", "kitti07_scale", "--poses", "12",
                                "--landmarks", "300", "--device", "cpu"]) == 2
    assert not (tmp_path / "PARITY.md").exists()


def test_parity_kitti00_gate():
    """compare: every reference as long as the run, at least 5 iterations,
    each within GATE."""
    chis = np.linspace(100.0, 50.0, 10)
    rels, ok = parity_kitti00.compare(chis, {"a": chis * (1 + 4e-3), "b": chis})
    assert ok and rels["a"].max() < 4e-3 and rels["b"].max() == 0
    assert not parity_kitti00.compare(chis, {"a": chis * (1 + 6e-3)})[1]
    assert not parity_kitti00.compare(chis, {"a": chis[:9]})[1]
