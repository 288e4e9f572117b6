"""CPU tests of what decides ``correct``: the plain reference agrees with
the port where both are right, its control (the reference one precision
lower) fails the cells' limits, and a run whose program is broken
underneath comes out not correct, once for each fault a BA cell can have.

    python -m pytest benchmark/tests -q
"""

import json
import os

import pytest
import torch

from benchmark import compare, generator, program, reference, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CFG = run.load_config(BENCH, "kitti00-loop")
SMALL = dict(CFG["generator"], num_poses=150, num_landmarks=3000)


def _problem(seed):
    return generator.generate(seed=seed, **SMALL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_agrees_with_the_port(dtype):
    prob = _problem(11)
    s = program.structure(prob)
    eng = program.engine(s, CFG["huber_deltas"], program.make_config(CFG, dtype, "cpu"))
    res, host = program.solve(eng, CFG["iterations"])
    judge = compare.Judge(prob, CFG, "cpu")
    nums = judge.answer_numbers(res.chis, *program.caller_order(s, host, prob.fixed_poses))
    limits = compare.load_limits("kitti00-loop.solve" if dtype == "float32"
                                 else "kitti00-loop.solve-fp64")
    assert compare.verdict(nums, limits), nums
    if dtype == "float64":
        assert nums["chi2_gap"] < 1e-12 and nums["pose_gap_m"] < 1e-9


@pytest.mark.parametrize("cell,tf32", [("kitti00-loop.solve", True),
                                       ("kitti00-loop.fresh", True),
                                       ("stress-1m.solve", True),
                                       ("kitti00-loop.solve-fp64", False)])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_fails(cell, tf32, seed):
    """The reference in fp32 with TF32 products (fp32 alone for the fp64
    cell), in the program's place, is not correct under the cell's limits,
    on a small graph of the cell's own configuration."""
    cfg = run.load_config(BENCH, run.find_cell(BENCH, cell)["config"])
    prob = generator.generate(seed=seed, **dict(cfg["generator"], num_poses=150,
                                                num_landmarks=3000))
    judge = compare.Judge(prob, cfg, "cpu")
    ctl = compare.reference_of(prob, cfg, "cpu", dtype=torch.float32, tf32=tf32)
    chis, (R, t, X) = ctl.optimize(cfg["iterations"])
    nums = judge.numbers(chis, R.double(), t.double(), X.double())
    assert not compare.verdict(nums, compare.load_limits(cell)), nums


def test_control_readings_fail_without_a_card(capsys):
    """The control's readings are taken on the card only."""
    from benchmark import control

    assert not torch.cuda.is_available()
    assert control.main(["--workload", "kitti00-loop.solve", "--seeds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "cuda" in out.err


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 1.0 + 3 * 2**-12],
                     dtype=torch.float32)
    assert reference.round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0,
                                                1.0 + 2**-10]


# -- faults planted in the program, under a whole run -----------------------------

def _run(tiny_root, cell="tiny.solve"):
    args = run.parse(["--workload", cell, "--seed", "77", "--seconds", "0.5", "--trace", "0"])
    return run.execute(args, device="cpu", root=tiny_root)


def _half_the_observations(build):
    """Every second observation left out and the rest weighted double: the
    same total information, over half the data."""
    def wrapped(qs, ts, cams, Xws, fp, fl, mp, ml, mz, mw, sp, sl, sz, sw):
        return build(qs, ts, cams, Xws, fp, fl, mp[::2], ml[::2], mz[::2], 2 * mw[::2],
                     sp[::2], sl[::2], sz[::2], 2 * sw[::2])
    return wrapped


def _altered_answer(optimize):
    """The first pose's translation moved by a metre where the loop
    returns it."""
    def wrapped(self, state, n, marks=None):
        res = optimize(self, state, n, marks)
        ts = res.state.ts.clone()
        ts[0, 0] += 1.0
        return res._replace(state=res.state._replace(ts=ts))
    return wrapped


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_observations",
                                   "answer_altered", "none"])
@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.fresh"])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, fault, cell):
    from cuba_tpu_torch.solver import engine

    if fault == "state_unchanged":
        monkeypatch.setattr(engine.BlockSolverEngine, "_apply_update",
                            lambda self, state, xp, xl: state)
    elif fault == "half_the_observations":
        monkeypatch.setattr(program, "build_structure_from_arrays",
                            _half_the_observations(program.build_structure_from_arrays))
    elif fault == "answer_altered":
        monkeypatch.setattr(engine.BlockSolverEngine, "optimize",
                            _altered_answer(engine.BlockSolverEngine.optimize))
    res = _run(tiny_root, cell)
    assert res["correct"] is (fault == "none"), res["checks"]
