"""``cuba_tpu``'s own fp64 trajectories of the port's three full-width graphs
that no kitti record covers, and the tests that hold the port to them.

The record, ``docs/_parity_torch_cuba_fp64.json``, holds for each entry
``cuba_tpu``'s fp64 ``optimize(10)`` chi² per iteration (JAX x64 on the
CPU, the XLA path, ``mxu="off"``), its ``nedges``, ``solver`` and
``band_m``, the date, the host, the wall and the graph's parameters:

- ``stress_1m``: ``graphs.STRESS`` (1778 P, 1,000,000 L, ~5 observations
  each, 25% stereo, seed 0), the Huber kernels, ``solver="auto"``;
- ``ladybug49_bal``: ``data/bal_ladybug_scale.txt.gz`` through
  ``read_bal`` with no robust kernel and the ``BAConfig`` defaults apart
  from the dtype, with the file's sha256;
- ``pcg4096``: ``graphs.PCG4096`` (``bench_pcg_crossover``'s generator at
  4096 P / 61,440 L, gentle noise), the Huber kernels, ``solver="pcg"``.

Writing it runs ``cuba_tpu`` at full width, minutes of host time and ~14 GB
at stress-1m, so it runs only on request:

    JAX_PLATFORMS=cpu python tests/test_torch_records.py --write [--entries ...]

(or ``pytest -m slow tests/test_torch_records.py``, which rewrites it).
``chip_smoke.py`` reads the record as a data file; the port's own fp64
host trajectories beside it are ``cuba_tpu_torch/tools/parity_records.py``'s.

The tier-1 tests never write it: they hold each entry's provenance to what
the port builds from the same parameters and file, the port's committed
fp64 trajectories to it, and both packages to each other live, on the
Ladybug file and on the stress and pcg generators at reduced shapes.
"""

import argparse
import json
import os
import platform
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cuba_tpu_torch.tools import graphs, parity_records  # noqa: E402

RECORD = parity_records.CUBA_RECORD
NITERS = parity_records.NITERS
# a step's relative difference that counts as agreement between two fp64 runs
RTOL = parity_records.RTOL
# the reduced shapes of the live tests: the stress and pcg generators with
# fewer landmarks (and poses)
STRESS_SMALL = dict(graphs.STRESS, num_landmarks=20_000)
PCG_SMALL = dict(graphs.PCG4096, num_poses=1024, num_landmarks=15_360)
SMALL_ITERS = 3


# --- cuba_tpu's side ----------------------------------------------------------

def _tpu_config(solver):
    import jax.numpy as jnp

    import cuba_tpu

    return cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver=solver)


def tpu_synthetic_run(params, solver, iters=NITERS):
    """``cuba_tpu``'s fp64 XLA engine on the generator's graph with the
    Huber kernels: {chis, nedges, solver, band_m, wall}."""
    from cuba_tpu.io import synthetic
    from cuba_tpu.ops import robust
    from cuba_tpu.solver.engine import BlockSolverEngine
    from cuba_tpu.solver.structure import build_structure_from_arrays

    t0 = time.perf_counter()
    prob = synthetic.generate(**params)
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fixed_p = np.zeros(P, bool)
    fixed_p[prob.fixed_poses] = True
    s = build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fixed_p, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    nedges = int(prob.mono_p.size + prob.stereo_p.size)
    del prob
    kernels = ((robust.HUBER, graphs.MONO_DELTA), (robust.HUBER, graphs.STEREO_DELTA))
    eng = BlockSolverEngine(s, kernels, _tpu_config(solver))
    r = eng.optimize(None, iters)
    chis = np.asarray(r.chis, np.float64)[: int(r.niters)]
    return dict(chis=chis, nedges=nedges, solver=eng.solver, band_m=parity_records.band_m_of(eng),
                wall=time.perf_counter() - t0)


def tpu_bal_run(path, iters=NITERS):
    """``cuba_tpu``'s fp64 public API on a BAL file, read with no robust
    kernel and the ``BAConfig`` defaults apart from the dtype."""
    from cuba_tpu.io import bal

    t0 = time.perf_counter()
    ba = bal.read_bal(path, _tpu_config("auto"))
    ba.initialize()
    ba.optimize(iters)
    chis = np.array([s.chi2 for s in ba.batch_statistics()], np.float64)
    return dict(chis=chis, nedges=int(ba.nedges()), solver=ba._engine.solver,
                band_m=parity_records.band_m_of(ba._engine), wall=time.perf_counter() - t0)


def tpu_run(name):
    spec = parity_records.ENTRIES[name]
    if spec["kind"] == "bal":
        return tpu_bal_run(parity_records.bal_path(spec))
    return tpu_synthetic_run(spec["params"], spec["solver"])


def host() -> str:
    return f"{platform.machine()} CPU, {os.cpu_count()} cores, {platform.system()}"


def write(names) -> None:
    """Run ``cuba_tpu`` on each named entry and write its record into RECORD
    (other entries kept)."""
    import jax

    for name in names:
        spec = parity_records.ENTRIES[name]
        r = tpu_run(name)
        entry = dict(chis=[float(c) for c in r["chis"]], nedges=r["nedges"],
                     solver=r["solver"], band_m=r["band_m"], niters=NITERS,
                     params=parity_records.params_of(spec), date=time.strftime("%Y-%m-%d"),
                     host=host(), backend=jax.default_backend(),
                     jax=jax.__version__, wall_s=round(r["wall"], 1))
        if spec["kind"] == "bal":
            entry["sha256"] = parity_records.sha256(parity_records.bal_path(spec))
        parity_records.write_record(RECORD, entry, name)
        print(f"# {name}: {len(r['chis'])} iterations, {r['solver']}, nedges {r['nedges']}, "
              f"final chi2 {float(r['chis'][-1])!r}, {r['wall']:.1f} s", flush=True)


# --- the tier-1 tests ------------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_nedges(name):
    """The edges of the entry's graph as the port builds it."""
    spec = parity_records.ENTRIES[name]
    if spec["kind"] == "bal":
        from cuba_tpu_torch import BAConfig
        from cuba_tpu_torch.io import bal

        return bal.read_bal(parity_records.bal_path(spec), BAConfig(device="cpu")).nedges()
    from cuba_tpu_torch.io import synthetic

    prob = synthetic.generate(**spec["params"])
    return int(prob.mono_p.size + prob.stereo_p.size)


EXPECTED = {  # each record's solver, CR blocks and edges
    "stress_1m": ("band_cr", 28, 3_885_457),
    "ladybug49_bal": ("dense_cholesky", None, 31_818),
    "pcg4096": ("pcg", None, 238_292),
}


@pytest.mark.parametrize("name", sorted(parity_records.ENTRIES))
def test_record_provenance(name):
    """Each record was made from the graph the port builds today: its
    parameters are the port's (``graphs.STRESS``, ``graphs.PCG4096``, the
    BAL file and its reading), its edges the port's generator's or
    reader's, the BAL file's sha256 the committed file's, and it holds
    NITERS falling iterations."""
    rec = parity_records.load(RECORD)[name]
    spec = parity_records.ENTRIES[name]
    assert rec["params"] == parity_records.params_of(spec)
    if spec["kind"] == "synthetic":
        want = {"stress_1m": graphs.STRESS, "pcg4096": graphs.PCG4096}[name]
        assert {k: rec["params"][k] for k in want} == want
    else:
        assert rec["sha256"] == parity_records.sha256(parity_records.bal_path(spec))
    assert (rec["solver"], rec["band_m"], rec["nedges"]) == EXPECTED[name]
    assert rec["nedges"] == _port_nedges(name)
    chis = parity_records.reference(name, rec["nedges"])
    assert len(chis) == NITERS and np.all(np.diff(chis) <= 0)


def test_record_refuses_another_graph(tmp_path):
    """``parity_records.reference`` (the smoke's gate) refuses a record of
    other edges, other parameters or other file bytes, and a missing one."""
    record = parity_records.load(RECORD)
    nedges = record["ladybug49_bal"]["nedges"]
    with pytest.raises(ValueError, match="edges"):
        parity_records.reference("ladybug49_bal", nedges + 1)
    for name, key, value in (("pcg4096", "params", dict(graphs.PCG4096, seed=1)),
                             ("ladybug49_bal", "sha256", "0" * 64)):
        changed = json.loads(json.dumps(record))
        changed[name][key] = value
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(changed))
        with pytest.raises(ValueError, match=key if key == "sha256" else "parameters"):
            parity_records.reference(name, record[name]["nedges"], str(path))
    with pytest.raises(ValueError, match="holds no"):
        parity_records.reference("stress_1m", 3_885_457, str(tmp_path / "none.json"))


@pytest.mark.parametrize("name", sorted(parity_records.ENTRIES))
def test_committed_port_trajectories_agree(name):
    """The port's committed fp64 host trajectory (``parity_records --phase
    fp64 --device cpu``) of each entry: the same edges and solver as
    ``cuba_tpu``'s record, and within RTOL of it at every iteration."""
    port = parity_records.load(parity_records.RECORD)[name]["cpu"]
    cuba = parity_records.load(RECORD)[name]
    assert (port["nedges"], port["solver"], port["band_m"]) == (
        cuba["nedges"], cuba["solver"], cuba["band_m"])
    ref = parity_records.reference(name, port["nedges"])
    assert len(port["chis"]) == len(ref)
    assert np.all(parity_records.rel_diff(port["chis"], ref) < RTOL)


def test_compare_writes_the_parity_table(tmp_path, monkeypatch, capsys):
    """``parity_records --phase compare`` on the committed records: every
    entry PASS, exit 0."""
    monkeypatch.setattr(parity_records, "OUT", str(tmp_path / "p.md"))
    assert parity_records.main(["--phase", "compare"]) == 0
    text = (tmp_path / "p.md").read_text()
    assert text.count("— PASS") == len(parity_records.ENTRIES) and "**Overall: PASS**" in text


def test_smoke_gate_holds_a_run_to_the_record(capsys):
    """``chip_smoke.record_gate``, the one gate of every fp64 record, through
    ``cuba_record`` (phases 3, 15, 16 and 18: ``cuba_tpu``'s record of the
    entry, its first ``iters`` iterations) and ``fp64_records`` (the kitti
    records): a trajectory as long as the record and within the tolerance
    at every iteration (with ``final_only`` at its last) passes and logs
    its differences; one outside it, of another length, or of a graph with
    other edges ends the run."""
    import chip_smoke

    ref = parity_records.reference("stress_1m", 3_885_457)
    chip_smoke.cuba_record(ref * (1 + 4e-3), "stress_1m", 3_885_457, "fp32", 5e-3)
    chip_smoke.cuba_record(ref[:3] * (1 - 5e-7), "stress_1m", 3_885_457, "fp64", 1e-6, iters=3)
    bent = ref.copy()
    bent[:-1] *= 1.1
    chip_smoke.cuba_record(bent, "stress_1m", 3_885_457, "final", 5e-3, final_only=True)
    kitti = np.array(chip_smoke.CHI2_FP64_TRAJECTORY["kitti07_scale"])
    chip_smoke.fp64_records(kitti * (1 + 5e-7), "kitti07_scale", "kitti07")
    chip_smoke.fp64_records(kitti * 1.1, "kitti07_scale", "logged", gate=False)
    out = capsys.readouterr().out
    assert "fp32 vs cuba_tpu's fp64 record 'stress_1m': chi2 per iteration" in out
    assert "kitti07 vs the fp64 record of kitti07_scale: chi2 per iteration" in out
    for chis, nedges, kw in ((bent, 3_885_457, {}), (ref[:3], 3_885_457, {}),
                             (ref[:3], 3_885_457, dict(final_only=True, iters=10)),
                             (ref[:4], 3_885_457, dict(iters=3)), (ref, 3_885_456, {})):
        with pytest.raises(SystemExit):
            chip_smoke.cuba_record(chis, "stress_1m", nedges, "bad", 5e-3, **kw)
    for chis in (kitti * (1 + 2e-6), kitti[:9]):
        with pytest.raises(SystemExit):
            chip_smoke.fp64_records(chis, "kitti07_scale", "bad")


def _assert_agree(got, want, ref=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert len(got) == len(want) and got[-1] < got[0]
    assert np.all(parity_records.rel_diff(got, want) < RTOL)
    if ref is not None:
        assert np.all(parity_records.rel_diff(got, ref) < RTOL)


def test_live_bal_both_packages():
    """Both packages' fp64 optimize(10) on the Ladybug file, read as the
    record reads it: within RTOL of each other and of the record at every
    iteration, on the same solver."""
    r = parity_records.run("ladybug49_bal", torch.float64, "cpu")
    t = tpu_run("ladybug49_bal")
    assert (r["solver"], r["nedges"]) == (t["solver"], t["nedges"]) == ("dense_cholesky", 31_818)
    _assert_agree(r["chis"], t["chis"], parity_records.reference("ladybug49_bal", r["nedges"]))


@pytest.mark.parametrize("name", ["stress", "pcg"])
def test_live_reduced_shapes_both_packages(name):
    """The stress generator at 1778 P / 20,000 L (``solver="auto"``) and the
    pcg4096 generator at 1024 P / 15,360 L (``solver="pcg"``), fp64 on the
    CPU: the port's engine and ``cuba_tpu``'s XLA engine within RTOL at
    every one of SMALL_ITERS iterations, on the same solver."""
    from cuba_tpu_torch.config import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.solver.engine import BlockSolverEngine

    params, solver = (STRESS_SMALL, "auto") if name == "stress" else (PCG_SMALL, "pcg")
    eng = BlockSolverEngine(graphs.structure_of(synthetic.generate(**params)), graphs.KERNELS,
                            BAConfig(dtype=torch.float64, device="cpu", solver=solver))
    got = eng.optimize(eng.state, SMALL_ITERS).chis
    t = tpu_synthetic_run(params, solver, SMALL_ITERS)
    assert eng.solver == t["solver"] and parity_records.band_m_of(eng) == t["band_m"]
    _assert_agree(got, t["chis"])


@pytest.mark.slow
def test_write_records():
    """Rewrites the record (the slow lane only)."""
    write(list(parity_records.ENTRIES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true", required=True)
    ap.add_argument("--entries", nargs="*", default=list(parity_records.ENTRIES),
                    choices=list(parity_records.ENTRIES))
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write(args.entries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
