"""CPU tests of the benchmark's harness: its data files, its generator,
its request maker, its work counts, its trace arithmetic, its result line
and its refusals.  The runs here use ``device="cpu"``, where every kernel
of the port runs its plain torch version; no number here is a device
number.

    python -m pytest benchmark/tests -q
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, generator, run, trace, traffic, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- every entry loads --------------------------------------------------------

def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    w = run.find_cell(BENCH, cell)
    cfg = run.load_config(BENCH, w["config"])
    for key in ("source", "generator", "iterations", "huber_deltas", "lm", "assumed",
                "reduced"):
        assert key in cfg, key
    mix = traffic.Mix.load(w["traffic"])
    assert mix.kind in ("solve", "fresh")
    limits = compare.load_limits(cell)
    assert set(limits) == set(compare.NUMBERS)
    e2e = run.cell_metrics(BENCH, cell, False)
    per = run.cell_metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in e2e + per:
        assert callable(run.load_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configs_keep_their_sources_counts(name):
    """A configuration generates its source's poses and points unless
    ``reduced`` names the key, and lists the same ``reduced`` as
    BENCHMARK.json."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = run.load_config(BENCH, name)
    assert cfg["reduced"] == entry["reduced"]
    for key, count in (("num_poses", "poses"), ("num_landmarks", "landmarks")):
        if key not in cfg["reduced"]:
            assert cfg["generator"][key] == cfg["source_counts"][count], key


@pytest.mark.parametrize("suffix,moves", [(".large", "solve_s.large"),
                                           (".device", "solve_device_s")])
def test_large_readers_read_as_their_base(suffix, moves):
    """A ``.large`` (``.device``) metric reads what its base metric reads,
    and moves ``solve_s.large`` (``solve_device_s``) in the cells that
    report it, which do not report ``solve_s``."""
    per = {m["name"]: m for m in BENCH["per_layer"]}
    twins = [n for n in per if n.endswith(suffix)]
    assert twins and all(per[n]["moves"] == moves for n in twins)
    for n in twins:
        base = "idle_pct.solve" if n == "idle_pct.large" else n[:-len(suffix)]
        assert per[base]["moves"] == "solve_s"
        assert set(per[n]["workloads"]).isdisjoint(per[base]["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e["solve_s"]["workloads"]).isdisjoint(e2e[moves]["workloads"])


def test_solve_wall_is_solve_s_per_layer_where_the_device_time_is_end_to_end():
    """Where ``solve_s`` is not end to end, its reading stays as the
    per-layer ``solve_wall_s``, and the cell reports the device's time a
    solve, read from the traced request that a ``--trace 0`` run makes."""
    import types

    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = {m["name"]: m for m in BENCH["per_layer"]}
    cells = set(e2e["solve_device_s"]["workloads"])
    assert cells == set(per["solve_wall_s"]["workloads"])
    assert cells.isdisjoint(e2e["solve_s"]["workloads"])
    assert per["solve_wall_s"]["moves"] == "solve_device_s"
    recs = [{"wall_s": 0.3}, {"wall_s": 0.5}]
    fake = types.SimpleNamespace(mix=types.SimpleNamespace(kind="solve"), records=recs,
                                 traced={})
    assert run.load_reader("solve_wall_s")(fake) == run.load_reader("solve_s")(fake)
    device = run.load_reader("solve_device_s")
    assert device.device_trace and not getattr(run.load_reader("solve_s"), "device_trace",
                                               False)
    assert device(fake) is None  # no trace: nothing to read
    fake.traced["device"] = trace.Traced(wall_s=0.4, device_events=[(0.0, 1e5, "k"),
                                                                    (5e4, 2e5, "k")],
                                         host_events=[])
    assert device(fake) == pytest.approx(0.2)
    fake.mix.kind = "fresh"
    assert device(fake) is None


@pytest.mark.parametrize("reader,kind", [("idle_pct.solve", "solve"),
                                         ("idle_pct.fresh", "fresh"),
                                         ("idle_pct.large", "solve")])
def test_idle_share_is_of_the_unprofiled_wall(reader, kind):
    """The device's busy time in the traced request over the window's mean
    wall, not over the profiled request's own (slower) wall."""
    import types

    t = trace.Traced(wall_s=3.0, device_events=[(0.0, 2e5, "k")], host_events=[])
    fake = types.SimpleNamespace(mix=types.SimpleNamespace(kind=kind), traced={"device": t},
                                 records=[{"wall_s": 0.8}, {"wall_s": 1.2}])
    assert run.load_reader(reader)(fake) == pytest.approx(80.0)
    fake.mix.kind = "fresh" if kind == "solve" else "solve"
    assert run.load_reader(reader)(fake) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_lie_between_their_readings(cell):
    spec = json.load(open(os.path.join(ROOT, "benchmark", "limits", f"{cell}.json")))
    for k in compare.NUMBERS:
        if "lower" in spec[k]:
            lo, up, lim = spec[k]["lower"], spec[k]["upper"], spec[k]["limit"]
            assert lo < lim < up and up >= 3 * lo, (k, lo, lim, up)


def test_traffic_rejects_unknown_kind(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "odd.json").write_text('{"kind": "replay", "dtype": "float32"}')
    with pytest.raises(ValueError):
        traffic.Mix.load("odd", str(tmp_path))


# -- the generator copy -------------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(num_poses=30, num_landmarks=400, seed=0),
    dict(num_poses=200, num_landmarks=3000, mean_obs_per_landmark=5.5, stereo_fraction=0.25,
         seed=7, loop_closure=True),
    dict(num_poses=60, num_landmarks=900, mean_obs_per_landmark=4.65, stereo_fraction=0.25,
         seed=2**32 + 5, init_rot_noise=0.002, init_trans_noise=0.02, init_point_noise=0.04),
])
def test_generator_equals_the_ports_bit_for_bit(params):
    from cuba_tpu_torch.io import synthetic

    a, b = generator.generate(**params), synthetic.generate(**params)
    for field in ("gt_qs", "gt_ts", "gt_Xws", "qs", "ts", "Xws", "cam", "mono_p", "mono_l",
                  "mono_z", "mono_w", "stereo_p", "stereo_l", "stereo_z", "stereo_w",
                  "fixed_poses"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


# -- the fresh request maker --------------------------------------------------

def _fresh(seed, k, fraction=0.01):
    cfg = run.load_config(BENCH, "kitti00-loop")
    cfg = dict(cfg, generator=dict(cfg["generator"], num_poses=150, num_landmarks=3000))
    base = traffic.base_problem(cfg, seed)
    mix = traffic.Mix("fresh", "fresh", "float32", drop_fraction=fraction)
    return base, traffic.fresh_request(base, cfg, mix, seed, k)


@pytest.mark.parametrize("fraction", [0.01, 0.3])
def test_fresh_request_keeps_each_landmarks_last_two(fraction):
    base, req = _fresh(2**31 + 11, 3, fraction)
    E = base.num_edges
    assert req.num_edges == E - int(round(fraction * E))
    before = np.bincount(np.concatenate([base.mono_l, base.stereo_l]), minlength=3000)
    after = np.bincount(np.concatenate([req.mono_l, req.stereo_l]), minlength=3000)
    assert np.all(after >= np.minimum(before, 2))
    # every kept observation is one of the base graph's, unchanged
    keys = set(zip(base.mono_p.tolist(), base.mono_l.tolist(), base.mono_z[:, 0].tolist()))
    assert set(zip(req.mono_p.tolist(), req.mono_l.tolist(), req.mono_z[:, 0].tolist())) <= keys


def test_fresh_requests_repeat_and_differ():
    base, a = _fresh(5, 4)
    _, b = _fresh(5, 4)
    _, c = _fresh(5, 5)
    assert np.array_equal(a.qs, b.qs) and np.array_equal(a.mono_l, b.mono_l)
    assert not np.array_equal(a.qs, c.qs)
    # new initial estimates at the generator's scales; the fixed pose keeps
    # the ground truth
    assert np.array_equal(a.qs[base.fixed_poses], base.gt_qs[base.fixed_poses])
    assert 0.05 < np.std(a.Xws - base.gt_Xws) < 0.2


# -- the work counts of formation_roofline ------------------------------------

def _brute_force(P, pose_ids, lm_ids, fixed):
    slots = sorted({(int(l), int(p)) for p, l in zip(pose_ids, lm_ids) if p not in fixed})
    by_lm = {}
    for l, p in slots:
        by_lm.setdefault(l, []).append(p)
    triplets, blocks = 0, {(p, p) for p in range(P) if p not in fixed}
    for ps in by_lm.values():
        for i in range(len(ps)):
            for j in range(i, len(ps)):
                triplets += 1
                blocks.add((min(ps[i], ps[j]), max(ps[i], ps[j])))
    return work.SchurWork(landmarks=len(by_lm), slots=len(slots), triplets=triplets,
                          blocks=len(blocks))


@pytest.mark.parametrize("seed,loop", [(1, False), (2, True)])
def test_schur_work_against_brute_force(seed, loop):
    prob = generator.generate(num_poses=40, num_landmarks=500, mean_obs_per_landmark=5.5,
                              seed=seed, loop_closure=loop)
    p = np.concatenate([prob.mono_p, prob.stereo_p])
    l = np.concatenate([prob.mono_l, prob.stereo_l])
    # an observation twice over adds no slot
    p2, l2 = np.concatenate([p, p[:7]]), np.concatenate([l, l[:7]])
    got = work.schur_work(40, p2, l2, prob.fixed_poses)
    assert got == _brute_force(40, p2, l2, set(prob.fixed_poses.tolist()))


def test_schur_work_matches_the_ports_triplets():
    from benchmark import program

    prob = generator.generate(num_poses=60, num_landmarks=900, mean_obs_per_landmark=5.5,
                              seed=3, loop_closure=True)
    s = program.structure(prob)
    w = work.schur_work(60, np.concatenate([prob.mono_p, prob.stereo_p]),
                        np.concatenate([prob.mono_l, prob.stereo_l]), prob.fixed_poses)
    assert (w.slots, w.triplets, w.blocks) == (s.n_hpl, s.mul_i.size, s.n_hsc)


def test_roofline_takes_34_tflops_in_fp64_and_67_else():
    w = work.SchurWork(landmarks=0, slots=0, triplets=10**9, blocks=0)  # compute-bound
    assert w.least_seconds("float64") == pytest.approx(216e9 / 34e12)
    assert w.least_seconds("float32") == pytest.approx(216e9 / 67e12)
    m = work.SchurWork(landmarks=10**6, slots=0, triplets=0, blocks=0)  # bandwidth-bound
    assert m.least_seconds("float32") == pytest.approx(4 * 9e6 / 3.35e12)
    assert m.least_seconds("float64") == pytest.approx(8 * 9e6 / 3.35e12)
    assert work.roofline_pct(w, "float32", 0.0) is None
    assert work.roofline_pct(w, "float32", 2 * w.least_seconds("float32")) == pytest.approx(50)


# -- the trace arithmetic -----------------------------------------------------

def test_union_and_idle_gaps():
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    t = trace.Traced(wall_s=1.0, device_events=[(10, 20, "a"), (15, 30, "b"), (50, 60, "a")],
                     host_events=[(0, 100, "bench: optimize"), (32, 48, "aten::bmm"),
                                  (33, 40, "cudaLaunchKernel")])
    assert t.busy_s == pytest.approx(30e-6)
    assert t.top_device_ops() == [("a", pytest.approx(20e-6)), ("b", pytest.approx(15e-6))]
    gaps = dict(t.idle_gaps())
    # 0-10 and 60-100 under the outer range; 30-50's midpoint 40 in both
    # inner events, cudaLaunchKernel innermost
    assert gaps == {"bench: optimize": pytest.approx(50e-6),
                    "cudaLaunchKernel": pytest.approx(20e-6)}


# -- a run's refusals and its result line ---------------------------------------

def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["cuba_tpu", "numpy"]) == ["cuba_tpu"]
    assert run.forbidden_modules(["cuba_tpu.solver.engine"]) == ["cuba_tpu"]
    assert run.forbidden_modules(["cuba_tpu_torch", "cuba_tpu_torch.solver", "jaxtyping",
                                  "flax_like"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                             "jaxlib"]


def test_run_without_a_card_fails_and_prints_no_result():
    assert not torch.cuda.is_available()
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "kitti00-loop.solve", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr


def test_run_fails_outside_a_checkout(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "kitti00-loop.solve", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def _execute(root, cell, seconds=1.0, seed=2**31 + 99):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", "0"])
    return run.execute(args, device="cpu", root=root)


@pytest.mark.parametrize("mix", ["solve", "fresh", "solve-fp64"])
def test_result_line_keys(tiny_root, mix):
    res = _execute(tiny_root, f"tiny.{mix}")
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "checks" and "device" in res
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    want = {m["name"] for m in run.cell_metrics(bench, f"tiny.{mix}", False)}
    want -= {"peak_mem_gib", "solve_device_s"}
    assert set(res["metrics"]) == want  # no peak and no device trace on the host
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(res["checks"]) == set(compare.NUMBERS)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(res)


def test_a_run_imports_neither_jax_nor_cuba_tpu(tiny_root):
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "a = run.parse(['--workload', 'tiny.solve', '--seed', '5', '--seconds', '0.5', "
            "'--trace', '0']); run.execute(a, device='cpu', root=%r); "
            "print(run.forbidden_modules(list(sys.modules)))") % (ROOT, tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
