"""fp64 on the card, as far as the CPU can show it.

``csrc/segmm.cu`` builds each of its six kernels for float32 and float64:
every ``extern "C"`` entry ``cuba_<name>`` has a twin ``cuba_<name>_f64``
with the same parameters, ``double*`` for ``float*``.  These tests read the
source (no nvcc here), hold the Python launch arithmetic and the dispatch
rules to it, and run the fp64 engine on the host on every route with each
``segmm`` wrapper watched: every float tensor that reaches one is float64,
so that on the card each call takes the fp64 kernel and none rounds to
fp32.  The kernels themselves run in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` (phase 16).
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import cudalib, segmm, walks
from cuba_tpu_torch.solver import rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMM_CU = os.path.join(ROOT, "cuba_tpu_torch", "csrc", "segmm.cu")
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
WRAPPERS = ("gather", "segsum", "schur_fused", "compact_to_band", "compact_to_dense",
            "band_transpose")


def _entries():
    """{name: parameter list} of segmm.cu's extern "C" entry points."""
    src = open(SEGMM_CU).read()
    block = src[src.index('extern "C" {'):]
    found = re.findall(r"^int (cuba_\w+)\(([^)]*)\)", block, flags=re.M)
    return {name: " ".join(params.split()) for name, params in found}


def test_every_entry_has_an_fp64_twin():
    entries = _entries()
    fp32 = [n for n in entries if not n.endswith("_f64")]
    assert sorted(fp32) == sorted(n for n in segmm._SIGNATURES if not n.endswith("_f64"))
    assert len(entries) == 2 * len(fp32) == 14
    for name in fp32:
        twin = cudalib.symbol(name, torch.float64)
        assert twin == name + "_f64" and twin in entries
        assert entries[twin] == entries[name].replace("float*", "double*")
        assert segmm._SIGNATURES[twin] == segmm._SIGNATURES[name]
        assert cudalib.symbol(name, torch.float32) == name


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32])
def test_symbol_refuses_a_dtype_without_a_build(dtype):
    with pytest.raises(TypeError):
        cudalib.symbol("cuba_gather_cols", dtype)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _slot(src, ctype):
    body = re.search(rf"struct ScTraits<{ctype}> \{{(.*?)\}};", src, flags=re.S).group(1)
    return int(re.search(r"kSlot = (\d+);", body).group(1))


@pytest.mark.parametrize("kwin", [128, 256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_fused_launch_is_the_kernels_shared_memory(dtype, kwin):
    """``schur_fused_launch(plan, dtype)`` is ``schur_smem_bytes<T>`` of
    segmm.cu, from its own constants: the two windows of 512 slots of
    kSlot values (20 floats, 18 doubles), the ints padded to 4, the
    [36, kScPass + 4] tile; within the 232,448 bytes a block may have at
    every kwin the planner gives (chunk 1024).  fp32 leaves room for two
    blocks an SM at kitti00's kwin 256, fp64 for one (its build's bound)."""
    src = open(SEGMM_CU).read()
    win, npass = _constant(src, "kScWin"), _constant(src, "kScPass")
    assert "kScTileStride = kScPass + 4;" in src
    ctype, size = {torch.float32: ("float", 4), torch.float64: ("double", 8)}[dtype]
    slot = _slot(src, ctype)
    assert slot * size % 16 == 0 and slot >= 18  # whole 16-byte loads of 18 values
    chunk = segmm.SC_GEOMETRY[0]
    plan = segmm.SchurPlan(chunk, 256, kwin, 5, *([None] * 5), 0, 0, True)
    ints = (chunk + 2 * kwin + 1 + 3) // 4 * 4
    smem = size * (2 * win * slot + 36 * (npass + 4)) + 4 * ints
    assert segmm.schur_fused_launch(plan, dtype) == dict(grid=[5], threads=256, smem=smem)
    assert smem <= 232448
    blocks = re.search(rf"struct ScTraits<{ctype}> \{{.*?kBlocks = (\d+);", src,
                       flags=re.S).group(1)
    if kwin == 256:
        assert int(blocks) * smem <= 228 * 1024  # the SM's shared memory, less 1 KB a block
    if dtype == torch.float64:
        assert int(blocks) == 1 and 2 * smem > 228 * 1024


def test_fp64_staging_places_every_double_once():
    """The fp64 windows' staging (two batches of 18 double2 loads a
    thread): every double of the two [18, 512] windows is loaded once and
    lands once in its slot-major element, and a half-warp's 8-byte stores
    put at most two threads on one bank pair."""
    r, q, words = walks.schur_stage_walk(torch.float64)
    assert r.shape == (2 * 18, 256)  # two batches of 18 loads a thread
    assert len(set(zip(r.ravel().tolist(), q.ravel().tolist()))) == r.size == 36 * 256
    assert np.unique(words).size == words.size == 2 * 18 * 512
    win = 512 * segmm.SCHUR_SLOT_F64
    slot, val = words % win // segmm.SCHUR_SLOT_F64, words % segmm.SCHUR_SLOT_F64
    np.testing.assert_array_equal(slot, 2 * q[..., None] + np.arange(2))
    np.testing.assert_array_equal(val, np.broadcast_to((r % 18)[..., None], val.shape))
    pairs = words.reshape(36, 16, 16, 2) % 16
    for c in range(2):
        assert max(np.bincount(b, minlength=16).max() for b in pairs[..., c].reshape(-1, 16)) <= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_check_takes_either_float_dtype(dtype):
    a = torch.zeros((3, 4), dtype=dtype)
    b = torch.zeros((3, 4), dtype=dtype)
    dt = cudalib.float_dtype(a, b)
    assert dt == dtype
    cudalib.check(a, "a", dt, 2)
    cudalib.check(b, "b", dt, 2)


@pytest.mark.parametrize("dtypes", [(torch.float16,), (torch.bfloat16,), (torch.int32,),
                                    (torch.float32, torch.float64),
                                    (torch.float64, torch.float32)])
def test_check_refuses_other_and_mixed_dtypes(dtypes):
    ts = [torch.zeros(4, dtype=d) for d in dtypes]
    with pytest.raises(TypeError):
        cudalib.float_dtype(*ts)
    with pytest.raises(TypeError):
        cudalib.check(ts[0], "x", torch.float64 if dtypes[0] != torch.float64 else
                      torch.float32, 1)


def test_fp64_launch_counts():
    cudalib.reset_launches()
    cudalib.count("schur_fused", torch.float32)
    cudalib.count("schur_fused", torch.float64)
    cudalib.count("segsum", torch.float64)
    assert cudalib.LAUNCHES["schur_fused"] == 2 and cudalib.LAUNCHES_F64["schur_fused"] == 1
    assert cudalib.LAUNCHES["segsum"] == cudalib.LAUNCHES_F64["segsum"] == 1
    assert set(cudalib.LAUNCHES_F64) == set(cudalib.LAUNCHES)
    cudalib.reset_launches()
    assert not any(cudalib.LAUNCHES.values()) and not any(cudalib.LAUNCHES_F64.values())


def test_fp64_on_the_default_device_needs_the_card(monkeypatch):
    """The card is the default in fp64 too: without CUDA, initialize()
    raises the RuntimeError that names device="cpu" (no dtype gate is
    left)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = synthetic.generate(num_poses=10, num_landmarks=90, seed=7)
    ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float64))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ba.initialize()


def test_segsum_walk_in_fp64_is_an_fp64_sum():
    """The segment sum's walk keeps fp64 values in fp64 (the kernel's fp64
    build adds in fp64): within 1e-13 of each output's sum of |terms| of
    the plain version, and a G = 1 walk is the sequential fp64 sum."""
    rng = np.random.default_rng(0)
    ids = rng.integers(-2, 60, 3000).astype(np.int32)
    vals = rng.standard_normal((3, ids.size))
    csr = segmm.segment_csr(ids, 50, "cpu")
    got = walks.segsum_walk(vals, csr)
    assert got.dtype == np.float64
    vt, it = torch.from_numpy(vals), torch.from_numpy(ids)
    want = segmm.segsum_plain(vt, it, 50).numpy()
    bound = segmm.segsum_plain(vt.abs(), it, 50).numpy()
    assert np.all(np.abs(got - want) <= 1e-13 * bound)
    one = walks.segsum_walk(vals, csr, group=1)
    order, offs = csr.order.numpy(), csr.offs.numpy()
    for s in (0, 17, 49):
        acc = np.zeros(3)
        for j in order[offs[s]:offs[s + 1]]:
            acc = acc + vals[:, j]
        np.testing.assert_array_equal(one[:, s], acc)


def test_phase16_records_are_the_repos():
    """chip_smoke's fp64 trajectories are docs/_parity_kitti00_fp64.json's,
    and their last values are CHI2_FP64_FINAL's."""
    with open(os.path.join(ROOT, "docs", "_parity_kitti00_fp64.json")) as f:
        recs = json.load(f)
    assert set(chip_smoke.CHI2_FP64_TRAJECTORY) == set(recs)
    for graph, rec in recs.items():
        assert list(chip_smoke.CHI2_FP64_TRAJECTORY[graph]) == rec["chis"]
        assert round(rec["chis"][-1], 2) == chip_smoke.CHI2_FP64_FINAL[(graph, 10)]


def _watch_wrappers(monkeypatch):
    """Record the float dtypes of every call to the six segmm wrappers."""
    seen = {}
    for name in WRAPPERS:
        fn = getattr(segmm, name)

        def watched(*args, _fn=fn, _name=name, **kw):
            floats = {a.dtype for a in list(args) + list(kw.values())
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            seen.setdefault(_name, set()).update(floats)
            return _fn(*args, **kw)

        monkeypatch.setattr(segmm, name, watched)
    return seen


def _fp64_run(prob, solver, niters=2, edit=None):
    ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float64, solver=solver, device="cpu"))
    if edit is not None:
        edit(ba)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)
    ba.initialize()
    ba.optimize(niters)
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    assert np.all(np.isfinite(chis)) and chis[-1] < chis[0]
    return ba


_ROUTES = {
    # route: (graph, solver, the wrappers it must reach)
    "v2-band": (dict(num_poses=150, num_landmarks=1400, seed=2), "band_cr",
                {"gather", "segsum", "schur_fused", "compact_to_band"}),
    "v2-dense": (dict(num_poses=10, num_landmarks=90, seed=7), "dense_cholesky",
                 {"segsum", "schur_fused", "compact_to_dense"}),
    "v1": (dict(num_poses=150, num_landmarks=1400, seed=2), "band_cr",
           {"schur_fused", "segsum", "band_transpose"}),
    "rows-pcg": (dict(num_poses=40, num_landmarks=600, seed=4), "pcg",
                 {"gather", "segsum"}),
    "aos": (dict(num_poses=40, num_landmarks=600, seed=4), "band_lr", {"segsum"}),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_fp64_engine_hands_every_wrapper_fp64(monkeypatch, route):
    """The fp64 engine on each route the card takes: every float tensor
    that reaches a segmm wrapper is float64 (on the card each such call
    launches the fp64 kernel; a float32 tensor made without a dtype would
    launch the fp32 one or, beside fp64 inputs, raise)."""
    graph, solver, want = _ROUTES[route]
    if route == "v1":
        monkeypatch.setattr(rows, "_WG_MAX", 0)
    if route == "aos":
        monkeypatch.setattr(rows, "plan_row_tables",
                            lambda s, pad_blocks=0, lr=None: (None, None))
    seen = _watch_wrappers(monkeypatch)
    ba = _fp64_run(synthetic.generate(**graph), solver)
    assert ba._engine.path == route.split("-")[0]
    assert want <= set(seen), sorted(seen)
    assert all(d == {torch.float64} for d in seen.values()), seen
