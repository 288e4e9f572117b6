#!/usr/bin/env python3
"""Drive cuba_tpu_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc builds of ``cuba_tpu_torch/csrc/segmm.cu``,
   ``csrc/trisolve.cu``, ``csrc/edgeterms.cu`` and ``csrc/factors.cu`` (one
   nvcc each, in parallel, timed) and which symbolic pass (C++ or NumPy)
   the host runs.
2. Kernels against their plain torch versions, on the slice's own plan and
   tensors (the problem below after ``initialize()``): gathers must be equal
   bit for bit, segment sums within 1e-5 of each output's sum of |vals|,
   and a second launch of every kernel equal bit for bit to the first.
   The kernel, its plain version and its library call are timed in turns
   in one loop of 25 rounds under ``torch.profiler``, each call right after
   an untimed run of itself (warm: it reads its inputs as far as the L2
   holds them, whatever the order of the calls): the median CUDA-event
   time of each call (``ms``: the wrapper's host work included) and the
   median device time of the kernels it ran (``device_ms``).  A second loop
   times each call after a 128 MB read instead (cold: an empty, clean L2;
   ``cold_device_ms``).
3. The main path through the public API: the matrix-free PCG problem of
   ``tools/bench_pcg_crossover.py`` at P = 4096 poses, 61,440 landmarks
   (~5 observations each, 25% stereo, seed 0, gentle initial noise), Huber
   kernels, ``BAConfig(dtype=float32, solver="pcg", device="cuda")``:
   ``initialize()`` and ``optimize(10)`` once to warm up and once timed from
   a fresh graph.  chi² must be finite and fall and lie within
   CHI2_REL_BAND of ``cuba_tpu``'s fp64 record ``pcg4096`` at every
   iteration (``docs/_parity_torch_cuba_fp64.json``, read through
   ``parity_records.reference``: a missing record, or one made from other
   parameters or edges, ends the run); every kernel wrapper the plan
   routes through must have launched.
4. The same ``optimize(10)`` with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.
5. The band path through the public API: ``bench.py``'s kitti00-scale loop
   graph (1322 poses, 133,383 landmarks, ``mean_obs`` 5.5, 25% stereo, seed
   0, ``loop_closure=True``), Huber kernels, ``BAConfig(dtype=float32,
   device="cuda")`` with ``solver="auto"``: ``initialize()`` +
   ``optimize(10)`` once to warm up and once timed from a fresh graph.  The
   engine must resolve to ``band_cr`` with 22 CR blocks, chi² must be
   finite and fall, the final chi² must lie within ``bench.CHI2_REL_BAND``
   of the recorded fp64 value ``bench.CHI2_FP64_FINAL``, and every kernel
   of the path must have launched.
6. Every kernel of the band path against its plain version on that run's
   plan and first-attempt tensors: the gather and the segment sum
   (``gather``, ``segsum``: the sites of kernels 1-6) at phase
   2's call sites, ``segsum`` also at the combine of
   ``rows.schur_compact``, kernels 7-8 (``schur_fused``, ``compact_to_band``), ``edge_terms`` (the
   per-edge Gauss-Newton terms, mono and stereo, on the engine's initial
   state) and the Schur factors (``hll_inverse``, ``slot_factors`` at
   ``rows.prepare_factors``' call on the first damped attempt,
   :func:`check_factors`).  Gathers and ``compact_to_band`` equal bit for
   bit, [Hll^-1; bl] within one ulp, sums, the edge terms, W and W bl
   within 1e-5 of each output's sum of |terms|; median CUDA-event times of
   25 launches.
7. Phase 5's run with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.
8. The dense path through the public API: ``bench.py --quick``'s kitti07
   graph (248 poses, 26,127 landmarks, ``mean_obs`` 4.65, 25% stereo, seed
   0, ``loop_closure=False``), Huber kernels, ``BAConfig(dtype=float32,
   device="cuda")`` with ``solver="auto"``: ``initialize()`` +
   ``optimize(10)`` once to warm up and once counted and timed from a fresh
   graph.  The engine must resolve to ``dense_cholesky``, chi² must be
   finite and fall, the final chi² must lie within ``bench.CHI2_REL_BAND``
   of ``bench.CHI2_FP64_FINAL[("kitti07_scale", 10)]``, and every kernel of
   the path must have launched.
9. Every kernel of the dense path against its plain version on the warm-up
   engine's first-attempt tensors: kernels 1-7 and the Schur factors as in
   phase 6, then ``compact_to_dense`` and ``extract_diag_blocks`` bit for bit, ``matvec``
   within 1e-5 of each row's sum of |A_ij x_j|, ``solve_lower`` /
   ``solve_upper`` within SOLVE_RTOL of max |result|; median CUDA-event
   times of 25 launches; the whole ``cholesky_solve`` against the same call
   under ``use_plain()`` and the sweeps against ``torch.linalg.
   solve_triangular``; one damped attempt timed phase by phase.  Then the
   same kernel checks on the kitti00 loop graph built with
   ``solver="dense_cholesky"`` (n = 8448), and its ``optimize(10)``, whose
   chi² must be finite and fall (its final chi² is logged, not gated).
10. Phase 8's run with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.
11. The v1 formation: ``bench.py``'s kitti00 odometry graph (``loop_closure
   =False``: 1322 poses, 133,383 landmarks, seed 0) with the v2 gate closed
   (``rows._WG_MAX = 0``, restored after): ``solver="auto"`` must resolve
   to ``band_cr`` (m = 22) through the v1 formation and ``from_dense``;
   kernels 1-7 at its call sites (``segsum`` at both combines) and
   ``band_transpose`` (bit for bit at PB = 1408, timed beside its plain
   version and the permuted copy) against their plain versions; the
   counted ``optimize(10)`` must land within CHI2_REL_BAND of the fp64
   record and agree with the plain run to 5e-3; on one attempt's tensors
   the v1 dense matrix must match the v2 one within fp32 summation order;
   the gate-open (v2) run must agree with the v1 one to 5e-3 per iteration.
   With the gate still closed, kitti07's graph runs ``dense_cholesky``
   through the v1 formation (kernels 10-14): counted, within
   CHI2_REL_BAND of its fp64 record and within 5e-3 of phase 8's run.
12. ``band_lr`` on the MXU path: phase 11's graph (gate open) plus two loop
   chords (pose (src + 3P/7) % P and (src + 5P/7) % P re-observe the first
   landmark of pose src = (2c+1)P/5, c = 0, 1): m_lr 22, 26 out-of-band
   blocks, |J| 16; ``auto`` must resolve to ``band_lr`` on the v2 route;
   kernels 1-8 against their plain versions at its shapes; the counted
   ``optimize(10)`` against the plain run (5e-3) and against
   ``solver="dense_cholesky"`` on the same graph (rtol 2e-2 per iteration,
   final chi² within 5e-3).
13. The AoS path: the same graph with three chords, the rows planner made
   to find no plan (:func:`planner_closed`, as the tests close it; the
   graph plans for the card): ``auto`` must resolve to ``band_lr`` on the
   AoS route; the
   segment-sum kernel against its plain version at two AoS call sites (the
   pose sums of the mono terms, the per-block triplet sums); the checks of
   phase 12; then kitti07's graph with every landmark fixed (pose-only) and
   with every pose fixed (landmark-only) must descend.
14. The rest of the public API at the main path's full width, on phase 5's
   kitti00 loop graph: ``json_io.write_graph`` to a temporary directory and
   ``read_graph`` back (write and read seconds logged; the two graphs'
   ``BAStructure`` arrays must be equal bit for bit); ``optimize(10,
   profile=True)`` from a fresh ``initialize()``, counted: final chi² within
   CHI2_REL_BAND of the fp64 record, within TRAJ_RTOL of phase 5's run per
   iteration, the profile's keys exactly ``PROFILE_ITEMS`` with "4" and "5"
   at 0 and the others above, no attributed phase, every kernel of the band
   path launched; three plain ``optimize(10)`` with ``phase_attribution``
   on and three off, in turns, from the same engine and start: each run's
   five phases must be > 0 and sum to its "optimize (fused device loop)"
   wall to 1e-6 (walls logged, not gated), and one run of each, in one
   ``torch.profiler`` session between untimed runs, must run the same
   number of device operations; a checkpoint after ``optimize(5)`` restored into a fresh graph (the
   statistics equal, the engine's state equal bit for bit to the saved
   estimates cast to fp32, a further ``optimize(5)`` finite, never rising,
   and ending at or below the saved last chi²); ``chi_squared`` of every edge after one
   ``remove_edge``: finite, >= 0 and equal bit for bit to
   ``engine.chi_squares``.
15. The BAL path at the published Ladybug-49 shape
   (``data/bal_ladybug_scale.txt.gz``: 49 cameras, 7,776 points, 31,818
   observations; no robust kernel), ``BAConfig(dtype=float32,
   device="cuda")`` with ``solver="auto"``, which must resolve to
   ``dense_cholesky`` on the v2 route (PB 128, n = 768): kernels 1-7, 9
   and 11-14 against their plain versions at its shapes as in phase 9; the
   counted ``optimize(10)``: chi² falling, the final below 0.6x the first
   (tests/test_bal.py's bar) and within CHI2_REL_BAND of ``cuba_tpu``'s
   fp64 record ``ladybug49_bal`` (its edges and the file's sha256 the
   record's); its profile.  Then
   ``sample_comparison_with_reference``'s graph (20 poses, 300 landmarks)
   in process: the card's fp32 trajectory within TRAJ_RTOL of the port's
   fp64 oracle copy per iteration; and the three samples as subprocesses
   on the card, started together (``sample_ba_from_file`` on phase 14's JSON with
   ``--profiled``, ``sample_bal`` on the Ladybug file,
   ``sample_comparison_with_reference`` at its defaults): each must exit 0
   with finite, falling chi² lines.
16. fp64 on the card (``BAConfig(dtype=float64, device="cuda")``): the
   fp64 builds of kernels 1-10 (entries ``cuba_<name>_f64`` of
   ``csrc/segmm.cu``), of ``edge_terms`` (``csrc/edgeterms.cu``) and of
   ``hll_inverse`` and ``slot_factors`` (``csrc/factors.cu``) and,
   in the dense solve, ``cholesky_ex`` + ``solve_triangular`` (the ``trisolve.cu`` kernels are fp32 only, as
   ``cuba_tpu``'s are).  Phase 5's fp32 trajectory is logged against the
   recorded fp64 one (``CHI2_FP64_TRAJECTORY``, copied from
   ``docs/_parity_kitti00_fp64.json``; not gated).  Then, for each path, a
   warm-up run on whose engine every fp64 kernel of the path is held to its
   fp64 plain version at its call sites (gathers, placements and the
   transpose bit for bit, sums within 1e-13 of each output's sum of
   |terms|, a second launch bit for bit; timed as in phase 2), and a
   counted run in which every launch must be an fp64 one
   (``LAUNCHES_F64`` equal to ``LAUNCHES``): the kitti00 loop (``auto`` ->
   ``band_cr`` m = 22 on v2, kernels 1, 3-8 and ``edge_terms``), kitti07 (``dense_cholesky``
   on v2, kernels 2-7 and 9) and the kitti00 odometry graph with the v2
   gate closed (v1, ``band_cr``, kernels 1-7 and 10), each ``optimize(10)``
   within 1e-6 of its recorded fp64 trajectory at every iteration, each
   profiled; the three-chord graph (AoS, kernel 6) and pcg4096 (rows +
   PCG) at ``optimize(3)``, each within 1e-8 per iteration of the same run
   with the plain versions on the card, pcg4096 also within 1e-6 of the
   first three iterations of ``cuba_tpu``'s record; and ``sample_ba_from_file
   --synthetic --fp64`` as a subprocess on the card.
17. The landmark-sharded LM (``cuba_tpu_torch/parallel/``) on the card.
   a. The kitti00 loop through ``BAConfig(mesh=<a one-rank NCCL group>)``
   in this process, counted: ``auto`` must resolve to ``band_cr`` with 22
   CR blocks on the rows route (v2), every kernel of the route must
   launch, and the ``optimize(10)`` trajectory must equal phase 5's bit
   for bit (one shard is the whole graph; a one-rank all-reduce is the
   identity); then a single-device run and a mesh run in turns, walls
   logged, and one profiled mesh run.  b. MESH_RANKS = 4 ranks spawned on
   the one card over gloo (``parallel.launch.spawn``; any rank's failure,
   or MESH_TIMEOUT, ends the run), each building the same graph through
   the public API: the
   kitti00 loop in fp32 (``band_cr``, m = 22: final chi² within
   CHI2_REL_BAND of the fp64 record, every iteration within 5e-3 of
   phase 5's run) and in fp64 (every iteration within 1e-6 of the
   recorded fp64 trajectory), the two-chord graph (``band_lr`` on v2,
   within 5e-3 of phase 12's run per iteration), kitti07
   (``dense_cholesky``, kernels 9 and 11-14 in the replicated solve,
   within CHI2_REL_BAND of its fp64 record), pcg4096 (``solver="pcg"``,
   ``optimize(3)``, within 5e-3 of phase 3's first three iterations) and
   the three-chord graph (phase 13's structure through
   ``MultiChipSolverAdapter(aos=True)``, since its shards plan:
   the AoS shard body, kernel 6, where ``band_lr`` is an explicit
   ``dense_cholesky``; ``optimize(3)`` within 2e-2 of phase 13's per
   iteration).  Every rank's trajectory and estimates must equal every
   other rank's bit for bit, each case take its route and solver, and
   every kernel of the route (:func:`expected_kernels` of the route facts
   the rank reports) launch on every rank; each rank also logs its
   device-busy share of one more kitti00 loop run under
   ``torch.profiler``.  Walls are logged as what they are: four processes
   sharing one card, with gloo staging every collective through the
   host.  c. Rank 0's shard of the
   kitti00 loop (``rows_shard.shard_structures``, planned as the ranks
   plan it) in this process: kernels 1-7 against their plain versions at
   its call sites, as in phase 6, and ``compact_to_band`` on the sum of the
   four shards' compact tables (what the all-reduce delivers).
18. The large-landmark regime at full width: ``tools/stress_large_l.py``'s
   graph (1778 poses, 1,000,000 landmarks, ~5 observations each, 25%
   stereo, seed 0: 3,885,457 edges, 12.6M Schur triplets), Huber kernels,
   ``BAConfig(dtype=float32, device="cuda")`` with ``solver="auto"``, built
   once through the public API: ``initialize()`` must resolve to
   ``band_cr`` with 28 CR blocks on v2; a warm-up ``optimize(10)``; the
   memory plan (``stress_large_l.memory_plan``: the bytes of the engine's
   dominant tensors); the route's kernels (``engine_kernels``) against
   their plain versions at its call sites, as in phase 6; the counted
   ``optimize(10)`` from the engine's initial state (every kernel of the
   route launched, chi² finite and falling) and its profile; the same
   graph's first STRESS_PLAIN_ITERS iterations with the plain versions
   within TRAJ_RTOL of the kernel run's; and the same structure in fp64
   on the card.  The fp32 trajectory must lie within CHI2_REL_BAND of
   the card's fp64 run and of ``cuba_tpu``'s fp64 record ``stress_1m`` at
   every iteration, the fp64 run within CHI2_FP64_RTOL of that record.
   Each run logs the device's peak memory.
19. The port's tools (``cuba_tpu_torch/tools/``) at full width
   (:func:`check_tools`): ``profile_formation``'s formation and CR stages
   and ``profile_crsolve``'s on the kitti00 loop's band_cr engine (m =
   22), each stage's call and device ms with its top three device kernels
   (the two CR inverses' solutions within 1e-4 of each other, refine 1's
   residual no worse than refine 0's); ``bench_pcg_band_mc``'s t_form,
   t_band, t_pcg, CG steps and measured t_lat on the same engine (finite),
   the attempt damped at the JAX tool's λ = 1e-3 (``roofline.LAM0``, as
   ``profile_formation``'s);
   ``bench_multichip_mxu`` on kitti07 through a one-rank NCCL group (the
   rows route bit for bit against the single device); ``mc_parity``'s 8
   spawned gloo ranks on the card, kitti07 fp64 (within 1e-6 of the single
   device); ``parity_kitti00``'s table of phases 5, 11 (gate open) and 8
   against phase 16's fp64 runs and CHI2_FP64_TRAJECTORY (within 5e-3 at
   every iteration; a temporary file); ``perf_probe_solve`` at n = 8448
   (refine 1 and 2 no less accurate than refine 0, or below 1e-5).

Every phase's kernel check also times the one PyTorch call that computes
the same function where there is one (``index_select`` for the gathers,
``index_add_`` for the segment sums, one accumulating ``index_put_`` over
a flat index built once per structure for the placements
(``roofline.placement_library``), the permuted copy for
``band_transpose``, the strided diagonal copy for
``extract_diag_blocks``, ``solve_triangular`` for the sweeps, ``mv`` for the
matvec) and computes the kernel's bound on this card: the larger of the
bytes it must move (each input read once, each output written once, for
this run's data) over 3.35 TB/s and its fp32 operations over 67 TFLOP/s
(its fp64 ones over 34 TFLOP/s): ``cuba_tpu_torch/tools/roofline.py``,
the yardstick ``tools/mfu.py`` shares.

After each path's counted run one more ``optimize(10)`` of the same graph
from its engine's initial state (of a fresh graph for the one-rank mesh,
whose adapter keeps its state) runs under ``torch.profiler`` (device
activity only) and logs the device kernels per attempt, the device-busy
share of the wall and the kernels with the most device time (not gated).

The line before the last is a JSON object with one entry per kernel and
path (``"path"``: ``pcg`` from phases 2-3, ``band`` from phases 5-6,
``dense`` from phases 8-9 at kitti07, ``dense-kitti00`` from phase 9's
kitti00 engine, ``v1``, ``band_lr`` and ``aos`` from phases 11-13, ``bal``
from phase 15, ``band-fp64``, ``dense-fp64``, ``v1-fp64``, ``aos-fp64`` and
``pcg-fp64`` from phase 16, ``mesh`` from phase 17c with the launches of
rank 0's kitti00 loop run in 17b, ``stress`` from phase 18, each entry
with its ``dtype``;
``"site"`` names a second call site of one kernel).  ``launches`` is the
kernel's count in that path's counted run, over all its call sites, and
``attempts`` that run's damped attempts; the other numbers are that
path's comparisons: ``ms`` / ``plain_ms`` / ``library_ms`` event-timed
calls, ``device_ms`` / ``plain_device_ms`` / ``library_device_ms`` the
device time of the same calls (warm), ``cold_device_ms`` /
``plain_cold_device_ms`` / ``library_cold_device_ms`` the device time of
each after the 128 MB read, and for a segment sum the group width
``group`` and rows per chunk ``rows`` the kernel picks there and its CSR's
shape (``D``, ``segments``, ``entries``, ``max_len``, ``empty``), for
``extract_diag_blocks`` its ``grid`` and float4 ``loads`` per thread, for
``solve_lower`` and ``solve_upper`` their ``tile`` height or width and
``grid``, for ``matvec`` its ``slices`` S, accumulators ``accs`` U and
``float4`` loads, for ``schur_fused``, ``compact_to_band`` and
``compact_to_dense`` their ``grid``, ``threads`` a block, shared bytes
``smem`` with the build's ``registers`` and ``spill_bytes`` a thread and
``blocks_per_sm``.
Each timing loop also logs its launch floor: the median device time of
its ``torch.cuda._sleep`` marks.  A kernel call that raises, or device
times the profiler cannot split, end the run.  The last line is ``{"ok":
true, "device": {...}}``.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
try:  # the port's graphs, yardstick (peak rates, work counts and timing) and
    # cuba_tpu's fp64 records (main() fails where the package is missing)
    from cuba_tpu_torch.tools import graphs, parity_records, roofline
except ImportError:
    graphs = parity_records = roofline = None
ITERS = 10
# bench.py's recorded fp64 final chi² of its default graphs after 10 LM
# iterations (docs/PARITY_kitti00.md), and the band a run must land in
CHI2_FP64_FINAL = {
    ("kitti00_scale_loop", 10): 925601.05,
    ("kitti00_scale", 10): 924194.00,
    ("kitti07_scale", 10): 148331.12,
}
CHI2_REL_BAND = 5e-3
# the same records' chi² after each of the 10 iterations
# (docs/_parity_kitti00_fp64.json, cuba_tpu in fp64), which phase 16's fp64
# runs on the card must meet per iteration to CHI2_FP64_RTOL
CHI2_FP64_TRAJECTORY = {
    "kitti00_scale_loop": (
        4785262.696139738, 1293215.5800415375, 1029946.8585131207, 992869.8939932929,
        965980.4329075422, 946523.9796933774, 934647.7569399917, 928643.1061359957,
        926285.2779947994, 925601.0501801923,
    ),
    "kitti00_scale": (
        4713347.908070361, 1281806.3048493601, 1027507.450415333, 991016.8415941017,
        964332.3851512186, 944920.3122008743, 933045.9983509793, 927103.0491380619,
        924837.1379081398, 924193.9967762125,
    ),
    "kitti07_scale": (
        804702.4119413802, 210405.22378571687, 167563.04590730136, 161763.49863762167,
        156998.98808696453, 153154.52579939592, 150556.30578664228, 149121.04074117038,
        148518.97349157964, 148331.11946796652,
    ),
}
CHI2_FP64_RTOL = 1e-6
# phase 16's shorter fp64 runs (AoS, PCG) against the same runs with the
# plain versions on the card, per iteration
FP64_PLAIN_RTOL = 1e-8
FP64_SHORT_ITERS = 3
SEGSUM_RTOL = 1e-5
SEGSUM_RTOL_F64 = 1e-13  # the same bound for the fp64 builds (phase 16)
# the blocked sweeps against their plain versions: each entry within this
# share of the largest |entry|.  Both sum in exact fp32 in other orders
# (warp butterflies against cuBLAS), and a rounding difference in one
# stripe's result feeds every later stripe through L's off-diagonal
# blocks, so the gap grows with the stripe count and L's conditioning
# (the equilibrated Schur factor, K = 6 at kitti07, 33 at n = 8448).
SOLVE_RTOL = 1e-4
TRAJ_RTOL = 5e-3

if graphs is not None:  # tools/graphs.py's: bench.py:121-137 (with and without the
    # loop closure) and :114-119
    KITTI, KITTI00, KITTI07 = graphs.KITTI00_LOOP, graphs.KITTI00, graphs.KITTI07
KITTI_BAND_M = 22
# the dense solver against band_lr per iteration: cuba_tpu's on-chip bar
# for two solvers on one graph (tests/test_tpu_matrix.py)
SOLVER_RTOL = 2e-2
# the v1 dense Schur matrix against the v2 one: both sum the same window
# lanes of schur_fused in fp32, each within this share of max |A|
FORMATION_RTOL = 1e-5
TRISOLVE_KERNELS = ("extract_diag_blocks", "solve_lower", "solve_upper", "matvec")
# the launch parameters a kernel entry may carry (trisolve.diag_launch,
# trisolve.solve_lower_launch, trisolve.solve_upper_launch,
# trisolve.matvec_launch, segmm.schur_fused_launch,
# segmm.compact_to_band_launch, segmm.compact_to_dense_launch, and the
# build's segmm.kernel_attributes), logged beside its times
LAUNCH_NOTES = ("grid", "threads", "smem", "registers", "spill_bytes", "blocks_per_sm",
                "loads", "tile", "slices", "accs", "float4")
# the __global__ names of csrc/segmm.cu, csrc/trisolve.cu, csrc/edgeterms.cu and
# csrc/factors.cu, as a profile lists them
HAND_KERNELS = ("gather_cols", "segsum_", "schur_fused", "compact_to_band",
                "compact_to_dense", "band_transpose", "extract_diag", "solve_lower_kernel",
                "solve_upper_kernel", "matvec_kernel", "edge_terms_kernel", "hll_inverse_kernel",
                "slot_factors_kernel")
REPLACES = {
    "gather": "cuba_tpu/ops/segmm.py:1257 resident_gather, :1215 windowed_gather, "
                   ":487 tiled_gather",
    "segsum": "cuba_tpu/ops/segmm.py:105 accum_segsum, :205 accum_segsum_windowed, "
                  ":425 tiled_segsum",
    "schur_fused": "cuba_tpu/ops/segmm.py:798",
    "compact_to_band": "cuba_tpu/ops/segmm.py:1093",
    "compact_to_dense": "cuba_tpu/ops/segmm.py:964",
    "extract_diag_blocks": "cuba_tpu/solver/trisolve.py:74",
    "solve_lower": "cuba_tpu/solver/trisolve.py:120",
    "solve_upper": "cuba_tpu/solver/trisolve.py:159",
    "matvec": "cuba_tpu/solver/trisolve.py:200",
    "band_transpose": "cuba_tpu/ops/segmm.py:903",
    # no Pallas kernel: XLA fused term_rows on the TPU
    "edge_terms": "none (XLA fused cuba_tpu/solver/edgerows.py:132 term_rows)",
    # no Pallas kernels: XLA fused prepare_factors_mxu on the TPU
    "hll_inverse": "none (XLA fused cuba_tpu/solver/mxu.py:1575 prepare_factors_mxu)",
    "slot_factors": "none (XLA fused cuba_tpu/solver/mxu.py:1575 prepare_factors_mxu)",
}


def kernel_source(name: str) -> str:
    if name == "edge_terms":
        return "cuba_tpu_torch/csrc/edgeterms.cu"
    if name in ("hll_inverse", "slot_factors"):
        return "cuba_tpu_torch/csrc/factors.cu"
    return "cuba_tpu_torch/csrc/" + ("trisolve.cu" if name in TRISOLVE_KERNELS else "segmm.cu")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()
_STAMP = [_START]


def stamp(what: str) -> None:
    """Log the seconds since the previous stamp (or the start)."""
    now = time.perf_counter()
    log(f"{what}: {now - _STAMP[0]:.2f} s")
    _STAMP[0] = now


def make_graph(prob, config, fix=None):
    """The problem's graph with Huber kernels; ``fix`` = "landmarks" or
    "poses" holds every landmark or every pose fixed.  A ``prob`` that is a
    path names a BAL file, read with no robust kernel (as ``sample_bal``
    reads it by default)."""
    from cuba_tpu_torch.io import bal, synthetic

    if isinstance(prob, str):
        return bal.read_bal(prob, config)
    ba = synthetic.build_graph(prob, config)
    if fix == "landmarks":
        for j in range(prob.Xws.shape[0]):
            ba.landmark_vertex(j).fixed = True
    elif fix == "poses":
        for i in range(prob.qs.shape[0]):
            ba.pose_vertex(i).fixed = True
    set_huber(ba)
    return ba


def set_huber(ba):
    from cuba_tpu_torch import EdgeType, RobustKernelType

    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)


def cuda_ms(fn, torch) -> float:
    """Median milliseconds of ``fn()`` over ``roofline.REPEATS`` CUDA-event-timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(roofline.REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def interleaved_times(fns, torch, cold=False):
    """{label: (call_ms, device_ms)} of the callables of ``fns``, timed in
    turns under ``torch.profiler`` (``roofline.interleaved_times``, the
    one timing of the smoke and of ``tools/mfu.py``); a trace that splits
    too few rounds ends the run."""
    try:
        return roofline.interleaved_times(fns, cold)
    except RuntimeError as e:
        fail(str(e))


def sum_rtol(t) -> float:
    """The kernel-against-plain bound of a sum over tensor ``t``'s values,
    as a share of each output's sum of |terms|: SEGSUM_RTOL in fp32,
    SEGSUM_RTOL_F64 in fp64."""
    return SEGSUM_RTOL_F64 if t.element_size() == 8 else SEGSUM_RTOL


def site_case(site, segmm, torch):
    """The case (see :func:`compare_cases`) of a ``roofline.Site``: its
    wrapper against the plain version on the site's arguments, its work,
    and per kind the yardstick and notes.  A gather is exact, its library
    call ``index_select`` on the in-range ids (out-of-range ids read column
    0 there).  A segment sum is held to :func:`segsum_bound`, its library
    call ``index_add_`` into zeros; notes: the group width G and rows per
    chunk the kernel picks, and the CSR's shape.  ``schur_fused`` is held
    to its sum of |terms|, and no single PyTorch call computes it (a
    segmented sum of products: an einsum over the triplets and then an
    ``index_add_``, with a [36, triplets] intermediate); the placements are
    exact, their library call ``roofline.placement_library`` (one
    accumulating ``index_put_`` over a flat index built once per
    structure).  Notes of both: the launch and the build's attributes."""
    kern, plain = site.wrapper(segmm), site.plain(segmm)
    work = site.work()
    if site.kind == "gather":
        src, ids = site.inputs
        valid = (ids >= 0) & (ids < src.shape[1])
        safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
        return ("exact", site.call, kern, plain, work, lambda: src.index_select(1, safe))
    if site.kind == "segsum":
        vals, ids, num_out, csr = site.inputs
        valid = (ids >= 0) & (ids < num_out)
        D, N = vals.shape
        idx, v = ids[valid].long(), vals[:, valid].contiguous()

        def library():
            return torch.zeros((D, num_out), dtype=vals.dtype, device=vals.device).index_add_(
                1, idx, v)

        lengths = torch.diff(csr.offs)
        notes = dict(group=csr.group, rows=segmm.row_chunk(D, N, csr.group), D=D,
                     segments=num_out, entries=int(valid.sum()),
                     max_len=int(lengths.max()) if num_out else 0,
                     empty=int((lengths == 0).sum()))
        return ((vals, ids, num_out), site.call, kern, plain, work, library, notes)
    dtype = site.args[0].dtype
    if site.kind == "schur":
        launch = segmm.schur_fused_launch(site.inputs[2][0], dtype)
    else:
        launch = getattr(segmm, site.kernel + "_launch")(site.inputs[0].pad_blocks, dtype)
    library = None if site.kind == "schur" else roofline.placement_library(site)
    return (("schur",) if site.kind == "schur" else "exact", site.call, kern, plain, work,
            library, {**launch, **segmm.kernel_attributes(site.kernel, launch, dtype)})


def check_kernels(engine, torch, segmm):
    """Phase 2: each wrapper's kernel against its plain version on the
    slice's tensors (``roofline.row_sites``).  Returns {name: entry} (see
    :func:`compare_cases`)."""
    return compare_cases(kernel_cases(engine, torch, segmm), torch,
                         lambda *kind: segsum_bound(segmm, *kind), engine.dtype)


def kernel_cases(engine, torch, segmm):
    """The cases of the gather and the segment sum at the rows front end's
    call sites (``roofline.row_sites``)."""
    return {k: site_case(v, segmm, torch) for k, v in roofline.row_sites(engine).items()}


def segsum_bound(segmm, vals, ids, num_out):
    """A segment sum's bound: :func:`sum_rtol` times each output's sum of
    |vals|."""
    return sum_rtol(vals) * segmm.segsum_plain(vals.abs(), ids, num_out)


def compare_cases(cases, torch, bound_of, dtype=None):
    """Each case's kernel against its plain version, both of ``dtype``
    (float32 by default; the bound's operations counted in it): equal bit
    for bit ("exact"), or within ``bound_of(*kind)`` elementwise; and a
    second launch equal bit for bit to the first (a call that returns
    several tables is compared on them concatenated).  A case is (kind, call, kernel,
    plain, (bytes, flops), library call or None[, notes]); its label is the
    wrapper's name, with ``:site`` where one wrapper has two call sites.
    Then the kernel, the plain version and the library call of every case
    are timed in turns in one loop (:func:`interleaved_times`), warm, and
    in a second loop cold.  Returns {label: {max_abs_err, ms, device_ms,
    plain_ms, plain_device_ms, bound_ms, bound_by, library_ms,
    library_device_ms, cold_device_ms, plain_cold_device_ms,
    library_cold_device_ms, **notes}}."""
    out, fns = {}, {}
    dtype = torch.float32 if dtype is None else dtype

    def joined(r):  # a call that returns several tables is compared on all of them
        return torch.cat(r) if isinstance(r, tuple) else r

    for name, (kind, call, kern, plain, work, library, *notes) in cases.items():
        got = joined(call(kern))
        torch.cuda.synchronize()
        ref = joined(call(plain))
        if got.shape != ref.shape or got.dtype != dtype or ref.dtype != dtype:
            fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, "
                 f"plain {tuple(ref.shape)} {ref.dtype}")
        diff = (got - ref).abs()
        if kind == "exact":
            if not torch.equal(got, ref):
                fail(f"{name}: kernel and plain results differ (max {float(diff.max())})")
        elif not bool((diff <= bound_of(*kind)).all()):
            fail(f"{name}: kernel and plain sums differ beyond the stated bound "
                 f"(max abs diff {float(diff.max())})")
        again = joined(call(kern))
        if not bool((got.view(torch.int32) == again.view(torch.int32)).all()):
            fail(f"{name}: two launches on the same input gave different bits")
        err = float(diff.max()) if diff.numel() else 0.0
        del got, ref, diff, again
        bound_ms, bound_by = roofline.bound(*work, fp64=dtype == torch.float64)
        out[name] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                         **(notes[0] if notes else {}))
        fns[(name, "kernel")] = lambda call=call, kern=kern: call(kern)
        fns[(name, "plain")] = lambda call=call, plain=plain: call(plain)
        if library is not None:
            fns[(name, "library")] = library
    times = interleaved_times(fns, torch)
    cold = interleaved_times(fns, torch, cold=True)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    for name, e in out.items():
        (e["ms"], e["device_ms"]), (e["plain_ms"], e["plain_device_ms"]) = (
            times[(name, "kernel")], times[(name, "plain")])
        e["library_ms"], e["library_device_ms"] = times.get((name, "library"), (None, None))
        e["cold_device_ms"], e["plain_cold_device_ms"] = (
            cold[(name, "kernel")][1], cold[(name, "plain")][1])
        e["library_cold_device_ms"] = cold.get((name, "library"), (None, None))[1]
        lib = ("none" if (name, "library") not in times else
               f"{fmt(e['library_ms'])} (device {fmt(e['library_device_ms'])}, cold "
               f"{fmt(e['library_cold_device_ms'])})")
        group = f" G {e['group']} R {e['rows']}" if "group" in e else ""
        group += "".join(f" {k} {e[k]}" for k in LAUNCH_NOTES if k in e)
        log(f"kernel {name}:{group} max_abs_err {e['max_abs_err']:.3e} kernel {fmt(e['ms'])} "
            f"(device {fmt(e['device_ms'])}, cold {fmt(e['cold_device_ms'])}) plain "
            f"{fmt(e['plain_ms'])} (device {fmt(e['plain_device_ms'])}, cold "
            f"{fmt(e['plain_cold_device_ms'])}) bound {e['bound_ms']:.4f} ms ({e['bound_by']}) "
            f"library {lib}")
    return out


def band_case(gT, dbT, engine, segmm, torch):
    """compact_to_band's case on the compact table gT and the damped
    diagonal dbT (``roofline.placement_site``)."""
    return site_case(roofline.placement_site(engine, gT, dbT), segmm, torch)


def check_schur_kernels(engine, torch, segmm, HplT, W):
    """The gather and the segment sum at the call sites of phase 2,
    ``schur_fused``, and the segment sum at the combine of the engine's
    formation: v2's one
    (``rows.schur_compact``) or v1's two (``rows.dense_block_table``)."""
    out = check_kernels(engine, torch, segmm)
    cases, bound_of = schur_cases(engine, torch, segmm, HplT, W)
    out.update(compare_cases(cases, torch, bound_of, engine.dtype))
    return out


def schur_cases(engine, torch, segmm, HplT, W):
    """The cases of ``schur_fused`` and of the segment sum at the combine
    of the engine's formation, on W and HplT (``roofline.schur_sites``),
    and their bound: (cases, bound_of)."""
    sites = roofline.schur_sites(engine, HplT, W)
    return {k: site_case(v, segmm, torch) for k, v in sites.items()}, sites_bound(sites, segmm)


def sites_bound(sites, segmm):
    """The kernel-against-plain bound of the sums among ``sites``:
    :func:`sum_rtol` of each output's sum of |terms|, for ``schur_fused``
    its products' and for a segment sum its values' (:func:`segsum_bound`)."""
    def bound_of(*kind):
        if kind == ("schur",):
            W, G, *sc = sites["schur_fused"].args
            return sum_rtol(W) * segmm.schur_fused_plain(W.abs(), G.abs(), *sc)
        return segsum_bound(segmm, *kind)

    return bound_of


def check_band_kernels(engine, torch, segmm):
    """Phase 6: every kernel of the band path against its plain version on
    the band run's plan and first-attempt tensors: kernels 1-7 (as
    :func:`check_schur_kernels`), ``compact_to_band``, ``edge_terms``
    (:func:`check_edge_terms`) and the Schur factors
    (:func:`check_factors`).  Returns the kernel entries.  (The CR
    factor and solve with each diagonal-block inverse are timed in phase
    19, stage by stage.)"""
    from cuba_tpu_torch.solver import rows

    plan, rc = engine.plan, engine.rc
    HppT, HplT, lam, W, _bscT = roofline.first_attempt(engine)
    out = check_schur_kernels(engine, torch, segmm, HplT, W)
    gT = rows.schur_compact(W, HplT, plan, rc)
    dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, plan.pad_blocks)
    out.update(compare_cases({"compact_to_band": band_case(gT, dbT, engine, segmm, torch)},
                             torch, None, engine.dtype))
    out.update(check_edge_terms(engine, torch))
    out.update(check_factors(engine, torch))
    return out


def check_edge_terms(engine, torch):
    """``edge_terms`` (``edgerows.term_rows``) against its plain version
    (``term_rows_plain``) at each edge type's call site on the engine's
    initial state (``roofline.edge_sites``): the three tables within
    :func:`sum_rtol` of each entry's sum of |products|
    (``edgerows.term_rows_scale``: both versions form the same weighted
    Jacobians, one rounding an operation, and sum their products in other
    orders; an entry that cancels to 0 in exact arithmetic, as Hpp's (2, 5)
    does where fu == fv, is rounding alone), timed as every case.  No one
    PyTorch call computes the terms (library "none").  Returns {label:
    entry}."""
    from cuba_tpu_torch.solver import edgerows

    sites = roofline.edge_sites(engine)
    cases = {label: (("edge_terms", site.args), site.call, edgerows.term_rows,
                     edgerows.term_rows_plain, site.work(), None)
             for label, site in sites.items()}

    def bound_of(_kind, args):
        return sum_rtol(args[0]) * torch.cat(edgerows.term_rows_scale(*args))

    return compare_cases(cases, torch, bound_of, engine.dtype)


def check_factors(engine, torch):
    """``hll_inverse`` and ``slot_factors`` (``rows.hll_inverse_rows``,
    ``rows.slot_factors_rows``) against their plain versions at
    ``rows.prepare_factors``' call on the engine's first damped attempt
    (``roofline.factor_sites``): [Hll^-1; bl] within one ulp of the plain
    version's (the same fp64 operations, each rounded once, then rounded to
    the working dtype), W and W bl within :func:`sum_rtol` of each entry's
    sum of |products| (``rows.slot_factors_scale``: sums of three products
    in another order), timed as every case.  Library: for ``hll_inverse``
    ``torch.linalg.inv`` of the damped fp64 [L, 3, 3] blocks (built outside
    the timed call); none for ``slot_factors``, whose plain version is the
    einsum pair the kernel replaced.  Returns {label: entry}."""
    from cuba_tpu_torch.solver import rows

    sites = roofline.factor_sites(engine)
    inv_site, slot_site = sites["hll_inverse"], sites["slot_factors"]
    HllT, lam = inv_site.args
    blocks = HllT[:9].clone()
    blocks[0::4] += lam
    blocks = blocks.double().T.reshape(-1, 3, 3).contiguous()
    cases = {
        "hll_inverse": (("ulp",), inv_site.call, rows.hll_inverse_rows, rows.hll_inverse_plain,
                        inv_site.work(), lambda: torch.linalg.inv(blocks)),
        "slot_factors": (("sums",), slot_site.call, rows.slot_factors_rows,
                         rows.slot_factors_plain, slot_site.work(), None),
    }

    def bound_of(kind):
        if kind == "ulp":
            ref = rows.hll_inverse_plain(HllT, lam).abs()
            return torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
        return sum_rtol(HllT) * torch.cat(rows.slot_factors_scale(*slot_site.args))

    return compare_cases(cases, torch, bound_of, engine.dtype)


def check_dense_kernels(engine, torch, segmm, label, schur_kernels=True, trisolve_kernels=True):
    """Phase 9: every kernel of the dense path against its plain version on
    the engine's plan and first-attempt tensors (kernels 1-7 as
    :func:`check_schur_kernels` and the Schur factors as
    :func:`check_factors` with ``schur_kernels``, then kernels 9 and, with
    ``trisolve_kernels``, 11-14), the whole ``cholesky_solve`` against
    the same call under ``use_plain()``, and the two sweeps against
    ``torch.linalg.solve_triangular``.  Returns the kernel entries."""
    from cuba_tpu_torch.solver import dense_cholesky, rows, trisolve

    plan, rc = engine.plan, engine.rc
    HppT, HplT, lam, W, bscT = roofline.first_attempt(engine)
    out = {}
    if schur_kernels:
        out.update(check_schur_kernels(engine, torch, segmm, HplT, W))
        out.update(check_factors(engine, torch))
    PB = plan.pad_blocks
    gT = rows.schur_compact(W, HplT, plan, rc)
    dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, PB)
    dense_site = roofline.placement_site(engine, gT, dbT, dense=True)
    dense_case = site_case(dense_site, segmm, torch)
    if not trisolve_kernels:
        out.update(compare_cases({"compact_to_dense": dense_case}, torch, None, engine.dtype))
        return out
    A = dense_site.call(dense_site.wrapper(segmm))
    n = A.shape[0]
    rhs = bscT.new_zeros(n)
    rhs[:6 * engine.num_p] = bscT.T.reshape(-1)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    L, reads = dense_cholesky.factor(A * s[:, None] * s[None, :])
    if not bool(torch.isfinite(L).all()):
        fail(f"{label}: the first attempt's dense system did not factor")
    invd = trisolve.prepare(L)
    b = (rhs * s).contiguous()
    y = trisolve.solve_lower(L, invd, b)
    z = trisolve.solve_upper(L, invd, y)
    x = (s * z).contiguous()
    K = n // trisolve.BLOCK
    # a sweep reads L's strictly-lower blocks (invd takes the place of its
    # diagonal blocks), invd and the vector, and writes its result
    tri_bytes = 4 * ((n * n - K * trisolve.BLOCK ** 2) // 2 + K * trisolve.BLOCK ** 2 + 2 * n)
    cases = {
        "compact_to_dense": dense_case,
        "extract_diag_blocks": (
            "exact", lambda f: f(L), trisolve.extract_diag_blocks,
            trisolve.extract_diag_blocks_plain, (8 * K * trisolve.BLOCK ** 2, 0),
            lambda: torch.diagonal(L.reshape(K, trisolve.BLOCK, K, trisolve.BLOCK), dim1=0,
                                   dim2=2).permute(2, 0, 1).contiguous(),
            trisolve.diag_launch(K)),
        "solve_lower": (
            ("solve", y), lambda f: f(L, invd, b), trisolve.solve_lower,
            trisolve.solve_lower_plain, (tri_bytes, n * n),
            lambda: torch.linalg.solve_triangular(L, b[:, None], upper=False),
            trisolve.solve_lower_launch(n)),
        "solve_upper": (
            ("solve", z), lambda f: f(L, invd, y), trisolve.solve_upper,
            trisolve.solve_upper_plain, (tri_bytes, n * n),
            lambda: torch.linalg.solve_triangular(L.mT, y[:, None], upper=True),
            trisolve.solve_upper_launch(n)),
        "matvec": (
            ("matvec",), lambda f: f(A, x), trisolve.matvec, trisolve.matvec_plain,
            (4 * (n * n + 2 * n), 2 * n * n), lambda: torch.mv(A, x),
            trisolve.matvec_launch(A, x)),
    }

    def bound_of(*kind):
        if kind[0] == "solve":
            return SOLVE_RTOL * kind[1].abs().max()
        return SEGSUM_RTOL * (A.abs() @ x.abs())

    out.update(compare_cases(cases, torch, bound_of))

    refine = engine.config.refinement_steps + 1  # as the engine runs it on the card
    ms = cuda_ms(lambda: dense_cholesky.cholesky_solve(A, rhs, refine, use_kernels=True), torch)
    with segmm.use_plain():
        plain_ms = cuda_ms(lambda: dense_cholesky.cholesky_solve(A, rhs, refine,
                                                                 use_kernels=True), torch)
    tri_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, b[:, None], upper=False), upper=True), torch)
    fac_ms = cuda_ms(lambda: dense_cholesky.factor(A * s[:, None] * s[None, :]), torch)
    log(f"{label}: cholesky_solve (n {n}, {refine} refinement sweeps): kernels {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms; equilibrate + factor {fac_ms:.4f} ms ({reads} host read); "
        f"kernel sweeps lower + upper {out['solve_lower']['ms'] + out['solve_upper']['ms']:.4f} ms "
        f"against torch.linalg.solve_triangular lower + upper {tri_ms:.4f} ms")
    return out


def dense_attempt_phases(engine, torch):
    """One damped attempt of the dense path on the engine's initial state,
    phase by phase: median CUDA-event ms of each phase run alone."""
    from cuba_tpu_torch.solver import dense_cholesky, rows, trisolve

    plan, rc, P = engine.plan, engine.rc, engine.num_p
    st = engine.state
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    HppT, HllT, HplT = engine._build(pack_m, pack_s)
    lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    iv9, W, bscT, g12 = rows.prepare_factors(HppT, HllT, HplT, lam, P, rc)
    gT = rows.schur_compact(W, HplT, plan, rc)
    A = rows.dense_from_compact(gT, HppT, lam, P, plan, rc)
    n = A.shape[0]
    rhs = bscT.new_zeros(n)
    rhs[:6 * P] = bscT.T.reshape(-1)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    L, _ = dense_cholesky.factor(A * s[:, None] * s[None, :])
    invd = trisolve.prepare(L)

    def solve_with(v):
        return s * trisolve.solve_upper(L, invd, trisolve.solve_lower(L, invd, v * s))

    x = solve_with(rhs)
    xp = x[:6 * P].reshape(P, 6)
    xl = rows.back_substitute(iv9, HllT, HplT, g12, xp, engine.num_l, rc)
    phases = {
        "edge_rows": lambda: engine._residuals_and_chi(st),
        "build_system": lambda: engine._build(pack_m, pack_s),
        "prepare_factors": lambda: rows.prepare_factors(HppT, HllT, HplT, lam, P, rc),
        "schur_compact": lambda: rows.schur_compact(W, HplT, plan, rc),
        "dense_from_compact": lambda: rows.dense_from_compact(gT, HppT, lam, P, plan, rc),
        "equilibrate+factor": lambda: dense_cholesky.factor(A * s[:, None] * s[None, :]),
        "trisolve.prepare": lambda: trisolve.prepare(L),
        "first solve": lambda: solve_with(rhs),
        "one refinement sweep": lambda: x + solve_with(rhs - trisolve.matvec(A, x)),
        "back_substitute": lambda: rows.back_substitute(iv9, HllT, HplT, g12, xp,
                                                        engine.num_l, rc),
        "update+trial residuals": lambda: engine._residuals_and_chi(
            engine._apply_update(st, xp, xl)),
    }
    times = {name: cuda_ms(fn, torch) for name, fn in phases.items()}
    log("dense attempt phases (ms, median of 25, each alone): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; sum {sum(times.values()):.4f} with "
        f"{engine.config.refinement_steps + 1} refinement sweeps counted once")


def with_chords(prob, C: int):
    """The problem plus C loop chords (tests/test_band_lr.py's): for chord c,
    poses (src + 3P/7) % P and (src + 5P/7) % P re-observe the first
    landmark that pose src = (2c+1)P/(2C+1) observes in the mono edge list,
    at a fixed pixel (the Huber kernel caps its residual)."""
    P = prob.qs.shape[0]
    mp, ml = [], []
    for c in range(C):
        src = (2 * c + 1) * P // (2 * C + 1)
        lm = int(prob.mono_l[np.flatnonzero(prob.mono_p == src)[0]])
        for frac in (3, 5):
            mp.append((src + frac * P // 7) % P)
            ml.append(lm)
    n = len(mp)
    return dataclasses.replace(
        prob, mono_p=np.concatenate([prob.mono_p, mp]).astype(prob.mono_p.dtype),
        mono_l=np.concatenate([prob.mono_l, ml]).astype(prob.mono_l.dtype),
        mono_z=np.concatenate([prob.mono_z, np.tile([600.0, 180.0], (n, 1))]),
        mono_w=np.concatenate([prob.mono_w, np.ones(n)]))


def run_path(prob, config, torch, label, fix=None, iters=ITERS):
    """initialize() + optimize(iters) through the public API, timed."""
    ba = make_graph(prob, config, fix)
    t0 = time.perf_counter()
    ba.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba.optimize(iters)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    r = ba.last_result
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    log(f"{label}: solver {ba._engine.solver}, band_m {ba._engine.band_m}, "
        f"route {ba._engine.path}")
    log(f"{label}: initialize {t_init:.4f} s, optimize({iters}) {t_opt:.4f} s, "
        f"niters {r.niters}, attempts {r.nattempts}, cg_steps {r.cg_steps}, "
        f"host_reads {r.host_reads}")
    log(f"{label}: chi2 per iteration {chis.tolist()}")
    if chis.size == 0 or not np.all(np.isfinite(chis)):
        fail(f"{label}: chi2 trajectory not finite: {chis.tolist()}")
    qs = ba._state.qs
    if not bool(torch.isfinite(qs).all()) or tuple(qs.shape) != (ba._engine.structure.total_p, 4):
        fail(f"{label}: pose estimates not finite or of the wrong shape")
    return ba, chis, t_init, t_opt


@contextlib.contextmanager
def planner_closed():
    """Inside, the rows planner finds no plan (``rows.plan_row_tables``
    returns (None, None), as the tests close it), so every engine made
    there takes the AoS path."""
    from cuba_tpu_torch.solver import rows

    plan_row_tables = rows.plan_row_tables
    rows.plan_row_tables = lambda s, pad_blocks=0, lr=None: (None, None)
    try:
        yield
    finally:
        rows.plan_row_tables = plan_row_tables


def expected_kernels(facts):
    """The kernel wrappers that a route and solver run the LM loop through,
    from an engine's route facts (``drive.route_facts``: a rank's come back
    in its results)."""
    import torch

    from cuba_tpu_torch.solver import trisolve

    path, solver = str(facts["path"]), str(facts["solver"])
    if path == "aos":
        return {"segsum"}  # the AoS path's segment sums
    expected = {"gather", "segsum", "edge_terms", "hll_inverse", "slot_factors"}
    if path == "v1":
        expected |= {"schur_fused", "band_transpose"}
    elif path == "v2":
        expected.add("schur_fused")
        expected.add("compact_to_band" if solver in ("band_cr", "band_lr") else "compact_to_dense")
    dtype = getattr(torch, str(facts["dtype"]))
    if solver == "dense_cholesky" and trisolve.usable(6 * int(facts["pad_blocks"]), dtype):
        expected |= {"extract_diag_blocks", "solve_lower", "solve_upper"}
        if int(facts["refine"]) > 0:
            expected.add("matvec")
    return expected


def engine_kernels(engine):
    """:func:`expected_kernels` of an engine in this process."""
    from cuba_tpu_torch.parallel import drive

    return expected_kernels(drive.route_facts(engine))


def counted_run(prob, config, torch, segmm, label, expect_route, fix=None, iters=ITERS):
    """The path's counted run: launch counts set to 0 just before it and
    read just after; every kernel of its route must have launched.
    Returns (ba, chis, t_opt, launches)."""
    segmm.reset_launches()
    ba, chis, _t_init, t_opt = run_path(prob, config, torch, label, fix, iters)
    launches = dict(segmm.LAUNCHES)
    log(f"launches ({label}): {json.dumps(launches)}")
    if ba._engine.path != expect_route:
        fail(f"{label}: route {ba._engine.path!r}, expected {expect_route!r}")
    if not chis[-1] < chis[0]:
        fail(f"{label}: chi2 did not fall: {chis.tolist()}")
    missing = sorted(n for n in engine_kernels(ba._engine) if launches[n] == 0)
    if missing:
        fail(f"kernels of the {label} never launched: {missing}")
    return ba, chis, t_opt, launches


def union_us(spans):
    """The union of sorted (start, end) device intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_ops(fns, torch):
    """{label: (device kernels and copies, the union of their device
    intervals in ms)} of each callable of ``fns``, run in turns in one
    ``torch.profiler`` session (device activity only).  A
    ``torch.cuda._sleep`` mark before each call and one after the last
    split the trace.  The trace can miss a session's first events and its
    last ones (on an H100, the last few kernels and copies of a session
    that ended in a synchronize, the last mark among them), so an
    untimed run of the first callable comes before the first mark and one
    of the last after the last mark."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = list(fns)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fns[labels[0]]()
        for k in labels:
            torch.cuda._sleep(1)
            fns[k]()
        torch.cuda._sleep(1)
        fns[labels[-1]]()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    segments, cur = [], None
    for a, b, name in spans:
        if "spin_kernel" in name:
            if cur is not None:
                segments.append(cur)
            cur = []
        elif cur is not None:
            cur.append((a, b))
    if len(segments) != len(labels):
        fail(f"device_ops: the trace split into {len(segments)} calls, not {len(labels)} "
             f"({len(spans)} device events, segments of {[len(s) for s in segments]})")
    return {k: (len(seg), union_us(seg) / 1e3) for k, seg in zip(labels, segments)}


def profile_path(prob, config, torch, label, wall_s, fix=None):
    """One ``optimize(ITERS)`` of a fresh graph under ``torch.profiler``
    (device activity only): the device kernels and copies per damped
    attempt, the union of their device intervals, that union's share of
    the profiled wall and of ``wall_s`` (the same run's wall unprofiled),
    and the five kernels with the most device time.  Logged, not gated;
    an error of the run (a kernel's included) ends the smoke test."""
    ba = make_graph(prob, config, fix)
    ba.initialize()
    profile_optimize(ba, torch, label, wall_s)


def profile_optimize(ba, torch, label, wall_s):
    """:func:`profile_path`'s profiled ``optimize(ITERS)`` of an
    initialized graph, from its engine's initial state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ba._state = ba._engine.state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ba.optimize(ITERS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        attempts = ba.last_result.nattempts
        # the trace can miss a session's last events (see device_ops): an
        # untimed tail run after a mark takes the loss
        torch.cuda._sleep(1)
        ba.optimize(ITERS)
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    marks = [i for i, (_a, _b, name) in enumerate(events) if "spin_kernel" in name]
    if not marks:
        fail(f"profile ({label}): the trace lost the mark after the run")
    events = events[:marks[0]]
    spans = [(a, b) for a, b, _name in events]
    if not spans:
        log(f"profile ({label}): the profiler saw no device activity: not measured")
        return
    busy_us = union_us(spans)
    by_name = {}
    for a, b, name in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # the hand-written kernels' share, by the CUDA sources' kernel names
    # ("segsum_": segsum_csr and its zero fill)
    shares = {k: sum(us for name, us in by_name.items() if k in name) / busy_us
              for k in ("segsum_", "gather_cols")}
    ours = sum(us for name, us in by_name.items() if any(k in name for k in HAND_KERNELS))
    log(f"profile ({label}): {len(spans)} device kernels and copies over {attempts} attempts "
        f"({len(spans) / attempts:.1f} per attempt); device busy {busy_us / 1e3:.4f} ms of "
        f"{wall_ms:.4f} ms profiled wall ({busy_us / 10 / wall_ms:.1f}% busy) and of "
        f"{1e3 * wall_s:.4f} ms unprofiled ({busy_us / 10 / (1e3 * wall_s):.1f}% busy); "
        f"hand-written kernels {100 * ours / busy_us:.1f}% of busy ("
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items()) + "); top: "
        + "; ".join(f"{name[:60]} {us / 1e3:.4f} ms ({100 * us / busy_us:.1f}%)"
                    for name, us in top))


def check_v1_kernels(engine, torch, segmm):
    """Phase 11: kernels 1-7 at the v1 engine's call sites (the combine at
    both of its sites) and ``band_transpose`` on the first attempt's block
    table, bit for bit, beside the permuted copy.  Returns (entries, the
    attempt's (HppT, HplT, lam, W))."""
    from cuba_tpu_torch.solver import rows

    plan, rc = engine.plan, engine.rc
    HppT, HplT, lam, W, _bscT = roofline.first_attempt(engine)
    out = check_schur_kernels(engine, torch, segmm, HplT, W)
    PB = plan.pad_blocks
    m4 = rows.dense_block_table(W, HplT, plan, rc)
    m4.diagonal(dim1=1, dim2=2).add_(rows.damped_diagonal_T(HppT, lam, engine.num_p, PB))
    n_occ = int((rc.occ > 0).sum())
    log(f"band_transpose at PB {PB}: {n_occ} of {rc.occ.numel()} 64x128-block tiles occupied")
    nbytes = m4.element_size() * (36 * PB * PB + n_occ * 36 * 64 * 128) + 4 * rc.occ.numel()
    out.update(compare_cases({"band_transpose": (
        "exact", lambda f: f(m4, rc.occ, PB), segmm.band_transpose, segmm.band_transpose_plain,
        (nbytes, 0),
        lambda: m4.view(6, 6, PB, PB).permute(2, 0, 3, 1).reshape(6 * PB, 6 * PB).contiguous(),
    )}, torch, None, engine.dtype))
    return out, (HppT, HplT, lam, W)


def compare_formations(engine, attempt, torch):
    """The v1 engine's dense Schur matrix against the v2 formation's (gate
    open) of the same structure, on one attempt's tensors."""
    from cuba_tpu_torch.solver import rows

    HppT, HplT, lam, W = attempt
    plan2, rc2 = rows.plan_rows(engine.structure, engine.device, torch.float32,
                                pad_blocks=engine.pad_blocks, dense=True)
    if plan2 is None or not plan2.v2 or plan2.hpl_pad != engine.plan.hpl_pad:
        fail("the gate-open plan of the v1 graph is not a v2 plan of the same widths")
    A1 = rows.schur_dense(HppT, W, HplT, lam, engine.num_p, engine.plan, engine.rc)
    A2 = rows.schur_dense(HppT, W, HplT, lam, engine.num_p, plan2, rc2)
    diff, scale = float((A1 - A2).abs().max()), float(A2.abs().max())
    log(f"v1 vs v2 dense Schur matrix (n {A1.shape[0]}): max abs diff {diff:.3e}, max |A| "
        f"{scale:.3e}, bit-equal {bool(torch.equal(A1, A2))} (bound {FORMATION_RTOL} max |A|)")
    if not diff <= FORMATION_RTOL * scale:
        fail("the v1 and v2 dense Schur matrices disagree")


def time_woodbury(engine, torch):
    """Phase 12: the first attempt's band + Woodbury solve, timed beside the
    plain CR solve of the same band."""
    from cuba_tpu_torch.solver import band_cr, rows

    plan, rc, P = engine.plan, engine.rc, engine.num_p
    HppT, HplT, lam, W, bscT = roofline.first_attempt(engine)
    D, U, Vob = rows.schur_band(HppT, W, HplT, lam, P, plan, rc, with_ob=True)
    rhs = bscT.new_zeros(6 * plan.pad_blocks)
    rhs[:6 * P] = bscT.T.reshape(-1)
    refine = max(engine.config.refinement_steps, 1)
    x, ok, _ = band_cr.cr_solve_woodbury(D, U, rhs, Vob, *engine.lr_dev, refine)
    if not bool(ok):
        fail("cr_solve_woodbury rejected the first attempt")
    ms = cuda_ms(lambda: band_cr.cr_solve_woodbury(D, U, rhs, Vob, *engine.lr_dev, refine),
                 torch)
    cr_ms = cuda_ms(lambda: band_cr.cr_solve(D, U, rhs, refine), torch)
    log(f"band_lr first attempt: {Vob.shape[0]} out-of-band blocks, |J| "
        f"{engine.lr_dev[2].numel() // 6}; cr_solve_woodbury {ms:.4f} ms, cr_solve of the band "
        f"alone {cr_ms:.4f} ms ({refine} refinement sweep)")


def check_aos_kernels(engine, torch, segmm):
    """Phase 13: the segment-sum kernel against its plain version at two of
    the AoS path's call sites: the pose sums of the mono terms (Hpp with bp)
    and the per-block sums of the triplet products in ``assemble_dense``."""
    from cuba_tpu_torch.solver import assembly, schur

    st, sc, P = engine.state, engine.sc, engine.num_p
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    Hpp, bp, Hll, bl, Hpl = engine._build(pack_m, pack_s, st)
    lam = engine.config.tau * assembly.max_diagonal(Hpp, Hll)
    _inv, W, _bsc = schur.prepare_factors(bp, assembly.damp(Hll, lam), bl, Hpl, sc, P)
    ec, (err, Xc) = engine.edges[0], pack_m
    Hpp_e, bp_e, *_ = assembly.quadratic_form_terms(st.qs, engine.cams, err, Xc, ec, 2,
                                                    engine.kernels[0])
    v42 = torch.cat([Hpp_e.reshape(-1, 36), bp_e], 1).T.contiguous()
    prod = schur.triplet_products(W, Hpl, sc)
    n_hsc = sc.hsc_row.shape[0]
    sites = {
        "segsum:pose": (v42, ec.pose_idx, P, ec.csr_pose),
        "segsum:triplets": (prod, sc.mul_k, n_hsc, sc.csr_mul),
    }
    cases = {label: site_case(roofline.Site("segsum", (vals, ids, num_out), dict(csr=csr),
                                            "segsum", (vals, ids, num_out, csr)), segmm, torch)
             for label, (vals, ids, num_out, csr) in sites.items()}
    return compare_cases(cases, torch, lambda *kind: segsum_bound(segmm, *kind), engine.dtype)


def compare_solvers(chis, chis_dense, label):
    """band_lr against dense_cholesky on one graph: SOLVER_RTOL per
    iteration, and the final chi² within CHI2_REL_BAND."""
    n = min(len(chis), len(chis_dense))
    if n < 2:
        fail(f"{label}: trajectories too short: {len(chis)} and {len(chis_dense)}")
    rel = np.abs(chis[:n] - chis_dense[:n]) / np.abs(chis_dense[:n])
    final = abs(chis[-1] - chis_dense[-1]) / abs(chis_dense[-1])
    log(f"{label}: band_lr vs dense_cholesky chi2: max rel diff {rel.max():.3e} "
        f"(rtol {SOLVER_RTOL}), final rel diff {final:.3e} (band {CHI2_REL_BAND})")
    if not (np.all(rel <= SOLVER_RTOL) and final <= CHI2_REL_BAND):
        fail(f"{label}: band_lr and dense_cholesky trajectories disagree")


def compare_trajectories(chis, chis_ref, label, what="kernel vs plain", rtol=TRAJ_RTOL):
    n = min(len(chis), len(chis_ref))
    if n < 2 or len(chis) != len(chis_ref):
        fail(f"{label}: trajectories differ in length: {len(chis)} vs {len(chis_ref)}")
    rel = np.abs(chis[:n] - chis_ref[:n]) / np.abs(chis_ref[:n])
    log(f"{label}: {what} chi2: max rel diff {rel.max():.3e} (rtol {rtol})")
    if not np.all(rel <= rtol):
        fail(f"{label}: {what} chi2 trajectories disagree")


def structure_diffs(a, b):
    """The BAStructure fields in which two structures differ (arrays bit
    for bit)."""
    from cuba_tpu_torch.solver import structure

    def arrays(s):
        out = {}
        for f in dataclasses.fields(structure.BAStructure):
            v = getattr(s, f.name)
            if isinstance(v, structure.EdgeArrays):
                for g in ("measurements", "omegas", "pose_idx", "lm_idx"):
                    out[f"{f.name}.{g}"] = getattr(v, g)
            elif f.name == "schur_native" and v is not None:
                out.update({f"schur_native[{k}]": x for k, x in enumerate(v)})
            else:
                out[f.name] = v
        return out

    x, y = arrays(a), arrays(b)
    return sorted(k for k in set(x) | set(y)
                  if k not in x or k not in y
                  or not np.array_equal(np.asarray(x[k]), np.asarray(y[k])))


def check_public_api(prob, config, plain_chis, torch, segmm, tmp, card):
    """Phase 14: the public API at the main path's full width.  Returns the
    path of the JSON graph it wrote."""
    from cuba_tpu_torch.io import json_io
    from cuba_tpu_torch.solver import structure
    from cuba_tpu_torch.solver.engine import LOOP_PHASES, PROFILE_ITEMS

    src = make_graph(prob, config)
    path = os.path.join(tmp, "kitti00_loop.json")
    t0 = time.perf_counter()
    json_io.write_graph(src, path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba = json_io.read_graph(path, config)
    t_read = time.perf_counter() - t0
    set_huber(ba)
    log(f"json round trip (kitti00 loop, {os.path.getsize(path) / 1e6:.1f} MB): write "
        f"{t_write:.4f} s, read {t_read:.4f} s")
    s_src = structure.build_structure(sorted(src._poses), src._poses, sorted(src._landmarks),
                                      src._landmarks, src._mono_edges, src._stereo_edges)
    del src

    # optimize(ITERS, profile=True) from a fresh initialize(), counted
    segmm.reset_launches()
    ba.initialize()
    diffs = structure_diffs(s_src, ba._engine.structure)
    if diffs:
        fail(f"the JSON round trip changed the structure: {diffs}")
    del s_src
    t0 = time.perf_counter()
    ba.optimize(ITERS, profile=True)
    torch.cuda.synchronize()
    t_prof = time.perf_counter() - t0
    launches = dict(segmm.LAUNCHES)
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    prof = dict(ba.time_profile())
    log(f"profiled kitti00: optimize({ITERS}, profile=True) {t_prof:.4f} s, attempts "
        f"{ba.last_result.nattempts}, final_lambda {ba.last_result.final_lambda:.6e}; "
        f"chi2 {chis.tolist()}")
    log(f"profiled kitti00 phases (s): {json.dumps(prof)}")
    log(f"launches (profiled kitti00): {json.dumps(launches)}")
    if chis.size == 0 or not np.all(np.isfinite(chis)):
        fail(f"profiled kitti00: chi2 not finite: {chis.tolist()}")
    ref = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
    rel = abs(chis[-1] - ref) / ref
    log(f"profiled kitti00 final chi2 {chis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e}")
    if not rel < CHI2_REL_BAND:
        fail("profiled kitti00 final chi2 is outside the recorded fp64 band")
    compare_trajectories(chis, plain_chis, "kitti00", "profiled vs plain")
    if tuple(prof) != PROFILE_ITEMS:
        fail(f"profiled kitti00: profile keys {list(prof)}")
    zero = {k for k, v in prof.items() if not v > 0}
    if zero != {"4: Schur Complement", "5: Symbolic Decomposition"}:
        fail(f"profiled kitti00: the phases at 0 are {sorted(zero)}, expected 4 and 5")
    if ba.attributed_phases():
        fail(f"profiled kitti00: attributed phases {ba.attributed_phases()}")
    missing = sorted(n for n in engine_kernels(ba._engine) if launches[n] == 0)
    if missing:
        fail(f"kernels of the profiled kitti00 run never launched: {missing}")

    # plain runs from the same start, phase marks on and off in turns
    fused = "optimize (fused device loop)"
    modes = {"on": dataclasses.replace(config, phase_attribution=True),
             "off": dataclasses.replace(config, phase_attribution=False)}

    def plain_run(mode):
        ba.config = modes[mode]
        ba._state = ba._engine.state
        ba.optimize(ITERS)
        torch.cuda.synchronize()

    walls = {"on": [], "off": []}
    for _ in range(3):
        for mode in modes:
            before = dict(ba.time_profile())
            t0 = time.perf_counter()
            plain_run(mode)
            wall = time.perf_counter() - t0
            after = ba.time_profile()
            total = after[fused] - before.get(fused, 0.0)
            parts = {k: after[k] - before[k] for k in LOOP_PHASES}
            walls[mode].append(total)
            log(f"plain kitti00, phase marks {mode}: optimize({ITERS}) {total:.4f} s ({wall:.4f} "
                f"s with the write-back), attempts {ba.last_result.nattempts}; phases (s) "
                + ", ".join(f"{k} {v:.6f}" for k, v in parts.items()))
            if mode == "on":
                if not (abs(sum(parts.values()) - total) <= 1e-6 * total
                        and all(v > 0 for v in parts.values())):
                    fail(f"the phase split of a plain run does not sum to its wall {total}")
            elif any(parts.values()):
                fail("a plain run with phase_attribution=False added phase times")
    log(f"plain kitti00 walls ({card}): marks on {walls['on']}, off {walls['off']}")
    ops = device_ops({mode: lambda mode=mode: plain_run(mode) for mode in modes}, torch)
    ba.time_profile()
    for mode, (n_ops, busy) in ops.items():
        log(f"plain kitti00, phase marks {mode}, under torch.profiler: {n_ops} device kernels "
            f"and copies over {ba.last_result.nattempts} attempts "
            f"({n_ops / ba.last_result.nattempts:.1f} per attempt), device busy {busy:.4f} ms")
    if ops["on"][0] != ops["off"][0]:
        fail(f"the phase marks changed the device operations: {ops}")

    # checkpoint: save after optimize(5), restore into a fresh graph of the same ids
    ba.optimize(5)
    ck = os.path.join(tmp, "kitti00_loop.npz")
    ba.save_checkpoint(ck)
    saved = [(s.iteration, s.chi2) for s in ba.batch_statistics()]
    del ba
    fresh = make_graph(prob, config)
    fresh.load_checkpoint(ck)
    if [(s.iteration, s.chi2) for s in fresh.batch_statistics()] != saved:
        fail("load_checkpoint did not restore the batch statistics")
    fresh.initialize()
    data = np.load(ck)
    st = fresh._engine.state
    for key, ids, table, vertex, idx in (
            ("qs", "pose_ids", st.qs, fresh.pose_vertex, "iP"),
            ("ts", "pose_ids", st.ts, fresh.pose_vertex, "iP"),
            ("Xws", "lm_ids", st.Xws, fresh.landmark_vertex, "iL")):
        vs = [vertex(int(i)) for i in data[ids]]
        keep = np.array([bool(v.edges) for v in vs])  # the structure holds these
        rows = torch.tensor([getattr(v, idx) for v, k in zip(vs, keep) if k],
                            device=table.device)
        want = torch.from_numpy(data[key][keep].astype(np.float32)).to(table.device)
        if not torch.equal(table[rows], want):
            fail(f"the restored engine state {key} differs from the checkpoint's")
    fresh.optimize(5)
    rchis = np.array([s.chi2 for s in fresh.batch_statistics()])
    log(f"checkpoint: saved chi2 {[c for _, c in saved]}, resumed optimize(5) chi2 "
        f"{rchis.tolist()}")
    if not (rchis.size and np.all(np.isfinite(rchis)) and np.all(np.diff(rchis) <= 0)
            and rchis[-1] <= saved[-1][1]):
        fail("the resumed run rose above the checkpoint's last chi2")

    # chi_squared on the card, queried after one remove_edge
    edges = list(fresh._mono_edges) + list(fresh._stereo_edges)
    want = fresh._engine.chi_squares(fresh._state)
    fresh.remove_edge(edges[0])
    got = np.array([fresh.chi_squared(e) for e in edges])
    log(f"chi_squared: {got.size} edges, max {got.max():.4f}, edge 1 {got[1]!r} (engine "
        f"{want[1]!r}) after remove_edge of edge 0")
    if not (got.size == want.size and np.all(np.isfinite(got)) and np.all(got >= 0)
            and np.array_equal(got, want)):
        fail("chi_squared differs from the engine's per-edge chi2 in the caller's order")
    return path


def run_samples(samples):
    """Samples as subprocesses on the card, all started together
    (``samples``: [(module name, args, label)]); each one's printed chi2
    lines must be finite and fall.  None is left running."""
    t0 = time.perf_counter()
    procs = []
    try:
        for name, args, label in samples:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            procs.append((label, out, err, subprocess.Popen(
                [sys.executable, "-m", f"cuba_tpu_torch.samples.{name}", *args], cwd=HERE,
                stdout=out, stderr=err, text=True)))
        for label, out, err, proc in procs:
            try:
                proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"sample {label}: still running after 600 s")
            log(f"sample {label}: exit {proc.returncode} in {time.perf_counter() - t0:.2f} s "
                f"(the {len(procs)} started together)")
            out.seek(0)
            err.seek(0)
            lines = out.read().splitlines()
            for line in lines:
                log(f"  | {line}")
            if proc.returncode != 0:
                fail(f"sample {label} failed:\n{err.read()[-4000:]}")
            chis = [float(x.split("=")[1]) for x in lines
                    if x.startswith("iter ") and "chi2 =" in x]
            if not chis:  # the comparison's table: "i | port | oracle | rel"
                chis = [float(x.split("|")[1]) for x in lines
                        if x.strip()[:1].isdigit() and "|" in x]
            chis = np.array(chis)
            if chis.size < 2 or not np.all(np.isfinite(chis)) or not np.all(np.diff(chis) <= 0):
                fail(f"sample {label}: chi2 lines not finite and falling: {chis.tolist()}")
    finally:
        for _label, out, err, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def check_bal(path, config, torch, segmm, card):
    """Phase 15's BAL path.  Returns (kernel entries, launches, attempts)."""
    bba, _chis, _ti, bt_opt0 = run_path(path, config, torch, "bal warm-up")
    engine = bba._engine
    log(f"bal: {engine.num_p} free cameras, {engine.num_l} free points, PB "
        f"{engine.pad_blocks}, solver {engine.solver}, route {engine.path}")
    if (engine.solver, engine.path) != ("dense_cholesky", "v2"):
        fail(f"bal: solver='auto' took {engine.solver!r} on {engine.path!r}, "
             "expected dense_cholesky on v2")
    kern = check_dense_kernels(engine, torch, segmm, "bal")
    del bba, engine
    bba, bchis, bt_opt, launches = counted_run(path, config, torch, segmm, "bal path", "v2")
    attempts, nedges = bba.last_result.nattempts, bba.nedges()
    profile_optimize(bba, torch, "bal path", bt_opt)
    del bba
    if not (np.all(np.diff(bchis) <= 0) and bchis[-1] < 0.6 * bchis[0]):
        fail(f"bal: no real descent: {bchis.tolist()}")
    cuba_record(bchis, "ladybug49_bal", nedges, "bal", CHI2_REL_BAND, final_only=True)
    log(f"bal walls ({card}): optimize({ITERS}) {bt_opt} s (cold {bt_opt0} s)")
    return kern, launches, attempts


def check_oracle(torch):
    """sample_comparison_with_reference's graph in process: the card's fp32
    trajectory against the port's fp64 oracle, TRAJ_RTOL per iteration."""
    from cuba_tpu_torch import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.reference.solver import RefProblem, ReferenceSolver

    ba = make_graph(synthetic.generate(num_poses=20, num_landmarks=300, seed=0),
                    BAConfig(dtype=torch.float32, device="cuda"))
    ba.initialize()
    ref = ReferenceSolver(RefProblem.from_structure(ba._engine.structure, ba._kernels))
    ba.optimize(ITERS)
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    compare_trajectories(chis, np.array(ref.optimize(ITERS)), "20 x 300",
                         "card fp32 vs fp64 oracle")


def record_gate(chis, ref, label, rtol, final_only=False):
    """A run's chi² per iteration against a recorded fp64 trajectory
    ``ref``, the per-iteration relative differences logged: the run must be
    as long as ``ref`` and lie within ``rtol`` of it at every iteration, or
    with ``final_only`` at the last one (``rtol`` None: logged only)."""
    rel = parity_records.rel_diff(chis, ref)
    log(f"{label}: chi2 per iteration: max rel diff {rel.max():.3e}, final {rel[-1]:.3e} "
        f"(rtol {rtol}{', final' if final_only else ''}); {[float(f'{x:.3e}') for x in rel]}")
    held = rel[-1:] if final_only else rel
    if rtol is not None and not (len(chis) == len(ref) and np.all(held < rtol)):
        fail(f"{label}: the trajectory left the record")


def fp64_records(chis, graph, label, gate=True):
    """``record_gate`` against the recorded fp64 trajectory of ``graph``
    (CHI2_FP64_TRAJECTORY) at CHI2_FP64_RTOL; without ``gate`` logged only."""
    record_gate(chis, np.array(CHI2_FP64_TRAJECTORY[graph]),
                f"{label} vs the fp64 record of {graph}", CHI2_FP64_RTOL if gate else None)


def cuba_record(chis, name, nedges, label, rtol, final_only=False, iters=ITERS):
    """``record_gate`` against the first ``iters`` iterations of
    ``cuba_tpu``'s fp64 record of entry ``name`` of
    ``docs/_parity_torch_cuba_fp64.json`` (``parity_records.reference``: a
    missing record, or one made from other parameters, edges or file
    bytes, ends the run)."""
    try:
        ref = parity_records.reference(name, nedges)
    except ValueError as e:
        fail(f"{label}: {e}")
    record_gate(chis, ref[:iters], f"{label} vs cuba_tpu's fp64 record {name!r}", rtol,
                final_only)


def fp64_run(prob, config, torch, segmm, label, expect, check, graph=None,
             iters=ITERS, fix=None):
    """Phase 16's run of one path in fp64: a warm-up run, on whose engine
    ``check(engine)`` holds the fp64 kernels to their fp64 plain versions
    at the path's call sites; then the counted run (:func:`counted_run`):
    the engine's attributes as ``expect`` says ({name: value}), every launch
    an fp64 one, and with ``graph`` every iteration within CHI2_FP64_RTOL
    of its record and the run's profile (:func:`profile_optimize`).
    Returns (kernel entries, launches, chis, warm wall, attempts)."""
    wba, _chis, _ti, t_cold = run_path(prob, config, torch, f"{label} warm-up", fix, iters)
    got = {k: getattr(wba._engine, k) for k in expect}
    if got != expect:
        fail(f"{label}: the engine took {got}, expected {expect}")
    kern = check(wba._engine)
    del wba
    ba, chis, t_opt, launches = counted_run(prob, config, torch, segmm, f"{label} path",
                                            expect["path"], fix, iters)
    attempts = ba.last_result.nattempts
    f64 = dict(segmm.LAUNCHES_F64)
    log(f"fp64 launches ({label}): {json.dumps(f64)}")
    if f64 != launches:
        fail(f"{label}: launches other than the fp64 builds: {launches} against {f64}")
    if graph is not None:
        fp64_records(chis, graph, label)
        profile_optimize(ba, torch, label, t_opt)
    del ba
    log(f"{label}: optimize({iters}) {t_opt} s (cold {t_cold} s)")
    return kern, launches, chis, t_opt, attempts


def fp64_against_plain(prob, config, torch, label, chis, iters):
    """A phase 16 fp64 run against the same run with the plain versions on
    the card: FP64_PLAIN_RTOL per iteration."""
    from cuba_tpu_torch.ops import segmm

    with segmm.use_plain():
        _p, plain, _ti, t_plain = run_path(prob, config, torch, f"{label} plain", iters=iters)
    del _p
    compare_trajectories(chis, plain, label, "fp64 kernel vs fp64 plain", FP64_PLAIN_RTOL)
    return t_plain


# phase 17: the landmark-sharded LM (cuba_tpu_torch/parallel/)
MESH_RANKS = 4
MESH_TIMEOUT = 600.0  # seconds before every spawned rank is killed


def mesh_one_rank(kprob, kconfig, kchis, torch, segmm):
    """Phase 17a: the kitti00 loop through ``BAConfig(mesh=<a one-rank
    NCCL group>)`` in this process, counted: ``band_cr`` with 22 CR blocks
    on the rows route (v2), every kernel of the route launched, and the
    trajectory phase 5's bit for bit; then one single-device run and one
    more mesh run in turns for the walls.  Returns (the global structure,
    its robust kernels, the counted launches)."""
    with graphs.one_rank_group("cuda") as group:
        mconfig = dataclasses.replace(kconfig, mesh=group)
        ba, chis, t_opt, launches = counted_run(kprob, mconfig, torch, segmm,
                                                "mesh S=1 (nccl) path", "v2")
        eng = ba._engine
        if (eng.solver, eng.band_m) != ("band_cr", KITTI_BAND_M):
            fail(f"mesh S=1: {eng.solver!r} with band_m {eng.band_m}, expected band_cr / "
                 f"{KITTI_BAND_M}")
        if not np.array_equal(chis, kchis):
            fail(f"mesh S=1: the trajectory is not phase 5's bit for bit: {chis.tolist()} "
                 f"against {kchis.tolist()}")
        structure, kernels = eng.structure, ba._kernels
        del ba, eng
        _b, _c, _ti, t_single = run_path(kprob, kconfig, torch, "single-device, in turns")
        _m, mchis, _ti, t_mesh = run_path(kprob, mconfig, torch, "mesh S=1, in turns")
        del _b, _m
        if not np.array_equal(mchis, kchis):
            fail("mesh S=1: the second run left phase 5's trajectory")
        profile_path(kprob, mconfig, torch, "mesh S=1 (nccl) path", t_opt)
    log(f"mesh S=1 (nccl) walls: optimize({ITERS}) {t_opt} s and {t_mesh} s against the "
        f"single-device {t_single} s between them; trajectory equal to phase 5's bit for bit")
    return structure, kernels, launches


def mesh_cases(kprob, cprob, dprob, prob, astructure, akernels, torch):
    """Phase 17b's cases: the graphs of phases 5, 12, 8 and 3 through the
    public API with ``BAConfig(mesh=group)``, and phase 13's structure
    through ``MultiChipSolverAdapter`` on the AoS body, each with its
    expected (path, solver, band_m)."""
    f32, f64 = torch.float32, torch.float64
    cases = {
        "loop": (kprob, dict(dtype=f32), ITERS, ("v2", "band_cr", KITTI_BAND_M)),
        "loop-fp64": (kprob, dict(dtype=f64), ITERS, ("v2", "band_cr", KITTI_BAND_M)),
        "2chords": (cprob, dict(dtype=f32), ITERS, ("v2", "band_lr", 0)),
        "kitti07": (dprob, dict(dtype=f32), ITERS, ("v2", "dense_cholesky", 0)),
        "pcg4096": (prob, dict(dtype=f32, solver="pcg"), FP64_SHORT_ITERS, ("rows", "pcg", 0)),
    }
    expect = {name: e for name, (_p, _c, _i, e) in cases.items()}
    out = [dict(name=name, kind="api", problem=p, config=cfg, iters=iters, per_edge=False,
                trace=name == "loop")
           for name, (p, cfg, iters, _e) in cases.items()]
    # the three-chord graph's shards plan (phase 13 closes the planner on
    # one device): the case asks for the AoS body, as phase 11 closes the
    # v2 gate
    out.append(dict(name="3chords", kind="engine", structure=astructure, kernels=akernels,
                    config=dict(dtype=f32), iters=FP64_SHORT_ITERS, aos=True))
    expect["3chords"] = ("aos", "dense_cholesky", 0)
    return out, expect


def mesh_ranks(cases, expect, refs, torch):
    """Phase 17b: MESH_RANKS ranks on the card over gloo, spawned (each on
    cuda:0; a rank's failure or MESH_TIMEOUT fails the run).  Every rank's
    trajectory and estimates must equal every other rank's bit for bit,
    each case take its expected route and solver and launch every kernel
    of it on every rank, and meet its gate against ``refs``.  Returns rank
    0's results."""
    from cuba_tpu_torch.parallel import drive, launch

    t0 = time.perf_counter()
    try:
        res = launch.spawn(drive.run_cases, MESH_RANKS, backend="gloo", device="cuda",
                           timeout=MESH_TIMEOUT, args=(cases,))
    except (RuntimeError, TimeoutError) as e:
        fail(f"mesh ranks: {e}")
    log(f"mesh: {MESH_RANKS} ranks on one card over gloo, {time.perf_counter() - t0:.2f} s "
        "(four processes share the card; gloo stages every collective through the host)")
    for r, out in enumerate(res):
        if out["modules"].size:
            fail(f"mesh rank {r} imported {out['modules'].tolist()}")
    for case in cases:
        name = case["name"]
        r0 = res[0]
        keys = ("chis", "pose_t", "pose_q", "lm_Xw") if case["kind"] == "api" else (
            "chis", "qs", "ts", "Xws")
        for k in keys:
            if not all(np.array_equal(out[f"{name}.{k}"], r0[f"{name}.{k}"]) for out in res):
                fail(f"mesh {name}: the ranks' {k} differ")
        got = (str(r0[f"{name}.path"]), str(r0[f"{name}.solver"]), int(r0[f"{name}.band_m"]))
        if got[:2] != expect[name][:2] or (expect[name][2] and got[2] != expect[name][2]):
            fail(f"mesh {name}: took {got}, expected {expect[name]}")
        for r, out in enumerate(res):
            launched = dict(zip(drive.LAUNCH_NAMES, out[f"{name}.launches"].tolist()))
            facts = {k[len(name) + 1:]: v for k, v in out.items() if k.startswith(f"{name}.")}
            missing = sorted(n for n in expected_kernels(facts) if launched[n] == 0)
            if missing:
                fail(f"mesh {name}: rank {r} never launched {missing}")
        chis = r0[f"{name}.chis"]
        log(f"mesh {name}: {got}, initialize {[float(o[f'{name}.init_wall']) for o in res]} s, "
            f"optimize({case['iters']}) {[float(o[f'{name}.wall']) for o in res]} s, attempts "
            f"{int(r0[f'{name}.nattempts'])}; chi2 {chis.tolist()}; launches (rank 0) "
            + json.dumps(dict(zip(drive.LAUNCH_NAMES, r0[f"{name}.launches"].tolist()))))
        if not (np.all(np.isfinite(chis)) and chis[-1] < chis[0]):
            fail(f"mesh {name}: chi2 not finite and falling")
        refs[name](chis)
        if case.get("trace"):
            for r, out in enumerate(res):
                spans = list(zip(out[f"{name}.trace_start"], out[f"{name}.trace_end"]))
                wall_ms = 1e3 * float(out[f"{name}.trace_wall"])
                busy = union_us(spans) / 1e3
                log(f"profile (mesh {name}, rank {r}): {len(spans)} device kernels and copies "
                    f"over {int(out[f'{name}.trace_attempts'])} attempts; device busy "
                    f"{busy:.4f} ms of {wall_ms:.4f} ms profiled wall "
                    f"({100 * busy / wall_ms:.1f}% busy)")
    return res[0]


def mesh_gates(kchis, cchis, dchis, chis_pcg, achis):
    """Phase 17b's gate of each case, on rank 0's trajectory."""
    def loop(chis):
        ref = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
        rel = abs(chis[-1] - ref) / ref
        log(f"mesh loop: final chi2 {chis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e}")
        if not rel < CHI2_REL_BAND:
            fail("mesh loop: the final chi2 is outside the recorded fp64 band")
        compare_trajectories(chis, kchis, "mesh loop", "4 ranks vs single-device (phase 5)")

    def kitti07(chis):
        ref = CHI2_FP64_FINAL[("kitti07_scale", ITERS)]
        rel = abs(chis[-1] - ref) / ref
        log(f"mesh kitti07: final chi2 {chis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e}")
        if not rel < CHI2_REL_BAND:
            fail("mesh kitti07: the final chi2 is outside the recorded fp64 band")

    return {
        "loop": loop,
        "loop-fp64": lambda chis: fp64_records(chis, "kitti00_scale_loop", "mesh loop-fp64"),
        "2chords": lambda chis: compare_trajectories(chis, cchis, "mesh 2chords",
                                                     "4 ranks vs single-device (phase 12)"),
        "kitti07": kitti07,
        "pcg4096": lambda chis: compare_trajectories(
            chis, chis_pcg[:FP64_SHORT_ITERS], "mesh pcg4096", "4 ranks vs phase 3"),
        "3chords": lambda chis: compare_trajectories(
            chis, achis[:FP64_SHORT_ITERS], "mesh 3chords",
            "4 ranks (AoS, dense_cholesky) vs phase 13 (band_lr)", SOLVER_RTOL),
    }


def check_mesh_kernels(structure, kernels, config, torch, segmm):
    """Phase 17c: the kernels at a shard's sites.  Rank 0's shard of
    MESH_RANKS (``rows_shard.shard_structures``) planned as the ranks plan
    it, in this process: kernels 1-7 at the call sites of
    :func:`check_schur_kernels` on its tables and first-attempt tensors,
    and ``compact_to_band`` on the table the all-reduce delivers: the sum
    of every shard's compact table at the first attempt's global lambda
    and damped diagonal."""
    from cuba_tpu_torch.parallel import rows_shard
    from cuba_tpu_torch.solver import engine as engine_mod
    from cuba_tpu_torch.solver import rows

    shards = rows_shard.shard_structures(structure, MESH_RANKS)
    engines = [engine_mod.BlockSolverEngine(sh, kernels, config) for sh in shards]
    if any(e.path != "v2" for e in engines):
        fail(f"mesh shards: routes {[e.path for e in engines]}, expected v2")
    systems = [e._build(*e._residuals_and_chi(e.state)[:2]) for e in engines]
    HppT = sum(s[0] for s in systems)
    lam = config.tau * torch.stack([rows.max_diagonal_T(HppT, s[1]) for s in systems]).max()
    Ws = [rows.prepare_factors(HppT, HllT, HplT, lam, e.num_p, e.rc)[1]
          .contiguous() for e, (_h, HllT, HplT) in zip(engines, systems)]
    e0 = engines[0]
    log(f"mesh shard 0 of {MESH_RANKS}: L {e0.num_l}, slots {e0.structure.n_hpl}, "
        f"mono edges {e0.structure.mono.count}, triplets {e0.structure.mul_i.shape[0]}")
    out = check_schur_kernels(e0, torch, segmm, systems[0][2], Ws[0])
    gT = sum(rows.schur_compact(W, s[2], e.plan, e.rc) for W, s, e in zip(Ws, systems, engines))
    dbT = rows.damped_diagonal_T(HppT, lam, e0.num_p, e0.plan.pad_blocks)
    out.update(compare_cases({"compact_to_band": band_case(gT, dbT, e0, segmm, torch)},
                             torch, None, e0.dtype))
    return out


# phase 18: the large-landmark regime (tools/stress_large_l.py's graph)
STRESS_EDGES = 3_885_457
STRESS_BAND_M = 28
STRESS_PLAIN_ITERS = 5  # the plain run's depth: its first steps against the kernel run's


def stress_cases(engine, torch, segmm):
    """The kernel checks of the stress route at its call sites
    (``roofline.engine_sites``: the gather and the segment sum on the
    engine's initial state, ``schur_fused``, the combine and
    ``compact_to_band`` on its first damped attempt), kept where the route
    launches the kernel (:func:`engine_kernels`), ``edge_terms``
    (:func:`check_edge_terms`) and the Schur factors
    (:func:`check_factors`).  Returns {label: entry}."""
    keep = engine_kernels(engine)
    sites = {k: v for k, v in roofline.engine_sites(engine).items() if v.kernel in keep}
    out = compare_cases({k: site_case(v, segmm, torch) for k, v in sites.items()}, torch,
                        sites_bound(sites, segmm), engine.dtype)
    out.update(check_edge_terms(engine, torch))
    out.update(check_factors(engine, torch))
    return out


def peak_gib(torch) -> str:
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def check_stress(torch, segmm, card):
    """Phase 18: the large-landmark graph through the public API at full
    width.  Returns (kernel entries, launches, attempts)."""
    from cuba_tpu_torch import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.solver.engine import BlockSolverEngine
    from cuba_tpu_torch.tools import stress_large_l

    t0 = time.perf_counter()
    prob = synthetic.generate(**graphs.STRESS)
    n_edges = prob.mono_p.size + prob.stereo_p.size
    log(f"stress: P {graphs.STRESS['num_poses']}, L {graphs.STRESS['num_landmarks']}, "
        f"E {n_edges} "
        f"({prob.stereo_p.size} stereo), tools/stress_large_l.py parameters, seed 0; generate "
        f"{time.perf_counter() - t0:.2f} s")
    if n_edges != STRESS_EDGES:
        fail(f"stress: the generator gave {n_edges} edges, expected {STRESS_EDGES}")
    config = BAConfig(dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    ba = make_graph(prob, config)
    log(f"stress: graph built through the public API in {time.perf_counter() - t0:.2f} s")
    del prob
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ba.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ba._engine
    facts = stress_large_l.plan_facts(engine)
    log(f"stress: initialize {t_init:.4f} s ({json.dumps(dict(ba.time_profile()))}); "
        f"{json.dumps(facts)}; triplets {engine.structure.mul_i.shape[0]}; device memory "
        f"after initialize {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    if (engine.path, engine.solver, engine.band_m) != ("v2", "band_cr", STRESS_BAND_M):
        fail(f"stress: solver='auto' took {engine.path!r} / {engine.solver!r} / m "
             f"{engine.band_m}, expected v2 / band_cr / {STRESS_BAND_M}")

    def run(label, iters=ITERS):
        """optimize(iters) from the engine's initial state, timed; the
        device's peak memory of the run logged."""
        torch.cuda.reset_peak_memory_stats()
        ba._state = engine.state
        t0 = time.perf_counter()
        ba.optimize(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chis = np.array([s.chi2 for s in ba.batch_statistics()])
        r = ba.last_result
        log(f"stress {label}: optimize({iters}) {wall:.4f} s, attempts {r.nattempts}, host "
            f"reads {r.host_reads}, peak device memory {peak_gib(torch)}; chi2 {chis.tolist()}")
        if chis.size == 0 or not np.all(np.isfinite(chis)) or not chis[-1] < chis[0]:
            fail(f"stress {label}: chi2 not finite and falling: {chis.tolist()}")
        return chis, wall, r.nattempts

    _chis, t_cold, _a = run("warm-up (cold)")
    for name, nbytes in stress_large_l.memory_plan(engine):
        log(f"stress memory plan: {name}: {nbytes} B")
    kern = stress_cases(engine, torch, segmm)

    segmm.reset_launches()
    chis, t_opt, attempts = run("path (counted)")
    launches = dict(segmm.LAUNCHES)
    log(f"launches (stress path): {json.dumps(launches)}")
    missing = sorted(n for n in engine_kernels(engine) if launches[n] == 0)
    if missing:
        fail(f"kernels of the stress path never launched: {missing}")
    profile_optimize(ba, torch, "stress path", t_opt)

    with segmm.use_plain():
        plain, t_plain, _a = run("plain path", STRESS_PLAIN_ITERS)
    compare_trajectories(plain, chis[:STRESS_PLAIN_ITERS], "stress",
                         f"plain vs kernel, first {STRESS_PLAIN_ITERS} iterations")

    structure, kernels = engine.structure, ba._kernels
    del ba, engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e64 = BlockSolverEngine(structure, kernels, dataclasses.replace(config, dtype=torch.float64))
    torch.cuda.synchronize()
    t_ctor64 = time.perf_counter() - t0
    r64 = e64.optimize(e64.state, ITERS)
    torch.cuda.synchronize()
    t_opt64 = time.perf_counter() - t0 - t_ctor64
    chis64 = np.asarray(r64.chis, np.float64)
    log(f"stress fp64: {e64.path} / {e64.solver} / m {e64.band_m}, engine "
        f"{t_ctor64:.4f} s, optimize({ITERS}) {t_opt64:.4f} s, attempts {r64.nattempts}, peak "
        f"device memory {peak_gib(torch)}; chi2 {chis64.tolist()}")
    if len(chis64) != len(chis) or not np.all(np.isfinite(chis64)):
        fail(f"stress fp64: trajectory {chis64.tolist()} against fp32 {chis.tolist()}")
    rel = np.abs(chis - chis64) / chis64
    log(f"stress: fp32 vs the card's fp64 run per iteration: max rel {rel.max():.3e} (band "
        f"{CHI2_REL_BAND}), final {rel[-1]:.3e}; {[float(f'{x:.3e}') for x in rel]}")
    if not np.all(rel < CHI2_REL_BAND):
        fail("stress: the fp32 trajectory left the band of the card's fp64 run")
    cuba_record(chis, "stress_1m", n_edges, "stress fp32", CHI2_REL_BAND)
    cuba_record(chis64, "stress_1m", n_edges, "stress fp64", CHI2_FP64_RTOL)
    log(f"stress walls ({card}): initialize {t_init} s; optimize({ITERS}) {t_opt} s (cold "
        f"{t_cold} s), plain optimize({STRESS_PLAIN_ITERS}) {t_plain} s, fp64 {t_opt64} s")
    return kern, launches, attempts


# phase 19: the port's tools on the card (cuba_tpu_torch/tools/)
TOOL_REPS = 3  # rounds of each stage's timing loop
INV_RTOL = 1e-4  # the two CR inverses' solutions, over max |x|
MC_RTOL = 1e-6  # mc_parity's gate
# perf_probe_solve's system is well conditioned (~20 after equilibration):
# refine 0 is at fp32's floor (~5e-7), where a sweep's fp32 residual over n
# terms decides whether refinement lowers the error or raises it (twice
# refine 0's at n = 4096 on the host).  Below this floor a refinement
# sweep may lose to refine 0; above it, it may not.
DENSE_ERR_FLOOR = 1e-5


def check_tools(torch, card, kstructure, kkernels, kconfig, dprob, trajectories):
    """Phase 19: the tools' measurements at full width.  a.
    ``profile_formation``'s formation and CR stages and
    ``profile_crsolve``'s on the kitti00 loop's band_cr engine (m = 22),
    at the JAX tool's λ = 1e-3 (the heading says whether CR accepts the
    band there: where it rejects it, the stages time the rejected solve);
    on the band of the LM's own first attempt the two CR inverses' refine-1 solutions within INV_RTOL of each other,
    and refine 1's residual no worse than refine 0's.  b.
    ``bench_pcg_band_mc``'s measurement on the same engine: every time
    finite.  c. ``bench_multichip_mxu`` on kitti07 through a one-rank NCCL
    group: the rows route's trajectory the single-device one's bit for
    bit.  d. ``mc_parity``'s 8 spawned gloo ranks on the card, kitti07 in
    fp64: within MC_RTOL of the single-device engine.  e.
    ``parity_kitti00``'s table over ``trajectories`` ({shape: (edges, fp32
    chis, the card's fp64 chis)}, against those and CHI2_FP64_TRAJECTORY):
    within its gate at every iteration, written to a temporary file.  f.
    ``perf_probe_solve`` at n = 8448: refine 1 and 2 no less accurate
    than refine 0, or below DENSE_ERR_FLOOR."""
    from cuba_tpu_torch.solver.engine import BlockSolverEngine
    from cuba_tpu_torch.tools import (bench_multichip_mxu, bench_pcg_band_mc, mc_parity,
                                      parity_kitti00, perf_probe_solve, profile_crsolve,
                                      profile_formation)

    t0 = time.perf_counter()
    eng = BlockSolverEngine(kstructure, kkernels, kconfig)
    if (eng.solver, eng.band_m) != ("band_cr", KITTI_BAND_M):
        fail(f"tools: the kitti00 loop engine took {eng.solver!r} / m {eng.band_m}")
    HppT, HplT, lam, W, D, U, rhs = profile_formation.attempt_inputs(eng)
    fns = dict(profile_formation.formation_stages(eng, HppT, HplT, lam, W),
               **profile_formation.cr_stages(D, U, rhs))
    fns.update({f"crsolve: {k}": fn for k, fn in profile_crsolve.stages(D, U, rhs).items()
                if k not in ("factor only", "cr_solve refine=0")})
    times = roofline.stage_times(fns, eng.device, TOOL_REPS)
    roofline.print_stages(times, f"tools a: formation and CR stages (kitti00 loop, m = "
                                 f"{D.shape[0]}, fp32, {card}, "
                                 f"{profile_formation.lam_note(lam, D, U, rhs)})")
    profile_formation.print_marginals(times)
    del D, U, rhs, HppT, HplT, W
    lm = profile_formation.attempt_inputs(eng, None)
    chk = profile_formation.cr_check(*lm[4:])
    res = chk["residual"]
    log(f"tools a: on the LM's first attempt (lambda {float(lm[2]):g}): "
        f"||Ax - b|| / ||b|| " + ", ".join(f"refine {r} {v:.3e}" for r, v in res.items())
        + f"; _inv_spd_rs vs _inv_spd_chol max rel diff {chk['inverses']:.3e} (rtol "
        f"{INV_RTOL}); {time.perf_counter() - t0:.2f} s")
    if not (chk["ok"] and chk["inverses"] < INV_RTOL and res[1] <= res[0]):
        fail(f"tools a: the CR solutions fail their gates: {chk}")
    del lm

    t0 = time.perf_counter()
    m = bench_pcg_band_mc.measure(eng, TOOL_REPS, eng.config.pcg_tol, card)
    timed = 2 if eng.device.type == "cuda" else 1  # the host gives no device ms
    bad = [k for k, v in m["times"].items()
           if not all(x is not None and np.isfinite(x) for x in v[:timed])]
    log(f"tools b: lambda {m['lam']:g}, band solve accepted {m['band_ok']}, n_cg {m['n_cg']}, "
        f"converged {m['converged']}, t_lat "
        f"{m['t_lat']:.4f} ms, "
        f"crossover S = {m['crossover']}; {time.perf_counter() - t0:.2f} s")
    if bad or not np.isfinite(m["t_lat"]):
        fail(f"tools b: times not finite: {bad}, t_lat {m['t_lat']}")
    del eng

    t0 = time.perf_counter()
    dstructure = graphs.structure_of(dprob)
    with graphs.one_rank_group("cuda") as group:
        runs = bench_multichip_mxu.run(dstructure, graphs.KERNELS, kconfig, group, ITERS, 2)
    if not bench_multichip_mxu.report(runs, ITERS, card):
        fail("tools c: the one-rank mesh's rows trajectory is not the single-device one")
    log(f"tools c: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    chis1, wall1 = mc_parity.single(dstructure, torch.float64, "cuda")
    ranks = mc_parity.mesh(dstructure, torch.float64, "cuda")
    rel = mc_parity.max_rel(ranks[0]["mc.chis"], chis1)
    same = all(np.array_equal(r["mc.chis"], ranks[0]["mc.chis"]) for r in ranks)
    walls = [float(r["mc.wall"]) for r in ranks]
    log(f"tools d: {mc_parity.RANKS} gloo ranks on the card, kitti07 fp64, route "
        f"{ranks[0]['mc.path']}: max rel chi2 against the single device {rel:.3e} (rtol "
        f"{MC_RTOL}), ranks equal {same}; single-device {wall1:.2f} s with construction, "
        f"rank optimize({mc_parity.ITERS}) {min(walls):.2f}-{max(walls):.2f} s; "
        f"{time.perf_counter() - t0:.2f} s")
    if not (same and rel < MC_RTOL):
        fail("tools d: the 8-rank fp64 mesh left the single-device trajectory")

    t0 = time.perf_counter()
    sections, ok = [], True
    for shape, (nedges, chis32, chis64) in trajectories.items():
        refs = {"port fp64 (card, phase 16)": chis64,
                "cuba_tpu fp64": CHI2_FP64_TRAJECTORY[shape]}
        rels, shape_ok = parity_kitti00.compare(chis32, refs)
        ok = ok and shape_ok
        sections.append(parity_kitti00.section(shape, nedges, f"fp32 on {card}", chis32, refs,
                                               rels, shape_ok, parity_kitti00.GATE))
        log(f"tools e: {shape}: max rel " + ", ".join(f"{n} {v.max():.3e}"
                                                      for n, v in rels.items()))
    with tempfile.NamedTemporaryFile("w", suffix=".md", delete=False) as f:
        f.write(parity_kitti00.document(sections, ok, "chip_smoke.py phase 19"))
    log(f"tools e: parity table written to {f.name}: {'PASS' if ok else 'FAIL'}; "
        f"{time.perf_counter() - t0:.2f} s")
    os.unlink(f.name)
    if not ok:
        fail("tools e: an fp32 trajectory left its fp64 records' band")

    t0 = time.perf_counter()
    A, b = perf_probe_solve.system(8448, "cuda", torch.float32)
    times = roofline.stage_times(perf_probe_solve.stages(A, b), "cuda", TOOL_REPS)
    roofline.print_stages(times, f"tools f: dense solve stages (n = 8448, fp32, {card})")
    err = perf_probe_solve.accuracy(A, b)
    log(f"tools f: solve rel err " + ", ".join(f"refine {r} {e:.3e}" for r, e in err.items())
        + f"; {time.perf_counter() - t0:.2f} s")
    if not all(e <= max(err[0], DENSE_ERR_FLOOR) for e in err.values()):
        fail("tools f: a refinement sweep made the dense solve less accurate")
    del A, b
    torch.cuda.empty_cache()


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    try:
        import cuba_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cuba_tpu_torch is not importable next to chip_smoke.py ({e})")
    from cuba_tpu_torch import BAConfig, native
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.ops import segmm

    # phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    try:
        build_s = segmm.build_kernels()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        fail(f"kernel build failed: {e}")
    log(f"nvcc builds of cuba_tpu_torch/csrc/segmm.cu, trisolve.cu, edgeterms.cu and "
        f"factors.cu (in parallel): {build_s:.2f} s")
    log(f"symbolic pass: {native.backend()}")

    prob = synthetic.generate(**graphs.PCG4096)
    n_edges = prob.mono_p.size + prob.stereo_p.size
    log(f"problem: P {graphs.PCG4096['num_poses']}, L {graphs.PCG4096['num_landmarks']}, E "
        f"{n_edges} ({prob.stereo_p.size} stereo), bench_pcg_crossover parameters, seed 0")
    config = BAConfig(dtype=torch.float32, solver="pcg", device="cuda")

    # warm-up run (also the engine whose tables phase 2 uses)
    ba, _chis, t_init0, t_opt0 = run_path(prob, config, torch, "warm-up")
    engine = ba._engine

    # phase 2: kernels against plain versions
    kern_pcg = check_kernels(engine, torch, segmm)
    del ba, engine

    # phase 3: the PCG path, counted and timed
    segmm.reset_launches()
    ba, chis, t_init, t_opt = run_path(prob, config, torch, "pcg path")
    launches_pcg = dict(segmm.LAUNCHES)
    attempts = {"pcg": ba.last_result.nattempts}
    log(f"launches (pcg path): {json.dumps(launches_pcg)}")
    if not chis[-1] < chis[0]:
        fail(f"chi2 did not fall: {chis[0]} -> {chis[-1]}")
    cuba_record(chis, "pcg4096", n_edges, "pcg", CHI2_REL_BAND)
    missing = sorted(n for n in engine_kernels(ba._engine) if launches_pcg[n] == 0)
    if missing:
        fail(f"kernels of the pcg path never launched: {missing}")
    profile_optimize(ba, torch, "pcg path", t_opt)
    del ba

    # phase 4: the same run with the plain versions on the card
    with segmm.use_plain():
        _ba, chis_plain, _ti, t_opt_plain = run_path(prob, config, torch, "pcg plain path")
    compare_trajectories(chis, chis_plain, "pcg")
    log(f"pcg walls ({card}): initialize {t_init} s, optimize({ITERS}) {t_opt} s; cold "
        f"initialize {t_init0} s, optimize {t_opt0} s; plain optimize {t_opt_plain} s")
    del _ba
    stamp("phases 1-4")

    # phase 5: the band path (solver="auto") on the kitti00-scale loop graph
    kprob = synthetic.generate(**KITTI)
    log(f"kitti00 loop: P {KITTI['num_poses']}, L {KITTI['num_landmarks']}, "
        f"E {kprob.mono_p.size + kprob.stereo_p.size} ({kprob.stereo_p.size} stereo), "
        "bench.py parameters, seed 0")
    kconfig = BAConfig(dtype=torch.float32, device="cuda")
    kba, _kchis, kt_init0, kt_opt0 = run_path(kprob, kconfig, torch, "kitti warm-up")
    kengine = kba._engine
    if kengine.solver != "band_cr" or kengine.band_m != KITTI_BAND_M:
        fail(f"solver='auto' resolved to {kengine.solver!r} with band_m {kengine.band_m}, "
             f"expected 'band_cr' with {KITTI_BAND_M}")

    # phase 6: the band path's kernels against their plain versions
    kern_band = check_band_kernels(kengine, torch, segmm)
    del kba, kengine

    segmm.reset_launches()
    kba, kchis, kt_init, kt_opt = run_path(kprob, kconfig, torch, "band path")
    launches_band = dict(segmm.LAUNCHES)
    attempts["band"] = kba.last_result.nattempts
    log(f"launches (band path): {json.dumps(launches_band)}")
    if not (kchis[-1] < kchis[0] and np.all(np.diff(kchis) <= 0)):
        fail(f"kitti00 chi2 did not fall: {kchis.tolist()}")
    ref = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
    rel = abs(kchis[-1] - ref) / ref
    log(f"kitti00 final chi2 {kchis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e} "
        f"(band {CHI2_REL_BAND})")
    if not rel < CHI2_REL_BAND:
        fail("kitti00 final chi2 is outside the recorded fp64 band")
    missing = sorted(n for n in engine_kernels(kba._engine) if launches_band[n] == 0)
    if missing:
        fail(f"kernels of the band path never launched: {missing}")
    profile_optimize(kba, torch, "band path", kt_opt)
    del kba

    # phase 7: the band run with the plain versions on the card
    with segmm.use_plain():
        _kba, kchis_plain, kt_init_p, kt_opt_plain = run_path(kprob, kconfig, torch,
                                                              "band plain path")
    compare_trajectories(kchis, kchis_plain, "band")
    log(f"band walls ({card}): initialize {kt_init} s, optimize({ITERS}) {kt_opt} s; cold "
        f"initialize {kt_init0} s, optimize {kt_opt0} s; plain initialize {kt_init_p} s, "
        f"plain optimize {kt_opt_plain} s")
    del _kba
    stamp("phases 5-7")

    # phase 8: the dense path (solver="auto") on the kitti07-scale graph
    dprob = synthetic.generate(**KITTI07)
    log(f"kitti07: P {KITTI07['num_poses']}, L {KITTI07['num_landmarks']}, "
        f"E {dprob.mono_p.size + dprob.stereo_p.size} ({dprob.stereo_p.size} stereo), "
        "bench.py --quick parameters, seed 0")
    dba, _dchis, dt_init0, dt_opt0 = run_path(dprob, kconfig, torch, "kitti07 warm-up")
    dengine = dba._engine
    if dengine.solver != "dense_cholesky":
        fail(f"solver='auto' resolved to {dengine.solver!r} on kitti07, "
             "expected 'dense_cholesky'")

    # phase 9: the dense path's kernels against their plain versions
    kern_dense = check_dense_kernels(dengine, torch, segmm, "kitti07")
    dense_attempt_phases(dengine, torch)
    del dba, dengine

    segmm.reset_launches()
    dba, dchis, dt_init, dt_opt = run_path(dprob, kconfig, torch, "dense path")
    launches_dense = dict(segmm.LAUNCHES)
    attempts["dense"] = dba.last_result.nattempts
    log(f"launches (dense path): {json.dumps(launches_dense)}")
    if not (dchis[-1] < dchis[0] and np.all(np.diff(dchis) <= 0)):
        fail(f"kitti07 chi2 did not fall: {dchis.tolist()}")
    ref = CHI2_FP64_FINAL[("kitti07_scale", ITERS)]
    rel = abs(dchis[-1] - ref) / ref
    log(f"kitti07 final chi2 {dchis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e} "
        f"(band {CHI2_REL_BAND})")
    if not rel < CHI2_REL_BAND:
        fail("kitti07 final chi2 is outside the recorded fp64 band")
    missing = sorted(n for n in engine_kernels(dba._engine) if launches_dense[n] == 0)
    if missing:
        fail(f"kernels of the dense path never launched: {missing}")
    profile_optimize(dba, torch, "dense path", dt_opt)
    del dba

    # phase 9, kitti00: the dense solver on the loop graph (n = 8448)
    xconfig = BAConfig(dtype=torch.float32, device="cuda", solver="dense_cholesky")
    xba = make_graph(kprob, xconfig)
    t0 = time.perf_counter()
    xba.initialize()
    torch.cuda.synchronize()
    log(f"kitti00 dense: initialize {time.perf_counter() - t0:.4f} s, "
        f"n {6 * xba._engine.pad_blocks}")
    kern_dense00 = check_dense_kernels(xba._engine, torch, segmm, "kitti00 dense",
                                       schur_kernels=False)
    del xba
    segmm.reset_launches()
    _xba, xchis, _xt_init, xt_opt = run_path(kprob, xconfig, torch, "kitti00 dense path")
    launches_dense00 = dict(segmm.LAUNCHES)
    attempts["dense-kitti00"] = _xba.last_result.nattempts
    if not (xchis[-1] < xchis[0] and np.all(np.diff(xchis) <= 0)):
        fail(f"kitti00 dense chi2 did not fall: {xchis.tolist()}")
    ref00 = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
    log(f"kitti00 dense final chi2 {xchis[-1]:.2f} (band path {kchis[-1]:.2f}, fp64 record "
        f"{ref00:.2f}: rel {abs(xchis[-1] - ref00) / ref00:.3e}; not gated), "
        f"optimize({ITERS}) {xt_opt:.4f} s")
    profile_optimize(_xba, torch, "kitti00 dense path", xt_opt)
    del _xba

    # phase 10: the dense run with the plain versions on the card
    with segmm.use_plain():
        _dba, dchis_plain, dt_init_p, dt_opt_plain = run_path(dprob, kconfig, torch,
                                                              "dense plain path")
    compare_trajectories(dchis, dchis_plain, "dense")
    log(f"dense walls ({card}): initialize {dt_init} s, optimize({ITERS}) {dt_opt} s; cold "
        f"initialize {dt_init0} s, optimize {dt_opt0} s; plain initialize {dt_init_p} s, "
        f"plain optimize {dt_opt_plain} s")
    del _dba
    stamp("phases 8-10")

    # phase 11: the v1 formation on the kitti00 odometry graph, v2 gate closed
    from cuba_tpu_torch.solver import rows

    oprob = synthetic.generate(**KITTI00)
    log(f"kitti00 odometry: P {KITTI00['num_poses']}, L {KITTI00['num_landmarks']}, "
        f"E {oprob.mono_p.size + oprob.stereo_p.size} ({oprob.stereo_p.size} stereo), "
        "bench.py parameters with loop_closure=False, seed 0")
    wg_max = rows._WG_MAX
    rows._WG_MAX = 0
    log(f"v2 gate closed: rows._WG_MAX = {rows._WG_MAX} (was {wg_max})")
    try:
        vba, _vchis, _vt_init0, vt_opt0 = run_path(oprob, kconfig, torch, "v1 warm-up")
        vengine = vba._engine
        if (vengine.path, vengine.solver, vengine.band_m) != ("v1", "band_cr", KITTI_BAND_M):
            fail(f"the gate-closed kitti00 odometry graph took {vengine.path!r} / "
                 f"{vengine.solver!r} / m {vengine.band_m}, expected v1 / band_cr / 22")
        kern_v1, attempt = check_v1_kernels(vengine, torch, segmm)
        del vba
        vba, vchis, vt_opt, launches_v1 = counted_run(oprob, kconfig, torch, segmm, "v1 path",
                                                      "v1")
        attempts["v1"] = vba.last_result.nattempts
        profile_optimize(vba, torch, "v1 path", vt_opt)
        del vba
        ref = CHI2_FP64_FINAL[("kitti00_scale", ITERS)]
        rel = abs(vchis[-1] - ref) / ref
        log(f"kitti00 odometry (v1) final chi2 {vchis[-1]:.2f} vs fp64 record {ref:.2f}: rel "
            f"{rel:.3e} (band {CHI2_REL_BAND})")
        if not rel < CHI2_REL_BAND:
            fail("kitti00 odometry (v1) final chi2 is outside the recorded fp64 band")
        with segmm.use_plain():
            _p, vchis_plain, _ti, vt_opt_plain = run_path(oprob, kconfig, torch, "v1 plain path")
        del _p
        compare_trajectories(vchis, vchis_plain, "v1")
        # the dense solver behind the v1 formation: kitti07 plans v1 too
        # with the gate closed (dense_cholesky, kernels 10-14)
        wba, wchis, wt_opt, _launches = counted_run(dprob, kconfig, torch, segmm,
                                                    "v1 dense path", "v1")
        if wba._engine.solver != "dense_cholesky":
            fail(f"the gate-closed kitti07 graph resolved to {wba._engine.solver!r}")
        del wba
        ref = CHI2_FP64_FINAL[("kitti07_scale", ITERS)]
        rel = abs(wchis[-1] - ref) / ref
        log(f"kitti07 (v1, dense_cholesky) final chi2 {wchis[-1]:.2f} vs fp64 record "
            f"{ref:.2f}: rel {rel:.3e} (band {CHI2_REL_BAND}); optimize({ITERS}) {wt_opt:.4f} s")
        if not rel < CHI2_REL_BAND:
            fail("kitti07 (v1) final chi2 is outside the recorded fp64 band")
        compare_trajectories(wchis, dchis, "kitti07", "v1 vs v2 dense_cholesky")
    finally:
        rows._WG_MAX = wg_max
    log(f"v2 gate restored: rows._WG_MAX = {rows._WG_MAX}")
    compare_formations(vengine, attempt, torch)
    del vengine, attempt
    gba, gchis, _gt_init, gt_opt = run_path(oprob, kconfig, torch, "v2 gate-open path")
    if gba._engine.path != "v2":
        fail(f"the gate-open run took {gba._engine.path!r}")
    del gba
    compare_trajectories(vchis, gchis, "kitti00 odometry", "v1 vs gate-open v2")
    log(f"v1 walls ({card}): optimize({ITERS}) {vt_opt} s (cold {vt_opt0} s, plain "
        f"{vt_opt_plain} s); the gate-open v2 run {gt_opt} s")
    stamp("phase 11")

    # phase 12: band_lr on the MXU path, two loop chords
    dnconfig = BAConfig(dtype=torch.float32, device="cuda", solver="dense_cholesky")
    cprob = with_chords(oprob, 2)
    cba, _cchis, _ct_init0, ct_opt0 = run_path(cprob, kconfig, torch, "band_lr warm-up")
    cengine = cba._engine
    lr = cengine.lr
    facts = (cengine.solver, cengine.path, lr and lr["m"], cengine.plan.lr_nob,
             cengine.plan.lr_k)
    log(f"two chords: solver {facts[0]}, route {facts[1]}, m_lr {facts[2]}, out-of-band "
        f"blocks {facts[3]}, |J| {facts[4]}")
    if facts != ("band_lr", "v2", KITTI_BAND_M, 26, 16):
        fail(f"the two-chord graph planned {facts}, expected band_lr / v2 / 22 / 26 / 16")
    kern_lr = check_band_kernels(cengine, torch, segmm)
    time_woodbury(cengine, torch)
    del cba, cengine
    cba, cchis, ct_opt, launches_lr = counted_run(cprob, kconfig, torch, segmm,
                                                  "band_lr path", "v2")
    attempts["band_lr"] = cba.last_result.nattempts
    profile_optimize(cba, torch, "band_lr path", ct_opt)
    del cba
    with segmm.use_plain():
        _p, cchis_plain, _ti, ct_opt_plain = run_path(cprob, kconfig, torch,
                                                      "band_lr plain path")
    del _p
    compare_trajectories(cchis, cchis_plain, "band_lr")
    _p, cchis_dense, _ti, ct_opt_dense = run_path(cprob, dnconfig, torch,
                                                  "two chords, dense_cholesky")
    del _p
    compare_solvers(cchis, cchis_dense, "two chords")
    log(f"band_lr walls ({card}): optimize({ITERS}) {ct_opt} s (cold {ct_opt0} s, plain "
        f"{ct_opt_plain} s); dense_cholesky on the same graph {ct_opt_dense} s")
    stamp("phase 12")

    # phase 13: the AoS path, three loop chords, the planner closed
    aprob = with_chords(oprob, 3)
    with planner_closed():
        aba, _achis, _at_init0, at_opt0 = run_path(aprob, kconfig, torch, "aos warm-up")
        aengine = aba._engine
        if (aengine.path, aengine.solver) != ("aos", "band_lr"):
            fail(f"the three-chord graph took {aengine.path!r} / {aengine.solver!r}, "
                 "expected aos / band_lr")
        kern_aos = check_aos_kernels(aengine, torch, segmm)
        del aba, aengine
        aba, achis, at_opt, launches_aos = counted_run(aprob, kconfig, torch, segmm,
                                                       "aos path", "aos")
        attempts["aos"] = aba.last_result.nattempts
        astructure, akernels = aba._engine.structure, aba._kernels
        profile_optimize(aba, torch, "aos path", at_opt)
        del aba
        with segmm.use_plain():
            _p, achis_plain, _ti, at_opt_plain = run_path(aprob, kconfig, torch,
                                                          "aos plain path")
        del _p
        compare_trajectories(achis, achis_plain, "aos")
        _p, achis_dense, _ti, at_opt_dense = run_path(aprob, dnconfig, torch,
                                                      "three chords, dense_cholesky")
        if _p._engine.path != "aos":
            fail("the three-chord dense_cholesky run did not take the AoS path")
        del _p
    compare_solvers(achis, achis_dense, "three chords")
    log(f"aos walls ({card}): optimize({ITERS}) {at_opt} s (cold {at_opt0} s, plain "
        f"{at_opt_plain} s); dense_cholesky on the same graph {at_opt_dense} s")
    for fix, label in (("landmarks", "pose-only"), ("poses", "landmark-only")):
        fba, fchis, _ti, ft_opt = run_path(dprob, kconfig, torch, f"kitti07 {label}", fix=fix)
        if fba._engine.path != "aos" or not fchis[-1] < fchis[0]:
            fail(f"kitti07 {label}: route {fba._engine.path!r}, chi2 {fchis.tolist()}")
        del fba
    stamp("phase 13")

    # phases 14-15: the rest of the public API, the BAL path and the samples
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        json_path = check_public_api(kprob, kconfig, kchis, torch, segmm, tmp, card)
        log(f"phase 14: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        bal_path = os.path.join(HERE, "data", "bal_ladybug_scale.txt.gz")
        kern_bal, launches_bal, attempts["bal"] = check_bal(bal_path, kconfig, torch, segmm,
                                                            card)
        check_oracle(torch)
        run_samples([
            ("sample_ba_from_file", [json_path, "--profiled"], "ba_from_file (kitti00)"),
            ("sample_bal", [bal_path], "bal (ladybug)"),
            ("sample_comparison_with_reference", [], "comparison_with_reference")])
        log(f"phase 15: {time.perf_counter() - t0:.2f} s")
    stamp("phases 14-15")

    # phase 16: fp64 on the card, every route, the fp64 builds of kernels 1-10
    f64 = BAConfig(dtype=torch.float64, device="cuda")
    fp64_records(kchis, "kitti00_scale_loop", "kitti00 loop fp32 (phase 5)", gate=False)
    runs64 = {}
    runs64["band-fp64"] = fp64_run(
        kprob, f64, torch, segmm, "band-fp64",
        dict(path="v2", solver="band_cr", band_m=KITTI_BAND_M),
        lambda e: check_band_kernels(e, torch, segmm), "kitti00_scale_loop")
    runs64["dense-fp64"] = fp64_run(
        dprob, f64, torch, segmm, "dense-fp64", dict(path="v2", solver="dense_cholesky"),
        lambda e: check_dense_kernels(e, torch, segmm, "kitti07 fp64", trisolve_kernels=False),
        "kitti07_scale")
    rows._WG_MAX = 0
    log(f"v2 gate closed: rows._WG_MAX = {rows._WG_MAX}")
    try:
        runs64["v1-fp64"] = fp64_run(
            oprob, f64, torch, segmm, "v1-fp64",
            dict(path="v1", solver="band_cr", band_m=KITTI_BAND_M),
            lambda e: check_v1_kernels(e, torch, segmm)[0], "kitti00_scale")
    finally:
        rows._WG_MAX = wg_max
    log(f"v2 gate restored: rows._WG_MAX = {rows._WG_MAX}")
    with planner_closed():
        runs64["aos-fp64"] = fp64_run(
            aprob, f64, torch, segmm, "aos-fp64", dict(path="aos", solver="band_lr"),
            lambda e: check_aos_kernels(e, torch, segmm), iters=FP64_SHORT_ITERS)
        at_plain64 = fp64_against_plain(aprob, f64, torch, "aos-fp64", runs64["aos-fp64"][2],
                                        FP64_SHORT_ITERS)
    p64 = BAConfig(dtype=torch.float64, solver="pcg", device="cuda")
    runs64["pcg-fp64"] = fp64_run(
        prob, p64, torch, segmm, "pcg-fp64", dict(path="rows", solver="pcg"),
        lambda e: check_kernels(e, torch, segmm), iters=FP64_SHORT_ITERS)
    cuba_record(runs64["pcg-fp64"][2], "pcg4096", n_edges, "pcg-fp64", CHI2_FP64_RTOL,
                iters=FP64_SHORT_ITERS)
    pt_plain64 = fp64_against_plain(prob, p64, torch, "pcg-fp64", runs64["pcg-fp64"][2],
                                    FP64_SHORT_ITERS)
    run_samples([("sample_ba_from_file", ["--synthetic", "--fp64"],
                  "ba_from_file fp64 (synthetic)")])
    walls64 = {k: v[3] for k, v in runs64.items()}
    log(f"fp64 walls ({card}): {json.dumps(walls64)}; fp32 in this run: band {kt_opt} s, "
        f"dense {dt_opt} s, v1 {vt_opt} s; band fp64 / fp32 "
        f"{walls64['band-fp64'] / kt_opt:.3f}; plain optimize({FP64_SHORT_ITERS}): aos "
        f"{at_plain64} s, pcg {pt_plain64} s")
    stamp("phase 16")

    # phase 17: the landmark-sharded LM on the card
    mstructure, mkernels, _launches = mesh_one_rank(kprob, kconfig, kchis, torch, segmm)
    stamp("phase 17a")
    cases, expect = mesh_cases(kprob, cprob, dprob, prob, astructure, akernels, torch)
    r0 = mesh_ranks(cases, expect, mesh_gates(kchis, cchis, dchis, chis, achis), torch)
    from cuba_tpu_torch.parallel import drive

    launches_mesh = dict(zip(drive.LAUNCH_NAMES, r0["loop.launches"].tolist()))
    attempts["mesh"] = int(r0["loop.nattempts"])
    stamp("phase 17b")
    kern_mesh = check_mesh_kernels(mstructure, mkernels, kconfig, torch, segmm)
    stamp("phase 17c")

    # phase 18: the large-landmark regime, 1778 P / 1M L / 3.9M E
    kern_stress, launches_stress, attempts["stress"] = check_stress(torch, segmm, card)
    stamp("phase 18")

    # phase 19: the port's tools at full width
    check_tools(torch, card, mstructure, mkernels, kconfig, dprob, {
        shape: (p.mono_p.size + p.stereo_p.size, chis32, runs64[path][2])
        for shape, p, chis32, path in (("kitti00_scale_loop", kprob, kchis, "band-fp64"),
                                       ("kitti00_scale", oprob, gchis, "v1-fp64"),
                                       ("kitti07_scale", dprob, dchis, "dense-fp64"))})
    stamp("phase 19")

    entries = []
    paths = [("pcg", kern_pcg, launches_pcg), ("band", kern_band, launches_band),
             ("dense", kern_dense, launches_dense),
             ("dense-kitti00", kern_dense00, launches_dense00), ("v1", kern_v1, launches_v1),
             ("band_lr", kern_lr, launches_lr), ("aos", kern_aos, launches_aos),
             ("bal", kern_bal, launches_bal), ("mesh", kern_mesh, launches_mesh),
             ("stress", kern_stress, launches_stress)]
    paths += [(path, r[0], r[1]) for path, r in runs64.items()]
    attempts.update({path: r[4] for path, r in runs64.items()})
    for path, kern, launches in paths:
        for label, e in kern.items():
            name, _, site = label.partition(":")
            entries.append({"name": name, "path": path, **({"site": site} if site else {}),
                            "dtype": "float64" if path in runs64 else "float32",
                            "route": "cuda", "source": kernel_source(name),
                            "replaces": REPLACES[name], "launches": launches[name],
                            "attempts": attempts[path], **e})
    unmeasured = [(e["name"], e["path"]) for e in entries
                  if None in (e["device_ms"], e["plain_device_ms"], e["cold_device_ms"],
                              e["plain_cold_device_ms"])
                  or (e["library_ms"] is not None
                      and None in (e["library_device_ms"], e["library_cold_device_ms"]))]
    if unmeasured:
        fail(f"kernels without device times: {unmeasured}")
    names = {e["name"] for e in entries}
    if names != set(REPLACES):
        fail(f"the kernels line misses {sorted(set(REPLACES) - names)}")
    names64 = {e["name"] for e in entries if e["dtype"] == "float64"}
    segmm_names = {n for n in REPLACES if n not in TRISOLVE_KERNELS}
    if names64 != segmm_names:
        fail(f"the kernels line's fp64 entries miss {sorted(segmm_names - names64)}")
    log(f"chip_smoke: {time.perf_counter() - _START:.2f} s in all")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
