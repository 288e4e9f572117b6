"""Public optimizer API (port of ``cuba_tpu/models/graph.py``): the
``cuba::CudaBundleAdjustment`` surface in snake_case with camelCase aliases.

Add/remove vertices and edges, lookups, counts, ``set_robust_kernels``,
``initialize``, ``optimize`` (estimates are written back into the vertex
objects; ``profile=True`` runs the host-stepped driver with exact phase
timing), ``batch_statistics``, ``time_profile`` and ``attributed_phases``
(the reference's 8-phase TimeProfile), ``chi_squared``,
``save_checkpoint`` / ``load_checkpoint`` (``.npz`` files either package
reads) and ``clear``.  With ``BAConfig(mesh=group)`` every rank of the
group makes the same calls and the engine is landmark-sharded
(``parallel/sharding.py``); the estimates, statistics and per-edge chi²
are the same on every rank.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.models.types import (
    BaseEdge,
    BatchInfo,
    EdgeType,
    LandmarkVertex,
    MonoEdge,
    PoseVertex,
    RobustKernelType,
    StereoEdge,
)
from cuba_tpu_torch.solver.engine import (LOOP_PHASES, PROFILE_ITEMS, BlockSolverEngine,
                                          LMResult, PhaseMarks, State)
from cuba_tpu_torch.solver.structure import build_structure


class BundleAdjustment:
    """Sparse bundle-adjustment optimizer (BlockSolver_6_3 + LM).

    Construct, add vertices and edges, optionally set robust kernels,
    ``initialize()``, then ``optimize(n)``.
    """

    def __init__(self, config: Optional[BAConfig] = None):
        self.config = config or BAConfig()
        self._poses: Dict[int, PoseVertex] = {}
        self._landmarks: Dict[int, LandmarkVertex] = {}
        # dicts as insertion-ordered sets: O(1) add/remove/contains
        self._mono_edges: Dict[BaseEdge, None] = {}
        self._stereo_edges: Dict[BaseEdge, None] = {}
        self._kernels = [
            (int(RobustKernelType.NONE), 0.0),
            (int(RobustKernelType.NONE), 0.0),
        ]
        self._engine: Optional[BlockSolverEngine] = None
        self._state: Optional[State] = None
        self._stats = []
        self._time_profile = dict.fromkeys(PROFILE_ITEMS, 0.0)
        self._pending_attr = []  # (wall seconds, PhaseMarks) of plain runs
        self._attributed_phases: set = set()
        # the edges the engine's structure was built from (mono then stereo,
        # insertion order, both-fixed edges left out) and their chi²: empty
        # until an optimize(), None after one until the first query fills it
        self._edge_list: List[BaseEdge] = []
        self._chi_sqs: Optional[Dict[BaseEdge, float]] = {}
        self.last_result: Optional[LMResult] = None

    @classmethod
    def create(cls, config: Optional[BAConfig] = None) -> "BundleAdjustment":
        return cls(config)

    # --- graph construction ------------------------------------------------

    def add_pose_vertex(self, v: PoseVertex) -> None:
        if v.camera is None:
            raise ValueError(f"PoseVertex id={v.id}: camera must be set")
        if not np.all(np.isfinite(v.q)) or not np.all(np.isfinite(v.t)):
            raise ValueError(f"PoseVertex id={v.id}: non-finite q/t estimate")
        self._poses[v.id] = v

    def add_landmark_vertex(self, v: LandmarkVertex) -> None:
        if not np.all(np.isfinite(v.Xw)):
            raise ValueError(f"LandmarkVertex id={v.id}: non-finite Xw estimate")
        self._landmarks[v.id] = v

    def _check_edge(self, e: BaseEdge, dim: int) -> None:
        if e.dim() != dim:
            raise TypeError(
                f"edge measurement dim {e.dim()} does not match the add_*_edge "
                f"method used (expected {dim})"
            )
        if e.vertexP is None or e.vertexL is None:
            raise ValueError("edge endpoints vertexP/vertexL must both be set")
        if self._poses.get(e.vertexP.id) is not e.vertexP:
            raise ValueError(
                f"edge.vertexP (id={e.vertexP.id}) is not a registered pose vertex"
            )
        if self._landmarks.get(e.vertexL.id) is not e.vertexL:
            raise ValueError(
                f"edge.vertexL (id={e.vertexL.id}) is not a registered landmark vertex"
            )
        if not (e.information >= 0.0):  # also rejects NaN
            raise ValueError(f"edge.information must be >= 0, got {e.information}")

    def add_monocular_edge(self, e: MonoEdge) -> None:
        self._check_edge(e, 2)
        self._mono_edges[e] = None
        e.vertexP.edges.add(e)
        e.vertexL.edges.add(e)

    def add_stereo_edge(self, e: StereoEdge) -> None:
        self._check_edge(e, 3)
        self._stereo_edges[e] = None
        e.vertexP.edges.add(e)
        e.vertexL.edges.add(e)

    def pose_vertex(self, vid: int) -> PoseVertex:
        return self._poses[vid]

    def landmark_vertex(self, vid: int) -> LandmarkVertex:
        return self._landmarks[vid]

    def remove_pose_vertex(self, v: PoseVertex) -> None:
        found = self._poses.pop(v.id, None)
        if found is not None:
            for e in list(found.edges):
                self.remove_edge(e)

    def remove_landmark_vertex(self, v: LandmarkVertex) -> None:
        found = self._landmarks.pop(v.id, None)
        if found is not None:
            for e in list(found.edges):
                self.remove_edge(e)

    def remove_edge(self, e: BaseEdge) -> None:
        e.vertexP.edges.discard(e)
        e.vertexL.edges.discard(e)
        self._mono_edges.pop(e, None)
        self._stereo_edges.pop(e, None)

    def nposes(self) -> int:
        return len(self._poses)

    def nlandmarks(self) -> int:
        return len(self._landmarks)

    def nedges(self) -> int:
        return len(self._mono_edges) + len(self._stereo_edges)

    def set_robust_kernels(self, kernel_type: RobustKernelType, delta: float,
                           edge_type: EdgeType) -> None:
        """One robust kernel per edge type."""
        self._kernels[int(edge_type)] = (int(kernel_type), float(delta))

    # --- optimization --------------------------------------------------------

    def initialize(self) -> None:
        """Compile the graph into a static structure and upload its tables:
        "1: Build Structure" and "0: Initialize Optimizer" of the profile."""
        t0 = time.perf_counter()
        structure = build_structure(
            sorted(self._poses.keys()), self._poses,
            sorted(self._landmarks.keys()), self._landmarks,
            self._mono_edges, self._stereo_edges,
        )
        t_structure = time.perf_counter() - t0
        if self.config.mesh is not None:
            from cuba_tpu_torch.parallel.sharding import MultiChipSolverAdapter

            self._engine = MultiChipSolverAdapter(structure, self._kernels, self.config,
                                                  self.config.mesh)
        else:
            self._engine = BlockSolverEngine(structure, self._kernels, self.config)
        if self._engine.device.type == "cuda":
            torch.cuda.synchronize(self._engine.device)
        self._state = self._engine.state
        self._stats = []
        self._time_profile = dict.fromkeys(PROFILE_ITEMS, 0.0)
        self._time_profile["1: Build Structure"] = t_structure
        self._time_profile["0: Initialize Optimizer"] = time.perf_counter() - t0 - t_structure
        self._pending_attr = []
        self._attributed_phases = set()
        self._edge_list = list(self._active_edges())
        self._chi_sqs = {}

    def optimize(self, niterations: int, profile: bool = False) -> None:
        """Run the LM loop and write the estimates back into the vertices.
        With ``profile=True``, the host-stepped driver times every phase
        exactly (and follows its own control law: see
        ``BlockSolverEngine.optimize_profiled``)."""
        if self._engine is None:
            raise RuntimeError("call initialize() before optimize()")
        marks = None
        t0 = time.perf_counter()
        if profile:
            result, prof = self._engine.optimize_profiled(self._state, niterations)
            for k, v in prof.items():
                self._time_profile[k] += v
        else:
            if self.config.phase_attribution:
                marks = PhaseMarks(self._engine.device)
            result = self._engine.optimize(self._state, niterations, marks)
        total = time.perf_counter() - t0
        if not profile:
            key = "optimize (fused device loop)"
            self._time_profile[key] = self._time_profile.get(key, 0.0) + total
            if marks is not None:
                self._pending_attr.append((total, marks))
        self.last_result = result
        self._state = result.state
        self._stats = [BatchInfo(i, float(c)) for i, c in enumerate(result.chis)]
        self._chi_sqs = None
        self._finalize()

    def _finalize(self) -> None:
        """Write the optimized estimates back into the vertex objects (on
        a mesh, every rank's: the state is the gathered global one)."""
        s = self._engine.structure
        qs = self._state.qs.double().cpu().numpy()
        ts = self._state.ts.double().cpu().numpy()
        Xws = self._state.Xws.double().cpu().numpy()
        for v in self._poses.values():
            if 0 <= v.iP < s.total_p and v.edges:
                v.q = qs[v.iP].copy()
                v.t = ts[v.iP].copy()
        for v in self._landmarks.values():
            if 0 <= v.iL < s.total_l and v.edges:
                v.Xw = Xws[v.iL].copy()

    def _active_edges(self):
        for edges in (self._mono_edges, self._stereo_edges):
            for e in edges:
                if not (e.vertexP.fixed and e.vertexL.fixed):
                    yield e

    def clear(self) -> None:
        self._poses.clear()
        self._landmarks.clear()
        self._mono_edges.clear()
        self._stereo_edges.clear()
        self._stats = []
        self._engine = None
        self._state = None
        self._pending_attr = []
        self._edge_list = []
        self._chi_sqs = {}

    # --- checkpoint / resume ----------------------------------------------
    # The same .npz keys as cuba_tpu's: a file written by either package
    # loads into the other's graph.

    def save_checkpoint(self, path: str) -> None:
        """Persist the vertices' current estimates and the statistics to an
        .npz file."""
        pids = sorted(self._poses)
        lids = sorted(self._landmarks)
        np.savez(
            path,
            pose_ids=np.asarray(pids, np.int64),
            qs=np.stack([self._poses[i].q for i in pids]) if pids else np.zeros((0, 4)),
            ts=np.stack([self._poses[i].t for i in pids]) if pids else np.zeros((0, 3)),
            lm_ids=np.asarray(lids, np.int64),
            Xws=np.stack([self._landmarks[i].Xw for i in lids]) if lids else np.zeros((0, 3)),
            stats_iter=np.asarray([s.iteration for s in self._stats], np.int64),
            stats_chi2=np.asarray([s.chi2 for s in self._stats], np.float64),
        )

    def load_checkpoint(self, path: str) -> None:
        """Restore estimates saved by :meth:`save_checkpoint`.

        Vertices are matched by id; ids in the file but not in the graph
        are ignored, and graph vertices missing from the file keep their
        estimates.  Call before ``initialize()`` (or initialize again
        afterwards) so that the solver starts from the restored state."""
        # each array read once: an NpzFile reads a key's whole array again
        # at every lookup
        with np.load(path) as f:
            data = {k: f[k] for k in f.files}
        for pid, q, t in zip(data["pose_ids"], data["qs"], data["ts"]):
            v = self._poses.get(int(pid))
            if v is not None:
                v.q = q.copy()
                v.t = t.copy()
        for lid, Xw in zip(data["lm_ids"], data["Xws"]):
            v = self._landmarks.get(int(lid))
            if v is not None:
                v.Xw = Xw.copy()
        self._stats = [BatchInfo(int(it), float(c))
                       for it, c in zip(data["stats_iter"], data["stats_chi2"])]

    def batch_statistics(self):
        return self._stats

    def time_profile(self) -> Dict[str, float]:
        """The reference's 8-phase TimeProfile, in seconds.

        ``initialize()`` times "1: Build Structure" and "0: Initialize
        Optimizer".  A plain ``optimize()`` adds its wall under
        "optimize (fused device loop)"; with ``config.phase_attribution``
        its phase marks stay pending until this call, which reads them and
        adds the five loop phases scaled to sum to that wall.
        ``optimize(n, profile=True)`` adds host-timed phases directly."""
        for total, marks in self._pending_attr:
            parts = marks.seconds()
            measured = sum(parts.values())
            scale = total / measured if measured > 0 else 0.0
            for k, v in parts.items():
                self._time_profile[k] += v * scale
                self._attributed_phases.add(k)
        self._pending_attr = []
        return self._time_profile

    def attributed_phases(self) -> set:
        """Phase keys of :meth:`time_profile` whose values split a plain
        run's measured wall by its phase marks rather than time each phase
        with a synchronisation (``optimize(n, profile=True)``, which leaves
        this set empty).  Empty until the first ``time_profile()`` after a
        plain run; the two initialize phases are never in it."""
        return set(self._attributed_phases)

    def chi_squared(self, e: BaseEdge) -> float:
        """Unrobustified chi² of one edge at the estimates of the last
        ``optimize()``: 0.0 before the first ``optimize()`` after
        ``initialize()``, after ``clear()``, and for an edge the structure
        did not hold.  Computed for all of the structure's edges at the
        first query after an ``optimize``."""
        if self._chi_sqs is None:
            values = self._engine.chi_squares(self._state)
            self._chi_sqs = dict(zip(self._edge_list, values.tolist(), strict=True))
        return self._chi_sqs.get(e, 0.0)

    # --- camelCase aliases ----------------------------------------------------
    addPoseVertex = add_pose_vertex
    addLandmarkVertex = add_landmark_vertex
    addMonocularEdge = add_monocular_edge
    addStereoEdge = add_stereo_edge
    poseVertex = pose_vertex
    landmarkVertex = landmark_vertex
    removePoseVertex = remove_pose_vertex
    removeLandmarkVertex = remove_landmark_vertex
    removeEdge = remove_edge
    setRobustKernels = set_robust_kernels
    batchStatistics = batch_statistics
    timeProfile = time_profile
    saveCheckpoint = save_checkpoint
    loadCheckpoint = load_checkpoint
    chiSquared = chi_squared
