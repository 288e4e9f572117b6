"""Public optimizer API (port of ``cuba_tpu/models/graph.py``): the
``cuba::CudaBundleAdjustment`` surface in snake_case with camelCase aliases.

Add/remove vertices and edges, lookups, counts, ``set_robust_kernels``,
``initialize``, ``optimize`` (estimates are written back into the vertex
objects), ``batch_statistics``, ``chi_squared`` and ``clear``.  Profiling
and checkpoints are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

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
from cuba_tpu_torch.solver.engine import BlockSolverEngine, LMResult, State
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
        self._chi_sqs: Optional[Dict[BaseEdge, float]] = None
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
        """Compile the graph into a static structure and upload its tables."""
        structure = build_structure(
            sorted(self._poses.keys()), self._poses,
            sorted(self._landmarks.keys()), self._landmarks,
            self._mono_edges, self._stereo_edges,
        )
        self._engine = BlockSolverEngine(structure, self._kernels, self.config)
        self._state = self._engine.state
        self._stats = []
        self._chi_sqs = None

    def optimize(self, niterations: int) -> None:
        """Run the LM loop and write the estimates back into the vertices."""
        if self._engine is None:
            raise RuntimeError("call initialize() before optimize()")
        result = self._engine.optimize(self._state, niterations)
        self.last_result = result
        self._state = result.state
        self._stats = [BatchInfo(i, float(c)) for i, c in enumerate(result.chis)]
        self._chi_sqs = None
        self._finalize()

    def _finalize(self) -> None:
        """Write the optimized estimates back into the vertex objects."""
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
        self._chi_sqs = None

    def batch_statistics(self):
        return self._stats

    def chi_squared(self, e: BaseEdge) -> float:
        """Unrobustified chi² of one edge at the current estimate (0 for an
        edge that took no part).  Computed for all edges on the first query
        after an ``optimize``."""
        if self._engine is None:
            return 0.0
        if self._chi_sqs is None:
            values = self._engine.chi_squares(self._state)
            self._chi_sqs = dict(zip(self._active_edges(), values.tolist()))
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
    chiSquared = chi_squared
