"""User-facing graph types: camera, vertices, edges, enums, statistics.

A NumPy copy of ``cuba_tpu/models/types.py`` (that package imports JAX on
import, so the port cannot share it).  Python counterparts of the reference PODs (reference:
include/cuda_bundle_adjustment_types.h:51-236).  Quaternions are stored in
(x, y, z, w) coefficient order, matching Eigen's ``coeffs()`` layout that the
reference gathers into device arrays (src/cuda_bundle_adjustment.cpp:151).
The internal index attributes ``iP`` / ``iL`` are assigned at
``initialize()`` just like the reference (active vertices first, fixed
appended after, cpp:140-199).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set

import numpy as np


@dataclasses.dataclass
class CameraParams:
    """Pinhole + stereo-baseline camera intrinsics (types.h:51-62)."""

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    bf: float = 0.0  # stereo baseline times fx

    def to_array(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy, self.bf], dtype=np.float64)


class EdgeType(enum.IntEnum):
    """types.h:143-148."""

    MONOCULAR = 0
    STEREO = 1
    COUNT = 2


class RobustKernelType(enum.IntEnum):
    """types.h:213-218."""

    NONE = 0
    HUBER = 1
    TUKEY = 2


@dataclasses.dataclass
class PoseVertex:
    """SE(3) camera pose vertex (world-to-camera), types.h:156-183.

    q: quaternion (x, y, z, w); t: translation; camera rides on the vertex.
    """

    id: int = -1
    q: np.ndarray = None
    t: np.ndarray = None
    camera: CameraParams = None
    fixed: bool = False
    iP: int = -1
    edges: Set["BaseEdge"] = dataclasses.field(default_factory=set, repr=False)

    def __init__(self, id=-1, q=None, t=None, camera=None, fixed=False):
        self.id = id
        self.q = np.asarray(q, dtype=np.float64).reshape(4) if q is not None else np.array(
            [0.0, 0.0, 0.0, 1.0]
        )
        self.t = np.asarray(t, dtype=np.float64).reshape(3) if t is not None else np.zeros(3)
        self.camera = camera if camera is not None else CameraParams()
        self.fixed = bool(fixed)
        self.iP = -1
        self.edges = set()

    def __hash__(self):
        return object.__hash__(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass
class LandmarkVertex:
    """3D point vertex, types.h:187-208."""

    id: int = -1
    Xw: np.ndarray = None
    fixed: bool = False
    iL: int = -1
    edges: Set["BaseEdge"] = dataclasses.field(default_factory=set, repr=False)

    def __init__(self, id=-1, Xw=None, fixed=False):
        self.id = id
        self.Xw = np.asarray(Xw, dtype=np.float64).reshape(3) if Xw is not None else np.zeros(3)
        self.fixed = bool(fixed)
        self.iL = -1
        self.edges = set()

    def __hash__(self):
        return object.__hash__(self)

    def __eq__(self, other):
        return self is other


class BaseEdge:
    """Projection-factor edge base (types.h:73-90).

    measurement: dim-vector; information: *scalar* omega (the reference's
    documented simplification, README.md:44); vertexP/vertexL: endpoints.
    """

    DIM = 0

    def __init__(self, measurement=None, information=1.0, vertexP=None, vertexL=None):
        d = self.DIM
        self.measurement = (
            np.asarray(measurement, dtype=np.float64).reshape(d)
            if measurement is not None
            else np.zeros(d)
        )
        self.information = float(information)
        self.vertexP: Optional[PoseVertex] = vertexP
        self.vertexL: Optional[LandmarkVertex] = vertexL

    def pose_vertex(self) -> PoseVertex:
        return self.vertexP

    def landmark_vertex(self) -> LandmarkVertex:
        return self.vertexL

    def dim(self) -> int:
        return self.DIM

    # camelCase parity aliases
    poseVertex = pose_vertex
    landmarkVertex = landmark_vertex

    def __hash__(self):
        return object.__hash__(self)

    def __eq__(self, other):
        return self is other


class MonoEdge(BaseEdge):
    """2D monocular observation (types.h:135)."""

    DIM = 2


class StereoEdge(BaseEdge):
    """3D stereo observation (u_left, v, u_right) (types.h:139)."""

    DIM = 3


@dataclasses.dataclass
class BatchInfo:
    """Per-iteration optimization record (types.h:226-231)."""

    iteration: int
    chi2: float


BatchStatistics = List[BatchInfo]
TimeProfile = Dict[str, float]
