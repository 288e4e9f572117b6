"""cuba_tpu_torch: the PyTorch and CUDA port of cuba_tpu's bundle adjustment.

The public API mirrors ``cuba_tpu`` (and the reference's
``cuba::CudaBundleAdjustment``).  Host structure work is NumPy (and the C++
symbolic pass); the numeric path is torch on an explicit device, with the
index-driven gathers and segment sums in hand-written CUDA kernels
(``csrc/segmm.cu``) on the GPU.  This package imports neither JAX nor
``cuba_tpu``.
"""

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.models.types import (
    CameraParams,
    PoseVertex,
    LandmarkVertex,
    MonoEdge,
    StereoEdge,
    EdgeType,
    RobustKernelType,
    BatchInfo,
)
from cuba_tpu_torch.models.graph import BundleAdjustment

# Reference-compatible aliases (cuba::CudaBundleAdjustment)
CudaBundleAdjustment = BundleAdjustment
VertexP = PoseVertex
VertexL = LandmarkVertex
Edge2D = MonoEdge
Edge3D = StereoEdge

__version__ = "0.1.0"

__all__ = [
    "BAConfig",
    "BundleAdjustment",
    "CudaBundleAdjustment",
    "CameraParams",
    "PoseVertex",
    "LandmarkVertex",
    "MonoEdge",
    "StereoEdge",
    "EdgeType",
    "RobustKernelType",
    "BatchInfo",
    "VertexP",
    "VertexL",
    "Edge2D",
    "Edge3D",
]
