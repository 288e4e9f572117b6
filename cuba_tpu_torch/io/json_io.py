"""Graph JSON IO (port of ``cuba_tpu/io/json_io.py``), compatible with the
reference's cv::FileStorage layout (reference:
samples/sample_ba_from_file.cpp:91-164):

  { "fx":..., "fy":..., "cx":..., "cy":..., "bf":...,
    "pose_vertices":     [{"id", "fixed", "q":[x,y,z,w], "t":[x,y,z]}, ...],
    "landmark_vertices": [{"id", "fixed", "Xw":[x,y,z]}, ...],
    "monocular_edges":   [{"vertexP", "vertexL", "measurement":[u,v],
                           "information"}, ...],
    "stereo_edges":      [{"vertexP", "vertexL", "measurement":[u,v,ur],
                           "information"}, ...] }

The quaternion is stored in Eigen coeffs order (x, y, z, w), matching the
Quaterniond(Vector4d) construction in the reference sample.  A file written
by either package reads into the other's graph: Python's ``json`` writes
each float64 so that it reads back exactly.
"""

from __future__ import annotations

import json
from typing import Optional

from cuba_tpu_torch.models.graph import BundleAdjustment
from cuba_tpu_torch.models.types import (
    CameraParams,
    LandmarkVertex,
    MonoEdge,
    PoseVertex,
    StereoEdge,
)


def read_graph(path: str, config=None) -> BundleAdjustment:
    """Load a BA graph from a reference-format JSON file into a
    :class:`BundleAdjustment` of ``config`` (a ``BAConfig``; the default
    runs on the card)."""
    with open(path) as f:
        data = json.load(f)

    camera = CameraParams(
        fx=float(data["fx"]),
        fy=float(data["fy"]),
        cx=float(data["cx"]),
        cy=float(data["cy"]),
        bf=float(data.get("bf", 0.0)),
    )

    ba = BundleAdjustment(config)
    for node in data.get("pose_vertices", []):
        ba.add_pose_vertex(
            PoseVertex(
                int(node["id"]),
                node["q"],
                node["t"],
                camera,
                fixed=bool(int(node.get("fixed", 0))),
            )
        )
    for node in data.get("landmark_vertices", []):
        ba.add_landmark_vertex(
            LandmarkVertex(int(node["id"]), node["Xw"], fixed=bool(int(node.get("fixed", 0))))
        )
    for node in data.get("monocular_edges", []):
        ba.add_monocular_edge(
            MonoEdge(
                node["measurement"],
                float(node["information"]),
                ba.pose_vertex(int(node["vertexP"])),
                ba.landmark_vertex(int(node["vertexL"])),
            )
        )
    for node in data.get("stereo_edges", []):
        ba.add_stereo_edge(
            StereoEdge(
                node["measurement"],
                float(node["information"]),
                ba.pose_vertex(int(node["vertexP"])),
                ba.landmark_vertex(int(node["vertexL"])),
            )
        )
    return ba


def write_graph(ba: BundleAdjustment, path: str, camera: Optional[CameraParams] = None) -> None:
    """Save a BA graph in the reference-format JSON layout."""
    poses = [ba.pose_vertex(i) for i in sorted(ba._poses.keys())]
    cam = camera or (poses[0].camera if poses else CameraParams())
    data = {
        "fx": cam.fx,
        "fy": cam.fy,
        "cx": cam.cx,
        "cy": cam.cy,
        "bf": cam.bf,
        "pose_vertices": [
            {
                "id": v.id,
                "fixed": int(v.fixed),
                "q": [float(x) for x in v.q],
                "t": [float(x) for x in v.t],
            }
            for v in poses
        ],
        "landmark_vertices": [
            {
                "id": v.id,
                "fixed": int(v.fixed),
                "Xw": [float(x) for x in v.Xw],
            }
            for v in (ba.landmark_vertex(i) for i in sorted(ba._landmarks.keys()))
        ],
        "monocular_edges": [
            {
                "vertexP": e.vertexP.id,
                "vertexL": e.vertexL.id,
                "measurement": [float(x) for x in e.measurement],
                "information": e.information,
            }
            for e in ba._mono_edges
        ],
        "stereo_edges": [
            {
                "vertexP": e.vertexP.id,
                "vertexL": e.vertexL.id,
                "measurement": [float(x) for x in e.measurement],
                "information": e.information,
            }
            for e in ba._stereo_edges
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)
