"""The comparison that decides ``correct``.

The plain reference (``reference.py``, float64) solves the request's
problem once; each answer of the program is then judged by four numbers:

- ``iterations_gap``: how many more or fewer LM iterations the program
  ran than the reference (an exact comparison);
- ``chi2_gap``: the largest relative gap between the program's chi² after
  each LM iteration and the reference's, over the iterations both ran;
- ``state_chi2_gap``: the relative gap between the reference's chi² of
  the program's final poses and landmarks and the reference's own final
  chi² (the answer judged by what it says, not by what the program says of
  it);
- ``pose_gap_m``: the largest distance, in metres, between a camera centre
  of the program's answer and the reference's.

Each has its limit in ``benchmark/limits/<cell>.json``, set from the
readings of sound runs and of the control; a run is correct where every
number of every answer compared is finite and within its limit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import reference

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("iterations_gap", "chi2_gap", "state_chi2_gap", "pose_gap_m")


def load_limits(cell: str, root: str = HERE) -> dict:
    """{number: limit} of a cell."""
    with open(os.path.join(root, "limits", f"{cell}.json")) as f:
        spec = json.load(f)
    return {k: float(spec[k]["limit"]) for k in NUMBERS}


def reference_of(prob, cfg: dict, device, dtype=torch.float64, tf32=False):
    lm = reference.LMParams(**cfg["lm"])
    return reference.Reference(
        prob.qs, prob.ts, prob.cam, prob.Xws, prob.fixed_poses,
        (prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w),
        (prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w),
        cfg["huber_deltas"], device, dtype=dtype, tf32=tf32, lm=lm)


class Judge:
    """The float64 reference's solution of one problem, and the numbers of
    an answer against it."""

    def __init__(self, prob, cfg: dict, device):
        self.ref = reference_of(prob, cfg, device)
        self.chis, (R, t, X) = self.ref.optimize(cfg["iterations"])
        self.centres = reference.camera_centres(R, t)

    def numbers(self, chis, R, t, X) -> dict:
        """The numbers of an answer: its chi² per iteration, and its
        final rotations [P, 3, 3], translations and landmarks (in the
        caller's numbering)."""
        chis = np.asarray(chis, np.float64)
        n = min(chis.size, self.chis.size)
        chi2_gap = float(np.max(np.abs(chis[:n] / self.chis[:n] - 1.0))) if n else float("inf")
        dev, dt = self.ref.device, self.ref.dtype
        R, t, X = (torch.as_tensor(a).to(device=dev, dtype=dt) for a in (R, t, X))
        state_chi2 = self.ref.chi2(R, t, X)
        pose_gap = (reference.camera_centres(R, t) - self.centres).norm(dim=-1).max()
        return {"iterations_gap": float(abs(chis.size - self.chis.size)),
                "chi2_gap": chi2_gap,
                "state_chi2_gap": abs(state_chi2 / float(self.chis[-1]) - 1.0),
                "pose_gap_m": float(pose_gap)}

    def answer_numbers(self, chis, qs, ts, Xws) -> dict:
        """:meth:`numbers` of an answer given as quaternions (x, y, z, w)."""
        R = reference.quat_to_rot(torch.as_tensor(qs, dtype=torch.float64))
        return self.numbers(chis, R, ts, Xws)


def worst(readings) -> dict:
    """The largest reading of each number (NaN counts as infinite)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = max(float("inf") if not np.isfinite(v) else v for v in vals)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)
