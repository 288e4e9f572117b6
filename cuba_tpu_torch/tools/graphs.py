"""The seeded graphs the port's tools run, and the common ways to build
them: as a ``BAStructure`` from the generator's arrays (the engine-level
tools) or as a ``BundleAdjustment`` graph (the public API), both with the
Huber kernels of ``bench.py`` (delta sqrt(5.991) mono, sqrt(7.815)
stereo)."""

import argparse
import contextlib

import numpy as np
import torch

from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import robust
from cuba_tpu_torch.solver.structure import build_structure_from_arrays

# bench.py's kitti00-scale loop graph (bench.py:121-137)
KITTI00_LOOP = dict(num_poses=1322, num_landmarks=133383, mean_obs_per_landmark=5.5,
                    stereo_fraction=0.25, seed=0, loop_closure=True)
# the same graph without the loop closure: bench.py's odometry graph
KITTI00 = dict(KITTI00_LOOP, loop_closure=False)
# bench.py --quick's kitti07-scale graph (reference ba_kitti_07: 248 / 26,127 / 95,037)
KITTI07 = dict(num_poses=248, num_landmarks=26127, mean_obs_per_landmark=4.65,
               stereo_fraction=0.25, seed=0, loop_closure=False)
# the large-landmark regime (1778 P / 1M L / 3,885,457 E)
STRESS = dict(num_poses=1778, num_landmarks=1_000_000, mean_obs_per_landmark=5.0,
              stereo_fraction=0.25, seed=0)
GRAPHS = {"kitti00": KITTI00, "kitti00-loop": KITTI00_LOOP, "kitti07": KITTI07,
          "stress": STRESS}
# the solver crossover's gentler initial noise: at P >= 4096 the default
# drift starts LM so far from the basin that fp32 rejects the first steps
GENTLE_NOISE = dict(init_rot_noise=0.002, init_trans_noise=0.02, init_point_noise=0.04)
# chip_smoke.py's PCG graph: the solver crossover's generator at P = 4096,
# L = 15 P (4096 P / 61,440 L / 238,292 E)
PCG4096 = dict(num_poses=4096, num_landmarks=61_440, mean_obs_per_landmark=5.0,
               stereo_fraction=0.25, seed=0, **GENTLE_NOISE)

MONO_DELTA = float(np.sqrt(5.991))
STEREO_DELTA = float(np.sqrt(7.815))
KERNELS = ((robust.HUBER, MONO_DELTA), (robust.HUBER, STEREO_DELTA))


def add_graph_args(ap: argparse.ArgumentParser, default: str) -> None:
    """``--graph`` (a name of GRAPHS) and :func:`add_size_args`."""
    ap.add_argument("--graph", default=default, choices=sorted(GRAPHS))
    add_size_args(ap)


def add_size_args(ap: argparse.ArgumentParser) -> None:
    """``--poses`` / ``--landmarks``, which resize a graph with its other
    generator arguments kept."""
    ap.add_argument("--poses", type=int, default=None)
    ap.add_argument("--landmarks", type=int, default=None)


def graph_params(name: str, args) -> dict:
    """The generator arguments of GRAPHS[name], resized by ``args``."""
    params = dict(GRAPHS[name])
    if args.poses is not None:
        params["num_poses"] = args.poses
    if args.landmarks is not None:
        params["num_landmarks"] = args.landmarks
    return params


def add_device_args(ap: argparse.ArgumentParser, dtype="float32") -> None:
    """``--device`` (the card unless asked) and, unless ``dtype`` is None
    (a tool whose mode fixes it), ``--dtype``."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    if dtype is not None:
        ap.add_argument("--dtype", default=dtype, choices=("float32", "float64"))


def structure_of(prob):
    """The problem's ``BAStructure``, its first pose fixed as the generator
    says and no landmark fixed."""
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fixed_p = np.zeros(P, bool)
    fixed_p[prob.fixed_poses] = True
    return build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fixed_p, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


def make_graph(prob, config):
    """The problem as a ``BundleAdjustment`` graph with the Huber kernels."""
    from cuba_tpu_torch import EdgeType, RobustKernelType

    ba = synthetic.build_graph(prob, config)
    ba.set_robust_kernels(RobustKernelType.HUBER, MONO_DELTA, EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, STEREO_DELTA, EdgeType.STEREO)
    return ba


def sync(device) -> None:
    """Wait for the card (nothing on the host)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (what
    every time a tool prints is measured on), or "cpu".  Raises where the
    card is asked for and there is none: no tool carries on on the host."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) but torch.cuda.is_available() is "
                           "False: pass --device cpu to run on the host")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        line = smi.stdout.strip().splitlines()
        if smi.returncode == 0 and line:
            return line[0].strip()
    except OSError:
        pass
    return f"{torch.cuda.get_device_name(0)} (power limit not read)"


@contextlib.contextmanager
def one_rank_group(device):
    """A ``torch.distributed`` group of this process alone (NCCL on the
    card, gloo on the host), joined through a file in a temporary
    directory and destroyed on exit, so that no group outlives the tool
    that made it."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=600))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()
