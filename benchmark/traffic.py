"""The one request maker every traffic mix goes through.

A mix is a JSON file ``benchmark/traffic/<name>.json`` of parameters:

- ``kind``: ``"solve"`` (the engine is built once in set-up and every
  request re-solves the problem from its initial state: steps 3-4) or
  ``"fresh"`` (every request is a new problem: steps 1-4);
- ``dtype``: the engine's compute dtype, ``"float32"`` or ``"float64"``;
- ``drop_fraction`` and ``keep_per_landmark`` (fresh): the share of the
  configuration's observations a request leaves out, drawn from the seed,
  and the observations of each landmark that are never left out.

Set-up makes :data:`WARMUP_REQUESTS` requests before the window.

Every request of a fresh mix also draws new initial estimates at the
generator's noise scales.  Request ``k`` of seed ``s`` is the same problem
in every run, so that the check can make it again after the window.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from benchmark import generator

HERE = os.path.dirname(os.path.abspath(__file__))
NOISE_KEYS = ("init_rot_noise", "init_trans_noise", "init_point_noise")
WARMUP_REQUESTS = 2  # the first loads the libraries and kernels it calls; the second checks
GENERATOR_DEFAULTS = dict(init_rot_noise=0.005, init_trans_noise=0.05, init_point_noise=0.10)


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    kind: str
    dtype: str
    drop_fraction: float = 0.0
    keep_per_landmark: int = 2

    @classmethod
    def load(cls, name: str, root: str = HERE) -> "Mix":
        with open(os.path.join(root, "traffic", f"{name}.json")) as f:
            spec = json.load(f)
        mix = cls(name=name, **spec)
        if mix.kind not in ("solve", "fresh"):
            raise ValueError(f"traffic {name}: unknown kind {mix.kind!r}")
        if mix.dtype not in ("float32", "float64"):
            raise ValueError(f"traffic {name}: unknown dtype {mix.dtype!r}")
        return mix


def base_problem(cfg: dict, seed: int) -> generator.Problem:
    """The configuration's graph, generated from ``seed``."""
    return generator.generate(seed=seed, **cfg["generator"])


def request_rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([seed, k, 0x5EED])


def drop_observations(prob: generator.Problem, rng, fraction: float, keep: int):
    """The problem with round(fraction * E) observations left out, drawn
    uniformly among those that leave every landmark at least ``keep`` of
    its observations: each landmark's observations are ranked by a random
    key, and only those ranked before its last ``keep`` may go."""
    E2 = prob.mono_p.size
    lm = np.concatenate([prob.mono_l, prob.stereo_l])
    E = lm.size
    key = rng.random(E)
    order = np.lexsort((key, lm))
    counts = np.bincount(lm, minlength=prob.Xws.shape[0])
    first = np.cumsum(counts) - counts
    rank = np.empty(E, np.int64)
    rank[order] = np.arange(E) - first[lm[order]]
    eligible = np.nonzero(rank < counts[lm] - keep)[0]
    n_drop = int(round(fraction * E))
    if n_drop > eligible.size:
        raise ValueError(f"cannot leave out {n_drop} of {E} observations keeping {keep} a "
                         f"landmark: only {eligible.size} may go")
    gone = np.zeros(E, bool)
    gone[rng.choice(eligible, n_drop, replace=False)] = True
    km, ks = ~gone[:E2], ~gone[E2:]
    return dataclasses.replace(
        prob, mono_p=prob.mono_p[km], mono_l=prob.mono_l[km], mono_z=prob.mono_z[km],
        mono_w=prob.mono_w[km], stereo_p=prob.stereo_p[ks], stereo_l=prob.stereo_l[ks],
        stereo_z=prob.stereo_z[ks], stereo_w=prob.stereo_w[ks])


def fresh_request(base: generator.Problem, cfg: dict, mix: Mix, seed: int, k: int):
    """Request ``k`` of a fresh mix: the base graph less a seeded share of
    its observations, from new initial estimates."""
    rng = request_rng(seed, k)
    prob = drop_observations(base, rng, mix.drop_fraction, mix.keep_per_landmark)
    noise = {n: cfg["generator"].get(n, GENERATOR_DEFAULTS[n]) for n in NOISE_KEYS}
    qs, ts, Xws = generator.initial_estimate(
        base.gt_qs, base.gt_ts, base.gt_Xws, rng, noise["init_rot_noise"],
        noise["init_trans_noise"], noise["init_point_noise"], base.fixed_poses)
    return dataclasses.replace(prob, qs=qs, ts=ts, Xws=Xws)
