"""The yardstick of ``formation_roofline``: the work the Schur complement
phase needs, counted from the generated graph alone, and the H100's peaks.

The phase ("4: Schur Complement" of the port's phase marks) takes the
damped landmark blocks Hll and the pose-landmark blocks Hpl of one attempt
and writes the reduced pose system.  What any implementation of it has to
do, per attempt:

- invert each free landmark's 3x3 block (``INV3_FLOPS`` operations) and
  form W = Hpl Hll^-1 for each slot, a (free pose, free landmark) pair with
  an observation (6 x 3 x 3 multiply-adds: 108 operations);
- for each triplet, a pair of slots (i <= j) of one landmark, add
  W_i Hpl_j^T (6 x 3 x 6 multiply-adds: 216 operations);
- read Hll once (9 values a landmark), read Hpl once and W once (18 values
  a slot each), and write each block of the reduced system once (36 values
  for each pair of free poses p <= q that share a landmark, and for each
  free pose's diagonal block).

Its least time is the larger of those operations over the peak rate and
those bytes over the peak bandwidth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth, and the vector
# (non-tensor-core) float32 and float64 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ELEMENT_BYTES = {"float32": 4, "float64": 8}

INV3_FLOPS = 30  # symmetric 3x3 inverse by cofactors: 18 + 5 + 7
W_FLOPS = 108
TRIPLET_FLOPS = 216


@dataclasses.dataclass(frozen=True)
class SchurWork:
    landmarks: int  # free landmarks with at least one slot
    slots: int
    triplets: int
    blocks: int  # blocks of the reduced system's upper triangle, diagonal included

    def flops(self) -> int:
        return self.landmarks * INV3_FLOPS + self.slots * W_FLOPS + self.triplets * TRIPLET_FLOPS

    def bytes(self, dtype: str) -> int:
        return ELEMENT_BYTES[dtype] * (9 * self.landmarks + 36 * self.slots + 36 * self.blocks)

    def least_seconds(self, dtype: str) -> float:
        return max(self.flops() / PEAK_FLOPS[dtype], self.bytes(dtype) / PEAK_BYTES_PER_S)


def schur_work(num_poses: int, pose_ids, landmark_ids, fixed_poses) -> SchurWork:
    """Counts of one attempt's Schur complement for observations (pose,
    landmark); every landmark is free, the poses of ``fixed_poses`` fixed."""
    pose_ids = np.asarray(pose_ids, np.int64)
    landmark_ids = np.asarray(landmark_ids, np.int64)
    free = np.ones(num_poses, bool)
    free[np.asarray(fixed_poses, np.int64)] = False
    m = free[pose_ids]
    key = np.unique(landmark_ids[m] * num_poses + pose_ids[m])
    slot_l, slot_p = key // num_poses, key % num_poses
    _, k = np.unique(slot_l, return_counts=True)
    triplets = int((k * (k + 1) // 2).sum())
    # slots are sorted by (landmark, pose): slot s of rank r in a landmark
    # of k slots pairs with itself and the k - r - 1 slots after it
    first = np.cumsum(k) - k
    rank = np.arange(slot_l.size) - np.repeat(first, k)
    after = np.repeat(k, k) - rank
    s = np.repeat(np.arange(slot_l.size), after)
    partner = s + np.arange(s.size) - np.repeat(np.cumsum(after) - after, after)
    pairs = np.unique(slot_p[s] * num_poses + slot_p[partner])
    diag = np.nonzero(free)[0]
    blocks = np.union1d(pairs, diag * num_poses + diag).size
    return SchurWork(landmarks=int(k.size), slots=int(key.size), triplets=triplets,
                     blocks=int(blocks))


def roofline_pct(work: SchurWork, dtype: str, phase_seconds_per_attempt: float):
    """The phase's share of its roofline, in percent, or None where no
    time was read."""
    if not phase_seconds_per_attempt > 0:
        return None
    return 100.0 * work.least_seconds(dtype) / phase_seconds_per_attempt
