"""Gathers and segment sums over transposed ``[D, N]`` fp32 tables.

Port of the six one-hot-matmul Pallas kernels of ``cuba_tpu/ops/segmm.py``
that the PCG slice runs.  Each wrapper keeps its TPU kernel's argument list,
output shape and layout (``[D, N]``, fp32) and invalid-id rules:

* gathers ``resident_gather`` / ``windowed_gather`` / ``tiled_gather``:
  ``out[:, n] = src[:, ids[n]]``, 0 where ``ids[n] < 0`` or ``>= S``;
* segment sums ``accum_segsum`` / ``accum_segsum_windowed`` /
  ``tiled_segsum``: ``out[:, s] = sum of vals[:, n] over ids[n] == s`` for
  ``0 <= s < num_out``; other ids are dropped.

The TPU kernels' windows and tiles only kept a one-hot factor inside VMEM;
here the plan arguments are accepted and ignored.  Underneath, two
hand-written CUDA kernels (``csrc/segmm.cu``) serve all six wrappers: a
column gather and a deterministic CSR segment sum.  The CSR of a call site
(:class:`SegmentCSR`) is built once per structure by the planner
(``solver/rows.py``); a segment-sum wrapper given none builds it on the spot,
which only tests do.

Dispatch: a CPU tensor takes the ``*_plain`` torch version, a CUDA tensor
the kernel (or an exception: there is no fallback).  :func:`use_plain`
switches CUDA tensors to the plain versions too, for the comparisons in the
tests and ``chip_smoke.py``.  Every kernel launch adds one to
``LAUNCHES[wrapper name]``.

The host plans (:class:`TilePlan`, :class:`AccumWindowPlan` and their
planners) are NumPy copies of ``cuba_tpu``'s: the planner keeps them so its
paddings and its choice of wrapper match ``cuba_tpu``'s exactly.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cuba_tpu_torch import native

# ---------------------------------------------------------------------------
# host plans (NumPy copies of cuba_tpu/ops/segmm.py's planners)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class AccumWindowPlan:
    """Per-chunk windows: the ids in chunk c all fall in [wb[c]*128,
    wb[c]*128 + win)."""

    chunk: int
    win: int
    num_chunks: int
    wb: np.ndarray  # [num_chunks] int32 window base in 128-column units
    out_pad: int
    ok: bool


def plan_accum_windows(ids: np.ndarray, num_out: int, *, chunk: int = 1024,
                       max_win: int = 512) -> AccumWindowPlan:
    ids = np.asarray(ids)
    N = int(ids.size)
    C = max(N // chunk, 1)
    if N % chunk != 0 or num_out <= 0:
        return AccumWindowPlan(chunk, 0, C, np.zeros(C, np.int32), 0, False)
    nat = native.tile_minmax(ids, num_out, chunk, 1, C)
    if nat is not None:
        lo, hi = nat
    else:
        iv = ids.astype(np.int64).reshape(C, chunk)
        valid = (iv >= 0) & (iv < num_out)
        lo = np.where(valid, iv, np.int64(1) << 40).min(axis=1)
        hi = np.where(valid, iv, -1).max(axis=1)
    empty = hi < 0
    lo[empty] = 0
    hi[empty] = 0
    wb = lo // 128
    width = int((hi - wb * 128).max()) + 1
    win = max(_round_up(width, 128), 128)
    ok = win <= max_win
    out_pad = max(_round_up(int(wb.max()) * 128 + win, 128), _round_up(num_out, 128))
    return AccumWindowPlan(chunk, win, C, wb.astype(np.int32), out_pad, ok)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Per-tile input windows of tiled_segsum / tiled_gather: tile t's
    inputs lie in blocks [base_block[t], base_block[t] + n_blocks)."""

    tile: int
    block: int
    n_blocks: int
    num_tiles: int
    base_block: np.ndarray  # [num_tiles] int32, -1 for an empty tile
    n_pad: int
    ok: bool


def plan_tiles(ids: np.ndarray, num_out: int, *, tile: int = 512, block: int = 1024,
               max_blocks: int = 8) -> TilePlan:
    """tiled_segsum plan: per output tile, the input range covering it."""
    N = int(ids.size)
    num_tiles = max((num_out + tile - 1) // tile, 1)
    nat = native.tile_minmax(ids, num_out, tile, 0, num_tiles)
    if nat is not None:
        first, last = nat
    else:
        valid = (ids >= 0) & (ids < num_out)
        idx = np.nonzero(valid)[0]
        t_of = ids[idx] // tile
        first = np.full(num_tiles, np.int64(1) << 62, dtype=np.int64)
        last = np.full(num_tiles, -1, dtype=np.int64)
        np.minimum.at(first, t_of, idx)
        np.maximum.at(last, t_of, idx)
    empty = last < 0
    first[empty] = 0
    last[empty] = 0
    base_block = first // block
    end_block = last // block + 1
    base_block[empty] = -1
    n_blocks = max(int(np.max(end_block - base_block)) if num_tiles else 1, 1)
    ok = n_blocks <= max_blocks
    n_pad = int(np.max(base_block) + n_blocks) * block if ok else _round_up(N, block)
    n_pad = max(n_pad, block)
    return TilePlan(tile, block, n_blocks, num_tiles, base_block.astype(np.int32), n_pad, ok)


def plan_gather_tiles(ids: np.ndarray, num_src: int, *, tile: int = 512, block: int = 1024,
                      max_blocks: int = 8) -> TilePlan:
    """tiled_gather plan: per output tile, the source-column window."""
    N = int(ids.size)
    num_tiles = max((N + tile - 1) // tile, 1)
    nat = native.tile_minmax(ids, num_src, tile, 1, num_tiles)
    if nat is not None:
        lo, hi = nat
        any_valid = hi >= 0
        lo[~any_valid] = 0
        hi[~any_valid] = 0
    else:
        pad = num_tiles * tile - N
        idp = np.concatenate([ids, np.full(pad, -1, np.int32)]).reshape(num_tiles, tile)
        valid = (idp >= 0) & (idp < num_src)
        any_valid = valid.any(axis=1)
        lo = np.where(any_valid, np.where(valid, idp, num_src).min(axis=1), 0)
        hi = np.where(any_valid, np.where(valid, idp, -1).max(axis=1), 0)
    base_block = lo // block
    n_blocks = max(int(np.max(hi // block + 1 - base_block)) if num_tiles else 1, 1)
    base_block[~any_valid] = -1
    ok = n_blocks <= max_blocks
    n_pad = int(np.max(base_block) + n_blocks) * block if ok else _round_up(num_src, block)
    n_pad = max(n_pad, block)
    return TilePlan(tile, block, n_blocks, num_tiles, base_block.astype(np.int32), n_pad, ok)


class SegmentCSR(NamedTuple):
    """The fixed summation order of one segment-sum call site."""

    order: torch.Tensor  # [M] int32: input columns with a valid id, stably sorted by id
    offs: torch.Tensor  # [num_out + 1] int32: segment s is order[offs[s]:offs[s+1]]


def segment_csr(ids, num_out: int, device) -> SegmentCSR:
    """CSR of ``ids`` over ``num_out`` segments; ids outside [0, num_out)
    are left out."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids, np.int64)
    pos = np.flatnonzero((ids >= 0) & (ids < num_out))
    order = pos[np.argsort(ids[pos], kind="stable")]
    offs = np.zeros(num_out + 1, np.int64)
    np.cumsum(np.bincount(ids[pos], minlength=num_out), out=offs[1:])
    return SegmentCSR(
        torch.from_numpy(order.astype(np.int32)).to(device),
        torch.from_numpy(offs.astype(np.int32)).to(device),
    )


# ---------------------------------------------------------------------------
# the CUDA library: built from csrc/segmm.cu with nvcc, bound with ctypes
# ---------------------------------------------------------------------------

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "segmm.cu")
_LIB_PATH = os.path.join(native.BUILD_DIR, "libcuba_segmm.so")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

LAUNCHES = {
    "resident_gather": 0,
    "windowed_gather": 0,
    "tiled_gather": 0,
    "accum_segsum": 0,
    "accum_segsum_windowed": 0,
    "tiled_segsum": 0,
}
_FORCE_PLAIN = [False]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def use_plain():
    """Run CUDA tensors through the plain torch versions (comparisons only)."""
    prev = _FORCE_PLAIN[0]
    _FORCE_PLAIN[0] = True
    try:
        yield
    finally:
        _FORCE_PLAIN[0] = prev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of csrc/segmm.cu cannot be built")


def build_kernels() -> float:
    """Compile csrc/segmm.cu into the build directory; returns seconds."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, KERNEL_SRC],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {KERNEL_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            if (not os.path.exists(_LIB_PATH)
                    or os.path.getmtime(_LIB_PATH) < os.path.getmtime(KERNEL_SRC)):
                build_kernels()
            lib = ctypes.CDLL(_LIB_PATH)
            i64, vp = ctypes.c_int64, ctypes.c_void_p
            lib.cuba_gather_cols.restype = ctypes.c_int
            lib.cuba_gather_cols.argtypes = [vp, vp, vp, i64, i64, i64, vp]
            lib.cuba_segsum_csr.restype = ctypes.c_int
            lib.cuba_segsum_csr.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp]
            _lib = lib
        return _lib


def _use_kernel(*tensors: torch.Tensor) -> bool:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _FORCE_PLAIN[0]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_gather(name: str, src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check(src, "src", torch.float32, 2)
    _check(ids, "ids", torch.int32, 1)
    D, S = src.shape
    N = ids.shape[0]
    out = torch.empty((D, N), dtype=torch.float32, device=src.device)
    if D * N == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.cuba_gather_cols(src.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                   D, S, N, stream)
    if err != 0:
        raise RuntimeError(f"{name}: gather_cols launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out


def _launch_segsum(name: str, vals: torch.Tensor, num_out: int,
                   csr: SegmentCSR) -> torch.Tensor:
    _check(vals, "vals", torch.float32, 2)
    _check(csr.order, "csr.order", torch.int32, 1)
    _check(csr.offs, "csr.offs", torch.int32, 1)
    if csr.offs.shape[0] != num_out + 1:
        raise ValueError(f"csr.offs has {csr.offs.shape[0]} entries, expected {num_out + 1}")
    if csr.order.device != vals.device or csr.offs.device != vals.device:
        raise ValueError("csr tensors must be on the device of vals")
    D, N = vals.shape
    out = torch.empty((D, num_out), dtype=torch.float32, device=vals.device)
    if D * num_out == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.cuba_segsum_csr(vals.data_ptr(), csr.order.data_ptr(), csr.offs.data_ptr(),
                                  out.data_ptr(), D, N, num_out, stream)
    if err != 0:
        raise RuntimeError(f"{name}: segsum_csr launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out


def _gather_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    valid = (ids >= 0) & (ids < src.shape[1])
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    return torch.where(valid[None, :], src[:, safe], torch.zeros((), dtype=src.dtype,
                                                                   device=src.device))


def _segsum_plain(vals: torch.Tensor, ids: torch.Tensor, num_out: int) -> torch.Tensor:
    valid = (ids >= 0) & (ids < num_out)
    out = torch.zeros((vals.shape[0], num_out), dtype=vals.dtype, device=vals.device)
    return out.index_add_(1, ids[valid].long(), vals[:, valid])


def _gather(name, src, ids):
    if _use_kernel(src, ids):
        return _launch_gather(name, src, ids)
    return _gather_plain(src, ids)


def _segsum(name, vals, ids, num_out, csr):
    if _use_kernel(vals, ids):
        if csr is None:
            csr = segment_csr(ids, num_out, vals.device)
        return _launch_segsum(name, vals, num_out, csr)
    return _segsum_plain(vals, ids, num_out)


# ---------------------------------------------------------------------------
# the six wrappers and their plain versions
# ---------------------------------------------------------------------------


def resident_gather(src, ids, *, chunk: int = 1024):
    """Per-edge pose gather, src [D, S] by ids [N] -> [D, N]
    (cuba_tpu segmm.resident_gather; ``chunk`` is ignored)."""
    return _gather("resident_gather", src, ids)


def resident_gather_plain(src, ids, *, chunk: int = 1024):
    return _gather_plain(src, ids)


def windowed_gather(src, ids, plan: AccumWindowPlan, wb):
    """resident_gather over rank-ordered ids (cuba_tpu
    segmm.windowed_gather; the window plan is ignored)."""
    return _gather("windowed_gather", src, ids)


def windowed_gather_plain(src, ids, plan: AccumWindowPlan, wb):
    return _gather_plain(src, ids)


def tiled_gather(src, ids, plan: TilePlan, base_block, *, num_out: Optional[int] = None):
    """src [D, S] by ids [N] -> [D, N], or its first ``num_out`` columns
    (cuba_tpu segmm.tiled_gather; the tile plan is ignored)."""
    if num_out is not None:
        ids = ids[:num_out]
    return _gather("tiled_gather", src, ids)


def tiled_gather_plain(src, ids, plan: TilePlan, base_block, *, num_out: Optional[int] = None):
    return _gather_plain(src, ids if num_out is None else ids[:num_out])


def accum_segsum(vals, ids, num_out: int, *, chunk: int = 1024,
                 csr: Optional[SegmentCSR] = None):
    """vals [D, N] summed by ids [N] -> [D, num_out] (cuba_tpu
    segmm.accum_segsum; ``chunk`` is ignored)."""
    return _segsum("accum_segsum", vals, ids, num_out, csr)


def accum_segsum_plain(vals, ids, num_out: int, *, chunk: int = 1024, csr=None):
    return _segsum_plain(vals, ids, num_out)


def accum_segsum_windowed(vals, ids, num_out: int, plan: AccumWindowPlan, wb, *,
                          csr: Optional[SegmentCSR] = None):
    """accum_segsum over locally banded ids (cuba_tpu
    segmm.accum_segsum_windowed; the window plan is ignored)."""
    return _segsum("accum_segsum_windowed", vals, ids, num_out, csr)


def accum_segsum_windowed_plain(vals, ids, num_out: int, plan: AccumWindowPlan, wb, *,
                                csr=None):
    return _segsum_plain(vals, ids, num_out)


def tiled_segsum(vals, ids, num_out: int, plan: TilePlan, base_block, *,
                 csr: Optional[SegmentCSR] = None):
    """accum_segsum over locally sorted ids (cuba_tpu segmm.tiled_segsum;
    the tile plan is ignored)."""
    return _segsum("tiled_segsum", vals, ids, num_out, csr)


def tiled_segsum_plain(vals, ids, num_out: int, plan: TilePlan, base_block, *, csr=None):
    return _segsum_plain(vals, ids, num_out)
