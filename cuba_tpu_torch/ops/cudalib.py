"""Building, loading and dispatching the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface in the build directory, at first
use (or all together, one ``nvcc`` per source started at once, by
:func:`build_kernels`), and bound with ctypes.  A library older than its
source is rebuilt.

Dispatch: a CPU tensor takes a wrapper's plain torch version, a CUDA tensor
the kernel (or an exception: there is no fallback).  :func:`use_plain`
switches CUDA tensors to the plain versions too, for the comparisons in the
tests and ``chip_smoke.py``.  Every kernel launch adds one to
``LAUNCHES[name]`` (:func:`count`; ``name`` is the launching wrapper's),
and an fp64 launch to ``LAUNCHES_F64[name]`` as well.

Element types: ``csrc/segmm.cu``, ``csrc/edgeterms.cu`` and
``csrc/factors.cu`` (``hll_inverse`` and ``slot_factors``, whose launches
``LAUNCHES`` counts under those names) build each of their kernels for
float32 and float64 (entry ``cuba_<name>`` and its twin
``cuba_<name>_f64``, :func:`symbol`); a call takes the one float dtype of
its float inputs (:func:`float_dtype`).  ``csrc/trisolve.cu`` is float32
only.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch

from cuba_tpu_torch import native

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = {name: os.path.join(CSRC, f"{name}.cu")
           for name in ("segmm", "trisolve", "edgeterms", "factors")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {
    "gather": 0,
    "segsum": 0,
    "schur_fused": 0,
    "compact_to_band": 0,
    "compact_to_dense": 0,
    "band_transpose": 0,
    "extract_diag_blocks": 0,
    "solve_lower": 0,
    "solve_upper": 0,
    "matvec": 0,
    "edge_terms": 0,
    "hll_inverse": 0,
    "slot_factors": 0,
}
# the same counts, of fp64 launches only
LAUNCHES_F64 = dict.fromkeys(LAUNCHES, 0)
_FORCE_PLAIN = [False]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCHES_F64[k] = 0


def count(name: str, dtype: torch.dtype) -> None:
    """One launch of kernel ``name``, built for ``dtype``."""
    LAUNCHES[name] += 1
    if dtype == torch.float64:
        LAUNCHES_F64[name] += 1


@contextlib.contextmanager
def use_plain():
    """Run CUDA tensors through the plain torch versions (comparisons only)."""
    prev = _FORCE_PLAIN[0]
    _FORCE_PLAIN[0] = True
    try:
        yield
    finally:
        _FORCE_PLAIN[0] = prev


def lib_path(name: str) -> str:
    return os.path.join(native.BUILD_DIR, f"libcuba_{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of csrc/ cannot be built")


def build_kernels(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named sources (all by default), one nvcc process each,
    started together; returns the wall seconds.  Raises on any failure."""
    names = list(SOURCES if names is None else names)
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs: List[tuple] = []
    for name in names:
        tmp = f"{lib_path(name)}.tmp.{os.getpid()}"
        procs.append((name, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]}:\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if missing or older
    than its source), with each entry point's argtypes set and an int
    (cudaError) return."""
    lib = _libs.get(name)  # loaded: no lock on the per-call path
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if (not os.path.exists(path)
                    or os.path.getmtime(path) < os.path.getmtime(SOURCES[name])):
                build_kernels([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in signatures.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def _raw_stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# the current stream's handle without building a torch.cuda.Stream (CUDA
# builds of torch have it; the public call above is the same value)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _raw_stream)


def call(what: str, t: torch.Tensor, fn, *args) -> None:
    """Call entry point ``fn(*args, stream)`` on ``t``'s device and current
    stream; raise if it reports a CUDA error (a refused launch never runs,
    and no later synchronise reports it).  The device is switched only
    when ``t`` is not on the current one."""
    index = t.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{what}: launch failed (cudaError {err})")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version), True for CUDA tensors
    unless :func:`use_plain` is active; raises for mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _FORCE_PLAIN[0]


INT32_MAX = 2 ** 31 - 1


def check_int32(what: str, *sizes: int) -> None:
    """Raise unless every size fits the kernels' int32 index arithmetic."""
    if max(sizes) > INT32_MAX:
        raise ValueError(f"{what}: {max(sizes)} elements exceed the kernel's int32 indexing")


FLOAT_DTYPES = (torch.float32, torch.float64)


def float_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The one float dtype of a call's float inputs, float32 or float64;
    TypeError for another dtype or for inputs of both."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(FLOAT_DTYPES):
        raise TypeError(f"expected float32 or float64 inputs of one dtype, got "
                        f"{sorted(str(d) for d in dtypes)}")
    return dtypes.pop()


def symbol(entry: str, dtype: torch.dtype) -> str:
    """The C entry point of ``entry``'s kernel built for ``dtype``:
    ``entry`` for float32, ``entry + "_f64"`` for float64."""
    if dtype == torch.float32:
        return entry
    if dtype == torch.float64:
        return entry + "_f64"
    raise TypeError(f"{entry}: no kernel built for {dtype}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor of ``dtype``
    (for a float input, the call's :func:`float_dtype`)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
