"""The C++ symbolic pass, built from the port's ``csrc/symbolic.cpp``.

``cuba_tpu``'s binding (``cuba_tpu/native/__init__.py``) cannot be imported
here: importing anything under ``cuba_tpu`` imports JAX.  So the port keeps
its own copy of that C++ source (byte-equal to ``cuba_tpu``'s, which
``tests/test_torch_api.py`` checks), compiles it with g++ into its own build
directory at first use and binds the entry points the port needs: the
symbolic pass (Hpl slots, the Schur co-observation pattern, the
multiplication triplets and the fused Schur chunk plan) and the locality
reorder.  Where no g++ or no source is found,
:func:`get_lib` returns None and the callers take their NumPy paths, which
give the same tables.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "symbolic.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
# the ABI version is in the file name: dlopen caches by path, so a library
# of another ABI can never be mapped under this name by mistake
_LIB_PATH = os.path.join(BUILD_DIR, "libcuba_symbolic.abi2.so")
_ABI_VERSION = 2
# (chunk, slot_block, max_kwin) of the fused Schur plan the C++ pass also
# emits: cuba_tpu's default segmm.sc_geometry(), without its environment
# overrides
SC_GEOMETRY = (1024, 256, 1024)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private path, then rename: concurrent builds (test
    # workers) never see a half-written library
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    lib.ba_abi_version.restype = ctypes.c_int32
    lib.ba_abi_version.argtypes = []
    if int(lib.ba_abi_version()) != _ABI_VERSION:
        return None
    lib.ba_symbolic_compile.restype = ctypes.c_void_p
    lib.ba_symbolic_compile.argtypes = [
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    for name in ("ba_n_hpl", "ba_n_hsc", "ba_n_mul", "ba_fsp_chunks", "ba_fsp_slot_pad",
                 "ba_fsp_hsc_pad"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("ba_fsp_kwin", "ba_fsp_ok"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ba_copy_hpl.restype = None
    lib.ba_copy_hpl.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i32p]
    lib.ba_copy_hsc.restype = None
    lib.ba_copy_hsc.argtypes = [ctypes.c_void_p, _i32p, _i32p]
    lib.ba_copy_mul.restype = None
    lib.ba_copy_mul.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i32p]
    lib.ba_fsp_copy.restype = None
    lib.ba_fsp_copy.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i32p, _i32p, _i32p]
    lib.ba_symbolic_free.restype = None
    lib.ba_symbolic_free.argtypes = [ctypes.c_void_p]
    lib.ba_locality_reorder.restype = None
    lib.ba_locality_reorder.argtypes = [
        _i32p, _i32p, ctypes.c_int64, _i32p, _i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i64p, _i64p, _i64p, _i32p, _i32p,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(SRC):
            return None
        stale = (not os.path.exists(_LIB_PATH)
                 or os.path.getmtime(_LIB_PATH) < os.path.getmtime(SRC))
        if stale and not _build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except (OSError, AttributeError):
            _lib = None
        return _lib


def backend() -> str:
    """Which symbolic pass runs in this process: "c++" or "numpy"."""
    return "c++" if get_lib() is not None else "numpy"


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _ptr64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def symbolic_compile(e_pi: np.ndarray, e_li: np.ndarray, num_p: int, num_l: int):
    """The C++ symbolic pass, or None without the library.  Returns
    (hpl_row, hpl_col, edge2hpl, hsc_row, hsc_col, mul_i, mul_j, mul_k,
    schur_native), as ``cuba_tpu.native.symbolic_compile``; schur_native is
    the fused Schur chunk plan at ``SC_GEOMETRY``: ((chunk, slot_block,
    max_kwin), kwin, ok, C, n_slot_pad, n_hsc_pad, sb, li, lj, lk, gid)."""
    lib = get_lib()
    if lib is None:
        return None
    e_pi = np.ascontiguousarray(e_pi, np.int32)
    e_li = np.ascontiguousarray(e_li, np.int32)
    chunk = SC_GEOMETRY[0]
    h = lib.ba_symbolic_compile(_ptr32(e_pi), _ptr32(e_li), e_pi.size,
                                int(num_p), int(num_l), *SC_GEOMETRY)
    try:
        n_hpl, n_hsc, n_mul = (int(f(h)) for f in (lib.ba_n_hpl, lib.ba_n_hsc, lib.ba_n_mul))
        hpl_row, hpl_col = np.empty(n_hpl, np.int32), np.empty(n_hpl, np.int32)
        edge2hpl = np.empty(e_pi.size, np.int32)
        lib.ba_copy_hpl(h, _ptr32(hpl_row), _ptr32(hpl_col), _ptr32(edge2hpl))
        hsc_row, hsc_col = np.empty(n_hsc, np.int32), np.empty(n_hsc, np.int32)
        lib.ba_copy_hsc(h, _ptr32(hsc_row), _ptr32(hsc_col))
        mul = [np.empty(n_mul, np.int32) for _ in range(3)]
        lib.ba_copy_mul(h, *(_ptr32(a) for a in mul))
        kwin = int(lib.ba_fsp_kwin(h))
        C = int(lib.ba_fsp_chunks(h))
        sb = np.empty(C, np.int32)
        li, lj, lk = (np.empty(C * chunk, np.int32) for _ in range(3))
        gid = np.empty(C * kwin, np.int32)
        lib.ba_fsp_copy(h, _ptr32(sb), _ptr32(li), _ptr32(lj), _ptr32(lk), _ptr32(gid))
        schur_native = (SC_GEOMETRY, kwin, bool(lib.ba_fsp_ok(h)), C,
                        int(lib.ba_fsp_slot_pad(h)), int(lib.ba_fsp_hsc_pad(h)),
                        sb, li, lj, lk, gid)
    finally:
        lib.ba_symbolic_free(h)
    return (hpl_row, hpl_col, edge2hpl, hsc_row, hsc_col, *mul, schur_native)


def locality_reorder(mono_pi, mono_li, stereo_pi, stereo_li, total_p, total_l, num_l):
    """(rank, mono_perm, stereo_perm, mono_new_li, stereo_new_li), or None."""
    lib = get_lib()
    if lib is None:
        return None
    mpi = np.ascontiguousarray(mono_pi, np.int32)
    mli = np.ascontiguousarray(mono_li, np.int32)
    spi = np.ascontiguousarray(stereo_pi, np.int32)
    sli = np.ascontiguousarray(stereo_li, np.int32)
    rank = np.empty(num_l, np.int64)
    mono_perm = np.empty(mpi.size, np.int64)
    stereo_perm = np.empty(spi.size, np.int64)
    mono_new_li = np.empty(mpi.size, np.int32)
    stereo_new_li = np.empty(spi.size, np.int32)
    lib.ba_locality_reorder(
        _ptr32(mpi), _ptr32(mli), mpi.size, _ptr32(spi), _ptr32(sli), spi.size,
        int(total_p), int(total_l), int(num_l),
        _ptr64(rank), _ptr64(mono_perm), _ptr64(stereo_perm),
        _ptr32(mono_new_li), _ptr32(stereo_new_li),
    )
    return rank, mono_perm, stereo_perm, mono_new_li, stereo_new_li
