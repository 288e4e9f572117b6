"""The per-edge Gauss-Newton terms as one hand-written CUDA kernel
(``csrc/edgeterms.cu``).

:func:`edge_terms` launches ``edge_terms_kernel`` for one edge type: from
the gathered pose rows ``g12`` [12, E], the residuals ``err`` [mdim, E],
the camera-frame points ``Xc`` [3, E], ``inv_z`` [E] and ``omega`` [E] it
writes ``solver/edgerows.py``'s ``term_rows`` tables (v42 [42, E], v12
[12, E], v18 [18, E]) with nothing in device memory between.  It replaces
no TPU kernel (XLA fused ``term_rows`` there); its plain version is
``edgerows.term_rows_plain``, and ``edgerows.term_rows`` dispatches between
the two as ``ops/cudalib.py`` does for every kernel.  mdim (2 mono, 3
stereo) and the robust kind are compile-time cases of the kernel, taken
from ``err``'s rows and the edge type's kernel.  float32 calls take entry
``cuba_edge_terms``, float64 ones ``cuba_edge_terms_f64``; a launch adds
one to ``LAUNCHES["edge_terms"]`` (and to ``LAUNCHES_F64`` in fp64).
"""

from __future__ import annotations

import ctypes

import torch

from cuba_tpu_torch.ops import cudalib, robust

KERNEL_SRC = cudalib.SOURCES["edgeterms"]
_i64, _vp = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "cuba_edge_terms": [_vp, _vp, _vp, _vp, _vp, _i64, _i64, ctypes.c_double, _vp, _vp, _vp,
                        _i64, _vp],
}
# the fp64 twin takes the same arguments
_SIGNATURES.update({cudalib.symbol(k, torch.float64): v for k, v in list(_SIGNATURES.items())})
KINDS = (robust.NONE, robust.HUBER, robust.TUKEY)


def _lib() -> ctypes.CDLL:
    return cudalib.library("edgeterms", _SIGNATURES)


def edge_terms(g12, err, Xc, inv_z, omega, kernel, mdim: int):
    """(v42 [42, E], v12 [12, E], v18 [18, E]) of one edge type on the card:
    one launch of ``edge_terms_kernel`` on the current stream.  Raises for
    inputs off the card, of another or mixed dtypes, not contiguous or of
    other shapes, and for a robust kind the kernel has no case for."""
    dt = cudalib.float_dtype(g12, err, Xc, inv_z, omega)
    for t, name, ndim in ((g12, "g12", 2), (err, "err", 2), (Xc, "Xc", 2),
                          (inv_z, "inv_z", 1), (omega, "omega", 1)):
        if t.device.type != "cuda" or t.device != g12.device:
            raise ValueError(f"edge_terms: {name} on {t.device}, g12 on {g12.device}")
        cudalib.check(t, name, dt, ndim)
    E = g12.shape[1]
    if (mdim not in (2, 3) or g12.shape[0] != 12 or tuple(err.shape) != (mdim, E)
            or Xc.shape != (3, E) or inv_z.shape != (E,) or omega.shape != (E,)):
        raise ValueError(f"edge_terms: g12 {tuple(g12.shape)}, err {tuple(err.shape)}, Xc "
                         f"{tuple(Xc.shape)}, inv_z {tuple(inv_z.shape)}, omega "
                         f"{tuple(omega.shape)} do not fit mdim {mdim}")
    kind, delta = int(kernel[0]), float(kernel[1])
    if kind not in KINDS:
        raise ValueError(f"edge_terms: unknown robust kernel type {kind}")
    cudalib.check_int32("edge_terms", 42 * E)
    outs = tuple(torch.empty((d, E), dtype=dt, device=g12.device) for d in (42, 12, 18))
    if E == 0:
        return outs
    v42, v12, v18 = outs
    cudalib.call("edge_terms", g12, getattr(_lib(), cudalib.symbol("cuba_edge_terms", dt)),
                 g12.data_ptr(), err.data_ptr(), Xc.data_ptr(), inv_z.data_ptr(),
                 omega.data_ptr(), mdim, kind, delta, v42.data_ptr(), v12.data_ptr(),
                 v18.data_ptr(), E)
    cudalib.count("edge_terms", dt)
    return outs

