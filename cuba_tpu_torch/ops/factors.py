"""The Schur factors of the rows front end as two hand-written CUDA kernels
(``csrc/factors.cu``).

:func:`hll_inverse` launches ``hll_inverse_kernel``: from HllT [12, L] and
the damping ``lam`` (a 0-d tensor on the card, read there) it writes
[Hll^-1; bl] [12, L], the landmarks' damped 3x3 inverses taken in float64
term for term as ``solver/rows.py``'s ``_sym3x3_inv_rows``, and their bl
rows.  :func:`slot_factors` launches ``slot_factors_kernel``: from HplT
[18, H] and the slots' gathered [Hll^-1; bl] g12 [12, H] it writes W = Hpl
Hll^-1 [18, H] (row i*3+m) and W bl [6, H] with nothing in device memory
between.  Neither replaces a TPU kernel (XLA fused ``prepare_factors_mxu``
there); their plain versions are ``rows.hll_inverse_plain`` and
``rows.slot_factors_plain``, and ``rows.hll_inverse_rows`` /
``rows.slot_factors_rows`` dispatch between the two as ``ops/cudalib.py``
does for every kernel.  float32 calls take entries ``cuba_hll_inverse`` /
``cuba_slot_factors``, float64 ones their ``_f64`` twins; a launch adds
one to ``LAUNCHES["hll_inverse"]`` / ``LAUNCHES["slot_factors"]`` (and to
``LAUNCHES_F64`` in fp64).
"""

from __future__ import annotations

import ctypes

import torch

from cuba_tpu_torch.ops import cudalib

KERNEL_SRC = cudalib.SOURCES["factors"]
_i64, _vp = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "cuba_hll_inverse": [_vp, _vp, _vp, _i64, _vp],
    "cuba_slot_factors": [_vp, _vp, _vp, _vp, _i64, _vp],
}
# the fp64 twins take the same arguments
_SIGNATURES.update({cudalib.symbol(k, torch.float64): v for k, v in list(_SIGNATURES.items())})


def _lib() -> ctypes.CDLL:
    return cudalib.library("factors", _SIGNATURES)


def _check_on(what: str, tensors) -> None:
    """Raise unless every (tensor, name) of ``tensors`` is on the first's
    CUDA device."""
    first, first_name = tensors[0]
    for t, name in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} on {t.device}, {first_name} on {first.device}")


def hll_inverse(HllT: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """[Hll^-1 (9 rows); bl (3 rows)] [12, L] of the damped HllT [12, L] on
    the card: one launch of ``hll_inverse_kernel`` on the current stream.
    ``lam`` is a 0-d tensor of HllT's dtype on its device.  Raises for
    inputs of another or mixed dtypes, not contiguous, of other shapes or
    off the card."""
    dt = cudalib.float_dtype(HllT, lam)
    cudalib.check(HllT, "HllT", dt, 2)
    cudalib.check(lam, "lam", dt, 0)
    if HllT.shape[0] != 12:
        raise ValueError(f"hll_inverse: HllT {tuple(HllT.shape)} is not [12, L]")
    _check_on("hll_inverse", ((HllT, "HllT"), (lam, "lam")))
    L = HllT.shape[1]
    cudalib.check_int32("hll_inverse", 12 * L)
    out = torch.empty((12, L), dtype=dt, device=HllT.device)
    if L == 0:
        return out
    cudalib.call("hll_inverse", HllT, getattr(_lib(), cudalib.symbol("cuba_hll_inverse", dt)),
                 HllT.data_ptr(), lam.data_ptr(), out.data_ptr(), L)
    cudalib.count("hll_inverse", dt)
    return out


def slot_factors(HplT: torch.Tensor, g12: torch.Tensor):
    """(W [18, H], W bl [6, H]) of the slots on the card, from HplT [18, H]
    and the gathered [Hll^-1; bl] g12 [12, H]: one launch of
    ``slot_factors_kernel`` on the current stream.  Raises for inputs of
    another or mixed dtypes, not contiguous, of other shapes or off the
    card."""
    dt = cudalib.float_dtype(HplT, g12)
    cudalib.check(HplT, "HplT", dt, 2)
    cudalib.check(g12, "g12", dt, 2)
    H = HplT.shape[1]
    if HplT.shape[0] != 18 or tuple(g12.shape) != (12, H):
        raise ValueError(f"slot_factors: HplT {tuple(HplT.shape)} and g12 "
                         f"{tuple(g12.shape)} are not [18, H] and [12, H]")
    _check_on("slot_factors", ((HplT, "HplT"), (g12, "g12")))
    cudalib.check_int32("slot_factors", 18 * H)
    W = torch.empty((18, H), dtype=dt, device=HplT.device)
    wbl = torch.empty((6, H), dtype=dt, device=HplT.device)
    if H == 0:
        return W, wbl
    cudalib.call("slot_factors", HplT, getattr(_lib(), cudalib.symbol("cuba_slot_factors", dt)),
                 HplT.data_ptr(), g12.data_ptr(), W.data_ptr(), wbl.data_ptr(), H)
    cudalib.count("slot_factors", dt)
    return W, wbl
