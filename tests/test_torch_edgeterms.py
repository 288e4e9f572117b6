"""The per-edge Gauss-Newton terms (``edgerows.term_rows``) on the CPU.

On the card ``term_rows`` launches ``csrc/edgeterms.cu``'s kernel
(``tests/test_torch_gpu.py`` holds it to the plain version there); on the
CPU it must return what the port returned before the kernel existed, bit
for bit: the rotation from the gathered quaternions, ``jac_rows``, the IRLS
weight and the einsums, restated below as they were.  It launches nothing
here, and its work count, call sites and comparison scale are what the
chip smoke test and the kernel tests read.
"""

import numpy as np
import pytest
import torch

from cuba_tpu_torch import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import cudalib, edgeterms, robust
from cuba_tpu_torch.solver import edgerows
from cuba_tpu_torch.tools import graphs, roofline

KINDS = {"none": (robust.NONE, 0.0), "huber": (robust.HUBER, float(np.sqrt(5.991))),
         "tukey": (robust.TUKEY, 2.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[torch.float32, torch.float64], ids=["fp32", "fp64"])
def engine(request):
    """A small band graph's engine on the CPU (mono and stereo edges, the
    packs padded to 1024 lanes)."""
    torch.set_num_threads(1)
    prob = synthetic.generate(num_poses=40, num_landmarks=600, stereo_fraction=0.25, seed=4)
    ba = graphs.make_graph(prob, BAConfig(dtype=request.param, device="cpu"))
    ba.initialize()
    return ba._engine


def _old_term_rows(err, Xc, R, inv_z, cam, omega, kernel, mdim):
    """``term_rows`` as the port computed it before the kernel, from the
    rotation its caller formed."""
    E = err.shape[1]
    w = omega * robust.weight(edgerows.chi_per_edge(err, omega), kernel[0], kernel[1])
    JP, JL = edgerows.jac_rows(Xc, R, inv_z, cam, mdim)
    wJP = w * JP
    wJL = w * JL
    v42 = torch.cat([torch.einsum("kie,kje->ije", wJP, JP).reshape(36, E),
                     torch.einsum("kie,ke->ie", wJP, err)])
    v12 = torch.cat([torch.einsum("kae,kbe->abe", wJL, JL).reshape(9, E),
                     torch.einsum("kae,ke->ae", wJL, err)])
    v18 = torch.einsum("kie,kbe->ibe", wJP, JL).reshape(18, E).contiguous()
    return v42, v12, v18


def _packs(engine):
    """(g12, err, Xc, inv_z, omegaT, mdim) of each edge type."""
    pm, ps, _chi = engine._residuals_and_chi(engine.state)
    rc = engine.rc
    return [(*pm, rc.omegaT_m, 2), (*ps, rc.omegaT_s, 3)]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mdim", [2, 3])
def test_term_rows_on_cpu_is_the_old_computation(engine, mdim, kind):
    g12, err, Xc, inv_z, omega, _m = _packs(engine)[mdim - 2]
    kernel = KINDS[kind]
    cudalib.reset_launches()
    got = edgerows.term_rows(g12, err, Xc, inv_z, omega, kernel, mdim)
    want = _old_term_rows(err, Xc, edgerows.rotmat_rows(g12[0:4]), inv_z, g12[7:12], omega,
                          kernel, mdim)
    assert [t.shape for t in got] == [(42, g12.shape[1]), (12, g12.shape[1]),
                                      (18, g12.shape[1])]
    for a, b in zip(got, want):
        assert a.dtype == engine.dtype and torch.equal(a, b)
    # the robust weight bites: some lanes are down-weighted
    if kind != "none":
        w = robust.weight(edgerows.chi_per_edge(err, omega), *kernel)[omega > 0]
        assert bool((w < 1).any()) and bool((w > 0).any())
    # on the CPU nothing launches
    assert not any(cudalib.LAUNCHES.values()) and not any(cudalib.LAUNCHES_F64.values())


def test_term_rows_padding_lanes_are_zero(engine):
    for g12, err, Xc, inv_z, omega, mdim in _packs(engine):
        pad = omega == 0
        assert bool(pad.any())
        for t in edgerows.term_rows(g12, err, Xc, inv_z, omega, engine.kernels[mdim - 2], mdim):
            assert bool((t[:, pad] == 0).all())


def test_term_rows_scale_bounds_every_entry(engine):
    """The comparison scale is each entry's sum of |products|: no entry
    exceeds it, and where fu == fv Hpp's (2, 5) entry (row 17) cancels, so
    its scale is far above its value."""
    for g12, err, Xc, inv_z, omega, mdim in _packs(engine):
        kernel = engine.kernels[mdim - 2]
        vals = edgerows.term_rows(g12, err, Xc, inv_z, omega, kernel, mdim)
        scale = edgerows.term_rows_scale(g12, err, Xc, inv_z, omega, kernel, mdim)
        for v, s in zip(vals, scale):
            assert bool((v.abs() <= s * (1 + 1e-5)).all())
        if mdim == 2 and bool((g12[7] == g12[8]).all()):
            live = omega > 0
            assert float(vals[0][17, live].abs().max()) < 1e-4 * float(scale[0][17, live].max())


def test_edge_terms_wrapper_refuses_cpu_tensors(engine):
    g12, err, Xc, inv_z, omega, mdim = _packs(engine)[0]
    with pytest.raises(ValueError, match="on cpu"):
        edgeterms.edge_terms(g12, err, Xc, inv_z, omega, engine.kernels[0], mdim)


@pytest.mark.parametrize("mdim, nbytes, flops", [(2, 336, 240), (3, 344, 357)])
def test_edge_terms_work(mdim, nbytes, flops):
    """12 values read a mono lane (14 stereo) and 72 written, 4 bytes each
    in fp32, 8 in fp64."""
    assert roofline.edge_terms_work(1024, mdim) == (1024 * nbytes, 1024 * flops)
    assert roofline.edge_terms_work(1024, mdim, 8)[0] == 2048 * nbytes


def test_edge_sites_call_term_rows(engine):
    sites = roofline.edge_sites(engine)
    assert sorted(sites) == ["edge_terms:mono", "edge_terms:stereo"]
    for label, site in sites.items():
        g12, err, *_rest, mdim = site.args
        assert site.kind == "edge_terms" and mdim == (2 if label.endswith("mono") else 3)
        assert site.work() == roofline.edge_terms_work(g12.shape[1], mdim,
                                                       g12.element_size())
        for a, b in zip(site.call(edgerows.term_rows), site.call(edgerows.term_rows_plain)):
            assert torch.equal(a, b)
