"""The yardstick of the port's kernels on one NVIDIA H100: the card's peak
rates, an engine's kernel call sites, the work (bytes moved, operations
done) of each call on this run's data, the least time that work could
take, and the device time of a call as ``torch.profiler`` measures it.

``chip_smoke.py`` (its kernel checks and ``bound_ms`` column) and
``tools/mfu.py`` (its roofline table) take their sites, work counts and
times from here, so that one kernel site gets one bound whatever kernel
implements it.  A work count is (bytes, operations): each input the
function needs read once, each output written once, for the ids this
run's data holds (a gather reads the source columns its ids name, a sum
adds the values whose id is in range).
"""

import functools
import statistics
import time
from typing import NamedTuple

import torch

from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import edgerows, rows

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): device
# memory rate and fp32 and fp64 rates outside the tensor cores, per
# millisecond
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOPS_PER_MS = 67e9
FP64_FLOPS_PER_MS = 34e9

REPEATS = 25  # rounds of interleaved_times
# the damping at which the solve tools build their attempt (bench_pcg_band_mc,
# profile_formation), as the JAX tools fix it (tools/bench_pcg_band_mc.py:76,
# tools/profile_formation.py:52); the kernel sites keep the engine's own λ
LAM0 = 1e-3
PROFILE_TRIES = 3  # profiler sessions interleaved_times may take to split its rounds
FLUSH_BYTES = 128 << 20  # read before every cold call: 2.5x the H100's 50 MB L2


def bound(nbytes: float, flops: float, fp64: bool = False):
    """(bound_ms, bound_by): the least time this card could take to move
    ``nbytes`` and do ``flops`` fp32 (or, with ``fp64``, fp64) operations."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / (FP64_FLOPS_PER_MS if fp64 else FP32_FLOPS_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(src: torch.Tensor, ids: torch.Tensor):
    """A gather's (bytes, flops): its ids and output, and the source
    columns its in-range ids name, read once; no operations."""
    valid = (ids >= 0) & (ids < src.shape[1])
    cols = int(torch.unique(ids[valid]).numel())
    D, N = src.shape[0], ids.shape[0]
    return 4 * N + src.element_size() * (D * N + D * cols), 0


def segsum_work(vals: torch.Tensor, ids: torch.Tensor, num_out: int):
    """A segment sum's (bytes, flops): its ids, the columns with an id in
    range and its output; one add per summed value."""
    nv = int(((ids >= 0) & (ids < num_out)).sum())
    D, N = vals.shape
    return 4 * N + vals.element_size() * (D * nv + D * num_out), D * nv


def schur_work(plan, sc, csr, size: int = 4):
    """schur_fused's (bytes, flops) for values of ``size`` bytes: the W and
    G columns its triplets read; the index tables its kernel reads, one int
    a CSR entry (``csr.pairs``, the size of ``csr.order``), the lane
    offsets, one lane order entry an output lane, and sb; and its output; 3
    multiply-adds for each of the 36 outputs of a triplet.  ``sc`` is
    (plan, sb, li, lj, lk) as the wrapper takes them."""
    sb, li, lj, _lk = sc[1:]
    base = (sb.long() * plan.slot_block).repeat_interleave(plan.chunk)
    valid = (li >= 0) & (lj >= 0)
    cols = sum(int(torch.unique((base + x.long())[valid]).numel()) for x in (li, lj))
    lanes = plan.num_chunks * plan.kwin
    index = csr.order.numel() + csr.offs.numel() + lanes + sb.numel()
    return size * (18 * cols + 36 * lanes) + 4 * index, 216 * int(valid.sum())


def band_work(plan, rc, size: int = 4):
    """compact_to_band's (bytes, flops) for values of ``size`` bytes: the
    table entries it places (36 values a filled slot), the slot ids, the
    diagonal, the occupancy and its output; one add per diagonal element."""
    PB = plan.pad_blocks
    M = PB // 64
    n_slots = int((rc.iru >= 0).sum())
    return (size * (36 * n_slots + 36 * PB + M * 384 * 768) + 4 * (2 * rc.iru.numel() + 2 * M),
            36 * PB)


def dense_work(plan, rc, size: int = 4):
    """compact_to_dense's (bytes, flops) for values of ``size`` bytes: the
    table entries it places (36 values a filled slot), the slot ids, the
    diagonal, the occupancy and its [6PB, 6PB] output; one add per diagonal
    element."""
    PB = plan.pad_blocks
    n_slots = int((rc.iru >= 0).sum())
    return (size * (36 * n_slots + 36 * PB + 36 * PB * PB)
            + 4 * (2 * rc.iru.numel() + rc.occ2.numel()), 36 * PB)


def edge_terms_work(E: int, mdim: int, size: int = 4):
    """``edge_terms``' (bytes, flops) over E lanes for values of ``size``
    bytes: each value it needs read once (q 4, fu fv 2, X Y 2, inv_z,
    omega, err mdim and, in stereo, bf) and each of its 72 outputs written
    once; flops: the 54 weighted products' (21 + 6 unique Hpp and Hll, 6 +
    3 gradients, 18 Hpl, each mdim multiplies and mdim - 1 adds) and the
    weighting's (9 mdim), plus ~60 for the rotation, the Jacobians and the
    weight."""
    reads = 10 + mdim + (mdim == 3)
    return E * (reads + 72) * size, E * (54 * (2 * mdim - 1) + 9 * mdim + 60)


def hll_inverse_work(L: int, size: int = 4):
    """``hll_inverse``'s (bytes, flops) over L landmarks for values of
    ``size`` bytes: the 6 distinct entries of each symmetric Hll and its bl
    read once (the 3 mirrored rows are never read), its 12 outputs written
    once; flops: 3 damping adds, 17 for the determinant, the reciprocal,
    18 for the cofactors and 6 scalings."""
    return L * (9 + 12) * size, L * 45


def slot_factors_work(H: int, size: int = 4):
    """``slot_factors``' (bytes, flops) over H slots for values of ``size``
    bytes: Hpl (18) and the gathered [Hll^-1; bl] (12) read once, W (18) and
    W bl (6) written once; flops: 3 multiplies and 2 adds for each of the
    24 outputs."""
    return H * (30 + 24) * size, H * 24 * 5


# the work counts of the kinds whose inputs are the count's own arguments
_WORK = {"edge_terms": edge_terms_work, "hll_inverse": hll_inverse_work,
         "slot_factors": slot_factors_work}


class Site(NamedTuple):
    """A kernel's call at one of an engine's call sites: the name of its
    wrapper in ``ops.segmm``, under which ``LAUNCHES`` counts it, the
    arguments that the wrapper and its plain version take, the tables that
    only the kernel reads (``kwargs``: a CSR or a placement table, bound
    into :meth:`wrapper`), and what its work is counted on: ``kind``
    "gather" (inputs: src, ids), "segsum" (vals, ids, num_out, csr),
    "schur" (W, G, the plan's (plan, sb, li, lj, lk), csr), "band" or
    "dense" (plan, rc, the values' element size), "edge_terms" (E, mdim,
    the values' element size; its wrapper is ``edgerows.term_rows``),
    "hll_inverse" (L, the element size; ``rows.hll_inverse_rows``) or
    "slot_factors" (H, the element size; ``rows.slot_factors_rows``)."""

    kernel: str
    args: tuple
    kwargs: dict
    kind: str
    inputs: tuple

    def wrapper(self, module=segmm):
        """The kernel's wrapper in ``module`` (``ops.segmm`` by default),
        with the site's kernel tables bound."""
        return functools.partial(getattr(module, self.kernel), **self.kwargs)

    def plain(self, module=segmm):
        """The wrapper's plain version in ``module``."""
        return getattr(module, self.kernel + "_plain")

    def call(self, fn):
        """``fn`` (:meth:`wrapper` or :meth:`plain`) on the site's arguments."""
        return fn(*self.args)

    def work(self):
        """(bytes, flops) of the call on this run's data."""
        if self.kind == "gather":
            return gather_work(*self.inputs)
        if self.kind == "segsum":
            return segsum_work(*self.inputs[:3])
        if self.kind == "schur":
            W, _G, sc, csr = self.inputs
            return schur_work(sc[0], sc, csr, W.element_size())
        if self.kind in _WORK:
            return _WORK[self.kind](*self.inputs)
        return (band_work if self.kind == "band" else dense_work)(*self.inputs)


def first_attempt(engine, lam=None):
    """The first damped attempt's (HppT, HplT, lam, W, bscT) on the
    engine's initial state: at the engine's own λ = τ·max diag, or at the
    fixed ``lam`` where one is given (the solve tools' LAM0)."""
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(engine.state)[:2])
    if lam is None:
        lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    else:
        lam = torch.tensor(lam, dtype=HppT.dtype, device=HppT.device)
    _iv9, W, bscT, _g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.rc)
    return HppT, HplT, lam, W.contiguous(), bscT


def row_sites(engine):
    """{label: Site} of the gather and the segment sum at the rows front
    end's call sites, on the engine's initial state: the pose fetch
    (``gather:pose``), the per-slot gather of [Hll^-1; bl]
    (``gather:slot``), the mono pose sums (``segsum:pose``) and
    the mono Hpl-slot sums (``segsum:slot``)."""
    rc, st = engine.rc, engine.state
    psrc = torch.cat([st.qs, st.ts, engine.cams], dim=1).T.contiguous()
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    g12, err, Xc, inv_z = pack_m
    v42, _v12, v18 = edgerows.term_rows(g12, err, Xc, inv_z, rc.omegaT_m, engine.kernels[0], 2)
    HllT = engine._build(pack_m, pack_s)[1]
    src12 = rows.hll_inverse_rows(HllT, torch.ones((), dtype=st.qs.dtype, device=st.qs.device))

    def gather(src, ids):
        return Site("gather", (src, ids), {}, "gather", (src, ids))

    def segsum(vals, ids, num_out, csr):
        return Site("segsum", (vals, ids, num_out), dict(csr=csr), "segsum",
                    (vals, ids, num_out, csr))

    return {
        "gather:pose": gather(psrc, rc.pose_gid_m),
        "gather:slot": gather(src12, rc.hpl_col),
        "segsum:pose": segsum(v42, rc.pose_acc_m, engine.num_p, rc.csr_pose_m),
        "segsum:slot": segsum(v18, rc.e2h_m, engine.plan.hpl_pad, rc.csr_e2h_m),
    }


def edge_sites(engine):
    """{label: Site} of ``edge_terms`` at ``rows.build_system_rows``' call,
    one an edge type the engine holds (``edge_terms:mono``,
    ``edge_terms:stereo``), on the engine's initial state."""
    rc = engine.rc
    packs = engine._residuals_and_chi(engine.state)[:2]
    out = {}
    for label, pack, omegaT, kern, mdim in (("mono", packs[0], rc.omegaT_m, engine.kernels[0], 2),
                                            ("stereo", packs[1], rc.omegaT_s, engine.kernels[1],
                                             3)):
        if pack is None:
            continue
        g12, err, Xc, inv_z = pack
        out[f"edge_terms:{label}"] = Site("edge_terms", (g12, err, Xc, inv_z, omegaT, kern, mdim),
                                          {}, "edge_terms",
                                          (g12.shape[1], mdim, g12.element_size()))
    return out


def factor_sites(engine):
    """{label: Site} of ``hll_inverse`` and ``slot_factors`` at
    ``rows.prepare_factors``' call on the engine's first damped attempt (at
    its own λ = τ·max diag): the landmarks' HllT and λ, the slots' HplT and
    gathered [Hll^-1; bl]."""
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(engine.state)[:2])
    lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.rc)[3]
    size = HllT.element_size()
    return {"hll_inverse": Site("hll_inverse", (HllT, lam), {}, "hll_inverse",
                                (HllT.shape[1], size)),
            "slot_factors": Site("slot_factors", (HplT, g12), {}, "slot_factors",
                                 (HplT.shape[1], size))}


def schur_sites(engine, HplT, W):
    """{label: Site} of ``schur_fused`` on W and HplT and of the segment
    sum at the combine of the engine's formation on its output: v2's one
    (``rows.schur_compact``) or v1's two (``rows.dense_block_table``)."""
    plan, rc = engine.plan, engine.rc
    sc = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    PB = plan.pad_blocks
    out = {"schur_fused": Site("schur_fused", (W, HplT, *sc), dict(csr=rc.csr_sc), "schur",
                               (W, HplT, sc, rc.csr_sc))}
    # the combine's input as the formation makes it
    win = segmm.schur_fused(W, HplT, *sc, csr=rc.csr_sc)
    if plan.v2:
        combines = {"combine": (rc.gkey_up2, PB // 64 * plan.wg, rc.csr_up2)}
    else:
        combines = {"combine_up": (rc.gkey_up, PB * PB, rc.csr_up),
                    "combine_lo": (rc.gkey_lo, PB * PB, rc.csr_lo)}
    for site, (keys, num_out, csr) in combines.items():
        out[f"segsum:{site}"] = Site("segsum", (win, keys, num_out), dict(csr=csr),
                                         "segsum", (win, keys, num_out, csr))
    return out


def placement_site(engine, gT, dbT, dense: bool = False) -> Site:
    """``compact_to_band``'s (or with ``dense`` ``compact_to_dense``'s)
    Site on the compact table gT and the damped diagonal dbT."""
    plan, rc = engine.plan, engine.rc
    if dense:
        return Site("compact_to_dense", (gT, rc.iru, rc.icu, dbT, rc.occ2, plan.pad_blocks,
                                         plan.wg), dict(table=rc.dense_table), "dense",
                    (plan, rc, gT.element_size()))
    return Site("compact_to_band", (gT, rc.iru, rc.icu, dbT, rc.band_occ, plan.pad_blocks,
                                    plan.wg), dict(table=rc.band_table), "band",
                (plan, rc, gT.element_size()))


def placement_library(site):
    """The one PyTorch call that computes a placement site's function
    (``compact_to_band`` or ``compact_to_dense``: -gT's blocks and their
    mirrors, plus dbT on the diagonal, in the output's occupied tiles): an
    accumulating ``Tensor.index_put_`` into a zeroed flat output of the
    values of gT (negated) and dbT that land there, over two flat indices
    built here once per structure, as the placement table is: each
    destination and the value it takes, read off the plain version run on
    the values' own positions.  Returns the call (the negation, the
    concatenation and the values' gather included); it is timed beside
    the kernel and used nowhere in the port."""
    plain = site.plain()
    gT, dbT = site.args[0], site.args[3]
    f64 = dict(dtype=torch.float64, device=gT.device)
    dsts, srcs, base = [], [], 0
    for which in (0, 3):  # gT's values, then dbT's, each at its 1-based position
        args = list(site.args)
        args[0], args[3] = torch.zeros(gT.shape, **f64), torch.zeros(dbT.shape, **f64)
        src = args[which]
        src.copy_(torch.arange(1, src.numel() + 1, **f64).reshape(src.shape))
        out = plain(*args)
        shape, flat = out.shape, out.reshape(-1)
        hit = torch.nonzero(flat).flatten()
        dsts.append(hit)
        srcs.append(base + flat[hit].abs().long() - 1)
        base += src.numel()
        del out, flat
    dst, src, n = torch.cat(dsts), torch.cat(srcs), shape.numel()

    def call():
        vals = torch.cat((gT.reshape(-1).neg(), dbT.reshape(-1)))
        return gT.new_zeros(n).index_put_((dst,), vals[src], accumulate=True).view(shape)

    return call


def engine_sites(engine):
    """{label: Site} of every kernel site of a rows-route engine: the
    gather and the segment sum on its initial state, and where it forms the
    Schur complement ``schur_fused`` and the combine on the first damped
    attempt and the placement its solver runs (v2: ``compact_to_band`` or
    ``compact_to_dense``)."""
    out = row_sites(engine)
    plan, rc = engine.plan, engine.rc
    if plan.schur is None:
        return out
    HppT, HplT, lam, W, _bscT = first_attempt(engine)
    out.update(schur_sites(engine, HplT, W))
    if plan.v2:
        dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, plan.pad_blocks)
        gT = rows.schur_compact(W, HplT, plan, rc)
        if engine.solver in ("band_cr", "band_lr"):
            out["compact_to_band"] = placement_site(engine, gT, dbT)
        elif engine.solver == "dense_cholesky" and rc.dense_table is not None:
            out["compact_to_dense"] = placement_site(engine, gT, dbT, dense=True)
    return out


def interleaved_times(fns, cold: bool = False):
    """{label: (call_ms, device_ms)} for the callables of ``fns`` ({label:
    fn}), timed in turns in one loop of REPEATS rounds under
    ``torch.profiler`` (device activity only): call_ms is the median of the
    CUDA-event time around each call, host work of the wrapper included;
    device_ms the median over the same calls of the summed durations of the
    device kernels, copies and sets the call ran.

    Every call starts from a cache of its own making, so that no call's time
    depends on which call ran before it: an untimed run of the same call
    (warm: its inputs in the L2 as far as they fit), or with ``cold`` a
    read of FLUSH_BYTES (2.5x the L2), which leaves the L2 empty of its
    inputs and clean.  A ``torch.cuda._sleep`` kernel before that run and
    another before the call mark where each starts in the trace (the first
    segment is dropped), two in a row where a round starts, and one after
    the last round.  The trace can miss events (the first few of a
    profiler session and its last ones, as seen on an H100: an untimed
    call before the first mark and after the last one takes that loss),
    so a round counts only where the marks close it and split it into as
    many segments as it made.  Where fewer than half the rounds count, the
    loop runs again in a new profiler session, and it raises after
    PROFILE_TRIES sessions: every time it returns was measured."""
    return {k: v[:2] for k, v in interleaved_kernels(fns, cold).items()}


def interleaved_kernels(fns, cold: bool = False, repeats: int = REPEATS):
    """:func:`interleaved_times` over ``repeats`` rounds, with each label's
    three device kernels of most device time in the same session: {label:
    (call_ms, device_ms, [(kernel name, mean device ms a call), ...])}."""
    labels = list(fns)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        call_ms, whole, marks = _profiled_rounds(fns, labels, cold, repeats)
        if 2 * len(whole) >= repeats:
            print(f"launch floor: median device time of this session's {len(marks)} "
                  f"spin_kernel marks {statistics.median(marks) / 1e3:.4f} ms", flush=True)
            out = {}
            for i, k in enumerate(labels):
                by_name = {}
                for r in whole:
                    for name, us in r[i][1].items():
                        by_name[name] = by_name.get(name, 0.0) + us
                ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
                out[k] = (statistics.median(call_ms[k]),
                          statistics.median(r[i][0] for r in whole) / 1e3,
                          [(name, us / len(whole) / 1e3) for name, us in ranked])
            return out
        print(f"interleaved_times: {len(whole)} of {repeats} rounds whole in the trace",
              flush=True)
    raise RuntimeError(f"device time not measured: the trace split too few rounds in "
                       f"{PROFILE_TRIES} profiler sessions")


def host_times(fns, repeats: int = REPEATS):
    """{label: median host ms} over ``repeats`` calls after one untimed
    call (the CPU's plain versions: no device metric)."""
    out = {}
    for k, fn in fns.items():
        fn()
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        out[k] = statistics.median(ts)
    return out


def _profiled_rounds(fns, labels, cold, repeats):
    """One profiler session of :func:`interleaved_kernels`: ({label: call
    ms per round}, [[(device us, {kernel name: device us}) per label] for
    each round the trace split whole], [device us of each mark]).  A mark
    is a ``torch.cuda._sleep(1)`` kernel, whose device time is the floor of
    one launch in this session.  A call that raises ends the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call_ms = {k: [] for k in labels}
    if cold:
        flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        prepare = {k: flush.sum for k in labels}
    else:
        prepare = fns
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can lose a session's first and last events: an untimed
        # call before the first mark and one after a mark that closes the
        # last round take the loss
        fns[labels[0]]()
        for _ in range(repeats):
            torch.cuda._sleep(1)
            for k in labels:
                torch.cuda._sleep(1)
                prepare[k]()
                torch.cuda._sleep(1)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fns[k]()
                b.record()
                b.synchronize()
                call_ms[k].append(a.elapsed_time(b))
        torch.cuda._sleep(1)
        fns[labels[-1]]()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    segments, cur = [], None  # [events, device us, {name: us}] between consecutive marks
    marks = []
    for start, end, name in spans:
        if "spin_kernel" in name:
            marks.append(end - start)
            if cur is not None:
                segments.append(cur)
            cur = [0, 0.0, {}]
        elif cur is not None:
            cur[0] += 1
            cur[1] += end - start
            cur[2][name] = cur[2].get(name, 0.0) + (end - start)
    # the segment after the closing mark is the untimed tail call
    rounds, rnd = [], None
    for n, us, names in segments:
        if n == 0:  # two marks in a row: a round starts
            if rnd is not None:
                rounds.append(rnd)
            rnd = []
        elif rnd is not None:
            rnd.append((us, names))
    if rnd is not None:
        rounds.append(rnd)
    # each call's segment follows its preparation's
    return call_ms, [r[1::2] for r in rounds if len(r) == 2 * len(labels)], marks


def stage_times(fns, device, repeats: int = REPEATS):
    """{label: (call_ms, device_ms, top kernels)} of the stages of ``fns``:
    on the card :func:`interleaved_kernels` (warm); on the host one call's
    host ms each after an untimed one (the plain versions: a check that
    the stages run, no device metric), device_ms and top None."""
    if torch.device(device).type == "cuda":
        return interleaved_kernels(fns, repeats=repeats)
    return {k: (ms, None, None) for k, ms in host_times(fns, 1).items()}


def print_stages(times, title: str) -> None:
    """A markdown table of :func:`stage_times`' result under ``title``."""
    cuda = any(v[1] is not None for v in times.values())
    call = "call ms (CUDA events, host work included)" if cuda else \
        "host ms (CPU, plain versions; not a device time)"
    print(f"\n{title}\n\n| stage | {call} | device ms | top device kernels (ms a call) |\n"
          "|---|---|---|---|", flush=True)
    for label, (ms, dms, top) in times.items():
        kernels = "; ".join(f"{name[:70]} {t:.4f}" for name, t in top) if top else "–"
        dev = "–" if dms is None else f"{dms:.4f}"
        print(f"| {label} | {ms:.4f} | {dev} | {kernels} |", flush=True)


READ_REPEATS = 200  # calls of host_read_ms


def host_read_ms(fn, device, repeats: int = READ_REPEATS) -> float:
    """Median host-clock ms of ``fn()``, a call that ends in a read to the
    host, each call on an idle device (a synchronize before it)."""
    cuda = torch.device(device).type == "cuda"
    ts = []
    for _ in range(repeats + 1):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts[1:])
