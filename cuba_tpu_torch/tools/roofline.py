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


class Site(NamedTuple):
    """A kernel wrapper's call at one of an engine's call sites: its name
    in ``ops.segmm`` (the plain version, ``kernel + "_plain"``, takes the
    same arguments), the arguments, and what its work is counted on:
    ``kind`` "gather" (inputs: src, ids), "segsum" (vals, ids, num_out,
    csr), "schur" (W, G, the plan's (plan, sb, li, lj, lk), csr), "band" or
    "dense" (plan, rc, the values' element size)."""

    kernel: str
    args: tuple
    kwargs: dict
    kind: str
    inputs: tuple

    def call(self, fn):
        """``fn`` (the wrapper or its plain version) on the site's arguments."""
        return fn(*self.args, **self.kwargs)

    def work(self):
        """(bytes, flops) of the call on this run's data."""
        if self.kind == "gather":
            return gather_work(*self.inputs)
        if self.kind == "segsum":
            return segsum_work(*self.inputs[:3])
        if self.kind == "schur":
            W, _G, sc, csr = self.inputs
            return schur_work(sc[0], sc, csr, W.element_size())
        return (band_work if self.kind == "band" else dense_work)(*self.inputs)


def first_attempt(engine, lam=None):
    """The first damped attempt's (HppT, HplT, lam, W, bscT) on the
    engine's initial state: at the engine's own λ = τ·max diag, or at the
    fixed ``lam`` where one is given (the solve tools' LAM0)."""
    plan, rc = engine.plan, engine.rc
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(engine.state)[:2])
    if lam is None:
        lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    else:
        lam = torch.tensor(lam, dtype=HppT.dtype, device=HppT.device)
    _iv9, W, bscT, _g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p,
                                               engine.num_l, plan, rc)
    return HppT, HplT, lam, W.contiguous(), bscT


def row_sites(engine):
    """{label: Site} of kernels 1-6 at the rows front end's call sites, on
    the engine's initial state: the pose fetch (resident and windowed), the
    per-slot gather of [Hll^-1; bl], the mono pose sums (windowed and
    resident) and the mono Hpl-slot sums."""
    plan, rc, st = engine.plan, engine.rc, engine.state
    total_p = st.qs.shape[0]
    psrc = torch.zeros((12, plan.p_res_pad), dtype=st.qs.dtype, device=st.qs.device)
    psrc[:, :total_p] = torch.cat([st.qs, st.ts, engine.cams], dim=1).T
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    g12, err, Xc, inv_z = pack_m
    R = edgerows.rotmat_rows(g12[0:4])
    v42, _v12, v18 = edgerows.term_rows(err, Xc, R, inv_z, g12[7:12], rc.omegaT_m,
                                        engine.kernels[0], 2)
    HppT, HllT, HplT = engine._build(pack_m, pack_s)
    lam = torch.ones((), dtype=st.qs.dtype, device=st.qs.device)
    iv9 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.num_l, plan, rc)[0]
    src12 = torch.cat([iv9, HllT[9:12]])
    if plan.rg_m is not None:
        wsrc, wids = psrc.index_select(1, rc.res_perm), rc.pose_gidr_m
    else:
        wsrc, wids = psrc, rc.pose_gid_m
    P = engine.num_p

    def gather(kernel, src, ids, *rest):
        return Site(kernel, (src, ids, *rest), {}, "gather", (src, ids))

    def segsum(kernel, vals, ids, num_out, *rest, csr):
        return Site(kernel, (vals, ids, num_out, *rest), dict(csr=csr), "segsum",
                    (vals, ids, num_out, csr))

    return {
        "resident_gather": gather("resident_gather", psrc, rc.pose_gid_m),
        "windowed_gather": gather("windowed_gather", wsrc, wids, plan.rg_m, None),
        "tiled_gather": gather("tiled_gather", src12, rc.hpl_col, plan.ivs, None),
        "accum_segsum_windowed": segsum("accum_segsum_windowed", v42, rc.pose_acc_m, P,
                                        plan.paw_m, None, csr=rc.csr_pose_m),
        "tiled_segsum": segsum("tiled_segsum", v18, rc.e2h_m, plan.hpl_pad, plan.hpl_m, None,
                               csr=rc.csr_e2h_m),
        "accum_segsum": segsum("accum_segsum", v42, rc.pose_acc_m, P, csr=rc.csr_pose_m),
    }


def schur_sites(engine, HplT, W):
    """{label: Site} of ``schur_fused`` on W and HplT and of ``tiled_segsum``
    at the combine of the engine's formation on its output: v2's one
    (``rows.schur_compact``) or v1's two (``rows.dense_block_table``)."""
    plan, rc = engine.plan, engine.rc
    sc = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    PB = plan.pad_blocks
    out = {"schur_fused": Site("schur_fused", (W, HplT, *sc), dict(csr=rc.csr_sc), "schur",
                               (W, HplT, sc, rc.csr_sc))}
    # the combine's input as the formation makes it
    win = segmm.schur_fused(W, HplT, *sc, csr=rc.csr_sc)
    win = torch.nn.functional.pad(win, (0, plan.wpad - win.shape[1]))
    if plan.v2:
        combines = {"combine": (rc.gkey_up2, PB // 64 * plan.wg, plan.up2, rc.csr_up2)}
    else:
        combines = {"combine_up": (rc.gkey_up, PB * PB, plan.up, rc.csr_up),
                    "combine_lo": (rc.gkey_lo, PB * PB, plan.lo, rc.csr_lo)}
    for site, (keys, num_out, tplan, csr) in combines.items():
        out[f"tiled_segsum:{site}"] = Site(
            "tiled_segsum", (win, keys, num_out, tplan, tplan.base_block), dict(csr=csr),
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
    plain = getattr(segmm, site.kernel + "_plain")
    gT, dbT = site.args[0], site.args[3]
    f64 = dict(dtype=torch.float64, device=gT.device)
    dsts, srcs, base = [], [], 0
    for which in (0, 3):  # gT's values, then dbT's, each at its 1-based position
        args = list(site.args)
        args[0], args[3] = torch.zeros(gT.shape, **f64), torch.zeros(dbT.shape, **f64)
        src = args[which]
        src.copy_(torch.arange(1, src.numel() + 1, **f64).reshape(src.shape))
        out = plain(*args, **site.kwargs)
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
    """{label: Site} of every kernel site of a rows-route engine: kernels
    1-6 on its initial state, and where it forms the Schur complement
    ``schur_fused`` and the combine on the first damped attempt and the
    placement its solver runs (v2: ``compact_to_band`` or
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
