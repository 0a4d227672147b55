"""The extension stage against an earlier checkout's, in turns, on one
card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.extend_before_after build/before
    python -m bwa_mem_scale_tpu_torch.tools.extend_before_after build/before \
        --mem 3

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, as ``probe_before``) and builds
its kernels into its own ``build/``. Each checkout's
``seed_chain_extend`` runs once on a batch; then its seeding, SA lookup
and chaining (``align.collect_seeds``, ``expand_and_lookup``,
``chain_and_filter``) are replaced by their recorded outputs, so that a
call is the extension alone: from the chain filter's outputs to the
returned dict, the four BSW rounds included. This checkout's is seven
launches (csrc/extend.cu's: select, pairs, stage and four BSW rounds
with the band phases inside); an earlier one's may be eleven (the band
phases launched after each BSW call) or torch operations with four host
synchronisations (the BSW wrapper's length check). Both dicts are first
held equal, key by key. Then, in turns (before, after, after, before;
means of 2): the device time of a call (``timing.device_ms``: the stream
held while the call is queued; a call that synchronises inside is timed
through its stalls), the device's busy time in the call (the sum of its
kernels' times, from torch.profiler), the host wall of one synchronised
call (``timing.wall_ms``) and the outermost aten operations a call issues
(``glue_ops.outer_ops``). Beside them, this checkout's launches as the
call makes them, each alone: device ms, the bytes bound (``ext_work``:
each distinct input byte read once, each output written once, the work
these inputs need), the launch floor (the kernel on one read or one
pair) and the launches a call; and, where the earlier checkout has them
(its band phases as ``ext_band_cuda`` launches), each in turns against
it on the same inputs: ext_select_cuda on the batch and on its first read,
and each fused BSW round against the earlier BSW launch (``bsw_rows``)
followed by its ``ext_band_cuda`` phase. First, ptxas's registers and
spills of csrc/bsw.cu's kernels in both checkouts, and of this
checkout's fused rounds.

Batches (``tools/batches.py``): chip_smoke.py phase 5's (512 reads of the
4.6 Mbp cell) at the main path's capacities, its first 64 at tier 1's
and first 8 at tier 2's (``align.tier_config``), the same 512 at the
forced int64 layout, the repeat batch, and 512 of phase 10's long reads
(800-2,500 bp: the seed-SW filter's path). With ``--mem RUNS``, instead,
SE ``mem`` end to end, RUNS runs a checkout in turns
(``kstep_before_after.mem_turns``), then the ``mem -v 4`` stage table's
prefixes (``pipeline/stageprof.py``) on phase 5's batch, 3 turns a
checkout, whose extension row is the full program less the chain prefix.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import inspect
import re
import sys
import types
from functools import partial

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import extend_cuda
from ..ops.bsw_cuda import banded_swa_batch_cuda
from ..ops import bsw_cuda, nvcc_build
from ..ops.bsw import banded_swa_batch
from ..ops.extend import Left, Sel, Stage, bsw_inputs, live_seeds
from ..pipeline import align
from .batches import long_batch, repeat_batch, se_batch
from .glue_ops import outer_ops
from .probe_before_after import load_before
from .timing import card_line, device_ms, wall_ms

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
STAGES = ("collect_seeds", "expand_and_lookup", "chain_and_filter")
KERNELS = ("ext_select_cuda", "ext_pairs_cuda", "ext_stage_cuda",
           "ext_bsw_band_cuda")
BSW_OPS_PER_CELL = 20        # chip_smoke.py's count a band cell


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` and do `ops` integer operations."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _distinct(keys) -> int:
    return int(torch.unique(keys).numel())


def _union_bytes(lo, hi, top: int) -> int:
    """Bytes of [0, top] in the union of the windows [lo, hi) (int64
    tensors of one length), each index clamped into [0, top] as the kernel
    clamps it: a window wholly outside still reads its end byte."""
    lo = lo.clamp(0, top)
    hi = torch.maximum(hi.clamp(max=top + 1), lo + 1)
    o = torch.argsort(lo)
    lo, hi = lo[o], hi[o]
    reach = torch.cummax(hi, 0).values
    prev = torch.cat([lo[:1], reach[:-1]])
    return int((hi - torch.maximum(lo, prev)).clamp(min=0).sum())


def ext_work(name: str, args) -> tuple:
    """(bytes, integer operations) a call of extension kernel `name` needs
    on these inputs, each distinct input byte read once and each output
    written once. ext_select: the live seeds' qbeg, len and rbeg, the
    chains' counts, order and kept, the ranked seeds' scores, the rmax
    rows, sel; 40 operations a live seed (its span) and 2 S a ranked seed
    (the count). ext_pairs: a read's flags, count and meta, a pair's read,
    candidate and flag; 20 a read and 10 a pair. ext_stage: a row's read,
    candidate and flag; each distinct candidate's sel entry and seed, each
    distinct chain's rid and rmax, each distinct read's length and codes;
    the union of the rows' reference windows (the invalid rows share read
    0's candidate 0's); the rows and windows written (int32); 8
    operations a window element. ext_bsw_band: BSW's (the live pairs'
    query and target codes, each pair's lengths and h0 read, its rows
    written, BSW_OPS_PER_CELL a band cell the plain BSW walks), a pair's
    stage rows and the earlier round's rows read, its outputs; in phase 3
    each distinct (read, slot) chain's live flags and live seeds (6
    operations a live seed a row)."""
    if name == "ext_select_cuda":
        ch, order, kept, seed_live, seed_score, lens, dbns, opt, R = args
        B, C, S = ch.seed_qbeg.shape
        P = ch.seed_rbeg.element_size()
        n_live = int(live_seeds(ch, seed_live).sum())
        ranked = int(ext_select_ranked(ch, order, kept, seed_live, R))
        nbytes = (n_live * (8 + P) + (B * C * S if seed_live is not None
                                      else 4 * B * C)
                  + 8 * B * C + 4 * ranked + 4 * B + 8 * dbns.offsets.numel()
                  + 5 * B + 4 * B * R + 16 * B * C)
        return nbytes, 40 * n_live + 2 * S * ranked
    if name == "ext_pairs_cuda":
        sel, PX = args[:2]
        B = sel.sel.shape[0]
        return 26 * B + 9 * PX + 5, 20 * B + 10 * PX
    if name == "ext_stage_cuda":
        pr, sel, ch, codes, lens, ref, l_pac, TL, opt = args
        PX = pr.read.shape[0]
        B, L = codes.shape
        _, C, S = ch.seed_qbeg.shape
        R = sel.sel.shape[1]
        P = ch.seed_rbeg.element_size()
        read, cand = pr.read.long(), pr.cand.long()
        ss = sel.sel[read, cand].long()
        rbeg = ch.seed_rbeg.reshape(B, C * S)[read, ss].long()
        re0 = rbeg + ch.seed_len.reshape(B, C * S)[read, ss].long()
        ref_bytes = _union_bytes(torch.cat([rbeg - TL, re0]),
                                 torch.cat([rbeg, re0 + TL]), 2 * l_pac - 1)
        nbytes = (9 * PX + (12 + P) * _distinct(read * R + cand)
                  + 20 * _distinct(read * C + ss // S)
                  + (4 + 4 * L) * _distinct(read) + ref_bytes
                  + PX * (48 + 8) + 4 * PX * (2 * L + 2 * TL))
        return nbytes, 30 * PX + 8 * PX * (2 * L + 2 * TL)
    phase, st, pr, lens, r1, left, ch, seed_live, opt = args[:9]
    PX = pr.read.shape[0]
    q, ln, t, h0, w = bsw_inputs(phase, st, lens, left, opt)
    stats = {}
    banded_swa_batch(q, ln[0], t, ln[1], h0, w, opt.o_del, opt.e_del,
                     opt.o_ins, opt.e_ins, opt.zdrop, opt.mat, stats=stats)
    read = {0: 4, 1: 24, 2: 12, 3: 24 + 24 + 8}[phase]
    write = {0: 8, 1: 32, 2: 8, 3: 12 + 24 + 56}[phase]
    live = (ln[0] > 0) & (ln[1] > 0)            # the pairs BSW walks
    nbytes = (PX * (1 + 4 + 20 + 8 + read + write)
              + 4 * (int((ln[0] + ln[1])[live].sum()) + 3 * PX + 6 * PX))
    ops = 20 * PX + BSW_OPS_PER_CELL * stats.get("bsw_cells", 0)
    if phase == 3:
        _, C, S = ch.seed_qbeg.shape
        P = ch.seed_rbeg.element_size()
        b, slot = pr.read.long(), st.slot.long()
        live = live_seeds(ch, seed_live)[b, slot].sum(1)
        chain = b * C + slot
        keys, first = torch.unique(chain, return_inverse=True)
        n_live = torch.zeros(len(keys), dtype=live.dtype,
                             device=live.device).scatter_(0, first, live)
        nbytes += (int(n_live.sum()) * (8 + P)
                   + len(keys) * (S if seed_live is not None else 4))
        ops += 6 * int(live.sum())
    return nbytes, ops


def ext_select_ranked(ch, order, kept, seed_live, R):
    """The seeds ext_select_kernel ranks: the candidates it writes, at
    most R a read."""
    B, C, S = ch.seed_qbeg.shape
    live = live_seeds(ch, seed_live)
    by_pos = live.gather(1, order.long()[:, :, None].expand(B, C, S))
    n = (by_pos & (kept > 0)[:, :, None]).sum((1, 2))
    return n.clamp(max=R).sum()


def _cols(x, k=1):
    return x[..., :k].contiguous()


def one_item(name, args):
    """`args` cut to one read (ext_select, ext_pairs) or one pair
    (ext_stage, ext_bsw_band): the launch floor's inputs."""
    if name == "ext_select_cuda":
        ch, order, kept, seed_live, seed_score, lens, dbns, opt, R = args
        return (type(ch)(*(f[:1] for f in ch)), order[:1], kept[:1],
                None if seed_live is None else seed_live[:1],
                seed_score[:1], lens[:1], dbns, opt, R)
    if name == "ext_pairs_cuda":
        sel, PX, cnt, M, coord_of, ch_of, sw_of, frac_rep = args
        return (Sel(*(f[:1] for f in sel)), sel.sel.shape[1], cnt[:1], M,
                coord_of[:1], ch_of[:1], None if sw_of is None else sw_of[:1],
                frac_rep[:1])
    if name == "ext_stage_cuda":
        pr = args[0]
        return (pr._replace(read=pr.read[:1], cand=pr.cand[:1],
                            valid=pr.valid[:1]), *args[1:])
    phase, st, pr, lens, r1, left, ch, seed_live, opt = args[:9]
    m = torch.cat([t.reshape(-1, t.shape[-1])[:, :1] for t in (
        st.qbeg, st.slen, st.rid, st.slot, st.plens, st.lens, st.bl,
        st.h0)]).contiguous()
    st1 = Stage(*m[:5], m[5:9], m[9:11], m[11], st.rbeg[:1], st.q_l[:1],
                st.t_l[:1], st.q_r[:1], st.t_r[:1])
    left1 = None
    if left is not None:
        n = torch.cat([t.reshape(-1, t.shape[-1])[:, :1] for t in (
            left.qb, left.score, left.truesc, left.w, left.bl)]).contiguous()
        left1 = Left(*n[:4], n[4:6], left.rb[:1])
    return (phase, st1, pr._replace(read=pr.read[:1], valid=pr.valid[:1]),
            _cols(lens), None if r1 is None else _cols(r1), left1, ch,
            seed_live, opt)


def kernel_calls(run) -> list:
    """[(wrapper name, args)] of the extension kernels run() launches, in
    order, through align's call sites (keyword arguments made
    positional)."""
    made = []
    real = {n: getattr(align, n) for n in KERNELS}

    def rec(n):
        def call(*a, **k):
            b = inspect.signature(real[n]).bind(*a, **k)
            b.arguments.pop("stats", None)
            made.append((n, b.args))
            return real[n](*a, **k)
        return call
    for n in KERNELS:
        setattr(align, n, rec(n))
    try:
        run()
    finally:
        for n, fn in real.items():
            setattr(align, n, fn)
    return made


@contextlib.contextmanager
def extension_only(mods, recorded):
    """Each module of `mods` with its seeding, SA lookup and chaining
    returning `recorded[mod]`'s outputs."""
    saved = [(m, n, getattr(m, n)) for m in mods for n in STAGES]
    for m in mods:
        for n in STAGES:
            setattr(m, n, (lambda out: lambda *a, **k: out)(recorded[m][n]))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def record_stages(mod, run):
    """{stage name: its output} of one run() through mod's call sites."""
    out = {}
    real = {n: getattr(mod, n) for n in STAGES}

    def rec(n):
        def call(*a, **k):
            out[n] = real[n](*a, **k)
            return out[n]
        return call
    for n in STAGES:
        setattr(mod, n, rec(n))
    try:
        run()
    finally:
        for n, fn in real.items():
            setattr(mod, n, fn)
    return out


def busy_ms(fn) -> float:
    """The sum of the device kernels' times in one fn() (torch.profiler),
    or None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / 1e3 if total else None


def cases():
    """(name, index, codes, lens, PipelineConfig, forced int64)."""
    base = align.PipelineConfig(seed_engine="onehot")
    idx, codes, lens = se_batch(512)
    t1 = align.tier_config(base, 1, 64)
    yield "phase 5's batch", idx, codes, lens, base, False
    yield "tier 1 (64 reads)", idx, codes[:64], lens[:64], t1, False
    yield ("tier 2 (8 reads)", idx, codes[:8], lens[:8],
           align.tier_config(t1, 2, 8), False)
    yield "int64", idx, codes, lens, base, True
    ridx, rc, rl = repeat_batch(512)
    yield "repeat batch", ridx, rc, rl, base, False
    lidx, lc, ll = long_batch(512)
    yield "long reads", lidx, lc, ll, base, False


def run_case(case, old, card, dev) -> None:
    name, idx, codes, lens, cfg, wide = case
    opt = MemOptions()
    root = {"before": "probe_before", "after": "bwa_mem_scale_tpu_torch"}
    mods = {"before": old, "after": align}
    thunks, recorded, outs = {}, {}, {}
    L = codes.shape[1]
    for v, mod in mods.items():
        occ = importlib.import_module(root[v] + ".ops.occ")
        chain = importlib.import_module(root[v] + ".ops.chain")
        fmi = occ.DeviceFMIndex.from_host(idx, dev, force_int64=wide)
        dbns = chain.DeviceBns.from_host(idx.bns, dev)
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        cfg_v = mod.PipelineConfig(**dataclasses.asdict(cfg))
        thunks[v] = partial(mod.seed_chain_extend, fmi, dbns, c, ln, L,
                            opt=opt, cfg=cfg_v)
        recorded[mod] = record_stages(mod, thunks[v])
    with extension_only(list(mods.values()), recorded):
        for v in mods:
            outs[v] = thunks[v]()
        torch.cuda.synchronize()
        for k, want in outs["before"].items():
            if not torch.equal(outs["after"][k], want):
                raise SystemExit(f"{name}: {k} differs after vs before")
        ms = {v: dict(device=0.0, busy=0.0, wall=0.0) for v in mods}
        for v in ["before", "after", "after", "before"]:
            ms[v]["device"] += device_ms(thunks[v], 20, dev) / 2
            b = busy_ms(thunks[v])
            ms[v]["busy"] = None if b is None or ms[v]["busy"] is None \
                else ms[v]["busy"] + b / 2
            ms[v]["wall"] += wall_ms(thunks[v]) / 2
        ops = {v: outer_ops(thunks[v]) for v in mods}
        made = kernel_calls(thunks["after"])
        base_launches = banded_swa_batch_cuda.launches
        thunks["after"]()
        bsw = banded_swa_batch_cuda.launches - base_launches
    fmt = lambda x: "not measured" if x is None else f"{x:.5f}"
    PX = int(outs["after"]["packed"].shape[0])
    print(f"[ext] {name} (B={len(codes)}, L={L}, C={cfg.max_chains}, "
          f"S={cfg.max_seeds_per_chain}, R={cfg.max_regs}, PX={PX}, "
          f"{int(outs['after']['valid'].sum())} pairs valid, positions "
          f"{'int64' if wide else 'int32'}): the dicts equal; device ms "
          f"{ms['after']['device']:.5f} [before {ms['before']['device']:.5f}]"
          f", device busy {fmt(ms['after']['busy'])} [before "
          f"{fmt(ms['before']['busy'])}], host wall of a synchronised call "
          f"{ms['after']['wall']:.5f} [before {ms['before']['wall']:.5f}], "
          f"outer aten ops {ops['after']} [before {ops['before']}], BSW "
          f"launches {bsw}  [{card}]", flush=True)
    per = {}
    for n, a in made:
        per.setdefault(n, []).append(a)
    for n, calls in per.items():
        wrapper = getattr(extend_cuda, n)
        for a in calls:
            what = n if n != "ext_bsw_band_cuda" else f"{n} phase {a[0]}"
            t = device_ms(lambda: wrapper(*a), 20, dev)
            one = one_item(n, a)
            floor = device_ms(lambda: wrapper(*one), 20, dev)
            nbytes, nops = ext_work(n, a)
            b = bound(nbytes, nops)
            print(f"[ext] {name}: {what}: {t:.5f} ms, bound {b[0]:.6f} ms "
                  f"by {b[1]} ({nbytes} bytes, {nops} operations), launch "
                  f"floor {floor:.5f} ms (one "
                  f"{'read' if n in KERNELS[:2] else 'pair'}), launches a "
                  f"call {len(calls)}  [{card}]", flush=True)
    if hasattr(sys.modules.get("probe_before.ops.extend_cuda"),
               "ext_band_cuda"):
        kernel_turns(name, made, card, dev)


def _turns(fns, dev) -> dict:
    """{version: device ms, mean of 2}, in turns: before, after, after,
    before."""
    ms = {v: 0.0 for v in fns}
    for v in ("before", "after", "after", "before"):
        ms[v] += device_ms(fns[v], 20, dev) / 2
    return ms


def _flat(x):
    return [t for v in x for t in _flat(v)] if isinstance(x, tuple) else [x]


def kernel_turns(name, made, card, dev) -> None:
    """The case's ext_select launch (the batch and its first read) and
    each fused BSW round in turns against an earlier checkout whose
    band phases are kernels of their own (``ext_band_cuda``): its
    ext_select_cuda, and its BSW launch (bsw_rows) followed by its
    ext_band_cuda phase, on the same inputs, each output held equal
    first."""
    old_ext = importlib.import_module("probe_before.ops.extend_cuda")
    old_bsw = importlib.import_module("probe_before.ops.bsw_cuda")
    for n, a in made:
        if n == "ext_select_cuda":
            for what, x in (("the batch", a), ("one read", one_item(n, a))):
                fns = {"before": lambda x=x: old_ext.ext_select_cuda(*x),
                       "after": lambda x=x: extend_cuda.ext_select_cuda(*x)}
                got, want = fns["after"](), fns["before"]()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"{name}: ext_select differs after vs "
                                     f"before")
                t = _turns(fns, dev)
                print(f"[ext] {name}: ext_select_cuda, {what}, in turns: "
                      f"{t['after']:.5f} ms [before {t['before']:.5f}]  "
                      f"[{card}]", flush=True)
        if n != "ext_bsw_band_cuda":
            continue
        phase, st, pr, lens, r1, left, ch, seed_live, opt = a[:9]
        q, ln, t_, h0, w = bsw_inputs(phase, st, lens, left, opt)
        pen = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
               opt.mat)

        def before(phase=phase, st=st, pr=pr, r1=r1, left=left, ch=ch,
                   seed_live=seed_live, opt=opt, q=q, ln=ln, t_=t_, h0=h0,
                   w=w):
            rows = old_bsw.bsw_rows(q, ln, t_, h0, w, *pen)
            if phase in (0, 2):
                return rows, old_ext.ext_band_cuda(phase, st, pr, rows, None,
                                                   left, ch, seed_live, opt)
            return rows, old_ext.ext_band_cuda(phase, st, pr, r1, rows, left,
                                               ch, seed_live, opt)
        fns = {"before": before,
               "after": lambda a=a: extend_cuda.ext_bsw_band_cuda(*a)}
        got, want = _flat(fns["after"]()), _flat(fns["before"]())
        if len(got) != len(want) or not all(
                torch.equal(g, x) for g, x in zip(got, want)):
            raise SystemExit(f"{name}: fused BSW round {phase} differs from "
                             f"the earlier BSW launch and band phase")
        tm = _turns(fns, dev)
        print(f"[ext] {name}: BSW round {phase} with its band phase, in "
              f"turns: one launch {tm['after']:.5f} ms [before: BSW then "
              f"ext_band_kernel<{phase}>, {tm['before']:.5f}]  [{card}]",
              flush=True)


def ptxas_turn(card) -> None:
    """ptxas's registers and spills of csrc/bsw.cu's kernels as each
    checkout builds them (both built here), and of this checkout's fused
    rounds (csrc/extend.cu's bsw_band_kernel) and ext_select_kernel."""
    old_nvcc = importlib.import_module("probe_before.ops.nvcc_build")
    old_bsw = importlib.import_module("probe_before.ops.bsw_cuda")
    old_bsw.build(force=True)
    bsw_cuda.build(force=True)
    extend_cuda.build(force=True)
    # by the kernel's name and template arguments (the mangled parameter
    # types differ between the checkouts)
    name = re.compile(r"\d+((?:bsw|ext)_[a-z_]+?kernel)"
                      r"(I(?:Li\d+ELb[01]E|[ix]E))?")
    kern = lambda rep, keep: {
        "".join(g or "" for g in name.search(k).groups()): v
        for k, v in nvcc_build.ptxas_kernels(rep).items()
        if any(x in k for x in keep)}
    before = kern(old_nvcc.REPORTS["bsw_cuda"], ("bsw_",))
    after = kern(nvcc_build.REPORTS["bsw_cuda"], ("bsw_",))
    fused = kern(nvcc_build.REPORTS["extend_cuda"],
                 ("bsw_band", "ext_select"))
    print(f"[ptxas] csrc/bsw.cu, (registers, spill bytes) by kernel: "
          f"{sorted(after.items())} [before {sorted(before.items())}]; "
          f"{'equal' if after == before else 'DIFFERENT'}  [{card}]",
          flush=True)
    print(f"[ptxas] csrc/extend.cu: {sorted(fused.items())}  [{card}]",
          flush=True)


def prefix_turns(old_root: str, card: str, dev, turns: int = 3) -> None:
    """The `mem -v 4` stage table's prefixes on phase 5's batch for each
    checkout, `turns` turns a checkout; the extension row is the full
    program less the chain prefix."""
    idx, codes, lens = se_batch(512)
    opt = MemOptions()
    got = {}
    for t in range(turns):
        for v in (["before", "after"] if t % 2 == 0 else ["after", "before"]):
            root = "probe_before" if v == "before" else \
                "bwa_mem_scale_tpu_torch"
            mod = importlib.import_module(root + ".pipeline.align")
            prof = importlib.import_module(root + ".pipeline.stageprof")
            occ = importlib.import_module(root + ".ops.occ")
            chain = importlib.import_module(root + ".ops.chain")
            cfg = mod.PipelineConfig(seed_engine="onehot")
            al = types.SimpleNamespace(
                opt=opt, cfg=cfg, device=dev, dfma=None, dert=None,
                fmi=occ.DeviceFMIndex.from_host(idx, dev),
                dbns=chain.DeviceBns.from_host(idx.bns, dev),
                _to_device=lambda c, ln: (torch.as_tensor(c, device=dev),
                                          torch.as_tensor(ln, device=dev)))
            al._extend = partial(mod.seed_chain_extend, opt=opt, cfg=cfg)
            with open("/dev/null", "w") as null:
                times = prof.device_stage_profile(al, codes, lens, file=null)
            got.setdefault(v, []).append(times)
    for v, runs in got.items():
        ext = [r["+extend(full)"] - r["+chain/filter"] for r in runs]
        full = [r["+extend(full)"] for r in runs]
        print(f"[ext] -v 4 prefix table, phase 5's batch, {v}: extension "
              f"row {sum(ext) / len(ext):.5f} s (runs "
              + ", ".join(f"{x:.5f}" for x in ext)
              + f"), full program {sum(full) / len(full):.5f} s  [{card}]",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.extend_before_after",
        description="Time the extension stage against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    ap.add_argument("--mem", type=int, default=0, metavar="RUNS",
                    help="instead, SE mem end to end in turns, RUNS runs "
                         "a checkout, and the -v 4 prefix table")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    if args.mem:
        from .kstep_before_after import mem_turns
        mem_turns(args.before, args.mem, card, tables=("none",))
        prefix_turns(args.before, card, dev)
        return 0
    old = importlib.import_module("probe_before.pipeline.align")
    ptxas_turn(card)
    for case in cases():
        run_case(case, old, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
