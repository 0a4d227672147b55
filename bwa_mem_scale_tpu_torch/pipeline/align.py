"""Single-end and paired-end alignment pipeline on one GPU (or the CPU
when named).

Counterpart of ``bwa_mem_scale_tpu/pipeline/align.py``. Per batch:

  device: SMEM seeding -> SA lookup -> chaining -> chain filter ->
          (batches holding long reads) the seed-SW filter ->
          left/right banded extension with band-doubling retries
          (``seed_chain_extend``, eager PyTorch; BSW and the seed-SW
          scorer in CUDA kernels)
  host:   the native finalizer (dedup/patch, primary marking, CIGAR,
          SAM text; ``native/finalize.cpp``), shared with the JAX
          package; for pairs, its one-call PE stage (insert-size
          stats, mate rescue, pairing, records: ``finalize_pe_rows``),
          or the Python PE path (``pipeline/pe.py``) for a batch the
          native stage declines.

``GpuAligner`` carries the surface that ``SeStream`` and the driver
call: ``dispatch_batch`` / ``fetch_extend`` / ``finalize_stage_*`` for
single reads, ``dispatch_pairs`` / ``fetch_pairs`` / ``pe_post`` for
pairs, and the JAX package's in-process single-end API: ``emf_filter``,
``align_batch``, ``finalize_batch``, ``align_and_finalize`` and
``align_reads_to_sam``. Those probe the EMF table on the device
(``ops/emf_cuda.py``, the kernel of ``csrc/emf.cu``) when the table
passes the residency gate (``EMF_DEVICE_BYTES``); the SE stream and the
PE path probe it on the host. JAX's jitted programs become cached
configurations: the retry tiers are ``seed_chain_extend`` bound to
larger capacities. ``fetch_extend`` is the device sync point (``.cpu()``
of ``packed``, ``meta`` and the probe's outputs). With ``mesh=``
(``parallel/mesh.py``) every device stage of a batch (the EMF probe,
seeding to extension, the retry tiers) runs read-sharded over the mesh's
devices, each holding a replica of the index and its tables; the host
stages see global read ids, as in the JAX package's ``TpuAligner(mesh=)``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import time
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from ..config import MemOptions, MEM_F_PRIMARY5, needs_seed_sw_filter
from ..index.artifacts import FMIndex
from ..index.perfect import emf_lookup_host
from ..io.sam import aln_to_sam_line
from ..pipeline import native_finalize
from ..ref.extend import AlnReg
from ..ref.finalize import (sort_dedup_patch, mark_primary,
                                    reorder_primary5)
from ..utils.profiling import PROFILER
from ..device import synchronize
from ..ops.bsw import banded_swa_batch
from ..ops.bsw_cuda import banded_swa_batch_cuda
from ..ops.chain import DeviceBns
from ..ops.chain_cuda import chain_filter_cuda, chain_seeds_cuda
from ..ops.emf import DeviceEmf, FW_MATCHED, RC_MATCHED
from ..ops.emf_cuda import emf_lookup_cuda
from ..ops.ert import DeviceErt, collect_smems_ert
from ..ops.occ import DeviceFMIndex
from ..ops.sal import expand_and_lookup
from ..ops.seedsw import seed_sw_filter
from ..ops.smem import SmemBuf, collect_smems_device, compact_indices
from ..ops.smem_oh import collect_smems_oh
from ..ops.smem_rl import collect_smems_rl
from ..ops.window import take_windows, ref_windows
from ..parallel.mesh import (Mesh, concat as mesh_concat,
                             globalize as mesh_globalize, pad_to_multiple,
                             sharded_emf_fn, split_rows)
from .perfect import perfect_regs, perfect_sam_records


def _cal_max_gap(qlen, a, o_del, e_del, o_ins, e_ins, w):
    tdiv = partial(torch.div, rounding_mode="trunc")
    l_del = tdiv(qlen * a - o_del, e_del) + 1
    l_ins = tdiv(qlen * a - o_ins, e_ins) + 1
    return torch.clamp(torch.maximum(l_del, l_ins), min=1, max=w << 1)


@dataclasses.dataclass
class PipelineConfig:
    """Fixed-shape capacities for the device pipeline (the fields and
    defaults of the JAX package's PipelineConfig)."""
    max_smem_out: Optional[int] = None   # per pass; default read length
    max_coords: int = 512                # SA coordinates per read
    max_chains: int = 64
    max_seeds_per_chain: int = 32
    max_regs: int = 64                   # extension candidates per read
    max_pairs: int = 4096                # extension pairs per batch
    target_pad: int = 8
    # "sweep" (ops/smem.py, the FMA table's engine), "onehot"
    # (ops/smem_oh.py, the CLI's default) or "readlane" (ops/smem_rl.py,
    # read-per-lane machines at full depth; ignores the FMA table); all
    # three give identical output
    seed_engine: str = "sweep"
    # readlane worker lanes: a lane pulls the next task of the backlog as
    # it finishes one (kt_for's dynamic scheduling); None = one a task
    seed_lanes: Optional[int] = None
    # "auto": the CUDA kernel for CUDA tensors, the plain PyTorch
    # version for CPU tensors; "plain": the plain version everywhere
    # (the kernel's reference on the card)
    bsw_engine: str = "auto"
    # per-lane emission / interval-stack depths (None = read length):
    # "auto" = 24 for an int32-position index and the read length for an
    # int64 one, forced or not (hg38-class repeat density overflowed 62%
    # of reads at depth 24 in the JAX package)
    seed_emit_depth: object = "auto"
    seed_stack_depth: object = "auto"
    reseed_factor: int = 2


class StageProfile:
    """Per-stage seconds between device synchronisations (``mem -v 4``).
    Each stage boundary synchronises, which serialises the host and
    the device: the numbers say where device time goes, at some cost
    to end-to-end throughput."""

    STAGES = ("seed", "sal", "chain", "seedsw", "bsw")

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = collections.Counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t0


def _stage(prof: Optional[StageProfile], name: str):
    return prof.stage(name) if prof is not None else contextlib.nullcontext()


def collect_seeds(fmi: DeviceFMIndex, codes, lens, L: int, *,
                  opt: MemOptions, cfg: PipelineConfig, fma=None, ert=None,
                  full_depth: bool = False,
                  stats: Optional[dict] = None) -> SmemBuf:
    """The batch's SMEMs from the engine seed_chain_extend takes (see
    there): the ERT descent when `ert` is given, else cfg.seed_engine.
    full_depth runs the one-hot engine at the read length, as the JAX
    package's stage table does, in place of its "auto" depths."""
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              max_out=cfg.max_smem_out or L, stats=stats)
    if ert is not None:
        return collect_smems_ert(ert, fmi.ref, codes, lens,
                                 pos_dtype=fmi.pos_dtype,
                                 seq_len=2 * fmi.l_pac, **kw)
    if cfg.seed_engine == "readlane":
        return collect_smems_rl(fmi, codes, lens, lanes=cfg.seed_lanes, **kw)
    if cfg.seed_engine == "onehot":
        auto = 24 if fmi.pos_dtype == torch.int32 else None
        ed, sd = cfg.seed_emit_depth, cfg.seed_stack_depth
        if full_depth:
            ed = sd = None
        return collect_smems_oh(
            fmi, codes, lens, emit_depth=auto if ed == "auto" else ed,
            stack_depth=auto if sd == "auto" else sd,
            reseed_factor=cfg.reseed_factor, **kw)
    return collect_smems_device(fmi, codes, lens, fma=fma, **kw)


def chain_and_filter(dbns: DeviceBns, bufs: SmemBuf, rbeg, seed_idx,
                     coord_valid, lens, *, opt: MemOptions,
                     cfg: PipelineConfig, stats: Optional[dict] = None):
    """Chaining and the chain filter of one batch: (the chains, the
    filter's (order, kept, its third output, frac_rep))."""
    # the kernels on CUDA tensors, the plain versions on CPU ones; called
    # by this module's names, which a caller may swap
    ch = chain_seeds_cuda(
        dbns, bufs, rbeg, seed_idx, coord_valid, w=opt.w,
        max_chain_gap=opt.max_chain_gap, max_chains=cfg.max_chains,
        max_seeds_per_chain=cfg.max_seeds_per_chain, stats=stats)
    return ch, chain_filter_cuda(
        ch, dbns, bufs, lens, min_chain_weight=opt.min_chain_weight,
        mask_level=opt.mask_level, max_chain_gap=opt.max_chain_gap,
        drop_ratio=opt.drop_ratio, min_seed_len=opt.min_seed_len,
        max_chain_extend=opt.max_chain_extend, max_occ=opt.max_occ,
        stats=stats)


def seed_chain_extend(fmi: DeviceFMIndex, dbns: DeviceBns, codes, lens,
                      L: int, *, opt: MemOptions, cfg: PipelineConfig,
                      fma=None, ert=None, prof: Optional[StageProfile] = None,
                      stats: Optional[dict] = None) -> dict:
    """Seeding -> chaining -> extension for one batch.

    codes [B, L] int32 and lens [B] int32 on fmi's device. Returns the
    JAX package's output dict: per-pair fields, ``packed [PX, 14]``
    int32 and ``meta [B, 2]`` float32 for the host, and the per-read
    overflow flags. Reference positions run at fmi's position dtype
    (int64 on its int64 layout). Seeding takes cfg.seed_engine: "sweep"
    (with `fma`, a DeviceFmaTable at fmi's position dtype, as each lane's
    start), "onehot" or "readlane" (on cfg.seed_lanes worker lanes, at full
    depth), the last two ignoring `fma`; with `ert` (an
    ``ops/ert.DeviceErt`` of the same text) the ERT descent seeds instead,
    whatever the engine, as in the JAX package. `stats` collects loop tick
    counts."""
    B = codes.shape[0]
    dev = codes.device
    i32, i64 = torch.int32, torch.int64
    lens = lens.to(i32)
    with _stage(prof, "seed"):
        bufs = collect_seeds(fmi, codes, lens, L, opt=opt, cfg=cfg, fma=fma,
                             ert=ert, stats=stats)
    with _stage(prof, "sal"):
        rbeg, seed_idx, coord_valid, total, coord_of = expand_and_lookup(
            fmi, bufs, opt.max_occ, cfg.max_coords, stats=stats)
    # SMEM buffer at capacity: possible overflow -> retry at larger shape
    smem_of = bufs.cnt >= bufs.m.shape[1]
    with _stage(prof, "chain"):
        ch, (order, kept, _, frac_rep) = chain_and_filter(
            dbns, bufs, rbeg, seed_idx, coord_valid, lens, opt=opt, cfg=cfg,
            stats=stats)

    C, S, R = cfg.max_chains, cfg.max_seeds_per_chain, cfg.max_regs
    sidx = torch.arange(S, dtype=i32, device=dev)[None, None, :]
    if needs_seed_sw_filter(opt, L):
        # the long-read regime (mem_flt_chained_seeds): a batch wide
        # enough to hold a read the filter applies to; each read's own
        # length decides whether its seeds are re-scored
        with _stage(prof, "seedsw"):
            seed_live, seed_score, sw_of = seed_sw_filter(
                fmi, dbns, codes, lens, ch, order, kept, opt,
                max_sw=cfg.max_pairs, stats=stats)
    else:
        seed_live = sidx < ch.n_seeds[:, :, None]      # [B, C, S] by slot
        seed_score = ch.seed_score
        sw_of = torch.zeros((B,), dtype=torch.bool, device=dev)

    # ---- (chain, seed) candidates in processing order: seeds of
    # earlier kept chains first, then best score first (ties: larger
    # seed index) within a chain
    kept_chain = kept > 0                              # [B, C] sorted pos
    o3 = order.long()[:, :, None].expand(B, C, S)
    live_by_pos = seed_live.gather(1, o3)
    score_by_pos = seed_score.gather(1, o3)
    svalid = live_by_pos & kept_chain[:, :, None]
    seed_key = torch.where(svalid, (score_by_pos << 16) | sidx, -1)
    # valid keys are distinct, so a key's descending-sort position is
    # the count of strictly larger keys (invalid ones tie but are masked)
    key_order = torch.argsort(seed_key, dim=2, descending=True)
    seed_rank = torch.empty_like(seed_key).scatter_(
        2, key_order, sidx.expand(B, C, S).contiguous())  # [B, C, S]
    nlive = svalid.sum(2, dtype=i32)
    base = torch.cumsum(nlive, 1, dtype=i32) - nlive
    dense = torch.where(svalid, base[:, :, None] + seed_rank, 1 << 30)
    n_cand = nlive.sum(1, dtype=i32)
    reg_overflow = n_cand > R
    # sel encodes (data slot, seed idx) as slot*S + sidx
    slotflat = (order[:, :, None] * S + sidx).reshape(B, C * S)
    tgt = dense.reshape(B, C * S).clamp(max=R).long()
    sel_ss = torch.zeros((B, R + 1), dtype=i32, device=dev)
    sel_ss.scatter_(1, tgt, slotflat)
    sel_ss = sel_ss[:, :R]
    sel_valid = torch.arange(R, device=dev)[None, :] < n_cand[:, None]
    sel_slot = sel_ss // S
    ss = sel_ss.long()
    g_qbeg = ch.seed_qbeg.reshape(B, C * S).gather(1, ss)
    g_rbeg = ch.seed_rbeg.reshape(B, C * S).gather(1, ss)
    g_len = ch.seed_len.reshape(B, C * S).gather(1, ss)
    g_rid = ch.rid.gather(1, sel_slot.long())

    # ---- per-chain reference span rmax (by slot)
    a_, w_ = opt.a, opt.w
    l_pac = dbns.l_pac
    cs_qbeg = ch.seed_qbeg.to(i64)
    cs_len = ch.seed_len.to(i64)
    cs_rbeg = ch.seed_rbeg.to(i64)
    gap_l = _cal_max_gap(cs_qbeg, a_, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, w_)
    flank_r = lens.to(i64)[:, None, None] - cs_qbeg - cs_len
    gap_r = _cal_max_gap(flank_r, a_, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, w_)
    l_pac2 = 2 * l_pac
    rmax0 = torch.where(seed_live, cs_rbeg - (cs_qbeg + gap_l),
                        l_pac2).min(2).values.clamp(min=0)
    rmax1 = torch.where(seed_live, cs_rbeg + cs_len + flank_r + gap_r,
                        0).max(2).values.clamp(max=l_pac2)
    # first live seed (slot 0 when none is live)
    first_i = torch.argmax(seed_live.to(i32), dim=2, keepdim=True)
    first_rbeg = cs_rbeg.gather(2, first_i)[..., 0]
    bridging = (rmax0 < l_pac) & (l_pac < rmax1)
    rmax1 = torch.where(bridging & (first_rbeg < l_pac), l_pac, rmax1)
    rmax0 = torch.where(bridging & (first_rbeg >= l_pac), l_pac, rmax0)
    # clamp to the contig of the first seed (bns_fetch_seq_v2)
    mid_f, mid_rev = dbns.depos(first_rbeg)
    mrid = dbns.pos2rid(mid_f).clamp(min=0).long()
    n_off = torch.cat([dbns.offsets,
                       torch.tensor([l_pac], dtype=i64, device=dev)])
    far_beg = dbns.offsets[mrid]
    far_end = n_off[mrid + 1]
    rmax0 = torch.maximum(rmax0, torch.where(mid_rev, l_pac2 - far_end,
                                             far_beg))
    rmax1 = torch.minimum(rmax1, torch.where(mid_rev, l_pac2 - far_beg,
                                             far_end))
    rm0 = rmax0.gather(1, sel_slot.long())             # [B, R]
    rm1 = rmax1.gather(1, sel_slot.long())

    # ---- compact candidates to pair space (read-major, rank order)
    PX = cfg.max_pairs
    flatv = sel_valid.reshape(B * R)
    pidx, p_valid = compact_indices(flatv, PX)
    pair_overflow = flatv.sum() > PX
    pair_rank = torch.cumsum(flatv.to(i32), 0) - 1
    read_pair_of = (flatv & (pair_rank >= PX)).reshape(B, R).any(1)
    pidx = pidx.long()
    p_read = pidx // R
    topair = lambda x: x.reshape(B * R)[pidx]
    p_qbeg = topair(g_qbeg)
    p_rbeg = topair(g_rbeg).to(i64)
    p_len = topair(g_len)
    p_rid = topair(g_rid)
    p_slot = topair(sel_slot).long()
    p_rm0 = topair(rm0)
    p_rm1 = topair(rm1)
    p_lens = torch.where(p_valid, lens[p_read], 0)

    # ---- extension pair sequences [PX, ...]
    TL = L + 2 * w_ + cfg.target_pad
    p_codes = codes[p_read]                            # [PX, L]
    # left: query reversed prefix, target reversed ref[rm0:rbeg]
    ql_len = torch.where(p_valid, p_qbeg, 0)
    q_l = take_windows(p_codes, p_qbeg - 1, L, reverse=True)
    tl_len = torch.where(p_valid, p_rbeg - p_rm0, 0).to(i32)
    t_l = ref_windows(fmi.ref, p_rbeg - 1, TL, l_pac, reverse=True)
    # right: query suffix from qe, target ref[rbeg+len : rm1]
    p_qe = p_qbeg + p_len
    qr_len = torch.where(p_valid, p_lens - p_qe, 0)
    q_r = take_windows(p_codes, p_qe, L)
    re0 = p_rbeg + p_len.to(i64)
    tr_len = torch.where(p_valid, p_rm1 - re0, 0).to(i32)
    t_r = ref_windows(fmi.ref, re0, TL, l_pac)
    do_left = p_valid & (p_qbeg > 0)
    do_right = p_valid & (p_qe < p_lens)
    h0_l = (p_len * a_).to(i32)

    bsw = banded_swa_batch if cfg.bsw_engine == "plain" \
        else banded_swa_batch_cuda

    def run_bsw(q, qlen, t, tlen, h0, wv):
        return bsw(q.to(i32), qlen.to(i32), t, tlen.to(i32), h0.to(i32),
                   wv, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                   opt.zdrop, opt.mat, stats=stats)

    def pick(r1, r2, which2):
        return type(r1)(*(torch.where(which2, b, a) for a, b in zip(r1, r2)))

    accept = (w_ >> 1) + (w_ >> 2)
    with _stage(prof, "bsw"):
        # left extension with band-doubling retry
        resL1 = run_bsw(q_l, torch.where(do_left, ql_len, 0), t_l,
                        torch.where(do_left, tl_len, 0), h0_l, w_)
        need2 = do_left & ~(resL1.max_off < accept)
        resL2 = run_bsw(q_l, torch.where(need2, ql_len, 0), t_l,
                        torch.where(need2, tl_len, 0), h0_l, w_ << 1)
        resL = pick(resL1, resL2, need2)
        wL = torch.where(need2, w_ << 1, w_)
        score_l = torch.where(do_left, resL.score, p_len * a_)
        gs_ok_l = (resL.gscore <= 0) | (resL.gscore
                                        <= score_l - opt.pen_clip5)
        qb = torch.where(do_left & gs_ok_l, p_qbeg - resL.qle, 0)
        qb = torch.where(do_left, qb, 0)
        rb = torch.where(do_left,
                         torch.where(gs_ok_l, p_rbeg - resL.tle,
                                     p_rbeg - resL.gtle), p_rbeg)
        truesc = torch.where(do_left,
                             torch.where(gs_ok_l, score_l, resL.gscore),
                             p_len * a_)
        a_w = torch.where(do_left, torch.clamp(wL, min=w_), w_)

        # right extension (h0 = left score)
        resR1 = run_bsw(q_r, torch.where(do_right, qr_len, 0), t_r,
                        torch.where(do_right, tr_len, 0), score_l, w_)
        accR1 = (resR1.score == score_l) | (resR1.max_off < accept)
        needR2 = do_right & ~accR1
        resR2 = run_bsw(q_r, torch.where(needR2, qr_len, 0), t_r,
                        torch.where(needR2, tr_len, 0), score_l, w_ << 1)
        resR = pick(resR1, resR2, needR2)
        wR = torch.where(needR2, w_ << 1, w_)
    score_f = torch.where(do_right, resR.score, score_l)
    gs_ok_r = (resR.gscore <= 0) | (resR.gscore <= score_f - opt.pen_clip3)
    qe_f = torch.where(do_right & gs_ok_r, p_qe + resR.qle, p_lens)
    re_f = torch.where(do_right,
                       re0 + torch.where(gs_ok_r, resR.tle,
                                         resR.gtle).to(i64), re0)
    truesc = truesc + torch.where(
        do_right, torch.where(gs_ok_r, score_f, resR.gscore) - score_l, 0)
    a_w = torch.where(do_right, torch.maximum(a_w, wR), a_w)

    # ---- seed coverage over the final region (pair space)
    ch_q = ch.seed_qbeg[p_read, p_slot]                # [PX, S]
    ch_r = ch.seed_rbeg[p_read, p_slot].to(i64)
    ch_l = ch.seed_len[p_read, p_slot]
    inside = (seed_live[p_read, p_slot]
              & (ch_q >= qb[:, None]) & (ch_q + ch_l <= qe_f[:, None])
              & (ch_r >= rb[:, None]) & (ch_r + ch_l <= re_f[:, None]))
    seedcov = torch.where(inside, ch_l, 0).sum(1, dtype=i64)

    # one int32 matrix with every per-pair field the host needs (int64
    # reference positions split into 31-bit halves)
    packed = torch.stack(
        [p_valid.to(i32), p_read.to(i32), qb.to(i32), qe_f.to(i32),
         score_f.to(i32), truesc.to(i32), a_w.to(i32), seedcov.to(i32),
         p_rid.to(i32), p_len.to(i32),
         (rb & 0x7FFFFFFF).to(i32), (rb >> 31).to(i32),
         (re_f & 0x7FFFFFFF).to(i32), (re_f >> 31).to(i32)], dim=1)
    # any capacity that truncated this read's work: the host reruns it
    read_overflow = (smem_of | coord_of | ch.overflow | reg_overflow
                     | read_pair_of | sw_of)
    meta = torch.stack([frac_rep.to(torch.float32),
                        read_overflow.to(torch.float32)], dim=1)
    return dict(
        valid=p_valid, read=p_read.to(i32), qb=qb, qe=qe_f, rb=rb, re=re_f,
        score=score_f, truesc=truesc, w=a_w, seedcov=seedcov, rid=p_rid,
        seedlen0=p_len, frac_rep=frac_rep, packed=packed, meta=meta,
        read_overflow=read_overflow, smem_cnt=bufs.cnt, coord_total=total,
        chain_overflow=ch.overflow, reg_overflow=reg_overflow,
        pair_overflow=pair_overflow)


class GpuAligner:
    """Device index state plus the single-end pipeline stages."""

    EMF_CODE_NAMES = ("no_table", "with_n", "not_matched", "fw_matched",
                      "rc_matched")
    # overflow-retry tier batches
    RETRY_BATCH = 64
    RETRY2_BATCH = 8

    def __init__(self, idx: FMIndex, device, opt: MemOptions = None,
                 cfg: PipelineConfig = None, emf=None, fma=None, ert=None,
                 cp2=None, mesh: Optional[Mesh] = None):
        if not native_finalize.available():
            raise RuntimeError(
                "the native finalizer (native/libfinalize.so) is required: "
                "build it with `make -C native`")
        self.idx = idx
        # with a mesh (parallel/mesh.py) every device stage of a batch runs
        # read-sharded over it; the aligner's own device is its first
        self.mesh = mesh
        self.device = mesh[0] if mesh is not None else torch.device(device)
        self.opt = opt or MemOptions()
        self.cfg = cfg or PipelineConfig(seed_engine="onehot")
        if not idx.pos_fits_int32:
            # hg38-class repeat density overflows ~20% of a batch (the
            # JAX package's measure): retries are a volume path there,
            # served in few wide batches
            self.RETRY_BATCH = 512
            self.RETRY2_BATCH = 16
        # with the k-gram checkpoint table (index/kstep.py), every FM walk of
        # every tier extends K bases a row fetch
        self.fmi = DeviceFMIndex.from_host(idx, self.device, cp2=cp2)
        self.dbns = DeviceBns.from_host(idx.bns, self.device)
        # the FMA ladder table (ops/fma.py) at the index's position dtype,
        # each sweep lane's start; every tier takes it
        self.dfma = (fma.to_device(self.fmi.pos_dtype, self.device)
                     if fma is not None else None)
        # the ERT (index/ert.py) on the device; when present it seeds every
        # tier, whatever the engine. Its leaves resolve through the full SA
        self.dert: Optional[DeviceErt] = None
        if ert is not None:
            if idx.sa_compx != 0:
                raise ValueError("ERT mode needs a full-SA index "
                                 "(build with sa_compx=0)")
            self.dert = DeviceErt.from_host(ert, self.fmi.sa_samples,
                                            idx.count, self.device)
        # one replica of the index and its tables on each other distinct
        # device of the mesh (a repeated device shares one)
        self._replicas = {}
        for dev in (mesh.distinct()[1:] if mesh is not None else ()):
            fmi_d = DeviceFMIndex.from_host(idx, dev, cp2=cp2)
            self._replicas[dev] = (
                fmi_d, DeviceBns.from_host(idx.bns, dev),
                fma.to_device(fmi_d.pos_dtype, dev) if fma is not None
                else None,
                DeviceErt.from_host(ert, fmi_d.sa_samples, idx.count, dev)
                if ert is not None else None)
        self.emf = emf               # host EMF table
        # its device copy, made at the first device probe (mem's stream
        # probes on the host and never reads it); None past the gate; the
        # copies on the mesh's other devices in _demfs
        self.demf: Optional[DeviceEmf] = None
        self._demfs = {}
        self.emf_resident = False
        if emf is not None:
            # the JAX package's residency gate, its variable and default
            # (4 GB, set for a TPU's HBM): a genome-scale table (hg38 at
            # 2^30 slots is ~22 GB) stays on the host, where the stream
            # probes it anyway
            emf_bytes = (emf.loc.nbytes + emf.fp.nbytes + emf.cnt.nbytes
                         + emf.fwless.nbytes)
            if emf_bytes <= int(os.environ.get("EMF_DEVICE_BYTES",
                                               4 << 30)):
                self.emf_resident = True
            else:
                print(f"* EMF table ({emf_bytes / 1e9:.1f} GB) stays "
                      f"host-resident (HBM budget); the streaming driver "
                      f"probes it on host", file=sys.stderr)
        self.emf_hits = 0
        self.emf_checked = 0
        self.emf_hist = collections.Counter()
        self.pes = None              # fixed insert-size stats (-I)
        self.overflow_retried = 0    # reads rerun at tier 1
        self.overflow_tier2 = 0      # of them, rerun at tier 2
        self.overflow_oracle = 0     # of those, run by the NumPy oracle
        self.batches = 0
        self.stats = {}              # loop ticks summed over batches
        self.prof: Optional[StageProfile] = None   # set for mem -v 4
        # mem -v 4: the one-shot device stage table (pipeline/stageprof.py)
        # on the first batch dispatched
        self.stage_profile_pending = False
        self._extend = partial(seed_chain_extend, opt=self.opt, cfg=self.cfg)
        self._retry_fn = self._retry2_fn = None

    # -- counters and reports -------------------------------------------
    def _emf_count(self, code_arr):
        """Accumulate the per-outcome EMF histogram."""
        c = np.bincount(np.asarray(code_arr, dtype=np.int64).ravel(),
                        minlength=5)
        for name, n in zip(self.EMF_CODE_NAMES, c[:5]):
            if n:
                self.emf_hist[name] += int(n)

    def emf_report(self, file=sys.stderr):
        """EMF outcome histogram and overflow-retry counters."""
        if self.emf_hist:
            total = sum(self.emf_hist.values())
            print("EMF outcomes:", file=file)
            for name in self.EMF_CODE_NAMES:
                n = self.emf_hist.get(name, 0)
                if n:
                    print(f"  {name:<12} {n:>10}  "
                          f"({100.0 * n / total:5.1f}%)", file=file)
        if self.overflow_retried:
            print(f"overflow retries: {self.overflow_retried} reads "
                  f"({self.overflow_oracle} to oracle)", file=file)

    def tick_report(self, file=sys.stderr):
        """Lockstep-loop ticks per main batch (each exit test of those
        loops is one host synchronisation on a GPU)."""
        if not self.batches:
            return
        per = {k: v / self.batches for k, v in sorted(self.stats.items())}
        print(f"loop ticks per batch ({self.batches} batches): "
              + ", ".join(f"{k} {v:.1f}" for k, v in per.items()),
              file=file)
        if self.prof is not None:
            print("device stage seconds (synchronised): "
                  + ", ".join(f"{k} {self.prof.seconds[k]:.3f}"
                              for k in StageProfile.STAGES), file=file)

    # -- device stage ----------------------------------------------------
    def _to_device(self, codes, lens, device=None):
        dev = self.device if device is None else device
        return (torch.as_tensor(np.ascontiguousarray(codes, np.int32),
                                device=dev),
                torch.as_tensor(np.ascontiguousarray(lens, np.int32),
                                device=dev))

    def _replica(self, dev):
        """(fmi, dbns, dfma, dert) on `dev`: this aligner's own on its
        device, else the mesh replica's."""
        if dev == self.device:
            return self.fmi, self.dbns, self.dfma, self.dert
        return self._replicas[dev]

    def _device_emf(self, dev=None) -> DeviceEmf:
        """The EMF table on `dev` (default the aligner's device), uploaded
        at the first call."""
        if dev is None or dev == self.device:
            if self.demf is None:
                self.demf = DeviceEmf.from_host(self.emf, self.device)
            return self.demf
        if dev not in self._demfs:
            self._demfs[dev] = DeviceEmf.from_host(self.emf, dev)
        return self._demfs[dev]

    def _probes_on_device(self, L: int) -> bool:
        return self.emf_resident and L >= self.emf.seed_len

    def _step_on(self, dev, fn, c_dev, l_dev, L, probe, prof=None,
                 stats=None):
        """(probe outputs or None, fn's output) for reads on `dev`: the EMF
        probe (with probe; hits' lengths zeroed on the device), then fn,
        seed_chain_extend bound to a tier's capacities."""
        fmi, dbns, dfma, dert = self._replica(dev)
        pm = None
        if probe:
            pm = emf_lookup_cuda(self._device_emf(dev), fmi.ref, c_dev,
                                 l_dev)
            hit = (pm["code"] == FW_MATCHED) | (pm["code"] == RC_MATCHED)
            l_dev = torch.where(hit, 0, l_dev)
        out = fn(fmi, dbns, c_dev, l_dev, L=L, fma=dfma, ert=dert, prof=prof,
                 stats=stats)
        return pm, out

    def _device_step(self, fn, codes, lens, L, probe=False, prof=None,
                     stats=None):
        """One batch's device stages on the aligner's device, or
        read-sharded over the mesh: each shard on its device against its
        replica, the batch padded with empty reads to a multiple of the
        mesh (the retry tiers' batches too), read ids global, the shards'
        outputs joined on the aligner's device, per-read rows past the
        batch dropped. Returns (probe outputs or None, output)."""
        if self.mesh is None:
            c_dev, l_dev = self._to_device(codes, lens)
            return self._step_on(self.device, fn, c_dev, l_dev, L, probe,
                                 prof, stats)
        n = self.mesh.size
        B = codes.shape[0]
        codes_p, lens_p, _ = pad_to_multiple(codes, lens, n)
        if probe:            # each device's table, before the shards run
            for dev in self.mesh.distinct():
                self._device_emf(dev)
        n_local = codes_p.shape[0] // n

        def shard(s, dev, c, ln):
            st = {} if stats is not None else None
            c_dev, l_dev = self._to_device(c, ln, dev)
            pm, out = self._step_on(dev, fn, c_dev, l_dev, L, probe,
                                    stats=st)
            return pm, mesh_globalize(out, s, n_local), st

        res = self.mesh.run(shard, split_rows(codes_p, n),
                            split_rows(lens_p, n))
        for _, _, st in res:        # summed on the aligner's device
            for k, v in (st or {}).items():
                if isinstance(v, torch.Tensor):
                    v = v.to(self.device)
                stats[k] = stats.get(k, 0) + v
        out = mesh_concat([r[1] for r in res], self.device)
        out["meta"] = out["meta"][:B]
        pm = None
        if probe:
            pm = {k: v[:B] for k, v in
                  mesh_concat([r[0] for r in res], self.device).items()}
        return pm, out

    def emf_filter(self, codes: np.ndarray, lens: np.ndarray):
        """The perfect-match prefilter (mem_kernel1_core's EMF pass,
        src/bwamem.cpp:1085-1130) on the device, read-sharded over a
        mesh: code, slot, loc and n_loc as numpy arrays, or None without
        a device table or for reads narrower than the seed."""
        if not self._probes_on_device(int(codes.shape[1])):
            return None
        if self.mesh is None:
            c_dev, l_dev = self._to_device(codes, lens)
            out = emf_lookup_cuda(self._device_emf(), self.fmi.ref, c_dev,
                                  l_dev)
        else:
            B = codes.shape[0]
            codes_p, lens_p, _ = pad_to_multiple(
                np.ascontiguousarray(codes, np.int32),
                np.ascontiguousarray(lens, np.int32), self.mesh.size)
            emfs = {d: self._device_emf(d) for d in self.mesh.distinct()}
            refs = {d: self._replica(d)[0].ref for d in self.mesh.distinct()}
            out = {k: v[:B] for k, v in sharded_emf_fn(self.mesh)(
                emfs, refs, codes_p, lens_p).items()}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def dispatch_batch(self, codes: np.ndarray, lens: np.ndarray,
                       skip_emf: bool = False):
        """Run the device stages of one batch: the EMF probe (unless
        skip_emf, or without a device table), the hit reads' lengths
        zeroed on the device, then seeding to extension, read-sharded
        over a mesh. Returns the handle fetch_extend and finalize_stage_a
        take."""
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        if self.stage_profile_pending:
            self.stage_profile_pending = False
            from .stageprof import device_stage_profile
            device_stage_profile(self, codes, lens)
        probe = not skip_emf and self._probes_on_device(int(codes.shape[1]))
        # StageProfile synchronises one device: a mesh's shards run without
        pm, out = self._device_step(
            self._extend, codes, lens, int(codes.shape[1]), probe=probe,
            prof=self.prof if self.mesh is None else None, stats=self.stats)
        self.batches += 1
        return (codes, lens, pm, out)

    def fetch_extend(self, handle):
        """Copy packed, meta and the probe's code, slot and loc (one
        stacked [B, 3] int64 copy) to the host: the device sync point.
        Returns the 5-tuple handle form finalize_stage_a consumes."""
        if len(handle) == 5:
            return handle
        codes, lens, pm, out = handle
        slot = {"packed": out["packed"].cpu().numpy(),
                "meta": out["meta"].cpu().numpy()}
        if pm is not None:
            slot["pm_cs"] = torch.stack(
                [pm["code"].long(), pm["slot"].long(), pm["loc"]],
                dim=1).cpu().numpy()
        return (codes, lens, pm, out, {"slot": slot})

    def _run_device(self, fn, codes, lens, L):
        _, out = self._device_step(fn, codes, lens, L)
        return out, {"packed": out["packed"].cpu().numpy(),
                     "meta": out["meta"].cpu().numpy()}

    def _regs_from_device(self, out, codes: np.ndarray, prefetched=None):
        """(all_regs, overflow): raw regions per read from the fetched
        packed/meta arrays; overflow marks truncated reads."""
        if prefetched is None:
            prefetched = {"packed": out["packed"].cpu().numpy(),
                          "meta": out["meta"].cpu().numpy()}
        pk, meta = prefetched["packed"], prefetched["meta"]
        frac_rep = meta[:, 0]
        overflow = meta[:, 1] > 0.5
        is_alt = self.idx.bns.is_alt
        B = codes.shape[0]
        (valid, read, qb_a, qe_a, score_a, truesc_a, w_a, seedcov_a,
         rid_a, seedlen0_a, rb_lo, rb_hi, re_lo, re_hi) = pk.T
        rb_a = (rb_hi.astype(np.int64) << 31) | rb_lo
        re_a = (re_hi.astype(np.int64) << 31) | re_lo
        all_regs: List[List[AlnReg]] = [[] for _ in range(B)]
        rows = np.flatnonzero(valid & (qe_a > qb_a))
        cols = [c[rows].tolist() for c in
                (read, rb_a, re_a, qb_a, qe_a, rid_a, score_a, truesc_a,
                 w_a, seedcov_a, seedlen0_a)]
        frep = frac_rep[read[rows]].tolist()
        alt = is_alt[rid_a[rows]].tolist()
        for (i, rb, re, qb, qe, rid, sc, tsc, w, scov, sl0), fr, al \
                in zip(zip(*cols), frep, alt):
            all_regs[i].append(AlnReg(
                rb=rb, re=re, qb=qb, qe=qe, rid=rid, score=sc, truesc=tsc,
                w=w, seedcov=scov, seedlen0=sl0, frac_rep=fr,
                is_alt=bool(al)))
        return all_regs, overflow

    # -- overflow retry ladder -------------------------------------------
    def _retry_jit(self):
        """Tier 1: seed_chain_extend bound to multiplied capacities (the
        JAX package's tier formulas)."""
        if self._retry_fn is None:
            c = self.cfg
            cfg_big = PipelineConfig(
                max_smem_out=4 * (c.max_smem_out or 128),
                max_coords=max(1024, 2 * c.max_coords),
                max_chains=max(256, 4 * c.max_chains),
                max_seeds_per_chain=max(64, 2 * c.max_seeds_per_chain),
                max_regs=max(512, 4 * c.max_regs),
                max_pairs=0, target_pad=c.target_pad,
                seed_engine=c.seed_engine, bsw_engine=c.bsw_engine,
                seed_emit_depth=48, seed_stack_depth=48, reseed_factor=8)
            cfg_big.max_pairs = min(self.RETRY_BATCH * cfg_big.max_regs,
                                    128 * self.RETRY_BATCH)
            self._retry_cfg = cfg_big
            self._retry_fn = partial(seed_chain_extend, opt=self.opt,
                                     cfg=cfg_big)
        return self._retry_fn

    def _retry2_jit(self):
        """Tier 2: full seeding depth and 16x coordinates."""
        if self._retry2_fn is None:
            c1 = self._retry_cfg
            cfg2 = PipelineConfig(
                max_smem_out=2 * c1.max_smem_out,
                max_coords=16 * c1.max_coords,
                max_chains=4 * c1.max_chains,
                max_seeds_per_chain=4 * c1.max_seeds_per_chain,
                max_regs=4 * c1.max_regs, max_pairs=0,
                target_pad=c1.target_pad, seed_engine=c1.seed_engine,
                bsw_engine=c1.bsw_engine, seed_emit_depth=None,
                seed_stack_depth=None, reseed_factor=256)
            cfg2.max_pairs = self.RETRY2_BATCH * cfg2.max_regs
            self._retry2_cfg = cfg2
            self._retry2_fn = partial(seed_chain_extend, opt=self.opt,
                                      cfg=cfg2)
        return self._retry2_fn

    def _oracle_raw_regs(self, query: np.ndarray):
        """Raw regions for one read via the NumPy oracle: the
        unbounded-capacity fallback of last resort."""
        from ..ref.fm import FMOracle
        from ..ref import chain as chain_mod
        from ..ref.extend import chain2aln
        if not hasattr(self, "_fm_oracle"):
            self._fm_oracle = FMOracle(self.idx)
        opt, bns = self.opt, self.idx.bns
        smems = self._fm_oracle.collect_smems(query, 0, opt)
        chains = chain_mod.chain_seeds(self._fm_oracle, opt, bns, query, 0,
                                       smems)
        chains = chain_mod.chain_flt(opt, chains)
        chain_mod.flt_chained_seeds(opt, bns, self.idx.ref_string, query,
                                    chains)
        return chain2aln(opt, bns, self.idx.ref_string, query, chains)

    def _apply_overflow_retry(self, all_regs, overflow, codes, lens):
        """Replace truncated reads' regions with reruns at the tier-1
        shape, then tier 2, then the oracle."""
        idxs = [int(i) for i in np.flatnonzero(overflow) if int(lens[i]) > 0]
        if not idxs:
            return all_regs
        self.overflow_retried += len(idxs)
        fn = self._retry_jit()
        L = int(codes.shape[1])
        RB, RB2 = self.RETRY_BATCH, self.RETRY2_BATCH
        for base in range(0, len(idxs), RB):
            grp = idxs[base: base + RB]
            gc = np.full((RB, L), 4, dtype=np.int32)
            gl = np.zeros(RB, dtype=np.int32)
            for j, i in enumerate(grp):
                gc[j] = codes[i]
                gl[j] = lens[i]
            out, pf = self._run_device(fn, gc, gl, L)
            regs2, of2 = self._regs_from_device(out, gc, prefetched=pf)
            tier2 = []
            for j, i in enumerate(grp):
                if of2[j]:
                    tier2.append(i)
                else:
                    all_regs[i] = regs2[j]
            self.overflow_tier2 += len(tier2)
            fn2 = self._retry2_jit() if tier2 else None
            for base2 in range(0, len(tier2), RB2):
                grp2 = tier2[base2: base2 + RB2]
                g2c = np.full((RB2, L), 4, dtype=np.int32)
                g2l = np.zeros(RB2, dtype=np.int32)
                for j, i in enumerate(grp2):
                    g2c[j] = codes[i]
                    g2l[j] = lens[i]
                out2, pf2 = self._run_device(fn2, g2c, g2l, L)
                regs3, of3 = self._regs_from_device(out2, g2c,
                                                    prefetched=pf2)
                for j, i in enumerate(grp2):
                    if of3[j]:   # still truncated: the oracle never drops
                        self.overflow_oracle += 1
                        all_regs[i] = self._oracle_raw_regs(
                            codes[i, : lens[i]].astype(np.uint8))
                    else:
                        all_regs[i] = regs3[j]
        return all_regs

    # -- host finalize ---------------------------------------------------
    def finalize_stage_a(self, handle, id_offset: int = 0, read_ids=None,
                         sam_ctx=None):
        """Fetch (if not yet fetched) and run the host record pipeline.
        With sam_ctx (names/quals/rg_id) the native finalizer composes
        SAM text; stage_b then returns bytes per read."""
        codes, lens, _, out, pf = self.fetch_extend(handle)
        pf = pf["slot"]
        pm_records = self._perfect_records(pf, codes, lens)
        nat = self._finalize_native(pf, codes, lens, id_offset, read_ids,
                                    pm_records, sam_ctx=sam_ctx)
        if nat is not None:
            return nat
        # the native arena declined this batch: Python record path on
        # the same regions, CIGARs from the native kswg library
        from .finalize import BatchFinalizer
        all_regs, overflow = self._regs_from_device(out, codes,
                                                    prefetched=pf)
        if overflow.any():
            with PROFILER.phase("overflow_retry"):
                all_regs = self._apply_overflow_retry(all_regs, overflow,
                                                      codes, lens)
        rids = (np.asarray(read_ids, dtype=np.int64) if read_ids is not None
                else id_offset + np.arange(codes.shape[0], dtype=np.int64))
        recs = self._records_from_regs(
            codes, lens, np.ones(codes.shape[0], bool), all_regs, rids)
        recs.update(pm_records)
        records = [recs[i] for i in range(codes.shape[0])]
        if sam_ctx is not None:
            return ("pysam", records, sam_ctx, codes, lens)
        return ("native", records, {})

    def _perfect_records(self, pf, codes, lens) -> dict:
        """The device probe's hits as records (mem_perfect2sam), counted
        in the EMF histogram: {batch index: [Aln, ...]}; {} when the
        batch was not probed on the device."""
        if "pm_cs" not in pf:
            return {}
        cs = pf["pm_cs"]
        code, slot, loc = cs[:, 0], cs[:, 1], cs[:, 2]
        hit = (code == FW_MATCHED) | (code == RC_MATCHED)
        self.emf_checked += len(lens)
        self.emf_hits += int(hit.sum())
        self._emf_count(code)
        opt, bns, ref = self.opt, self.idx.bns, self.idx.ref_string
        return {int(i): perfect_sam_records(
            opt, bns, self.emf, ref, codes[i, : lens[i]].astype(np.uint8),
            int(code[i]), int(slot[i]), loc0=int(loc[i]))
            for i in np.flatnonzero(hit)}

    def _finalize_native(self, pf, codes, lens, id_offset, read_ids,
                         pm_records, sam_ctx=None):
        """Native stage a: ('sam', bytes per read) or ('native', records
        per read, pm_records), or None when the native arena declined.
        Overflow reads come back None in defer_overflow sam mode (the
        stream retries them as a backlog), else via the Python retry
        path. The EMF hits' records (pm_records) replace theirs."""
        from ..io.sam import compose_sam_python
        opt, bns = self.opt, self.idx.bns
        pk, meta = pf["packed"], pf["meta"]
        frac_rep = meta[:, 0]
        overflow = meta[:, 1] > 0.5
        B = codes.shape[0]
        rids_arr = (np.asarray(read_ids, dtype=np.int64)
                    if read_ids is not None
                    else id_offset + np.arange(B, dtype=np.int64))
        with PROFILER.phase("native_finalize"):
            (valid, read, qb_a, qe_a, score_a, truesc_a, w_a, seedcov_a,
             rid_a, seedlen0_a, rb_lo, rb_hi, re_lo, re_hi) = pk.T
            keep = (valid & (qe_a > qb_a)).astype(bool)
            rows = {
                "read": read[keep],
                "rb": (rb_hi[keep].astype(np.int64) << 31) | rb_lo[keep],
                "re": (re_hi[keep].astype(np.int64) << 31) | re_lo[keep],
                "qb": qb_a[keep], "qe": qe_a[keep], "rid": rid_a[keep],
                "score": score_a[keep], "truesc": truesc_a[keep],
                "w": w_a[keep], "seedcov": seedcov_a[keep],
                "seedlen0": seedlen0_a[keep],
            }
            proc = np.flatnonzero(~overflow).astype(np.int32)
            rec_by_read = native_finalize.finalize_se_rows(
                opt, self.idx, rows, proc, frac_rep, rids_arr, codes, lens,
                want="raw" if sam_ctx is not None else "aln")
        if rec_by_read is None:
            return None
        if sam_ctx is not None:
            sam_by_read = native_finalize.compose_sam_raw(
                rec_by_read, opt, bns, codes, lens, sam_ctx.get("names"),
                sam_ctx.get("quals"), sam_ctx.get("rg_id"))
            if sam_by_read is None:
                return None
            out_lines = [None] * B
            for i in proc.tolist():
                out_lines[i] = sam_by_read.get(i, b"")
            if overflow.any() and not sam_ctx.get("defer_overflow"):
                by_idx = self._python_finalize_records(codes, lens, overflow,
                                                       rids_arr)
                for i, recs in by_idx.items():
                    out_lines[i] = compose_sam_python(
                        opt, bns, codes[i, : lens[i]], recs, sam_ctx, i)
            for i, recs in pm_records.items():
                out_lines[i] = compose_sam_python(
                    opt, bns, codes[i, : lens[i]], recs, sam_ctx, i)
            return ("sam", out_lines)
        out_records = [None] * B
        for i in proc.tolist():
            out_records[i] = rec_by_read.get(i)
        if overflow.any():
            out_records_ov = self._python_finalize_records(
                codes, lens, overflow, rids_arr)
            for i, recs in out_records_ov.items():
                out_records[i] = recs
        return ("native", out_records, pm_records)

    def _python_finalize_records(self, codes, lens, overflow, rids_arr):
        """Overflow reads' records via the retry ladder and the Python
        record path. Returns {batch_idx: [Aln, ...]}."""
        with PROFILER.phase("overflow_retry"):
            all_regs = self._apply_overflow_retry(
                [[] for _ in range(codes.shape[0])], overflow, codes, lens)
        return self._records_from_regs(codes, lens, overflow, all_regs,
                                       rids_arr)

    def _records_from_regs(self, codes, lens, which, all_regs, rids_arr):
        """Dedup/primary/records for the reads marked in `which` given
        raw region lists. Returns {batch_idx: [Aln, ...]}."""
        from .finalize import BatchFinalizer
        opt, bns, ref = self.opt, self.idx.bns, self.idx.ref_string
        ov = np.flatnonzero(which).tolist()
        queries, finalized = [], []
        for i in ov:
            query = codes[i, : lens[i]].astype(np.uint8)
            queries.append(query)
            regs = sort_dedup_patch(opt, bns, ref, query, all_regs[i])
            regs, _ = mark_primary(opt, regs, int(rids_arr[i]))
            if opt.flag & MEM_F_PRIMARY5:
                reorder_primary5(opt.T, regs)
            finalized.append(regs)
        recs = BatchFinalizer(opt, self.idx, self.device).records_for_batch(
            queries, finalized)
        return {i: recs[j] for j, i in enumerate(ov)}

    def finalize_stage_b(self, stage):
        if stage[0] == "sam":
            return stage[1]
        if stage[0] == "pysam":
            from ..io.sam import compose_sam_python
            _, recs, sam_ctx, codes, lens = stage
            return [compose_sam_python(self.opt, self.idx.bns,
                                       codes[i, : lens[i]], r, sam_ctx, i)
                    if r is not None else None
                    for i, r in enumerate(recs)]
        _, out_records, pm_records = stage
        for i, recs in pm_records.items():
            out_records[i] = recs
        return out_records

    # -- the in-process single-end API ------------------------------------
    def align_batch(self, codes: np.ndarray, lens: np.ndarray):
        """codes [B, L] (nt4), lens [B]: each read's raw AlnReg list, the
        overflowed reads rerun through the retry ladder (no EMF probe)."""
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        out, pf = self._run_device(self._extend, codes, lens,
                                   int(codes.shape[1]))
        all_regs, overflow = self._regs_from_device(out, codes,
                                                    prefetched=pf)
        return self._apply_overflow_retry(all_regs, overflow, codes, lens)

    def finalize_batch(self, handle, id_offset: int = 0, read_ids=None):
        """The host half of align_and_finalize for a dispatched batch.
        read_ids, when given, are the reads' global ids (the hash_64
        tiebreaks of a compacted backlog)."""
        return self.finalize_stage_b(
            self.finalize_stage_a(handle, id_offset, read_ids))

    def align_and_finalize(self, codes: np.ndarray, lens: np.ndarray,
                           id_offset: int = 0):
        """The SE path to each read's SAM records: the device EMF probe,
        seeding to extension, then the host records; a hit's records come
        from the table (mem_perfect2sam)."""
        return self.finalize_batch(self.dispatch_batch(codes, lens),
                                   id_offset)

    def align_reads_to_sam(self, batch, id_offset: int = 0) -> List[str]:
        """SAM lines of a ReadBatch (each ending in a newline), in read
        order."""
        codes, lens = batch.padded_codes()
        records_per_read = self.align_and_finalize(
            codes.astype(np.int32), lens, id_offset)
        lines = []
        for read, records in zip(batch.reads, records_per_read):
            for which in range(len(records)):
                lines.append(aln_to_sam_line(self.opt, self.idx.bns, read,
                                             len(records), records, which))
        return lines

    # -- paired-end ------------------------------------------------------
    def dispatch_pairs(self, codes: np.ndarray, lens: np.ndarray):
        """PE stage 1: the host EMF probe, then the device stages.
        codes [2N, L] with mates interleaved (2i, 2i+1). Unlike SE, EMF
        hits stay in the device batch, with length 0; their regions
        come from the table (perfect_regs)."""
        opt, bns, ref = self.opt, self.idx.bns, self.idx.ref_string
        if codes.shape[0] % 2:
            raise ValueError(f"a paired batch holds mates in turn, got "
                             f"{codes.shape[0]} reads")
        pm_regs = {}
        lens_eff = np.asarray(lens)
        if self.emf is not None and codes.shape[1] >= self.emf.seed_len:
            with PROFILER.phase("emf_probe_host"):
                pm = emf_lookup_host(self.emf, ref, codes, lens)
            is_pm = (pm["code"] == FW_MATCHED) | (pm["code"] == RC_MATCHED)
            self.emf_checked += len(lens)
            self.emf_hits += int(is_pm.sum())
            self._emf_count(pm["code"])
            if is_pm.any():
                lens_eff = np.where(is_pm, 0, lens_eff).astype(np.int32)
                for i in np.flatnonzero(is_pm):
                    pm_regs[int(i)] = perfect_regs(
                        opt, bns, self.emf, ref,
                        codes[i, : lens[i]].astype(np.uint8),
                        int(pm["code"][i]), int(pm["slot"][i]),
                        loc0=int(pm["loc"][i]))
        with PROFILER.phase("dispatch_extend"):
            handle = self.dispatch_batch(
                codes, np.asarray(lens_eff, dtype=np.int32), skip_emf=True)
        return (codes, lens, pm_regs, handle)

    def fetch_pairs(self, ph):
        """PE stage 2: packed and meta to the host (the device sync
        point); overflowed reads rerun the retry ladder here, at once.
        Returns the raw form pe_post takes."""
        codes, lens, pm_regs, handle = ph
        with PROFILER.phase("fetch_pack"):
            pf = self.fetch_extend(handle)[4]["slot"]
        pk, meta = pf["packed"], pf["meta"]
        overflow = meta[:, 1] > 0.5
        ov_regs = {}
        if overflow.any():
            with PROFILER.phase("overflow_retry"):
                tmp = self._apply_overflow_retry(
                    [[] for _ in range(codes.shape[0])], overflow, codes,
                    lens)
            ov_regs = {i: tmp[i] for i in np.flatnonzero(overflow).tolist()}
        return ("raw", codes, lens, pm_regs, pk, meta, ov_regs)

    def pe_post(self, fetched, id_offset: int = 0, sam_ctx=None):
        """PE stage 3 (host): insert-size stats (or ``self.pes``), mate
        rescue, pairing and records, in one native call. With sam_ctx
        (names/quals/rg_id), finished SAM bytes per read; without, Aln
        records per read and each read's mate record. A batch the
        native stage declines (its record capacity, CIGAR stride or
        MD/XA/SAM arena too small) takes the Python PE path, as in the
        JAX package."""
        # BWA_TPU_NO_NATIVE_PE sends every batch down the Python PE path,
        # the JAX package's switch
        out = (None if os.environ.get("BWA_TPU_NO_NATIVE_PE")
               else self._pe_post_native(fetched, id_offset, sam_ctx))
        if out is not None:
            return out
        records, mates = self._pe_post_python(
            self._raw_to_python_fetch(fetched), id_offset)
        if sam_ctx is not None:
            from ..io.sam import compose_sam_python
            codes, lens = fetched[1], fetched[2]
            records = [compose_sam_python(
                self.opt, self.idx.bns, codes[i, : lens[i]], r,
                sam_ctx, i, mate=mates[i]) if r is not None else None
                for i, r in enumerate(records)]
        return records, mates

    def _raw_to_python_fetch(self, fetched):
        """The Python path's (codes, lens, pm_regs, all_regs) from a raw
        fetch tuple."""
        _, codes, lens, pm_regs, pk, meta, ov_regs = fetched
        all_regs, _of = self._regs_from_device(
            None, codes, prefetched={"packed": pk, "meta": meta})
        for i, regs in ov_regs.items():
            all_regs[i] = regs
        return (codes, lens, pm_regs, all_regs)

    def _pe_post_native(self, fetched, id_offset: int, sam_ctx=None):
        """The one-call native PE stage; None when it declines."""
        _, codes, lens, pm_regs, pk, meta, ov_regs = fetched
        B = codes.shape[0]
        with PROFILER.phase("pe_rows"):
            # a writable copy: the overflowed reads' values are set below
            frac_rep = np.array(meta[:, 0], dtype=np.float32)
            overflow = meta[:, 1] > 0.5
            (valid, read, qb_a, qe_a, score_a, truesc_a, w_a, seedcov_a,
             rid_a, seedlen0_a, rb_lo, rb_hi, re_lo, re_hi) = pk.T
            bad = overflow.copy()
            for i in pm_regs:
                bad[i] = True
            keep = (valid & (qe_a > qb_a)).astype(bool) & ~bad[read]
            rows = dict(
                read=read[keep],
                rb=(rb_hi[keep].astype(np.int64) << 31) | rb_lo[keep],
                re=(re_hi[keep].astype(np.int64) << 31) | re_lo[keep],
                qb=qb_a[keep], qe=qe_a[keep], rid=rid_a[keep],
                score=score_a[keep], truesc=truesc_a[keep], w=w_a[keep],
                seedcov=seedcov_a[keep], seedlen0=seedlen0_a[keep])
            # regions from the EMF table and the retry ladder, merged in
            # read order after each read's device rows
            extra = []
            for src in (pm_regs, ov_regs):
                for i, regs in src.items():
                    extra += [(i, r.rb, r.re, r.qb, r.qe, r.rid, r.score,
                               r.truesc, r.w, r.seedcov, r.seedlen0)
                              for r in regs]
                    if src is ov_regs and regs:
                        frac_rep[i] = regs[0].frac_rep
            if extra:
                ex = np.asarray(extra, dtype=np.int64)
                allc = {k: np.concatenate([np.asarray(rows[k], np.int64),
                                           ex[:, j]])
                        for j, k in enumerate(rows)}
                order = np.argsort(allc["read"], kind="stable")
                rows = {k: v[order] for k, v in allc.items()}
            skip_dedup = np.zeros(B, dtype=np.uint8)
            for i in pm_regs:
                skip_dedup[i] = 1
            read_ids = id_offset + np.arange(B, dtype=np.int64)
        res = native_finalize.finalize_pe_rows(
            self.opt, self.idx, rows, B // 2, frac_rep, read_ids,
            skip_dedup, codes, lens, pes_in=self.pes,
            want="raw" if sam_ctx is not None else "aln")
        if res is None:
            return None
        if sam_ctx is None:
            recs_by_read, mates, _pes = res
            return [recs_by_read.get(i, []) for i in range(B)], mates
        raw, mate_arrs, _pes = res
        sam_by_read = native_finalize.compose_sam_raw(
            raw, self.opt, self.idx.bns, codes, lens, sam_ctx.get("names"),
            sam_ctx.get("quals"), sam_ctx.get("rg_id"), mate=mate_arrs)
        if sam_by_read is None:
            return None
        return [sam_by_read.get(i, b"") for i in range(B)], [None] * B

    def _pe_post_python(self, fetched, id_offset: int = 0):
        """The Python PE path (worker_sam's PE flow,
        src/bwamem.cpp:1668-1830): dedup, pestat, rescue in native kswa
        (on this aligner's device under BWA_TPU_NO_NATIVE_KSWA), pairing
        and records, CIGARs in one native call (the device DP under
        BWA_TPU_NO_NATIVE_KSWG)."""
        from .pe import (mem_pestat, build_rescue_jobs, run_rescue_jobs,
                         apply_rescues, sam_pe_records)
        from .pe_batch import AlnBatcher
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        codes, lens, pm_regs, all_regs = fetched
        B = codes.shape[0]
        queries = [codes[i, : lens[i]].astype(np.uint8) for i in range(B)]
        with PROFILER.phase("pe_dedup"):
            for i in range(B):
                if i in pm_regs:
                    all_regs[i] = pm_regs[i]
                else:
                    all_regs[i] = sort_dedup_patch(
                        opt, bns, ref, queries[i], all_regs[i])
        pair_regs = [(all_regs[2 * p], all_regs[2 * p + 1])
                     for p in range(B // 2)]
        pair_seqs = [(queries[2 * p], queries[2 * p + 1])
                     for p in range(B // 2)]
        with PROFILER.phase("pe_pestat"):
            pes = self.pes if self.pes is not None else mem_pestat(
                opt, bns.l_pac, pair_regs,
                log=lambda m: print(m, file=sys.stderr))
        with PROFILER.phase("pe_rescue_plan"):
            jobs = build_rescue_jobs(opt, bns, ref, pes, pair_regs,
                                     pair_seqs)
        with PROFILER.phase("pe_rescue_run"):
            results = run_rescue_jobs(opt, jobs, self.device)
            apply_rescues(opt, bns.l_pac, jobs, results, pair_regs)
        batcher = AlnBatcher(opt, self.idx, queries, self.device)
        records: List[list] = [None] * B
        mates: List[object] = [None] * B
        with PROFILER.phase("pe_records"):
            for p in range(B // 2):
                regs2 = [list(pair_regs[p][0]), list(pair_regs[p][1])]
                q2 = [queries[2 * p], queries[2 * p + 1]]
                recs2, m2 = sam_pe_records(
                    opt, bns, ref, pes, (id_offset >> 1) + p, q2,
                    regs2, batcher=batcher, qidx=(2 * p, 2 * p + 1))
                records[2 * p], records[2 * p + 1] = recs2
                mates[2 * p], mates[2 * p + 1] = m2
        with PROFILER.phase("pe_cigar_resolve"):
            batcher.resolve()
        return records, mates

    def align_pairs_and_finalize(self, codes: np.ndarray, lens: np.ndarray,
                                 id_offset: int = 0):
        """Synchronous PE path: dispatch, fetch and host post in one call
        (the driver pipelines the three stages instead)."""
        return self.pe_post(self.fetch_pairs(self.dispatch_pairs(codes,
                                                                 lens)),
                            id_offset)
