"""Paired-end pipeline: insert-size stats, batched mate rescue,
pair scoring, and PE SAM record composition.

The port's copy of the JAX package's ``pipeline/pe.py``. It is the
Python PE path that ``GpuAligner.pe_post`` takes when the native PE
stage (``native_finalize.finalize_pe_rows``) declines a batch, or for
every batch under ``BWA_TPU_NO_NATIVE_PE``. Mate rescue runs in the
native ``libkswa`` (``pipeline/native_kswa.py``), which is required
unless ``BWA_TPU_NO_NATIVE_KSWA`` sends it to the device
(``ops/kswa_cuda.py``), as in the JAX package; the JAX package's
pure-Python rescue SW, reached only when both are unavailable, is not
ported.

Ports (behavior contracts):
- mem_pestat                src/bwamem_pair.cpp:89-156
- mem_infer_dir / cal_sub   src/bwamem_pair.cpp:66-87
- mem_matesw_orig           src/bwamem_pair.cpp:276-364 — rescue jobs
  are precomputed for the whole batch from the pre-rescue region
  lists and run in one native call, then deduped once per read
  instead of once per orientation.
- mem_pair                  src/bwamem_pair.cpp:366-427
- mem_sam_pe                src/bwamem_pair.cpp:625-818
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import (MemOptions, MEM_F_ALL, MEM_F_NOPAIRING,
                      MEM_F_NO_RESCUE)
from ..ref.extend import AlnReg
from ..ref.finalize import (Aln, approx_mapq, gen_alt, hash_64,
                            mark_primary, reg2aln,
                            reg2sam_records,
                            reorder_primary5,
                            sort_dedup_patch)

OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


@dataclasses.dataclass
class PeStat:
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0
    failed: bool = True


def mem_infer_dir(l_pac: int, b1: int, b2: int) -> Tuple[int, int]:
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def cal_sub(opt: MemOptions, regs: List[AlnReg]) -> int:
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def mem_pestat(opt: MemOptions, l_pac: int,
               pair_regs: Sequence[Tuple[List[AlnReg], List[AlnReg]]],
               log=None) -> List[PeStat]:
    pes = [PeStat() for _ in range(4)]
    isize = [[] for _ in range(4)]
    for r0, r1 in pair_regs:
        if not r0 or not r1:
            continue
        if cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = mem_infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            continue
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        vals = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(vals) / len(vals)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in vals) / len(vals))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        r.low = min(r.low, int(r.avg - MAX_STDDEV * r.std + 0.499))
        r.high = max(r.high, int(r.avg + MAX_STDDEV * r.std + 0.499))
        r.low = max(r.low, 1)
        r.failed = False
        if log:
            log(f"[PE] orientation {'FR'[d >> 1 & 1]}{'FR'[d & 1]}: "
                f"({p25}, {p50}, {p75}) avg {r.avg:.2f} std {r.std:.2f} "
                f"proper [{r.low}, {r.high}]")
    mx = max(len(x) for x in isize)
    for d in range(4):
        if not pes[d].failed and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = True
    return pes


def _fetch_seq(bns, ref_string, rb: int, mid: int, re: int
               ) -> Tuple[int, int, int]:
    """bns_fetch_seq: clamp [rb, re) to the contig of mid on mid's
    strand; returns (rb, re, rid)."""
    l_pac = bns.l_pac
    pos_f, is_rev = bns.depos1(mid)
    rid = bns.pos2rid1(pos_f)
    off = bns.anns[rid].offset
    end = off + bns.anns[rid].length
    if is_rev:
        lo, hi = 2 * l_pac - end, 2 * l_pac - off
    else:
        lo, hi = off, end
    return max(rb, lo), min(re, hi), rid


@dataclasses.dataclass
class _RescueJob:
    pair: int
    end: int            # which mate's region list gains the rescue
    seq: np.ndarray     # mate sequence (maybe revcomped)
    target: np.ndarray  # reference window
    is_rev: bool
    rb: int
    l_ms: int
    rid: int
    is_alt: bool


def build_rescue_jobs(opt: MemOptions, bns, ref_string,
                      pes: List[PeStat],
                      pair_regs, pair_seqs) -> List[_RescueJob]:
    """Precompute every mate-SW problem in the batch
    (mem_matesw_orig's window construction, per orientation)."""
    l_pac = bns.l_pac
    jobs: List[_RescueJob] = []
    if opt.flag & MEM_F_NO_RESCUE:
        return jobs
    for p, (regs2, seqs2) in enumerate(zip(pair_regs, pair_seqs)):
        for i in (0, 1):
            a_list = regs2[i]
            if not a_list:
                continue
            ma = regs2[1 - i]
            ms = seqs2[1 - i]
            l_ms = len(ms)
            cand = [a for a in a_list
                    if a.score >= a_list[0].score - opt.pen_unpaired]
            for a in cand[: opt.max_matesw]:
                skip = [pes[r].failed for r in range(4)]
                for m in ma:
                    r, dist = mem_infer_dir(l_pac, a.rb, m.rb)
                    if pes[r].low <= dist <= pes[r].high:
                        skip[r] = True
                if all(skip):
                    continue
                for r in range(4):
                    if skip[r]:
                        continue
                    is_rev = (r >> 1) != (r & 1)
                    is_larger = not (r >> 1)
                    if not is_rev:
                        rb = (a.rb + pes[r].low if is_larger
                              else a.rb - pes[r].high)
                        re = (a.rb + pes[r].high if is_larger
                              else a.rb - pes[r].low) + l_ms
                    else:
                        rb = (a.rb + pes[r].low if is_larger
                              else a.rb - pes[r].high) - l_ms
                        re = (a.rb + pes[r].high if is_larger
                              else a.rb - pes[r].low)
                    rb = max(rb, 0)
                    re = min(re, l_pac << 1)
                    if rb >= re:
                        continue
                    rb, re, rid = _fetch_seq(bns, ref_string, rb,
                                             (rb + re) >> 1, re)
                    if rid != a.rid or re - rb < opt.min_seed_len:
                        continue
                    seq = (np.where(ms < 4, 3 - ms, 4)[::-1]
                           if is_rev else ms)
                    jobs.append(_RescueJob(
                        pair=p, end=1 - i, seq=seq.astype(np.uint8),
                        target=np.asarray(ref_string[rb:re],
                                          dtype=np.uint8),
                        is_rev=is_rev, rb=int(rb), l_ms=l_ms,
                        rid=int(rid), is_alt=a.is_alt))
    return jobs


def run_rescue_jobs(opt: MemOptions, jobs: List[_RescueJob], device=None):
    """Run all rescue alignments; returns list of KswResult-like tuples
    (score, te, qe, score2, tb, qb). In the native kswa library (raises
    when it cannot load), or, with ``BWA_TPU_NO_NATIVE_KSWA`` set, as the
    JAX package does then, in the batched local SW on `device`
    (``ops/kswa_cuda.py``: the kernel of csrc/kswa.cu on a GPU, the plain
    ``ops/kswa.py`` on the CPU, the default)."""
    minsc = opt.min_seed_len * opt.a
    if not jobs:
        return []
    from . import native_kswa
    if not os.environ.get("BWA_TPU_NO_NATIVE_KSWA"):
        return native_kswa.align_batch(
            [j.seq for j in jobs], [j.target for j in jobs], opt, minsc)
    from ..ops import kswa_cuda
    dev = torch.device(device if device is not None else "cpu")
    J = len(jobs)

    def rup(x, m):
        return ((x + m - 1) // m) * m

    # the JAX package's shapes
    L = rup(max(len(j.seq) for j in jobs), 32)
    T = rup(max(len(j.target) for j in jobs), 128)
    q = np.full((J, L), 4, dtype=np.int32)
    t = np.full((J, T), 4, dtype=np.int32)
    qlens = np.zeros(J, dtype=np.int32)
    tlens = np.zeros(J, dtype=np.int32)
    for k, j in enumerate(jobs):
        q[k, : len(j.seq)] = j.seq
        t[k, : len(j.target)] = j.target
        qlens[k], tlens[k] = len(j.seq), len(j.target)
    res = kswa_cuda.ksw_align_batch_cuda(
        *(torch.as_tensor(x, device=dev) for x in (q, qlens, t, tlens)),
        opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, minsc,
        int(opt.mat.max()))
    # one stacked fetch
    m = torch.stack([res.score, res.te, res.qe, res.score2, res.tb, res.qb],
                    dim=1).cpu().numpy()
    return [tuple(int(x) for x in row) for row in m]


def apply_rescues(opt: MemOptions, l_pac: int, jobs, results,
                  pair_regs) -> int:
    """Convert successful rescues to regions and dedup the touched
    lists (mem_matesw_orig's result mapping)."""
    touched = set()
    n = 0
    for j, (score, te, qe, score2, tb, qb) in zip(jobs, results):
        if score < opt.min_seed_len or qb < 0:
            continue
        b = AlnReg(rid=j.rid, is_alt=j.is_alt)
        if j.is_rev:
            b.qb = j.l_ms - (qe + 1)
            b.qe = j.l_ms - qb
            b.rb = (l_pac << 1) - (j.rb + te + 1)
            b.re = (l_pac << 1) - (j.rb + tb)
        else:
            b.qb, b.qe = qb, qe + 1
            b.rb, b.re = j.rb + tb, j.rb + te + 1
        b.score = score
        b.truesc = score
        b.csub = score2
        b.secondary = -1
        b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
        pair_regs[j.pair][j.end].append(b)
        touched.add((j.pair, j.end))
        n += 1
    for p, e in touched:
        pair_regs[p][e][:] = sort_dedup_patch(
            opt, None, None, None, pair_regs[p][e])
    return n


def mem_pair(opt: MemOptions, bns, pes: List[PeStat],
             regs2, pair_id: int, n_pri: List[int]
             ) -> Tuple[int, int, int, List[int]]:
    """Returns (score, sub, n_sub, z) with z the chosen indices, or
    score 0 when no proper pair was found."""
    l_pac = bns.l_pac
    v = []
    for r in (0, 1):
        for i in range(n_pri[r]):
            e = regs2[r][i]
            pos_f = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | int(pos_f - bns.anns[e.rid].offset)
            y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y4 = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in (0, 1):
            d = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[d].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y4[which] < 0:
                continue
            for k in range(y4[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[d].high:
                    break
                if dist < pes[d].low:
                    continue
                ns = (dist - pes[d].avg) / pes[d].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(
                            2.0 * math.erfc(abs(ns) * (2 ** -0.5)))
                        * opt.a + 0.499)
                q = max(q, 0)
                yk = (k << 32) | i
                u.append(((q << 32)
                          | (hash_64((yk ^ (pair_id << 8))
                                     & ((1 << 64) - 1)) & 0xFFFFFFFF),
                          yk))
        y4[v[i][1] & 3] = i
    z = [-1, -1]
    if not u:
        return 0, 0, 0, z
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del,
              opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    # y<<32>>34 in the reference = bits 2..31 of y: the region index
    z[v[i][1] & 1] = (v[i][1] >> 2) & 0x3FFFFFFF
    z[v[k][1] & 1] = (v[k][1] >> 2) & 0x3FFFFFFF
    o = u[-1][0] >> 32
    sub = u[-2][0] >> 32 if len(u) > 1 else 0
    n_sub = 0
    for j in range(len(u) - 2, -1, -1):
        if sub - (u[j][0] >> 32) <= tmp:
            n_sub += 1
    return int(o), int(sub), n_sub, z


def sam_pe_records(opt: MemOptions, bns, ref_string, pes: List[PeStat],
                   pair_id: int, queries2, regs2, batcher=None,
                   qidx=(0, 1)) -> Tuple[List[List[Aln]], List[Aln]]:
    """Pairing + record composition for one read pair (mem_sam_pe after
    mate rescue). Returns (records per end, mate record per end).

    With `batcher` (pipeline/pe_batch.AlnBatcher), record CIGARs are
    deferred to one batched device DP; the returned Aln objects are
    completed by batcher.resolve()."""
    def _r2a(i, reg):
        if batcher is not None:
            return batcher.lazy_reg2aln(qidx[i], reg)
        return reg2aln(opt, bns, ref_string, len(queries2[i]),
                       queries2[i], reg)

    n_pri = [0, 0]
    for i in (0, 1):
        regs2[i][:], n_pri[i] = mark_primary(opt, regs2[i],
                                             (pair_id << 1) | i)
        if opt.flag & 0x800:   # MEM_F_PRIMARY5 (mem_sam_pe V17 block)
            reorder_primary5(opt.T, regs2[i])

    def no_pairing():
        extra = 1
        h = [None, None]
        for i in (0, 1):
            which = -1
            a = regs2[i]
            if a:
                if a[0].score >= opt.T:
                    which = 0
                elif n_pri[i] < len(a) and a[n_pri[i]].score >= opt.T:
                    which = n_pri[i]
            h[i] = _r2a(i, a[which] if which >= 0 else None)
        nonlocal_extra = extra
        if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid
                and h[0].rid >= 0 and regs2[0] and regs2[1]):
            d, dist = mem_infer_dir(bns.l_pac, regs2[0][0].rb,
                                    regs2[1][0].rb)
            if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
                nonlocal_extra |= 2
        if batcher is not None:
            from .pe_batch import reg2sam_records_lazy
            recs = [reg2sam_records_lazy(
                        batcher, qidx[i], regs2[i],
                        extra_flag=(0x41 if i == 0 else 0x81)
                        | nonlocal_extra)
                    for i in (0, 1)]
        else:
            recs = [reg2sam_records(opt, bns, ref_string, queries2[i],
                                    regs2[i],
                                    extra_flag=(0x41 if i == 0 else 0x81)
                                    | nonlocal_extra)
                    for i in (0, 1)]
        return recs, [h[1], h[0]]

    if opt.flag & MEM_F_NOPAIRING:
        return no_pairing()
    if not (n_pri[0] and n_pri[1]):
        return no_pairing()
    o, subo, n_sub, z = mem_pair(opt, bns, pes, regs2, pair_id, n_pri)
    if o <= 0:
        return no_pairing()

    # multiple good hits on either end -> no pairing
    for i in (0, 1):
        for j in range(1, n_pri[i]):
            if (regs2[i][j].secondary < 0
                    and regs2[i][j].score >= opt.T):
                return no_pairing()

    extra_flag = 1
    score_un = regs2[0][0].score + regs2[1][0].score - opt.pen_unpaired
    subo = max(subo, score_un)
    q_pe = raw_mapq(o - subo, opt.a)
    if n_sub > 0:
        q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
    q_pe = min(max(q_pe, 0), 60)
    q_pe = int(q_pe * (1.0 - 0.5 * (regs2[0][0].frac_rep
                                    + regs2[1][0].frac_rep)) + 0.499)

    q_se = [0, 0]
    if o > score_un:  # paired alignment preferred
        c = [regs2[0][z[0]], regs2[1][z[1]]]
        for i in (0, 1):
            if c[i].secondary >= 0:
                c[i].sub = regs2[i][c[i].secondary].score
                c[i].secondary = -2
            q_se[i] = approx_mapq(opt, c[i])
        for i in (0, 1):
            q_se[i] = (q_se[i] if q_se[i] > q_pe
                       else min(q_pe, q_se[i] + 40))
            q_se[i] = min(q_se[i],
                          raw_mapq(c[i].score - c[i].csub, opt.a))
        extra_flag |= 2
    else:
        z = [0, 0]
        q_se[0] = approx_mapq(opt, regs2[0][0])
        q_se[1] = approx_mapq(opt, regs2[1][0])

    for i in (0, 1):
        k = regs2[i][z[i]].secondary_all
        if 0 <= k < n_pri[i]:  # promote chosen hit to primary
            for j in range(len(regs2[i])):
                if regs2[i][j].secondary_all == k or j == k:
                    regs2[i][j].secondary_all = z[i]
            regs2[i][z[i]].secondary_all = -1

    XA = [None, None]
    if batcher is None and not (opt.flag & MEM_F_ALL):
        for i in (0, 1):
            XA[i] = gen_alt(opt, bns, ref_string, regs2[i],
                            len(queries2[i]), queries2[i])

    h = [None, None]
    recs: List[List[Aln]] = [[], []]
    for i in (0, 1):
        alns_by_k = {}
        h[i] = _r2a(i, regs2[i][z[i]])
        h[i].mapq = q_se[i]
        h[i].flag |= (0x40 << i) | extra_flag
        h[i].XA = XA[i][z[i]] if XA[i] else None
        alns_by_k[z[i]] = h[i]
        recs[i].append(h[i])
        if n_pri[i] < len(regs2[i]):  # ALT hit record
            p = regs2[i][n_pri[i]]
            if p.score >= opt.T and p.secondary < 0 and p.is_alt:
                g = _r2a(i, p)
                g.flag |= 0x800 | (0x40 << i) | extra_flag
                g.XA = XA[i][n_pri[i]] if XA[i] else None
                alns_by_k[n_pri[i]] = g
                recs[i].append(g)
        if batcher is not None and not (opt.flag & MEM_F_ALL):
            batcher.lazy_xa(qidx[i], regs2[i], alns_by_k)
    return recs, [h[1], h[0]]
