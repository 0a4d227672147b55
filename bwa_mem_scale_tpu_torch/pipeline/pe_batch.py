"""Deferred (batched) record conversion for the PE path.

sam_pe_records composes records with reg2aln, whose banded global DP
was a per-record Python loop. AlnBatcher replaces those calls with
lazy Aln objects: the cigar-independent fields (mapq, score, sub,
flags) are filled immediately so all pairing logic works unchanged,
while the CIGAR/NM/MD/pos fields are produced afterwards by ONE
call over every requested record in the batch (native, or the device
DP under BWA_TPU_NO_NATIVE_KSWG) — the PE
equivalent of the SE path's BatchFinalizer (and of the reference
doing worker_sam's per-record ksw_global2 calls from a thread pool).
The port's copy of the JAX package's module.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..ref.extend import AlnReg
from ..ref.finalize import Aln, approx_mapq
from ..ref.ksw import compute_nm_md
from .finalize import BatchFinalizer


class AlnBatcher:
    """Collects reg->Aln conversions; resolves them in one call of the
    finalizer (native, or the device DP on `device`)."""

    def __init__(self, opt: MemOptions, idx, queries: List[np.ndarray],
                 device="cpu"):
        self.opt = opt
        self.idx = idx
        self.queries = queries
        self.fin = BatchFinalizer(opt, idx, device)
        self._jobs = []       # (job, aln, l_query)
        self._xa = []         # (job, parts list, slot, aln-ref)

    # -- lazy reg2aln ----------------------------------------------------
    def lazy_reg2aln(self, query_idx: int, ar: Optional[AlnReg]) -> Aln:
        opt, bns = self.opt, self.idx.bns
        a = Aln()
        if ar is None or ar.rb < 0 or ar.re < 0:
            a.rid = -1
            a.pos = -1
            a.flag |= 0x4
            return a
        a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
        if ar.secondary >= 0:
            a.flag |= 0x100
        a.score = ar.score
        a.sub = max(ar.sub, ar.csub)
        a.is_alt = ar.is_alt
        a.alt_sc = ar.alt_sc
        _, a.is_rev = bns.depos1(
            ar.rb if ar.rb < bns.l_pac else ar.re - 1)
        q = self.queries[query_idx]
        job = self.fin.make_job(query_idx, q, ar)
        if job is None:      # degenerate region: unmapped record
            a.rid = -1
            a.pos = -1
            a.flag |= 0x4
            return a
        self._jobs.append((job, a, len(q)))
        return a

    # -- lazy XA strings (mem_gen_alt) ------------------------------------
    def lazy_xa(self, query_idx: int, regs: List[AlnReg],
                alns_by_k: Dict[int, Aln]) -> None:
        """Queue XA sub-alignments; on resolve, each primary record in
        alns_by_k (keyed by reg index) gets its XA string."""
        opt, bns = self.opt, self.idx.bns
        n = len(regs)

        def pri_idx(i):
            k = regs[i].secondary_all
            if (k is not None and k >= 0
                    and regs[i].score >= regs[k].score
                    * opt.XA_drop_ratio):
                return k
            return -1

        cnt = [0] * n
        has_alt = [False] * n
        for i in range(n):
            r = pri_idx(i)
            if r >= 0:
                cnt[r] += 1
                if regs[i].is_alt:
                    has_alt[r] = True
        q = self.queries[query_idx]
        for i in range(n):
            r = pri_idx(i)
            if r < 0 or r not in alns_by_k:
                continue
            if (cnt[r] > opt.max_XA_hits_alt
                    or (not has_alt[r] and cnt[r] > opt.max_XA_hits)):
                continue
            job = self.fin.make_job(query_idx, q, regs[i])
            if job is not None:
                self._xa.append((job, len(q), alns_by_k[r]))

    # -- resolution --------------------------------------------------------
    def resolve(self) -> None:
        bns = self.idx.bns
        jobs = [j for j, _, _ in self._jobs] + [j for j, _, _ in self._xa]
        self.fin._resolve_jobs(jobs)
        for job, a, l_query in self._jobs:
            _fill_from_job(self.opt, bns, job, a, l_query)
        for job, l_query, target in self._xa:
            t = Aln()
            t.is_alt = job.reg.is_alt
            _fill_from_job(self.opt, bns, job, t, l_query)
            cig = "".join(f"{ln}{'MIDSHN'[op]}"
                          for ln, op in (t.cigar or []))
            s = (f"{bns.anns[t.rid].name},"
                 f"{'-' if t.is_rev else '+'}{t.pos + 1},"
                 f"{cig},{t.NM};")
            target.XA = (target.XA or "") + s


def reg2sam_records_lazy(batcher: AlnBatcher, query_idx: int,
                         regs: List[AlnReg], extra_flag: int = 0
                         ) -> List[Aln]:
    """Batcher-aware twin of ref/finalize.reg2sam_records (same
    selection rules, mem_reg2sam src/bwamem.cpp:2092-2150)."""
    opt = batcher.opt
    out: List[Aln] = []
    alns_by_k: Dict[int, Aln] = {}
    l = 0
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt
                                 or not (opt.flag & 0x8)):  # MEM_F_ALL
            continue
        if (0 <= p.secondary < (1 << 31) - 1
                and p.score < regs[p.secondary].score
                * opt.drop_ratio):
            continue
        q = batcher.lazy_reg2aln(query_idx, p)
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if l and p.secondary < 0:
            q.flag |= 0x10000 if (opt.flag & 0x10) else 0x800
        if (not (opt.flag & 0x1000) and l   # -q keeps supp mapq
                and not p.is_alt and q.mapq > out[0].mapq):
            q.mapq = out[0].mapq
        alns_by_k[k] = q
        l += 1
        out.append(q)
    if not out:
        t = Aln()
        t.rid = -1
        t.pos = -1
        t.flag |= 0x4 | extra_flag
        out.append(t)
    elif not (opt.flag & 0x8):
        batcher.lazy_xa(query_idx, regs, alns_by_k)
    return out


def _fill_from_job(opt, bns, job, a: Aln, l_query: int) -> None:
    """CIGAR-dependent half of reg2aln (src/bwamem.cpp:2570-2624)."""
    ar = job.reg
    is_fw = job.rb < bns.l_pac
    if job.nm >= 0:        # the native path computed NM/MD
        a.NM = job.nm
        a.MD = job.md
    else:
        a.NM, a.MD = compute_nm_md(job.cigar, job.query, job.rseq, is_fw)
    pos, a.is_rev = bns.depos1(job.rb if is_fw else job.re - 1)
    cigar = job.cigar
    if cigar:
        if cigar[0][1] == 2:
            pos += cigar[0][0]
            cigar = cigar[1:]
        elif cigar[-1][1] == 2:
            cigar = cigar[:-1]
    qb, qe = ar.qb, ar.qe
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if a.is_rev else qb
        clip3 = qb if a.is_rev else l_query - qe
        if clip5:
            cigar = [(clip5, 3)] + cigar
        if clip3:
            cigar = cigar + [(clip3, 3)]
    a.cigar = cigar
    a.rid = bns.pos2rid1(pos)
    a.pos = pos - bns.anns[a.rid].offset
