"""Batched finalization: regions -> SAM records with their CIGARs.

Counterpart of ``bwa_mem_scale_tpu/pipeline/finalize.py``: every selected
output region and XA sub-hit of a read batch becomes one "CIGAR job". The
jobs resolve in the native CIGAR library (``native/kswg.cpp`` through the
shared ``pipeline/native_kswg``: the bwa_gen_cigar2 + mem_reg2aln retry
loop and NM/MD in one C call), or, with ``BWA_TPU_NO_NATIVE_KSWG`` set, as
the JAX package does then, in the batched banded global DP on the
aligner's device (``ops/kswg_cuda.py``: the kernel of csrc/kswg.cu on a
GPU, the plain ``ops/kswg.py`` on the CPU) under the same w2-doubling
retry loop, NM/MD on the host. Unlike the JAX package, a native library
that fails to load is an error, not a silent switch to the device.
Selection, XA strings and record assembly follow the JAX module line for
line (mem_reg2sam, src/bwamem.cpp:2092-2130; mem_gen_alt,
src/bwamem_extra.cpp:130-183).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import MemOptions, MEM_F_ALL, MEM_F_NO_MULTI
from ..ops import kswg_cuda
from ..ops.kswg import rle_cigar
from ..pipeline import native_kswg
from ..ref.extend import AlnReg
from ..ref.finalize import Aln, approx_mapq, _infer_bw
from ..ref.ksw import compute_nm_md
from ..utils.profiling import PROFILER


@dataclasses.dataclass
class _Job:
    read_idx: int
    reg: AlnReg
    query: np.ndarray      # oriented query slice (already reversed if rc)
    rseq: np.ndarray       # oriented ref slice
    rb: int
    re: int
    w2: int
    truesc: int
    is_fw: bool = True
    # results
    cigar: Optional[list] = None
    score: int = 0
    nm: int = -1           # filled by the native path
    md: str = ""


class BatchFinalizer:
    def __init__(self, opt: MemOptions, idx, device="cpu"):
        self.opt = opt
        self.idx = idx
        self.device = torch.device(device)   # the device DP's
        self.native = native_kswg.available()
        if not self.native and not os.environ.get("BWA_TPU_NO_NATIVE_KSWG"):
            raise RuntimeError("the native CIGAR library "
                               "(native/libkswg.so) is required")

    # -- core: batched gen_cigar with the reg2aln retry loop --------------
    def _resolve_jobs(self, jobs: List[_Job]) -> None:
        """Scores and CIGARs for every job, in place (NM/MD too on the
        native path)."""
        if not jobs:
            return
        if self.native:
            with PROFILER.phase("kswg_native"):
                native_kswg.finalize_batch(jobs, self.opt)
            return
        opt = self.opt
        for j in jobs:
            j.w2 = min(j.w2, opt.w << 2)
        self._gen_cigar(jobs)
        # the (rare) band-widening retries (mem_reg2aln's w2 loop)
        last_sc = {id(j): -(1 << 30) for j in jobs}
        active = list(jobs)
        rounds = 0
        while True:
            nxt = []
            for j in active:
                if j.score == last_sc[id(j)] or j.w2 == opt.w << 2:
                    continue
                last_sc[id(j)] = j.score
                j.w2 <<= 1
                if j.score < j.truesc - opt.a:
                    nxt.append(j)
            rounds += 1
            # the i < 3 bound: after 3 widenings stop regardless
            if not nxt or rounds >= 4:
                break
            for j in nxt:
                j.w2 = min(j.w2, opt.w << 2)
            self._gen_cigar(nxt)
            active = nxt

    def _gen_cigar(self, jobs: List[_Job]) -> None:
        """One gen_cigar round over a job list (bwa_gen_cigar2's band
        selection, then the batched global DP on the device)."""
        opt = self.opt
        mat00 = int(opt.mat[0, 0])
        dp_jobs, dp_ws = [], []
        for j in jobs:
            l_query = len(j.query)
            rlen = len(j.rseq)
            if l_query == rlen and j.w2 == 0:
                # gap-free: direct score (src/bwa.cpp:404-414)
                j.cigar = [(l_query, 0)]
                j.score = int(opt.mat[j.rseq, j.query].astype(np.int64)
                              .sum())
                continue
            max_ins = int((((l_query + 1) >> 1) * mat00 - opt.o_ins)
                          / opt.e_ins + 1.0)
            max_del = int((((l_query + 1) >> 1) * mat00 - opt.o_del)
                          / opt.e_del + 1.0)
            max_gap = max(max(max_ins, max_del), 1)
            w = (max_gap + abs(rlen - l_query) + 1) >> 1
            w = min(w, j.w2)
            w = max(w, abs(rlen - l_query) + 3)
            dp_jobs.append(j)
            dp_ws.append(w)
        if not dp_jobs:
            return

        def rup(x, m):
            return ((x + m - 1) // m) * m

        # the JAX package's shape buckets
        QL = rup(max(len(j.query) for j in dp_jobs), 32)
        TL = rup(max(len(j.rseq) for j in dp_jobs), 64)
        P = max(1 << int(np.ceil(np.log2(len(dp_jobs)))), 16)
        qs = np.zeros((P, QL), np.int32)
        ts = np.zeros((P, TL), np.int32)
        qlens = np.zeros(P, np.int32)
        tlens = np.zeros(P, np.int32)
        ws = np.ones(P, np.int32)
        ws[: len(dp_ws)] = np.asarray(dp_ws, np.int32)
        for i, j in enumerate(dp_jobs):
            qs[i, : len(j.query)] = j.query
            ts[i, : len(j.rseq)] = j.rseq
            qlens[i] = len(j.query)
            tlens[i] = len(j.rseq)
        dev = self.device
        with PROFILER.phase("kswg_device"):
            res = kswg_cuda.ksw_global_batch_cuda(
                *(torch.as_tensor(x, device=dev)
                  for x in (qs, qlens, ts, tlens, ws)),
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.mat)
            meta = torch.stack([res.score, res.n_ops, res.tail_del,
                                res.tail_ins], dim=1).cpu().numpy()
            ops = res.ops.cpu().numpy()
        PROFILER.counts["kswg_jobs"] += len(dp_jobs)
        for i, j in enumerate(dp_jobs):
            score, n_ops, tdel, tins = (int(x) for x in meta[i])
            j.score = score
            j.cigar = rle_cigar(ops[i], n_ops, tdel, tins)

    # -- reg -> Aln (reg2aln with deferred cigars) ------------------------
    def make_job(self, read_idx: int, query: np.ndarray, ar: AlnReg
                 ) -> Optional[_Job]:
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
        if qe - qb <= 0 or rb >= re or (rb < bns.l_pac < re):
            return None
        w2 = max(_infer_bw(qe - qb, re - rb, ar.truesc, opt.a,
                           opt.o_del, opt.e_del),
                 _infer_bw(qe - qb, re - rb, ar.truesc, opt.a,
                           opt.o_ins, opt.e_ins))
        if w2 > opt.w:
            w2 = min(w2, ar.w)
        q = query[qb:qe].astype(np.int32)
        r = ref[rb:re].astype(np.int32)
        if rb >= bns.l_pac:
            q = q[::-1].copy()
            r = r[::-1].copy()
        return _Job(read_idx=read_idx, reg=ar, query=q, rseq=r,
                    rb=rb, re=re, w2=w2, truesc=ar.truesc,
                    is_fw=rb < bns.l_pac)

    def job_to_aln(self, job: _Job, l_query: int, secondary: bool) -> Aln:
        opt = self.opt
        bns = self.idx.bns
        ar = job.reg
        a = Aln()
        a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
        if ar.secondary >= 0:
            a.flag |= 0x100
        cigar = job.cigar
        is_fw = job.rb < bns.l_pac
        if job.nm >= 0:        # the native path computed NM/MD
            a.NM = job.nm
            a.MD = job.md
        else:
            a.NM, a.MD = compute_nm_md(cigar, job.query, job.rseq, is_fw)
        pos, a.is_rev = bns.depos1(job.rb if is_fw else job.re - 1)
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
        assert a.rid == ar.rid
        a.pos = pos - bns.anns[a.rid].offset
        a.score = ar.score
        a.sub = max(ar.sub, ar.csub)
        a.is_alt = ar.is_alt
        a.alt_sc = ar.alt_sc
        return a

    # -- full batch: selection + XA + records -----------------------------
    def records_for_batch(self, queries: List[np.ndarray],
                          regs_per_read: List[List[AlnReg]],
                          extra_flag: int = 0) -> List[List[Aln]]:
        return self.complete_batch(
            self.begin_batch(queries, regs_per_read, extra_flag))

    def begin_batch(self, queries: List[np.ndarray],
                    regs_per_read: List[List[AlnReg]],
                    extra_flag: int = 0):
        """Plan jobs + dispatch the CIGAR DP asynchronously."""
        opt = self.opt
        bns = self.idx.bns
        jobs: List[_Job] = []
        plans = []  # per read: (selected [(reg_idx, job|None)], xa info)

        ph = PROFILER.phase("cigar_jobs_build")
        ph.__enter__()
        for i, (query, regs) in enumerate(zip(queries, regs_per_read)):
            l_query = len(query)
            # XA candidates (mem_gen_alt, src/bwamem_extra.cpp:130-183)
            xa_jobs = {}
            cnt = [0] * len(regs)
            has_alt = [False] * len(regs)
            if not (opt.flag & MEM_F_ALL):
                def pri_idx(k):
                    r = regs[k].secondary_all
                    if (r is not None and r >= 0
                            and regs[k].score
                            >= regs[r].score * opt.XA_drop_ratio):
                        return r
                    return -1
                for k in range(len(regs)):
                    r = pri_idx(k)
                    if r >= 0:
                        cnt[r] += 1
                        if regs[k].is_alt:
                            has_alt[r] = True
                for k in range(len(regs)):
                    r = pri_idx(k)
                    if r < 0:
                        continue
                    if (cnt[r] > opt.max_XA_hits_alt
                            or (not has_alt[r]
                                and cnt[r] > opt.max_XA_hits)):
                        continue
                    jb = self.make_job(i, query, regs[k])
                    if jb:
                        jobs.append(jb)
                        xa_jobs[k] = (r, jb)
            # output selection (mem_reg2sam, src/bwamem.cpp:2092-2130)
            selected = []
            for k, p in enumerate(regs):
                if p.score < opt.T:
                    continue
                if p.secondary >= 0 and (p.is_alt
                                         or not (opt.flag & MEM_F_ALL)):
                    continue
                if (0 <= p.secondary < (1 << 31) - 1
                        and p.score
                        < regs[p.secondary].score * opt.drop_ratio):
                    continue
                jb = self.make_job(i, query, p)
                if jb:
                    jobs.append(jb)
                selected.append((k, jb))
            plans.append((selected, xa_jobs))
        ph.__exit__(None, None, None)

        self._resolve_jobs(jobs)
        return (queries, regs_per_read, plans, extra_flag)

    def complete_batch(self, state) -> List[List[Aln]]:
        queries, regs_per_read, plans, extra_flag = state
        opt = self.opt
        bns = self.idx.bns

        out: List[List[Aln]] = []
        for i, (query, regs) in enumerate(zip(queries, regs_per_read)):
            selected, xa_jobs = plans[i]
            l_query = len(query)
            # XA strings keyed by primary index
            xa_strings = {}
            for k, (r, jb) in xa_jobs.items():
                t = self.job_to_aln(jb, l_query, secondary=False)
                cig = "".join(f"{ln}{'MIDSHN'[op]}"
                              for ln, op in (t.cigar or []))
                xa_strings.setdefault(r, "")
                xa_strings[r] += (f"{bns.anns[t.rid].name},"
                                  f"{'-' if t.is_rev else '+'}{t.pos + 1},"
                                  f"{cig},{t.NM};")
            records: List[Aln] = []
            l = 0
            for (k, jb) in selected:
                p = regs[k]
                if jb is None:
                    continue
                q = self.job_to_aln(jb, l_query, secondary=p.secondary >= 0)
                q.XA = xa_strings.get(k)
                q.flag |= extra_flag
                if p.secondary >= 0:
                    q.sub = -1
                if l and p.secondary < 0:
                    q.flag |= (0x10000 if (opt.flag & MEM_F_NO_MULTI)
                               else 0x800)
                if (not (opt.flag & 0x1000) and l   # -q keeps supp mapq
                        and not p.is_alt
                        and q.mapq > records[0].mapq):
                    q.mapq = records[0].mapq
                l += 1
                records.append(q)
            if not records:
                t = Aln()
                t.rid = -1
                t.pos = -1
                t.flag |= 0x4 | extra_flag
                records.append(t)
            out.append(records)
        return out
