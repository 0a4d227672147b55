"""The CIGAR DP (banded global alignment with traceback) through the
hand-written CUDA kernel of csrc/kswg.cu.

``ksw_global_batch_cuda`` has the signature of the JAX package's
``ops/kswg.py::ksw_global_batch`` (its row loop, ``:67-143``, and its
traceback, ``:156-176``, are what the kernel replaces). On CUDA tensors
it launches ``kswg_kernel`` (one warp a pair, the band's columns across
lanes, the row state in shared memory, direction bytes for the band
alone in a scratch the wrapper allocates, the profile as a 5 x 5 table
by value) or raises; on CPU tensors it
runs the plain version, ``ops/kswg.py::ksw_global_batch``. There is no
fallback from the kernel to the plain version. ``kswg_twin`` follows the
kernel's loops in numpy (32-column passes with the held column and the
F carry, the band-only direction store, one lane's traceback) and counts
each pair's passes and traceback steps.

The source is compiled with nvcc into
``build/torch_kernels/libkswg_cuda.so`` at first use
(``ops/nvcc_build.py``) and bound with ctypes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .kswg import KswgResult, NEG_INF, ksw_global_batch, profile_scores

# eh_h and eh_e, (QL + 2) int32 each, in one block's 227 KB of shared memory
MAX_QL = 29024

class _Prof(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int * 25)]


_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = nvcc_build.Library(
    "kswg.cu", "kswg_cuda",
    {"kswg_launch": [_vp] * 11 + [_ci] * 4 + [_Prof] + [_ci] * 4})
build = LIB.build            # compile csrc/kswg.cu; returns the path


def profile_table(mat) -> _Prof:
    """The arithmetic profile as the kernel reads it: 5 x 5, row-major
    (target code, query code)."""
    match, mis, n = profile_scores(mat)
    t = _Prof()
    t.v[:] = [n if a == 4 or b == 4 else (match if a == b else mis)
              for a in range(5) for b in range(5)]
    return t


def band_width(w_max: int, QL: int) -> int:
    """Direction bytes a row keeps: its band, at most 2 w + 1 columns."""
    return max(1, min(2 * max(int(w_max), 0) + 1, QL))


def launch(qs, q_lens, ts, t_lens, w_p, o_del: int, e_del: int, o_ins: int,
           e_ins: int, mat, w_max: int) -> KswgResult:
    """One launch on contiguous int32 CUDA tensors, as
    ``ksw_global_batch_cuda`` checks them; w_max >= every w_p (the
    scratch's band width). No host synchronisation."""
    P, QL = qs.shape
    TL = ts.shape[1]
    dev = qs.device
    BW = band_width(w_max, QL)
    zb = torch.empty((P, TL, BW), dtype=torch.uint8, device=dev)
    score, n_ops, tdel, tins = (torch.empty((P,), dtype=torch.int32,
                                            device=dev) for _ in range(4))
    ops = torch.empty((P, QL + TL + 2), dtype=torch.int8, device=dev)
    if P:
        LIB.launch(dev, "kswg_launch", qs.data_ptr(), q_lens.data_ptr(),
                   ts.data_ptr(), t_lens.data_ptr(), w_p.data_ptr(),
                   zb.data_ptr(), score.data_ptr(), ops.data_ptr(),
                   n_ops.data_ptr(), tdel.data_ptr(), tins.data_ptr(), P, QL,
                   TL, BW, profile_table(mat), o_del, e_del, o_ins, e_ins)
        _DP_FN.launches += 1
    return KswgResult(score=score, ops=ops, n_ops=n_ops, tail_del=tdel,
                      tail_ins=tins)


def ksw_global_batch_cuda(qs, q_lens, ts, t_lens, w_p, o_del: int,
                          e_del: int, o_ins: int, e_ins: int,
                          mat) -> KswgResult:
    """KswgResult equal to the plain version's, every output. qs [P, QL],
    ts [P, TL], q_lens / t_lens / w_p [P], all int32; mat the 5 x 5
    scoring matrix (a numpy array or host values)."""
    dev = qs.device
    if dev.type == "cpu":
        return ksw_global_batch(qs, q_lens, ts, t_lens, w_p, o_del, e_del,
                                o_ins, e_ins, mat)
    if dev.type != "cuda":
        raise ValueError(f"ksw_global_batch_cuda: unsupported device {dev}")
    for name, x, nd in (("qs", qs, 2), ("ts", ts, 2), ("q_lens", q_lens, 1),
                        ("t_lens", t_lens, 1), ("w_p", w_p, 1)):
        if x.dtype != torch.int32 or x.dim() != nd or x.device != dev:
            raise ValueError(
                f"ksw_global_batch_cuda: {name}: expected a {nd}-d int32 "
                f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    P, QL = qs.shape
    if any(x.shape[0] != P for x in (ts, q_lens, t_lens, w_p)):
        raise ValueError("ksw_global_batch_cuda: pair counts differ")
    if not 1 <= QL <= MAX_QL or ts.shape[1] < 1:
        raise ValueError(f"ksw_global_batch_cuda: a query width of {QL} "
                         f"columns (the kernel takes 1 .. {MAX_QL}) or an "
                         f"empty target")
    if np.asarray(mat).size != 25:
        raise ValueError("ksw_global_batch_cuda: mat must be 5 x 5")
    w_max = int(w_p.max()) if P else 0      # the band scratch's width
    return launch(qs.contiguous(), q_lens.contiguous(), ts.contiguous(),
                  t_lens.contiguous(), w_p.contiguous(), o_del, e_del, o_ins,
                  e_ins, mat, w_max)


# kernel launches since the last reset (main-path proof in chip_smoke.py),
# counted through _DP_FN, so a swap of the module name keeps the count
ksw_global_batch_cuda.launches = 0
_DP_FN = ksw_global_batch_cuda


def band_cells(q_lens, t_lens, w_p) -> np.ndarray:
    """Each pair's DP cells: Sum over its rows of its band's columns."""
    out = np.zeros(len(q_lens), dtype=np.int64)
    for p, (ql, tl, w) in enumerate(zip(np.asarray(q_lens).tolist(),
                                        np.asarray(t_lens).tolist(),
                                        np.asarray(w_p).tolist())):
        i = np.arange(max(tl, 0))
        out[p] = np.clip(np.minimum(i + w + 1, ql) - np.maximum(i - w, 0),
                         0, None).sum()
    return out


def kswg_twin(qs, q_lens, ts, t_lens, w_p, o_del: int, e_del: int,
              o_ins: int, e_ins: int, mat, zb_out=None):
    """The kernel's loops in numpy, a pair at a time: (KswgResult of numpy
    arrays, passes [P] (32-column passes over the rows), steps [P]
    (traceback steps)). zb_out, a [P, TL, BW] uint8 array, receives the
    band's direction bytes as the kernel's scratch holds them."""
    qs, ts = np.asarray(qs, np.int64), np.asarray(ts, np.int64)
    P, QL = qs.shape
    TL = ts.shape[1]
    match, mis, nsc = profile_scores(mat)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w_all = np.asarray(w_p, np.int64)
    BW = band_width(w_all.max() if P else 0, QL)
    S = QL + TL + 2
    score = np.zeros(P, np.int32)
    ops = np.full((P, S), -1, np.int8)
    n_ops, tdel, tins = (np.zeros(P, np.int32) for _ in range(3))
    passes, steps = np.zeros(P, np.int64), np.zeros(P, np.int64)
    lanes = np.arange(32)
    for p in range(P):
        qlen = min(max(int(q_lens[p]), 0), QL)
        tlen = min(max(int(t_lens[p]), 0), TL)
        w = int(w_all[p])
        qc = np.clip(qs[p], 0, 4)
        c = np.arange(QL + 2)
        eh_h = np.where(c == 0, 0, np.where((c <= w) & (c <= qlen)
                                            & (c <= QL),
                                            -(o_ins + e_ins * c), NEG_INF))
        eh_e = np.full(QL + 2, NEG_INF, np.int64)
        zb = np.zeros((TL, BW), np.uint8)
        for i in range(tlen):
            tb = min(max(int(ts[p, i]), 0), 4)
            beg, end = max(i - w, 0), min(i + w + 1, qlen)
            h1_first = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
            run_carry, hold = NEG_INF, 0
            for a in range(beg, end, 32):
                passes[p] += 1
                j = a + lanes
                inb = j < end
                jc = np.minimum(j, QL + 1)
                hprev = np.where(inb, eh_h[jc], 0)
                eprev = np.where(inb, eh_e[jc], NEG_INF)
                eh_h[a] = h1_first if a == beg else hold
                q = qc[np.minimum(j, QL - 1)]
                qp = np.where(inb, np.where((tb == 4) | (q == 4), nsc,
                                            np.where(q == tb, match, mis)),
                              mis)
                M = np.maximum(hprev + qp, NEG_INF)
                dh = np.where(M >= eprev, 0, 1)
                pre = np.maximum(M, eprev)
                t_ins = np.maximum(M - oe_ins, NEG_INF)
                key = np.where(inb, t_ins + e_ins * j, NEG_INF)
                incl = np.maximum.accumulate(key)
                excl = np.maximum(np.concatenate([[NEG_INF], incl[:-1]]),
                                  run_carry)
                run_carry = max(run_carry, int(incl[31]))
                f = np.maximum(excl - e_ins * (j - 1), NEG_INF)
                f = np.where(j == beg, NEG_INF, f)
                dh = np.where(pre >= f, dh, 2)
                H = np.maximum(pre, f)
                t_del = np.maximum(M - oe_del, NEG_INF)
                e_bit = (eprev - e_del) > t_del
                E_next = np.maximum(eprev - e_del, t_del)
                f_bit = (f - e_ins) > t_ins
                d = dh | (e_bit.astype(np.int64) << 2) | (
                    f_bit.astype(np.int64) << 5)
                jj = j[inb]
                zb[i, jj - beg] = d[inb]
                eh_e[jj] = E_next[inb]
                low = inb & (lanes < 31)
                eh_h[j[low] + 1] = H[low]
                hold = int(H[31])
                if inb[31] and a + 32 >= end:
                    eh_h[a + 32] = H[31]
            ce = min(max(end, 0), QL)
            if end <= beg:
                if beg <= QL:
                    eh_h[beg] = h1_first
                eh_h[ce] = h1_first
            eh_e[ce] = NEG_INF
        if zb_out is not None:
            zb_out[p] = zb
        score[p] = eh_h[qlen]
        i, k = tlen - 1, min(tlen + w, qlen) - 1
        which = sc = 0
        while i >= 0 and k >= 0:
            beg, end = max(i - w, 0), min(i + w + 1, qlen)
            d = int(zb[i, k - beg]) if beg <= k < end else 0
            which = (d >> (which << 1)) & 3
            ops[p, sc] = 0 if which == 0 else (2 if which == 1 else 1)
            sc += 1
            i -= which != 2
            k -= which != 1
        n_ops[p], steps[p] = sc, sc
        tdel[p], tins[p] = max(i + 1, 0), max(k + 1, 0)
    return (KswgResult(score=score, ops=ops, n_ops=n_ops, tail_del=tdel,
                       tail_ins=tins), passes, steps)
