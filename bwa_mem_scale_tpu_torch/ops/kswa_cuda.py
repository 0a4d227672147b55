"""Mate-rescue local SW (ksw_align2 with start coordinates) through the
hand-written CUDA kernel of csrc/kswa.cu.

``ksw_align_batch_cuda`` has the signature of the JAX package's
``ops/kswa.py::ksw_align_batch`` (its two ``_scan_phase`` passes,
``:37-78``, and the score2 / te2 and tb / qb steps, ``:88-110``, are what
the kernel replaces). On CUDA tensors it launches ``kswa_kernel<K>`` (one
warp a job, K query columns a lane in registers, L <= 32 K) or raises; on
CPU tensors it runs the plain version, ``ops/kswa.py::ksw_align_batch``.
There is no fallback from the kernel to the plain version. ``kswa_twin``
follows the kernel's loops in numpy (K columns a lane, the lane scan, the
first best column at each new best, the strided score2 pass, the reverse
scan stopping at the score) and counts each job's rows.

The source is compiled with nvcc into
``build/torch_kernels/libkswa_cuda.so`` at first use
(``ops/nvcc_build.py``) and bound with ctypes; the 5 x 5 matrix goes by
value.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .kswa import KswBatchResult, NEG, ksw_align_batch

# columns a lane of the instantiations (csrc/kswa.cu kswa_k_for)
K_VALUES = (1, 2, 3, 4, 5, 6, 8, 12, 16)
MAX_L = 32 * K_VALUES[-1]


class _Mat(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int * 25)]


_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = nvcc_build.Library(
    "kswa.cu", "kswa_cuda",
    {"kswa_launch": [_vp] * 6 + [_ci] * 3 + [_Mat] + [_ci] * 6})
build = LIB.build            # compile csrc/kswa.cu; returns the path


def k_for(L: int) -> int:
    """Columns a lane for a query width L (0 past MAX_L)."""
    return next((k for k in K_VALUES if L <= 32 * k), 0)


def launch(q, qlens, t, tlens, mat5, o_del: int, e_del: int, o_ins: int,
           e_ins: int, minsc: int, max_mat: int) -> KswBatchResult:
    """One launch on contiguous int32 CUDA tensors, as
    ``ksw_align_batch_cuda`` checks them; no host synchronisation."""
    J, L = q.shape
    T = t.shape[1]
    dev = q.device
    colmax = torch.empty((J, T), dtype=torch.int32, device=dev)
    out = torch.empty((7, J), dtype=torch.int32, device=dev)
    m = _Mat()
    m.v[:] = [int(x) for x in np.asarray(mat5, np.int64).reshape(25)]
    if J:
        LIB.launch(dev, "kswa_launch", q.data_ptr(), qlens.data_ptr(),
                   t.data_ptr(), tlens.data_ptr(), colmax.data_ptr(),
                   out.data_ptr(), J, L, T, m, o_del, e_del, o_ins, e_ins,
                   minsc, max_mat)
        _ALIGN_FN.launches += 1
    return KswBatchResult(*out.unbind(0))


def ksw_align_batch_cuda(q, qlens, t, tlens, mat5, o_del: int, e_del: int,
                         o_ins: int, e_ins: int, minsc: int,
                         max_mat: int) -> KswBatchResult:
    """KswBatchResult equal to the plain version's, every output. q [J, L],
    t [J, T], qlens / tlens [J], all int32; mat5 the 5 x 5 matrix (a numpy
    array or host values)."""
    dev = q.device
    if dev.type == "cpu":
        return ksw_align_batch(q, qlens, t, tlens, mat5, o_del, e_del, o_ins,
                               e_ins, minsc, max_mat)
    if dev.type != "cuda":
        raise ValueError(f"ksw_align_batch_cuda: unsupported device {dev}")
    for name, x, nd in (("q", q, 2), ("t", t, 2), ("qlens", qlens, 1),
                        ("tlens", tlens, 1)):
        if x.dtype != torch.int32 or x.dim() != nd or x.device != dev:
            raise ValueError(
                f"ksw_align_batch_cuda: {name}: expected a {nd}-d int32 "
                f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    J, L = q.shape
    if any(x.shape[0] != J for x in (t, qlens, tlens)):
        raise ValueError("ksw_align_batch_cuda: job counts differ")
    if not k_for(L) or t.shape[1] < 1 or max_mat < 1:
        raise ValueError(f"ksw_align_batch_cuda: a query width of {L} "
                         f"columns (the kernel takes up to {MAX_L}), an "
                         f"empty target or max_mat {max_mat}")
    if np.asarray(mat5).size != 25:
        raise ValueError("ksw_align_batch_cuda: mat5 must be 5 x 5")
    return launch(q.contiguous(), qlens.contiguous(), t.contiguous(),
                  tlens.contiguous(), mat5, o_del, e_del, o_ins, e_ins, minsc,
                  max_mat)


# kernel launches since the last reset (main-path proof in chip_smoke.py),
# counted through _ALIGN_FN, so a swap of the module name keeps the count
ksw_align_batch_cuda.launches = 0
_ALIGN_FN = ksw_align_batch_cuda


def _scan_twin(qc, qlen, tcodes, mat, gap, K, colmax=None, stop_at=0):
    """csrc/kswa.cu scan(): (gmax, te, qe, rows run)."""
    o_del, e_del, o_ins, e_ins = gap
    n = 32 * K
    c = np.arange(n)
    H = np.zeros(n, np.int64)
    E = np.zeros(n, np.int64)
    ok = c < qlen
    q = np.where(qc < 0, 4, qc)
    gmax, te, qe, rows = 0, -1, -1, 0
    for i, tc in enumerate(tcodes):
        rows += 1
        M = np.concatenate([[0], H[:-1]]) + mat[tc, q]
        hp = np.where(ok, np.maximum(np.maximum(M, E), 0), 0)
        key = hp + e_ins * c
        # in-lane exclusive prefix, then the lanes' exclusive scan
        agg = np.maximum.accumulate(key.reshape(32, K), axis=1)
        pre = np.concatenate([np.full((32, 1), NEG), agg[:, :-1]],
                             axis=1).ravel()
        lane_incl = np.maximum.accumulate(agg[:, -1])
        run = np.repeat(np.concatenate([[NEG], lane_incl[:-1]]), K)
        f = np.maximum(run, pre) - o_ins - e_ins * c
        H = np.where(ok, np.maximum(hp, np.maximum(f, 0)), 0)
        E = np.where(ok, np.maximum(np.maximum(H - o_del - e_del, E - e_del),
                                    0), 0)
        cm = int(H.max())
        if colmax is not None:
            colmax[i] = cm
        if cm > gmax:
            gmax, te, qe = cm, i, int(np.flatnonzero(H == cm)[0])
            if stop_at > 0 and cm >= stop_at:
                break
    return gmax, te, qe, rows


def kswa_twin(q, qlens, t, tlens, mat5, o_del: int, e_del: int, o_ins: int,
              e_ins: int, minsc: int, max_mat: int):
    """The kernel's loops in numpy, a job at a time: (KswBatchResult of
    numpy arrays, rows [J] (forward plus reverse scan rows))."""
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    J, L = q.shape
    T = t.shape[1]
    K = k_for(L)
    mat = np.asarray(mat5, np.int64).reshape(5, 5)
    gap = (o_del, e_del, o_ins, e_ins)
    out = np.zeros((7, J), np.int32)
    rows = np.zeros(J, np.int64)
    for j in range(J):
        qlen = min(max(int(qlens[j]), 0), L)
        tlen = min(max(int(tlens[j]), 0), T)
        c = np.arange(32 * K)
        qc = np.where(c < qlen, np.clip(q[j, np.minimum(c, L - 1)], 0, 4),
                      -1)
        colmax = np.zeros(T, np.int64)
        gmax, te, qe, r1 = _scan_twin(qc, qlen, np.clip(t[j, :tlen], 0, 4),
                                      mat, gap, K, colmax)
        qe = qe if gmax > 0 else -1
        d = (gmax + max_mat - 1) // max_mat
        best, at = 0, 1 << 30
        for lane in range(32):
            lb, la = 0, 1 << 30
            for ti in range(lane, tlen, 32):
                cm = colmax[ti]
                if ((ti < te - d or ti > te + d) and cm >= max(minsc, 1)
                        and cm > lb):
                    lb, la = int(cm), ti
            if lb > best or (lb == best and la < at):
                best, at = lb, la
        te2 = at if best > 0 else -1
        tb = qb = -1
        r2 = 0
        if gmax > 0 and gmax >= minsc:
            rq = np.where(c <= qe, np.clip(q[j, np.clip(qe - c, 0, L - 1)],
                                           0, 4), -1)
            rt = np.clip(t[j, te::-1], 0, 4)
            g2, te_r, qe_r, r2 = _scan_twin(rq, qe + 1, rt, mat, gap, K,
                                            stop_at=gmax)
            if g2 == gmax:
                tb, qb = te - te_r, qe - qe_r
        out[:, j] = (gmax, te, qe, best, te2, tb, qb)
        rows[j] = r1 + r2
    return KswBatchResult(*out), rows
