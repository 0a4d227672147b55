"""Mate-rescue local SW (ksw_align2 with start coordinates) through the
hand-written CUDA kernel of csrc/kswa.cu.

``ksw_align_batch_cuda`` has the signature of the JAX package's
``ops/kswa.py::ksw_align_batch`` (its two ``_scan_phase`` passes,
``:37-78``, and the score2 / te2 and tb / qb steps, ``:88-110``, are what
the kernel replaces). On CUDA tensors it launches ``kswa_kernel<K>`` (one
warp a job, K query columns a lane in registers, L <= 32 K, the rows a
wavefront across the lanes) or raises; on CPU tensors it runs the plain
version, ``ops/kswa.py::ksw_align_batch``. There is no fallback from the
kernel to the plain version. ``kswa_twin`` follows the kernel's
wavefront in numpy, step by step with the 32 lanes side by side as the
warp runs them (the shuffled carries, the packed row maximum the last
lane stores, the first-best row after the scan, the strided score2
pass, the reverse scan checked for the score every STOP_EVERY steps),
and counts each job's steps; the wrapper keeps the last call's steps in ``last_steps``.

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
PACK = 10            # column bits of the packed row maximum (H < 2^21)
PAD = -(1 << 22)     # the padding row's score (csrc/kswa.cu)
ROWS = 2             # rows a lane computes a step
STOP_EVERY = 2       # steps between the reverse scan's checks


class _Mat(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int * 25)]


_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = nvcc_build.Library(
    "kswa.cu", "kswa_cuda",
    {"kswa_launch": [_vp] * 7 + [_ci] * 3 + [_Mat] + [_ci] * 6})
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
    out = torch.empty((8, J), dtype=torch.int32, device=dev)
    m = _Mat()
    m.v[:] = [int(x) for x in np.asarray(mat5, np.int64).reshape(25)]
    if J:
        LIB.launch(dev, "kswa_launch", q.data_ptr(), qlens.data_ptr(),
                   t.data_ptr(), tlens.data_ptr(), colmax.data_ptr(),
                   out.data_ptr(), out[7].data_ptr(), J, L, T, m, o_del,
                   e_del, o_ins, e_ins, minsc, max_mat)
        _ALIGN_FN.launches += 1
    _ALIGN_FN.last_steps = out[7]
    return KswBatchResult(*out[:7].unbind(0))


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
    mat = np.asarray(mat5)
    if mat.size != 25:
        raise ValueError("ksw_align_batch_cuda: mat5 must be 5 x 5")
    if (min(o_del, e_del, o_ins, e_ins) < 0
            or max(int(mat.max()), 0) * 32 * k_for(L) >= 1 << (31 - PACK)):
        raise ValueError("ksw_align_batch_cuda: a negative gap penalty, or "
                         "a score past the packed row maximum's 2^21")
    return launch(q.contiguous(), qlens.contiguous(), t.contiguous(),
                  tlens.contiguous(), mat5, o_del, e_del, o_ins, e_ins, minsc,
                  max_mat)


# kernel launches since the last reset (main-path proof in chip_smoke.py),
# counted through _ALIGN_FN, so a swap of the module name keeps the count
ksw_align_batch_cuda.launches = 0
ksw_align_batch_cuda.last_steps = None          # [J] int32, both scans
_ALIGN_FN = ksw_align_batch_cuda


def _scan_twin(qc, qlen, tcodes, mat, gap, K, rowpk=None, stop_at=0):
    """csrc/kswa.cu scan(): the wavefront, one step at a time with the 32
    lanes side by side (lane l on rows ROWS (s - l) .., one after the
    other), every lane computing every step, a row outside 0 .. tlen - 1
    taking the padding row, the columns past qlen unmasked but in the row
    maximum. qc [32 K] the query codes (-1 past qlen), tcodes the scan's
    target codes. Without stop_at each row's packed maximum goes to rowpk;
    with it the scan stops once a row reaches stop_at. Returns (te, qe,
    steps): the first row reaching stop_at and its first column, or
    -1."""
    o_del, e_del, o_ins, e_ins = gap
    tlen = len(tcodes)
    lane = np.arange(32)
    c = (lane[:, None] * K + np.arange(K)).astype(np.int64)   # [32, K]
    ok = c < qlen
    ec = e_ins * c
    last = (qlen - 1) // K if qlen > 0 else 0
    tab = np.concatenate([mat, np.full((1, 5), PAD, np.int64)])
    qq = np.where(qc < 0, 4, qc).reshape(32, K)

    def scores(r):                       # each lane's row r, [32, K]
        code = np.where((r >= 0) & (r < tlen),
                        tcodes[np.clip(r, 0, max(tlen - 1, 0))]
                        if tlen else 5, 5)
        return tab[code[:, None], qq]

    H = np.zeros((32, K), np.int64)
    E = np.zeros((32, K), np.int64)
    inG = np.full((ROWS, 32), NEG, np.int64)
    inPk, inH = np.zeros((ROWS, 32), np.int64), np.zeros((ROWS, 32),
                                                          np.int64)
    hdiag = np.zeros(32, np.int64)
    te, qe, done = -1, -1, False
    nsteps = -(-tlen // ROWS) + last if tlen else 0
    shift = lambda x: np.concatenate([x[:1], x[:-1]])   # __shfl_up_sync 1
    s = 0
    while s < nsteps:
        r0 = ROWS * (s - lane)
        out = []                         # each row's (G, packed max, H_last)
        for i in range(ROWS):
            diag = np.where(lane == 0, 0, hdiag if i == 0 else inH[i - 1])
            left = np.concatenate([diag[:, None], H[:, :-1]], 1)
            hp = np.maximum(np.maximum(left + scores(r0 + i), E), 0)
            acc = np.maximum.accumulate(hp + ec, axis=1)
            pre = np.concatenate([np.full((32, 1), NEG), acc[:, :-1]], 1)
            G = np.where(lane == 0, NEG, inG[i])
            pk = np.where(lane == 0, 0, inPk[i])
            f = np.maximum(G[:, None], pre) - o_ins - ec
            H = np.maximum(hp, np.maximum(f, 0))
            E = np.maximum(np.maximum(H - o_del - e_del, E - e_del), 0)
            # columns past qlen keep their own values; the maximum masks
            pk = np.maximum(pk, np.where(ok, (H << PACK) | (1023 - c), 0)
                            .max(1))
            out.append((np.maximum(G, acc[:, -1]), pk, H[:, -1]))
        hdiag = inH[ROWS - 1]
        inG = np.stack([shift(o[0]) for o in out])
        inPk = np.stack([shift(o[1]) for o in out])
        inH = np.stack([shift(o[2]) for o in out])
        for i in range(ROWS):            # the last lane: its rows done
            rl, p = int(r0[last]) + i, int(out[i][1][last])
            if 0 <= rl < tlen:
                if not stop_at:
                    rowpk[rl] = p
                elif not done and p >= stop_at << PACK:
                    te, qe, done = rl, 1023 - (p & 1023), True
        s += 1
        if stop_at > 0 and s % STOP_EVERY == 0 and done:
            break
    return te, qe, s


def kswa_twin(q, qlens, t, tlens, mat5, o_del: int, e_del: int, o_ins: int,
              e_ins: int, minsc: int, max_mat: int):
    """The kernel's loops in numpy, a job at a time: (KswBatchResult of
    numpy arrays, steps [J] (both scans' wavefront steps))."""
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    J, L = q.shape
    T = t.shape[1]
    K = k_for(L)
    mat = np.asarray(mat5, np.int64).reshape(5, 5)
    gap = (o_del, e_del, o_ins, e_ins)
    out = np.zeros((7, J), np.int32)
    steps = np.zeros(J, np.int64)
    for j in range(J):
        qlen = min(max(int(qlens[j]), 0), L)
        tlen = min(max(int(tlens[j]), 0), T)
        c = np.arange(32 * K)
        qc = np.where(c < qlen, np.clip(q[j, np.minimum(c, L - 1)], 0, 4),
                      -1)
        rowpk = np.zeros(T, np.int64)
        _, _, s1 = _scan_twin(qc, qlen, np.clip(t[j, :tlen], 0, 4), mat,
                              gap, K, rowpk)
        colmax = rowpk >> PACK
        # the first row of the largest maximum, its first column
        gmax = int(colmax[:tlen].max()) if tlen else 0
        te = int(np.argmax(colmax[:tlen])) if gmax > 0 else -1
        qe = 1023 - (int(rowpk[te]) & 1023) if gmax > 0 else -1
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
        s2 = 0
        if gmax > 0 and gmax >= minsc:
            rq = np.where(c <= qe, np.clip(q[j, np.clip(qe - c, 0, L - 1)],
                                           0, 4), -1)
            rt = np.clip(t[j, te::-1], 0, 4)
            te_r, qe_r, s2 = _scan_twin(rq, qe + 1, rt, mat, gap, K,
                                        stop_at=gmax)
            if te_r >= 0:
                tb, qb = te - te_r, qe - qe_r
        out[:, j] = (gmax, te, qe, best, te2, tb, qb)
        steps[j] = s1 + s2
    return KswBatchResult(*out), steps
