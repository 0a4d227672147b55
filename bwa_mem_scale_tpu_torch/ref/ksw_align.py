"""Oracle local Smith-Waterman with end/start coordinates and a
second-best score — the semantics of ksw_align2 (src/ksw.cpp:347-381,
core scan src/ksw.cpp:111-231) used by PE mate rescue.

Forward scan: affine-gap local DP clamped at 0; records global best
(score, te), the best-H row at te for qe (earliest query index on
ties), and per-target-column maxima for the second-best score.
Start coordinates come from re-running the scan on the reversed
prefixes (ksw_align2's revseq trick).

Divergence (both here and in ops/kswa.py, so tests agree): score2
takes the max per-column maximum outside the te +- ceil(score/max_mat)
window, without the reference's merging of consecutive-column runs
(src/ksw.cpp:199-207) — the merged representative can differ when a
run straddles the window edge; it only feeds the csub MAPQ cap.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KswResult:
    score: int = 0
    te: int = -1
    qe: int = -1
    score2: int = 0
    te2: int = -1
    tb: int = -1
    qb: int = -1


def _forward_scan(query, target, mat, o_del, e_del, o_ins, e_ins,
                  stop_at: int = 1 << 30):
    qlen, tlen = len(query), len(target)
    H_prev = np.zeros(qlen, dtype=np.int64)
    E = np.zeros(qlen, dtype=np.int64)
    gmax, te = 0, -1
    H_best = np.zeros(qlen, dtype=np.int64)
    colmax = np.zeros(tlen, dtype=np.int64)
    for i in range(tlen):
        S = mat[target[i], query].astype(np.int64)
        M = np.concatenate(([0], H_prev[:-1])) + S
        Hp = np.maximum(np.maximum(M, E), 0)
        # F via prefix max (insertions never chain through F-origin)
        A = Hp + e_ins * np.arange(qlen)
        pm = np.concatenate(([np.int64(-1 << 60)],
                             np.maximum.accumulate(A)[:-1]))
        F = pm - o_ins - e_ins * np.arange(qlen)
        H = np.maximum(Hp, np.maximum(F, 0))
        E = np.maximum(np.maximum(H - o_del - e_del, E - e_del), 0)
        colmax[i] = H.max() if qlen else 0
        if colmax[i] > gmax:
            gmax = int(colmax[i])
            te = i
            H_best = H.copy()
            if gmax >= stop_at:
                H_prev = H
                break
        H_prev = H
    return gmax, te, H_best, colmax


def ksw_align(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
              o_del: int, e_del: int, o_ins: int, e_ins: int,
              minsc: int = 0, want_start: bool = True) -> KswResult:
    r = KswResult()
    if len(query) == 0 or len(target) == 0:
        return r
    gmax, te, H_best, colmax = _forward_scan(
        query, target, mat, o_del, e_del, o_ins, e_ins)
    r.score, r.te = gmax, te
    if gmax == 0:
        return r
    r.qe = int(np.argmax(H_best))
    max_mat = int(mat.max())
    d = (gmax + max_mat - 1) // max_mat
    out = np.ones(len(target), dtype=bool)
    out[max(0, te - d): te + d + 1] = False
    cand = np.where(out & (colmax >= max(minsc, 1)), colmax, 0)
    if cand.max() > 0:
        r.score2 = int(cand.max())
        r.te2 = int(np.argmax(cand))
    if not want_start or (minsc and r.score < minsc):
        return r
    rq = query[: r.qe + 1][::-1]
    rt = target[: te + 1][::-1]
    g2, te2, Hb2, _ = _forward_scan(rq, rt, mat, o_del, e_del,
                                    o_ins, e_ins, stop_at=gmax)
    if g2 == gmax:
        r.tb = te - te2
        r.qb = r.qe - int(np.argmax(Hb2))
    return r
