"""Batched local Smith-Waterman (ksw_align2) for mate rescue.

Counterpart of ``bwa_mem_scale_tpu/ops/kswa.py``: one alignment problem
a row of the batch (the reference's inter-sequence kswv batch,
src/kswv.cpp:372-934, driven from mem_sam_pe_batch), the row recurrence
vectorised over (job, query) with the insertion term F as a prefix max:
F(i,j) = max_k<j (H'(i,k) - o_ins - e_ins*(j-k)), valid because an
insertion never improves by chaining through another insertion's origin
when o_ins >= 0.

Two-phase coordinates like the reference (src/ksw.cpp:369-379): the
forward scan gives (score, te, qe) and each target column's maximum,
from which score2 and te2 come; a second scan of the reversed
(qe, te)-prefixes gives (qb, tb). ``ref/ksw_align.py`` is the scalar
oracle, with the documented score2 divergence this function keeps.

``ksw_align_batch`` is the plain version, step for step the JAX
function's. ``pipeline/pe.py::run_rescue_jobs`` (when
``BWA_TPU_NO_NATIVE_KSWA`` is set) calls ``kswa_cuda.ksw_align_batch_cuda``:
the hand kernel of csrc/kswa.cu on CUDA tensors, this function on CPU
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -(1 << 29)


class KswBatchResult(NamedTuple):
    score: torch.Tensor
    te: torch.Tensor
    qe: torch.Tensor
    score2: torch.Tensor
    te2: torch.Tensor
    tb: torch.Tensor
    qb: torch.Tensor


def _scan_phase(q, qlens, t, tlens, mat5, o_del, e_del, o_ins, e_ins):
    """Forward local-SW scan. q [J, L] int32 (4=N ok), t [J, T].
    Returns (gmax, te, qe, colmax [J, T])."""
    J, L = q.shape
    T = t.shape[1]
    dev = q.device
    i32 = torch.int32
    jq = torch.arange(L, dtype=i32, device=dev)
    q_in = jq[None, :] < qlens[:, None]
    e_ins_j = (e_ins * jq)[None, :]
    qc = q.clamp(0, 4).long()
    zcol = torch.zeros((J, 1), dtype=i32, device=dev)
    negcol = torch.full((J, 1), NEG, dtype=i32, device=dev)
    H_prev = torch.zeros((J, L), dtype=i32, device=dev)
    E = torch.zeros_like(H_prev)
    Hbest = torch.zeros_like(H_prev)
    gmax = torch.zeros((J,), dtype=i32, device=dev)
    te = torch.full((J,), -1, dtype=i32, device=dev)
    colmax = torch.zeros((J, T), dtype=i32, device=dev)
    for i in range(T):
        tb = t[:, i].clamp(0, 4).long()
        S = mat5[tb[:, None], qc]
        M = torch.cat([zcol, H_prev[:, :-1]], dim=1) + S
        Hp = torch.maximum(M, E).clamp(min=0)
        Hp = torch.where(q_in, Hp, 0)
        A = Hp + e_ins_j
        pm = torch.cummax(A, dim=1).values
        pm = torch.cat([negcol, pm[:, :-1]], dim=1)
        F = pm - o_ins - e_ins_j
        H = torch.maximum(Hp, F.clamp(min=0))
        H = torch.where(q_in, H, 0)
        E = torch.maximum(H - o_del - e_del, E - e_del).clamp(min=0)
        E = torch.where(q_in, E, 0)
        live = i < tlens
        cm = torch.where(live, H.max(dim=1).values, 0)
        better = live & (cm > gmax)
        gmax = torch.where(better, cm, gmax)
        te = torch.where(better, i, te)
        Hbest = torch.where(better[:, None], H, Hbest)
        H_prev = torch.where(live[:, None], H, H_prev)
        colmax[:, i] = cm
    qe = _first_argmax(Hbest)
    qe = torch.where(gmax > 0, qe, -1)
    return gmax, te, qe, colmax


def _first_argmax(x):
    """Index of the first maximum of each row (jnp.argmax's tie rule)."""
    n = x.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
    at_max = x == x.max(dim=1, keepdim=True).values
    return torch.where(at_max, idx, n).min(dim=1).values


def ksw_align_batch(q, qlens, t, tlens, mat5, o_del, e_del, o_ins, e_ins,
                    minsc: int, max_mat: int) -> KswBatchResult:
    """Batched ksw_align2 with XSTART: q [J, L] / t [J, T] padded int32
    code arrays, qlens / tlens [J] int32, mat5 the 5 x 5 matrix."""
    J, L = q.shape
    T = t.shape[1]
    dev = q.device
    i32 = torch.int32
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    mat5 = torch.as_tensor(mat5).to(device=dev, dtype=i32)
    gmax, te, qe, colmax = _scan_phase(q, qlens, t, tlens, mat5, o_del,
                                       e_del, o_ins, e_ins)
    # second-best outside the te window (see the module docstring)
    d = torch.div(gmax + max_mat - 1, max_mat, rounding_mode="floor")
    ti = torch.arange(T, dtype=i32, device=dev)[None, :]
    outside = (ti < (te - d)[:, None]) | (ti > (te + d)[:, None])
    cand = torch.where(outside & (colmax >= max(minsc, 1)), colmax, 0)
    score2 = cand.max(dim=1).values
    te2 = torch.where(score2 > 0, _first_argmax(cand), -1)

    # phase 1: reversed prefixes for start coordinates
    jq = torch.arange(L, dtype=i32, device=dev)
    ti1 = torch.arange(T, dtype=i32, device=dev)
    rq = q.gather(1, (qe[:, None] - jq[None, :]).clamp(0, L - 1).long())
    rt = t.gather(1, (te[:, None] - ti1[None, :]).clamp(0, T - 1).long())
    g2, te_r, qe_r, _ = _scan_phase(rq, qe + 1, rt, te + 1, mat5, o_del,
                                    e_del, o_ins, e_ins)
    # ksw_align2 skips the start-coordinate pass below the XSUBO
    # threshold (src/ksw.cpp:369)
    ok = (g2 == gmax) & (gmax > 0) & (gmax >= minsc)
    tb = torch.where(ok, te - te_r, -1)
    qb = torch.where(ok, qe - qe_r, -1)
    return KswBatchResult(score=gmax, te=te, qe=qe, score2=score2,
                          te2=te2.to(i32), tb=tb.to(i32), qb=qb.to(i32))
