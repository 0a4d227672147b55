"""Batched banded global alignment with traceback (the CIGAR DP).

Counterpart of ``bwa_mem_scale_tpu/ops/kswg.py``: ksw_global2
(src/ksw.cpp:558-672) one pair a row of the batch, the query axis
vectorised, F as a prefix max with -inf semantics and the
strict-inequality direction bits of the JAX function; the direction
matrix banked per row as ``z [P, TL, QL]`` uint8 and a lockstep
traceback that records each step's op, which the host run-length
encodes into CIGARs (``rle_cigar``; bwa_gen_cigar2's NM/MD stay on the
host).

``ksw_global_batch`` is the plain version, step for step the JAX
function's. The finalizer's device path calls
``kswg_cuda.ksw_global_batch_cuda``: the hand kernel of csrc/kswg.cu on
CUDA tensors, this function on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -(1 << 29)


class KswgResult(NamedTuple):
    score: torch.Tensor      # [P] int32
    ops: torch.Tensor        # [P, S] int8 traceback ops (0=M,1=I,2=D), -1 pad
    n_ops: torch.Tensor      # [P] int32 number of recorded steps
    tail_del: torch.Tensor   # [P] leading deletion run length
    tail_ins: torch.Tensor   # [P] leading insertion run length


def profile_scores(mat):
    """(match, mismatch, N) scores of the arithmetic query profile the
    JAX function reads from the 5 x 5 matrix (bwa_fill_scmat's shape)."""
    m = torch.as_tensor(mat).reshape(5, 5)
    return int(m[0, 0]), int(m[0, 1]), int(m[0, 4])


def ksw_global_batch(qs, q_lens, ts, t_lens, w_p, o_del: int, e_del: int,
                     o_ins: int, e_ins: int, mat) -> KswgResult:
    """Banded global DP + traceback for a batch of pairs.

    qs [P, QL], ts [P, TL] int32 codes; q_lens/t_lens/w_p [P] int32.
    The caller guarantees w_p >= |tlen - qlen| (bwa_gen_cigar2 does)."""
    P, QL = qs.shape
    TL = ts.shape[1]
    dev = qs.device
    i32 = torch.int32
    q_lens = q_lens.to(i32)
    t_lens = t_lens.to(i32)
    w_p = w_p.to(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    s_match, s_mis, s_n = profile_scores(mat)
    q_codes = qs.clamp(0, 4).to(i32)

    colq = torch.arange(QL + 1, dtype=i32, device=dev)[None, :]
    colj = torch.arange(QL, dtype=i32, device=dev)[None, :]
    negcol = torch.full((P, 1), NEG_INF, dtype=i32, device=dev)

    # first row: eh_h[0]=0; eh_h[j]=-(o_ins+e_ins*j) for 1<=j<=w; else -inf
    first = -(o_ins + e_ins * colq)
    eh_h = torch.where(colq == 0, 0,
                       torch.where((colq <= w_p[:, None])
                                   & (colq <= q_lens[:, None]), first,
                                   NEG_INF)).to(i32)
    eh_h = torch.cat([eh_h, negcol], dim=1)
    eh_e = torch.full((P, QL + 2), NEG_INF, dtype=i32, device=dev)
    z = torch.zeros((P, TL, QL), dtype=torch.uint8, device=dev)

    for i in range(TL):
        alive = i < t_lens
        tb = ts[:, min(i, TL - 1)].clamp(0, 4)
        is_n = (tb[:, None] == 4) | (q_codes == 4)
        qprof = torch.where(is_n, s_n, torch.where(tb[:, None] == q_codes,
                                                   s_match, s_mis)).to(i32)

        beg = (i - w_p).clamp(min=0)
        end = torch.minimum(i + w_p + 1, q_lens)
        h1_first = torch.where(beg == 0, -(o_del + e_del * (i + 1)),
                               NEG_INF).to(i32)

        in_band = (colj >= beg[:, None]) & (colj < end[:, None])
        Hprev = eh_h[:, :QL]
        Eprev = eh_e[:, :QL]
        M = (Hprev + qprof).clamp(min=NEG_INF)

        d_h = torch.where(M >= Eprev, 0, 1).to(torch.uint8)
        pre = torch.maximum(M, Eprev)

        # F scan with -inf base; strict bit f_cur - e_ins > m - oe_ins
        t_ins = (M - oe_ins).clamp(min=NEG_INF)
        keyed = torch.where(in_band, t_ins + e_ins * colj, NEG_INF)
        run = torch.cummax(keyed, dim=1).values
        run_shift = torch.cat([negcol, run[:, :-1]], dim=1)
        f = (run_shift - e_ins * (colj - 1)).clamp(min=NEG_INF)
        f = torch.where(colj == beg[:, None], NEG_INF, f)

        d_h = torch.where(pre >= f, d_h, 2).to(torch.uint8)
        H = torch.maximum(pre, f)

        t_del = (M - oe_del).clamp(min=NEG_INF)
        e_bit = (Eprev - e_del) > t_del
        E_next = torch.maximum(Eprev - e_del, t_del)
        # F bit (value 2 in bits [4:6]): decayed running F beats opening
        f_bit = (f - e_ins) > t_ins

        d = (d_h | (e_bit.to(torch.uint8) << 2)
             | (f_bit.to(torch.uint8) << 5))
        drow = torch.where(in_band, d, 0).to(torch.uint8)
        z[:, i, :] = torch.where(alive[:, None], drow, z[:, i, :])

        # shifted write-back
        Hshift = torch.cat([negcol, H], dim=1)
        upd_h = (colq >= beg[:, None] + 1) & (colq <= end[:, None])
        new_h = torch.where(upd_h, Hshift, eh_h[:, : QL + 1])
        new_h = torch.where(colq == beg[:, None], h1_first[:, None], new_h)
        upd_e = (colq >= beg[:, None]) & (colq < end[:, None])
        new_e = torch.where(upd_e, torch.cat([E_next, negcol], dim=1),
                            eh_e[:, : QL + 1])
        at_end = colq == end.clamp(0, QL)[:, None]
        new_e = torch.where(at_end, NEG_INF, new_e)
        h1_last = torch.where(at_end, Hshift, 0).sum(1, dtype=i32)
        h1_last = torch.where(end > beg, h1_last, h1_first)
        new_h = torch.where(at_end, h1_last[:, None], new_h)

        eh_h = torch.where(alive[:, None],
                           torch.cat([new_h, eh_h[:, QL + 1:]], dim=1), eh_h)
        eh_e = torch.where(alive[:, None],
                           torch.cat([new_e, eh_e[:, QL + 1:]], dim=1), eh_e)
    at_q = (torch.arange(QL + 2, dtype=i32, device=dev)[None, :]
            == q_lens.clamp(0, QL + 1)[:, None])
    score = torch.where(at_q, eh_h, 0).sum(1, dtype=i32)

    # ---------------- lockstep traceback ----------------
    S = QL + TL + 2
    ops = torch.full((P, S + 1), -1, dtype=torch.int8, device=dev)
    bpx = torch.arange(P, device=dev)
    i = t_lens - 1
    k = torch.minimum(i + w_p + 1, q_lens) - 1
    which = torch.zeros((P,), dtype=i32, device=dev)
    sc = torch.zeros((P,), dtype=i32, device=dev)
    while True:
        active = (i >= 0) & (k >= 0)
        if not bool(active.any()):
            break
        d = z[bpx, i.clamp(0, TL - 1).long(),
              k.clamp(0, QL - 1).long()].to(i32)
        which = torch.where(active, (d >> (which << 1)) & 3, which)
        op = torch.where(which == 0, 0,
                         torch.where(which == 1, 2, 1)).to(torch.int8)
        # an inactive pair writes its op to the spare column S (dropped)
        ops[bpx, torch.where(active, sc, S).long()] = op
        sc = sc + active.to(i32)
        i = i - (active & (which != 2)).to(i32)
        k = k - (active & (which != 1)).to(i32)
    return KswgResult(score=score, ops=ops[:, :S].contiguous(), n_ops=sc,
                      tail_del=(i + 1).clamp(min=0),
                      tail_ins=(k + 1).clamp(min=0))


def rle_cigar(ops_row, n_ops: int, tail_del: int, tail_ins: int):
    """Host helper: recorded traceback -> cigar [(len, op)] list.

    The recorded sequence is alignment-end-first; leading D/I runs are
    appended then the whole list reversed (push_cigar semantics,
    src/ksw.cpp:655-668)."""
    seq = [int(x) for x in ops_row[:n_ops]]
    seq.extend([2] * tail_del)
    seq.extend([1] * tail_ins)
    seq.reverse()
    out = []
    for op in seq:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, int(op)))
    return out
