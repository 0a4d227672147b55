"""Batched banded Smith-Waterman extension in plain PyTorch.

Counterpart of ``bwa_mem_scale_tpu/ops/bsw.py`` and the plain version
of the CUDA kernel in ``csrc/bsw.cu`` (``ops/bsw_cuda.py`` wraps it):
one pair per row, the DP row loop vectorised over pairs and query
columns, the row-wise F dependency computed as a decayed prefix max

    t_j = max(M_j - oe_ins, 0)
    f_j = max_{k<j}(t_k - (j-1-k) * e_ins) = cummax(t_k + k*e_ins) - (j-1)*e_ins

Semantics are those of the scalar reference (scalarBandedSWA,
src/bandedSWA.cpp:116-238): the h0-seeded first row, z-drop, the
per-row adaptive band shrink on the shifted H row, and the
(score, qle, tle, gtle, gscore, max_off) outputs. Lanes with q_len or
t_len 0 keep score h0 with qle = tle = gtle = 0 and gscore -1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -(1 << 30)
CHECK_EVERY = 8


class BswBatchResult(NamedTuple):
    score: torch.Tensor
    qle: torch.Tensor
    tle: torch.Tensor
    gtle: torch.Tensor
    gscore: torch.Tensor
    max_off: torch.Tensor


def scoring(mat) -> dict:
    """The scalars of bwa's fill_scmat matrix (+a match, -b mismatch,
    -1 against N; src/bwa.cpp:98-110) that the DP needs."""
    m = np.asarray(mat)
    return dict(mx=int(m.max()), sc_match=int(m[0, 0]),
                sc_mis=int(m[0, 1]), sc_n=int(m[0, 4]))


def band_per_pair(q_lens, w: int, o_del: int, e_del: int, o_ins: int,
                  e_ins: int, mx: int, end_bonus: int = 0):
    """Per-pair band clamped to the largest feasible gap, with C
    truncating division (the scalar kernel's int(x / e + 1.0))."""
    q = q_lens.to(torch.int32) * mx + end_bonus
    max_ins = torch.div(q - o_ins, e_ins, rounding_mode="trunc") + 1
    max_del = torch.div(q - o_del, e_del, rounding_mode="trunc") + 1
    return torch.clamp(torch.minimum(max_ins.clamp(min=1),
                                     max_del.clamp(min=1)),
                       max=w).to(torch.int32)


def banded_swa_batch(qs, q_lens, ts, t_lens, h0, w: int, o_del: int,
                     e_del: int, o_ins: int, e_ins: int, zdrop: int, mat,
                     end_bonus: int = 0, stats: dict = None
                     ) -> BswBatchResult:
    """qs [P, QL] query codes, q_lens [P], ts [P, TL] target codes,
    t_lens [P], h0 [P]; all int32. Returns int32 results [P].

    Only the live pairs (q_len and t_len > 0) enter the DP; the others
    keep their fixed result. `stats`, where given, gains the loop's rows
    (``bsw_rows``), the rows the pairs walk (``bsw_pair_rows``) and the
    band cells they compute (``bsw_cells``), summed over calls; where it
    holds the key ``bsw_rows_per_pair``, that becomes this call's rows of
    each pair ([P])."""
    live = ((q_lens > 0) & (t_lens > 0)).nonzero()[:, 0]
    if live.numel() < qs.shape[0]:
        h0 = h0.to(torch.int32)
        neg = torch.full_like(h0, -1)
        out = [h0.clone(), neg + 1, neg + 1, neg + 1, neg,
               torch.zeros_like(h0)]
        if live.numel():
            sub = banded_swa_batch(qs[live], q_lens[live], ts[live],
                                   t_lens[live], h0[live], w, o_del, e_del,
                                   o_ins, e_ins, zdrop, mat, end_bonus,
                                   stats)
            for o, v in zip(out, sub):
                o[live] = v
            if stats is not None and "bsw_rows_per_pair" in stats:
                per = torch.zeros_like(h0)
                per[live] = stats["bsw_rows_per_pair"]
                stats["bsw_rows_per_pair"] = per
        return BswBatchResult(*out)
    P, QL = qs.shape
    TL = ts.shape[1]
    dev = qs.device
    i32 = torch.int32
    q_lens = q_lens.to(i32)
    t_lens = t_lens.to(i32)
    h0 = h0.to(i32)
    ts = ts.to(i32)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    sc = scoring(mat)
    q_codes = qs.to(i32).clamp(0, 4)
    colq = torch.arange(QL + 1, dtype=i32, device=dev)[None, :]
    colj = colq[:, :QL]

    # first row: h0, then the insertion ramp, cut after its first failure
    h_of_1 = torch.clamp(h0 - oe_ins, min=0)
    ramp = h_of_1[:, None] - e_ins * (colq[:, 2:] - 1)
    prev_val = torch.cat([h_of_1[:, None], ramp[:, :-1]], dim=1)
    ok = torch.cumprod((prev_val > e_ins).to(i32), dim=1).bool()
    ramp = torch.where(ok, ramp.clamp(min=0), 0)
    eh_h = torch.cat([h0[:, None], h_of_1[:, None], ramp], dim=1)
    eh_h = torch.where(colq <= q_lens[:, None], eh_h, 0)    # [P, QL+1]
    eh_e = torch.zeros_like(eh_h)

    w_p = band_per_pair(q_lens, w, o_del, e_del, o_ins, e_ins, sc["mx"],
                        end_bonus)
    beg = torch.zeros((P,), dtype=i32, device=dev)
    end = q_lens.clone()
    max_sc = h0.clone()
    max_i = torch.full((P,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros((P,), dtype=i32, device=dev)
    alive = (t_lens > 0) & (q_lens > 0)
    if stats is not None:           # rows and band cells each pair walks
        pair_rows = torch.zeros((P,), dtype=i32, device=dev)
        cells = torch.zeros((), dtype=torch.int64, device=dev)

    i = 0
    while bool(alive.any()):
        for _ in range(CHECK_EVERY):
            live = alive & (i < t_lens)
            tb = ts[:, min(i, TL - 1)].clamp(0, 4)[:, None]
            qprof = torch.where((tb == 4) | (q_codes == 4), sc["sc_n"],
                                torch.where(tb == q_codes, sc["sc_match"],
                                            sc["sc_mis"])).to(i32)
            bg = torch.maximum(beg, i - w_p)
            en = torch.minimum(torch.minimum(end, i + w_p + 1), q_lens)
            h1_first = torch.where(
                bg == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0),
                0)
            in_band = (colj >= bg[:, None]) & (colj < en[:, None])
            if stats is not None:
                pair_rows += live
                cells += torch.where(live, (en - bg).clamp(min=0), 0).sum()
            Hprev = eh_h[:, :QL]           # eh_h[j] = H(i-1, j-1)
            Eprev = eh_e[:, :QL]           # eh_e[j] = E(i, j)
            M = torch.where(Hprev != 0, Hprev + qprof, 0)
            pre = torch.maximum(M, Eprev)
            t_ins = torch.clamp(M - oe_ins, min=0)
            keyed = torch.where(in_band, t_ins + e_ins * colj, NEG)
            run = torch.cummax(keyed, dim=1).values
            run = torch.cat([torch.full((P, 1), NEG, dtype=i32, device=dev),
                             run[:, :-1]], dim=1)
            f = torch.clamp(run - e_ins * (colj - 1), min=0)
            f = torch.where(colj == bg[:, None], 0, f)
            H = torch.where(in_band, torch.maximum(pre, f), 0)

            # row max and the LAST column attaining it
            Hm = torch.where(in_band, H, -1)
            raw = Hm.max(1).values
            mj_last = torch.where(Hm == raw[:, None], colj, -1).max(1).values
            mrow = raw.clamp(min=0)
            mj = torch.where(mrow > 0, mj_last, -1)
            E_next = torch.maximum(torch.clamp(M - oe_del, min=0),
                                   Eprev - e_del)

            # write back the shifted row: eh_h[j] = H(i, j-1) on
            # (beg, end], eh_e[j] = E(i+1, j) on [beg, end), eh_e[end] = 0
            Hsh = torch.cat([torch.zeros((P, 1), dtype=i32, device=dev), H],
                            dim=1)
            upd_h = (colq >= bg[:, None] + 1) & (colq <= en[:, None])
            new_h = torch.where(upd_h, Hsh, eh_h)
            new_h = torch.where(colq == bg[:, None], h1_first[:, None],
                                new_h)
            E_sh = torch.cat([E_next, torch.zeros((P, 1), dtype=i32,
                                                  device=dev)], dim=1)
            upd_e = (colq >= bg[:, None]) & (colq < en[:, None])
            new_e = torch.where(upd_e, E_sh, eh_e)
            at_end = colq == en.clamp(0, QL)[:, None]
            new_e = torch.where(at_end, 0, new_e)
            h1_last = torch.where(at_end, Hsh, 0).sum(1, dtype=i32)
            h1_last = torch.where(en > bg, h1_last, h1_first)
            new_h = torch.where(at_end, h1_last[:, None], new_h)
            eh_h = torch.where(live[:, None], new_h, eh_h)
            eh_e = torch.where(live[:, None], new_e, eh_e)

            # gscore when the band reached the query end
            gupd = live & (en == q_lens) & (gscore <= h1_last)
            gscore = torch.where(gupd, h1_last, gscore)
            max_ie = torch.where(gupd, i, max_ie)

            brk0 = live & (mrow == 0)
            better = live & ~brk0 & (mrow > max_sc)
            max_off = torch.where(better, torch.maximum(max_off,
                                                        (mj - i).abs()),
                                  max_off)
            di = i - max_i
            dj = mj - max_j
            zdelta = torch.where(di > dj,
                                 max_sc - mrow - (di - dj) * e_del,
                                 max_sc - mrow - (dj - di) * e_ins)
            brkz = live & ~brk0 & ~better & (zdelta > zdrop) \
                if zdrop > 0 else torch.zeros_like(live)
            max_sc = torch.where(better, mrow, max_sc)
            max_i = torch.where(better, i, max_i)
            max_j = torch.where(better, mj, max_j)

            # adaptive band shrink on the freshly written rows
            nz = (new_h != 0) | (new_e != 0)
            cand = nz & (colq >= bg[:, None]) & (colq < en[:, None])
            lead = torch.where(cand, colq, 1 << 30).min(1).values
            beg2 = torch.where(lead < (1 << 30), lead, en)
            cand2 = nz & (colq >= beg2[:, None]) & (colq <= en[:, None])
            tail = torch.where(cand2, colq, NEG).max(1).values
            jpos = torch.where(tail > NEG, tail, beg2 - 1)
            end2 = torch.minimum(jpos + 2, q_lens)

            alive = live & ~brk0 & ~brkz
            beg = torch.where(live, beg2, beg)
            end = torch.where(live, end2, end)
            i += 1
    if stats is not None:
        stats["bsw_rows"] = stats.get("bsw_rows", 0) + i
        stats["bsw_pair_rows"] = (stats.get("bsw_pair_rows", 0)
                                  + int(pair_rows.sum()))
        stats["bsw_cells"] = stats.get("bsw_cells", 0) + int(cells)
        if "bsw_rows_per_pair" in stats:
            stats["bsw_rows_per_pair"] = pair_rows
    return BswBatchResult(score=max_sc, qle=max_j + 1, tle=max_i + 1,
                          gtle=max_ie + 1, gscore=gscore, max_off=max_off)


def banded_swa_rows(qs, lens, ts, h0, w: int, o_del: int, e_del: int,
                    o_ins: int, e_ins: int, zdrop: int, mat,
                    end_bonus: int = 0, stats: dict = None) -> torch.Tensor:
    """``banded_swa_batch`` in the extension's form: lens [2, P] (query
    and target lengths) in, the six results as one [6, P] int32 tensor
    out (the plain version of ``ops/bsw_cuda.py::bsw_rows``)."""
    return torch.stack(list(banded_swa_batch(
        qs, lens[0], ts, lens[1], h0, w, o_del, e_del, o_ins, e_ins, zdrop,
        mat, end_bonus, stats=stats)))
