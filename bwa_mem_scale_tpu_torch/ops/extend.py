"""The extension stage's glue in plain PyTorch: what ``seed_chain_extend``
does from the chain filter's outputs to its returned dict, around the four
BSW calls.

Counterpart of ``bwa_mem_scale_tpu/pipeline/align.py:202-509`` (candidate
enumeration, the per-chain rmax, compaction into pair space, window
staging, the band-doubling picks, seed coverage and the packed / meta
rows), written as the port's eager torch operations. These are the plain
versions of csrc/extend.cu's kernels (``ops/extend_cuda.py`` wraps them,
with the same signatures), used on CPU tensors and as the kernels'
reference on the card:

- ``ext_select``: each read's candidates in processing order (kept chains
  in the filter's order, then seed key ``(score << 16) | sidx``
  descending), their count, ``reg_overflow`` and each chain's reference
  span rmax0 / rmax1 (int64);
- ``ext_pairs``: the candidates compacted into pair space (each pair's
  read and candidate index), ``read_pair_of``, ``pair_overflow``,
  ``read_overflow`` and the ``meta [B, 2]`` rows;
- ``ext_stage``: the pair fields, the unmasked extension lengths, the
  left round-1 lengths, ``h0`` and the four windows;
- ``ext_band(phase, ...)``: phase 0 the left round-2 lengths, phase 1 the
  left pick and the right round-1 lengths, phase 2 the right round-2
  lengths, phase 3 the right pick, seed coverage, ``packed`` and the
  per-pair fields of the dict;
- ``ext_bsw_band(phase, ...)``: the BSW round that phase `phase` follows
  (``ops/bsw.py::banded_swa_rows`` on the round's windows, lengths, h0
  and band, ``bsw_inputs``), then ``ext_band`` on its rows: the plain
  version of csrc/extend.cu's bsw_band_kernel, which runs both in one
  launch.

BSW's output enters as its ``[6, P]`` rows (score, qle, tle, gtle,
gscore, max_off). Each length a BSW call takes is checked against its
row count (the check of ``ops/bsw_cuda.py::banded_swa_batch_cuda``): a
length past it ORs 1 into ``flag`` (``Pairs.flag``, [1] int32, updated in
place, the only in-place update of the stage), and the caller raises on
it after its copy to the host (``raise_len_flag``). The plain versions
only flag; the kernels also clamp the length they hand BSW, so that it
never reads past its row.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from .bsw import banded_swa_rows
from .smem import compact_indices
from .window import ref_windows, take_windows

LEN_MESSAGE = "banded_swa_batch_cuda: a length exceeds its row count"


class ExtendOut(dict):
    """``seed_chain_extend``'s dict. ``len_flag`` is the device word that
    the extension sets where a BSW length passed its row count (None on
    the routes that do not check)."""
    len_flag: Optional[torch.Tensor] = None


def raise_len_flag(out) -> None:
    """ValueError with the BSW length check's message where `out`'s
    ``len_flag`` is set (call it after the output's copy to the host:
    it reads the flag there)."""
    flag = getattr(out, "len_flag", None)
    if flag is not None and bool(flag.any()):
        raise ValueError(LEN_MESSAGE)


class Sel(NamedTuple):
    n_cand: torch.Tensor        # [B] int32
    sel: torch.Tensor           # [B, R] int32: slot * S + sidx, 0 past n_cand
    reg_overflow: torch.Tensor  # [B] bool
    rmax0: torch.Tensor         # [B, C] int64, by slot
    rmax1: torch.Tensor         # [B, C] int64


class Pairs(NamedTuple):
    read: torch.Tensor          # [PX] int32 (0 on invalid rows)
    cand: torch.Tensor          # [PX] int32: the read's candidate index
    valid: torch.Tensor         # [PX] bool
    read_pair_of: torch.Tensor  # [B] bool
    pair_overflow: torch.Tensor  # [] bool
    read_overflow: torch.Tensor  # [B] bool
    meta: torch.Tensor          # [B, 2] float32: frac_rep, read_overflow
    flag: torch.Tensor          # [1] int32: the BSW length check


class Stage(NamedTuple):
    qbeg: torch.Tensor          # [PX] int32
    slen: torch.Tensor          # [PX] int32 (the dict's seedlen0)
    rid: torch.Tensor           # [PX] int32
    slot: torch.Tensor          # [PX] int32
    plens: torch.Tensor         # [PX] int32: the read's length (0 invalid)
    lens: torch.Tensor          # [4, PX] int32: ql, tl, qr, tr
    bl: torch.Tensor            # [2, PX] int32: left round 1's lengths
    h0: torch.Tensor            # [PX] int32: left h0 (seed length x a)
    rbeg: torch.Tensor          # [PX] int64
    q_l: torch.Tensor           # [PX, L] int32, reversed
    t_l: torch.Tensor           # [PX, TL] int32, reversed
    q_r: torch.Tensor           # [PX, L] int32
    t_r: torch.Tensor           # [PX, TL] int32


class Left(NamedTuple):
    qb: torch.Tensor            # [PX] int32
    score: torch.Tensor         # [PX] int32: score_l, the right h0
    truesc: torch.Tensor        # [PX] int32
    w: torch.Tensor             # [PX] int32: the band after the left
    bl: torch.Tensor            # [2, PX] int32: right round 1's lengths
    rb: torch.Tensor            # [PX] int64


class Final(NamedTuple):
    qe: torch.Tensor            # [PX] int32
    score: torch.Tensor         # [PX] int32
    truesc: torch.Tensor        # [PX] int32
    re: torch.Tensor            # [PX] int64
    w: torch.Tensor             # [PX] int64
    seedcov: torch.Tensor       # [PX] int64
    packed: torch.Tensor        # [PX, 14] int32


def cal_max_gap(qlen, a, o_del, e_del, o_ins, e_ins, w):
    tdiv = partial(torch.div, rounding_mode="trunc")
    l_del = tdiv(qlen * a - o_del, e_del) + 1
    l_ins = tdiv(qlen * a - o_ins, e_ins) + 1
    return torch.clamp(torch.maximum(l_del, l_ins), min=1, max=w << 1)


def live_seeds(ch, seed_live):
    """[B, C, S] bool by slot: `seed_live` where given (the seed-SW
    filter's), else each chain's first n_seeds slots."""
    if seed_live is not None:
        return seed_live
    S = ch.seed_qbeg.shape[2]
    sidx = torch.arange(S, dtype=torch.int32, device=ch.n_seeds.device)
    return sidx[None, None, :] < ch.n_seeds[:, :, None]


def ext_select(ch, order, kept, seed_live, seed_score, lens, dbns, opt,
               R: int) -> Sel:
    """The (chain, seed) candidates of each read in processing order and
    each chain's rmax (JAX ``align.py:202-329``). `seed_live` None: each
    chain's first n_seeds slots."""
    i32, i64 = torch.int32, torch.int64
    B, C, S = ch.seed_qbeg.shape
    dev = ch.seed_qbeg.device
    seed_live = live_seeds(ch, seed_live)
    sidx = torch.arange(S, dtype=i32, device=dev)[None, None, :]
    # ---- (chain, seed) candidates in processing order: seeds of
    # earlier kept chains first, then best score first (ties: larger
    # seed index) within a chain
    kept_chain = kept > 0                              # [B, C] sorted pos
    o3 = order.long()[:, :, None].expand(B, C, S)
    live_by_pos = seed_live.gather(1, o3)
    score_by_pos = seed_score.gather(1, o3)
    svalid = live_by_pos & kept_chain[:, :, None]
    seed_key = torch.where(svalid, (score_by_pos << 16) | sidx, -1)
    # valid keys are distinct, so a key's descending-sort position is
    # the count of strictly larger keys (invalid ones tie but are masked)
    key_order = torch.argsort(seed_key, dim=2, descending=True)
    seed_rank = torch.empty_like(seed_key).scatter_(
        2, key_order, sidx.expand(B, C, S).contiguous())  # [B, C, S]
    nlive = svalid.sum(2, dtype=i32)
    base = torch.cumsum(nlive, 1, dtype=i32) - nlive
    dense = torch.where(svalid, base[:, :, None] + seed_rank, 1 << 30)
    n_cand = nlive.sum(1, dtype=i32)
    reg_overflow = n_cand > R
    # sel encodes (data slot, seed idx) as slot*S + sidx
    slotflat = (order[:, :, None] * S + sidx).reshape(B, C * S)
    tgt = dense.reshape(B, C * S).clamp(max=R).long()
    sel_ss = torch.zeros((B, R + 1), dtype=i32, device=dev)
    sel_ss.scatter_(1, tgt, slotflat)
    sel_ss = sel_ss[:, :R]

    # ---- per-chain reference span rmax (by slot)
    a_, w_ = opt.a, opt.w
    l_pac = dbns.l_pac
    cs_qbeg = ch.seed_qbeg.to(i64)
    cs_len = ch.seed_len.to(i64)
    cs_rbeg = ch.seed_rbeg.to(i64)
    gap_l = cal_max_gap(cs_qbeg, a_, opt.o_del, opt.e_del, opt.o_ins,
                        opt.e_ins, w_)
    flank_r = lens.to(i64)[:, None, None] - cs_qbeg - cs_len
    gap_r = cal_max_gap(flank_r, a_, opt.o_del, opt.e_del, opt.o_ins,
                        opt.e_ins, w_)
    l_pac2 = 2 * l_pac
    rmax0 = torch.where(seed_live, cs_rbeg - (cs_qbeg + gap_l),
                        l_pac2).min(2).values.clamp(min=0)
    rmax1 = torch.where(seed_live, cs_rbeg + cs_len + flank_r + gap_r,
                        0).max(2).values.clamp(max=l_pac2)
    # first live seed (slot 0 when none is live)
    first_i = torch.argmax(seed_live.to(i32), dim=2, keepdim=True)
    first_rbeg = cs_rbeg.gather(2, first_i)[..., 0]
    bridging = (rmax0 < l_pac) & (l_pac < rmax1)
    rmax1 = torch.where(bridging & (first_rbeg < l_pac), l_pac, rmax1)
    rmax0 = torch.where(bridging & (first_rbeg >= l_pac), l_pac, rmax0)
    # clamp to the contig of the first seed (bns_fetch_seq_v2)
    mid_f, mid_rev = dbns.depos(first_rbeg)
    mrid = dbns.pos2rid(mid_f).clamp(min=0).long()
    n_off = torch.cat([dbns.offsets,
                       torch.tensor([l_pac], dtype=i64, device=dev)])
    far_beg = dbns.offsets[mrid]
    far_end = n_off[mrid + 1]
    rmax0 = torch.maximum(rmax0, torch.where(mid_rev, l_pac2 - far_end,
                                             far_beg))
    rmax1 = torch.minimum(rmax1, torch.where(mid_rev, l_pac2 - far_beg,
                                             far_end))
    return Sel(n_cand, sel_ss.contiguous(), reg_overflow, rmax0, rmax1)


def ext_pairs(sel: Sel, PX: int, smem_cnt, M: int, coord_of, ch_overflow,
              sw_of, frac_rep) -> Pairs:
    """The first PX candidates of the batch in pair space (read-major,
    rank order; JAX ``align.py:331-358``), and each read's overflow flags
    and meta row. smem_cnt [B] is seeding's count against its M slots;
    `sw_of` None: no seed-SW filter ran."""
    i32 = torch.int32
    B, R = sel.sel.shape
    dev = sel.sel.device
    sel_valid = torch.arange(R, device=dev)[None, :] < sel.n_cand[:, None]
    flatv = sel_valid.reshape(B * R)
    pidx, p_valid = compact_indices(flatv, PX)
    pair_overflow = flatv.sum() > PX
    pair_rank = torch.cumsum(flatv.to(i32), 0) - 1
    read_pair_of = (flatv & (pair_rank >= PX)).reshape(B, R).any(1)
    pidx = pidx.long()
    # any capacity that truncated this read's work: the host reruns it
    read_overflow = ((smem_cnt >= M) | coord_of | ch_overflow
                     | sel.reg_overflow | read_pair_of)
    if sw_of is not None:
        read_overflow = read_overflow | sw_of
    meta = torch.stack([frac_rep.to(torch.float32),
                        read_overflow.to(torch.float32)], dim=1)
    return Pairs((pidx // R).to(i32), (pidx % R).to(i32), p_valid,
                 read_pair_of, pair_overflow, read_overflow, meta,
                 torch.zeros((1,), dtype=i32, device=dev))


def _check_lens(flag, q_lens, QL: int, t_lens, TL: int) -> None:
    """OR 1 into flag where a length passes its row count."""
    flag |= ((q_lens > QL) | (t_lens > TL)).any().to(torch.int32)


def ext_stage(pr: Pairs, sel: Sel, ch, codes, lens, ref, l_pac: int,
              TL: int, opt) -> Stage:
    """Each pair's fields, extension lengths and the four windows (JAX
    ``align.py:359-389``): the left query reversed from qbeg - 1, the left
    target reversed from rbeg - 1, the right ones from the seed's end.
    Invalid rows take read 0's candidate column 0, as compact_indices
    points them there."""
    i32, i64 = torch.int32, torch.int64
    B, C, S = ch.seed_qbeg.shape
    L = codes.shape[1]
    p_valid = pr.valid
    p_read = pr.read.long()
    ss = sel.sel[p_read, pr.cand.long()].long()
    p_slot = ss // S
    p_qbeg = ch.seed_qbeg.reshape(B, C * S)[p_read, ss]
    p_rbeg = ch.seed_rbeg.reshape(B, C * S)[p_read, ss].to(i64)
    p_len = ch.seed_len.reshape(B, C * S)[p_read, ss]
    p_rid = ch.rid[p_read, p_slot]
    p_rm0 = sel.rmax0[p_read, p_slot]
    p_rm1 = sel.rmax1[p_read, p_slot]
    p_lens = torch.where(p_valid, lens[p_read], 0)

    # ---- extension pair sequences [PX, ...]
    p_codes = codes[p_read]                            # [PX, L]
    # left: query reversed prefix, target reversed ref[rm0:rbeg]
    ql_len = torch.where(p_valid, p_qbeg, 0)
    q_l = take_windows(p_codes, p_qbeg - 1, L, reverse=True)
    tl_len = torch.where(p_valid, p_rbeg - p_rm0, 0).to(i32)
    t_l = ref_windows(ref, p_rbeg - 1, TL, l_pac, reverse=True)
    # right: query suffix from qe, target ref[rbeg+len : rm1]
    p_qe = p_qbeg + p_len
    qr_len = torch.where(p_valid, p_lens - p_qe, 0)
    q_r = take_windows(p_codes, p_qe, L)
    re0 = p_rbeg + p_len.to(i64)
    tr_len = torch.where(p_valid, p_rm1 - re0, 0).to(i32)
    t_r = ref_windows(ref, re0, TL, l_pac)
    do_left = p_valid & (p_qbeg > 0)
    bl = torch.stack([torch.where(do_left, ql_len, 0),
                      torch.where(do_left, tl_len, 0)])
    _check_lens(pr.flag, bl[0], L, bl[1], TL)
    return Stage(p_qbeg, p_len, p_rid, p_slot.to(i32), p_lens,
                 torch.stack([ql_len, tl_len, qr_len, tr_len]).to(i32), bl,
                 (p_len * opt.a).to(i32), p_rbeg, q_l.to(i32), t_l,
                 q_r.to(i32), t_r)


def _sides(st: Stage, pr: Pairs):
    """(do_left, do_right) of each pair."""
    return (pr.valid & (st.qbeg > 0),
            pr.valid & (st.qbeg + st.slen < st.plens))


def _pick(r1, r2, which2):
    return torch.where(which2[None, :], r2, r1)


def ext_band(phase: int, st: Stage, pr: Pairs, r1, r2, left: Left, ch,
             seed_live, opt):
    """Phase `phase` of the band-doubling retries (JAX
    ``align.py:410-509``) on BSW's [6, PX] rows: r1 the round-1 call's,
    r2 the round-2 call's (phases 1 and 3). Phase 0: the left round-2
    lengths [2, PX]; 1: Left; 2: the right round-2 lengths; 3: Final
    (`left` phase 1's, `ch` and `seed_live` the seed coverage's)."""
    i32, i64 = torch.int32, torch.int64
    w_, a_ = opt.w, opt.a
    accept = (w_ >> 1) + (w_ >> 2)
    L, TL = st.q_l.shape[1], st.t_l.shape[1]
    do_left, do_right = _sides(st, pr)
    ql_len, tl_len, qr_len, tr_len = st.lens
    p_len = st.slen
    if phase == 0:
        need2 = do_left & ~(r1[5] < accept)
        bl = torch.stack([torch.where(need2, ql_len, 0),
                          torch.where(need2, tl_len, 0)])
        _check_lens(pr.flag, bl[0], L, bl[1], TL)
        return bl
    if phase == 1:
        need2 = do_left & ~(r1[5] < accept)
        score, qle, tle, gtle, gscore, _ = _pick(r1, r2, need2)
        wL = torch.where(need2, w_ << 1, w_)
        score_l = torch.where(do_left, score, p_len * a_)
        gs_ok_l = (gscore <= 0) | (gscore <= score_l - opt.pen_clip5)
        qb = torch.where(do_left & gs_ok_l, st.qbeg - qle, 0)
        qb = torch.where(do_left, qb, 0)
        p_rbeg = st.rbeg
        rb = torch.where(do_left,
                         torch.where(gs_ok_l, p_rbeg - tle, p_rbeg - gtle),
                         p_rbeg)
        truesc = torch.where(do_left,
                             torch.where(gs_ok_l, score_l, gscore),
                             p_len * a_)
        a_w = torch.where(do_left, torch.clamp(wL, min=w_), w_)
        bl = torch.stack([torch.where(do_right, qr_len, 0),
                          torch.where(do_right, tr_len, 0)])
        _check_lens(pr.flag, bl[0], L, bl[1], TL)
        return Left(qb, score_l, truesc, a_w.to(i32), bl, rb)
    score_l = left.score
    accR1 = (r1[0] == score_l) | (r1[5] < accept)
    needR2 = do_right & ~accR1
    if phase == 2:
        bl = torch.stack([torch.where(needR2, qr_len, 0),
                          torch.where(needR2, tr_len, 0)])
        _check_lens(pr.flag, bl[0], L, bl[1], TL)
        return bl
    score, qle, tle, gtle, gscore, _ = _pick(r1, r2, needR2)
    wR = torch.where(needR2, w_ << 1, w_)
    p_qe = st.qbeg + p_len
    re0 = st.rbeg + p_len.to(i64)
    p_lens = st.plens
    score_f = torch.where(do_right, score, score_l)
    gs_ok_r = (gscore <= 0) | (gscore <= score_f - opt.pen_clip3)
    qe_f = torch.where(do_right & gs_ok_r, p_qe + qle, p_lens)
    re_f = torch.where(do_right,
                       re0 + torch.where(gs_ok_r, tle, gtle).to(i64), re0)
    truesc = left.truesc + torch.where(
        do_right, torch.where(gs_ok_r, score_f, gscore) - score_l, 0)
    a_w = left.w.to(i64)
    a_w = torch.where(do_right, torch.maximum(a_w, wR), a_w)
    qb, rb = left.qb, left.rb

    # ---- seed coverage over the final region (pair space)
    p_read, p_slot = pr.read.long(), st.slot.long()
    ch_q = ch.seed_qbeg[p_read, p_slot]                # [PX, S]
    ch_r = ch.seed_rbeg[p_read, p_slot].to(i64)
    ch_l = ch.seed_len[p_read, p_slot]
    inside = (live_seeds(ch, seed_live)[p_read, p_slot]
              & (ch_q >= qb[:, None]) & (ch_q + ch_l <= qe_f[:, None])
              & (ch_r >= rb[:, None]) & (ch_r + ch_l <= re_f[:, None]))
    seedcov = torch.where(inside, ch_l, 0).sum(1, dtype=i64)

    # one int32 matrix with every per-pair field the host needs (int64
    # reference positions split into 31-bit halves)
    packed = torch.stack(
        [pr.valid.to(i32), pr.read, qb.to(i32), qe_f.to(i32),
         score_f.to(i32), truesc.to(i32), a_w.to(i32), seedcov.to(i32),
         st.rid, p_len.to(i32),
         (rb & 0x7FFFFFFF).to(i32), (rb >> 31).to(i32),
         (re_f & 0x7FFFFFFF).to(i32), (re_f >> 31).to(i32)], dim=1)
    return Final(qe_f.to(i32), score_f.to(i32), truesc.to(i32), re_f, a_w,
                 seedcov, packed)


def bsw_inputs(phase: int, st: Stage, lens, left: Left, opt):
    """(qs, lens, ts, h0, w) of the BSW round that band phase `phase`
    follows: the left windows and h0 (the seed's score) in phases 0 and 1,
    the right windows and h0 = score_l in phases 2 and 3; the band w in
    the first round of a side, 2 w in its second. `lens` is the round's
    [2, PX] lengths (the stage's bl, then phase 0's, phase 1's bl, then
    phase 2's)."""
    if phase < 2:
        return st.q_l, lens, st.t_l, st.h0, opt.w << phase
    return st.q_r, lens, st.t_r, left.score, opt.w << (phase - 2)


def ext_bsw_band(phase: int, st: Stage, pr: Pairs, lens, r1, left: Left,
                 ch, seed_live, opt, stats: dict = None):
    """(the BSW round's [6, PX] rows, ``ext_band``'s output) of band
    phase `phase`: BSW on ``bsw_inputs``, then the phase on its rows, r1
    the round-1 rows in phases 1 and 3 (None in 0 and 2, whose own round
    is round 1). `stats` collects BSW's counts."""
    q, ln, t, h0, w = bsw_inputs(phase, st, lens, left, opt)
    rows = banded_swa_rows(q, ln, t, h0, w, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, opt.zdrop, opt.mat, stats=stats)
    if phase in (0, 2):
        return rows, ext_band(phase, st, pr, rows, None, left, ch,
                              seed_live, opt)
    return rows, ext_band(phase, st, pr, r1, rows, left, ch, seed_live, opt)
