"""The extension stage's glue through the hand-written kernels of
csrc/extend.cu.

Four wrappers, each with the signature of its plain version in
``ops/extend.py`` (the port's earlier torch glue):

- ``ext_select_cuda`` (plain ``ext_select``): ``ext_select_kernel``, a
  block a read (``select_warps``: 8, 16 or 32 warps, as many as keep the
  batch in one wave): the candidates in processing order, their count,
  ``reg_overflow`` and each chain's rmax;
- ``ext_pairs_cuda`` (``ext_pairs``): ``ext_pairs_kernel``, one block
  looping over the reads in chunks: pair compaction, the overflow flags,
  ``meta``, and the BSW length flag zeroed;
- ``ext_stage_cuda`` (``ext_stage``): ``ext_stage_kernel``, a warp a
  pair: the pair fields, lengths and the four windows;
- ``ext_bsw_band_cuda`` (``ext_bsw_band``): ``bsw_band_kernel``, a warp a
  pair: one BSW round (csrc/bsw_warp.cuh, the body of csrc/bsw.cu's
  kernel, at the same K columns a lane or tiled) and, in the same warp
  after the pair's results are stored, the band-doubling phase that
  follows it: the picks, the next round's lengths, and in phase 3 the
  seed coverage and ``packed``.

On CUDA tensors each launches its kernel once or raises; on CPU tensors
each runs its plain version. There is no fallback from a kernel to its
plain version. Each kernel reads both position layouts (the chains' rbeg
int32 or int64). Each wrapper keeps a ``launches`` count (``ext_bsw_band``
over its four phases) and a ``launches64`` count (the int64 layout);
``ext_bsw_band_cuda`` also adds each launch to BSW's count
(``bsw_cuda.banded_swa_batch_cuda.launches``, every launch of BSW's warp
body). The wrappers allocate every output with ``torch.empty`` (each
kernel writes every element) and launch on the current stream with no
host synchronisation: a call of ``seed_chain_extend`` on CUDA tensors is
then seven launches with no tensor operation between them but the
outputs' allocations. The source is compiled with nvcc into
``build/torch_kernels/libextend_cuda.so`` at first use
(``ops/nvcc_build.py``) and bound with ctypes; every pointer and integer
of a launch goes in one int64 array (the order csrc/extend.cu reads).

``ext_select_twin``, ``ext_pairs_twin``, ``ext_stage_twin``,
``ext_band_twin`` (the band epilogue) and ``ext_bsw_band_twin`` are the
kernels' loops in plain Python on numpy arrays (block, warp or lane;
chain by chain; rank by counting), tests of the kernels' control flow on
the CPU at small sizes. Like the kernels (and unlike the plain versions)
they clamp a BSW length that passes its row.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bsw_cuda, nvcc_build
from .bsw import banded_swa_rows, scoring
from .extend import (Final, Left, Pairs, Sel, Stage, bsw_inputs,
                     ext_bsw_band, ext_pairs, ext_select, ext_stage)

_ARR = ctypes.POINTER(ctypes.c_longlong)
_ci = ctypes.c_int
LIB = nvcc_build.Library("extend.cu", "extend_cuda", {
    "ext_select_launch": [_ARR, _ci],
    "ext_pairs_launch": [_ARR],
    "ext_stage_launch": [_ARR, _ci],
    "ext_bsw_band_launch": [_ARR]})
build = LIB.build            # compile csrc/extend.cu; returns the path

SELECT_ITEMS = 2             # ext_select_kernel: (slot, chunk) loads a round
SELECT_KEYS = 8192           # C x S keys it stages in shared memory
PAIR_THREADS = 1024          # ext_pairs_kernel's one block: a chunk
STAGE_ROWS = 12              # the stage's int32 rows (csrc/extend.cu)
LEFT_ROWS = 6                # phase 1's int32 rows


def _args(*vals) -> ctypes.Array:
    """The launch's int64 array: tensors as their data pointers, None as
    a null pointer, bools and ints as they are."""
    out = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            v = v.data_ptr()
        out.append(0 if v is None else int(v))
    return (ctypes.c_longlong * len(out))(*out)


def _chain_args(ch, seed_live) -> list:
    _, C, S = ch.seed_qbeg.shape
    return [ch.seed_qbeg, ch.seed_len, ch.seed_rbeg, ch.n_seeds, ch.rid,
            seed_live, C, S]


def _opt_args(opt, l_pac: int) -> list:
    return [opt.a, opt.w, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.pen_clip5, opt.pen_clip3, l_pac]


def _pos64(ch) -> int:
    pd = ch.seed_rbeg.dtype
    if pd not in (torch.int32, torch.int64):
        raise ValueError(f"extension: chains' rbeg of {pd}, not int32 or "
                         f"int64")
    return int(pd == torch.int64)


def _check(what: str, dev, *named):
    """ValueError unless each (name, tensor, dtype) lies contiguous on
    `dev` at its dtype (a None tensor passes)."""
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, t, dt in named:
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _chain_check(what, dev, ch, seed_live):
    _check(what, dev, ("seed_qbeg", ch.seed_qbeg, torch.int32),
           ("seed_len", ch.seed_len, torch.int32),
           ("seed_rbeg", ch.seed_rbeg, ch.seed_rbeg.dtype),
           ("n_seeds", ch.n_seeds, torch.int32), ("rid", ch.rid, torch.int32),
           ("seed_live", seed_live, torch.bool))


def _rows_ptr(what: str, dev, rows) -> int:
    """The base pointer of the contiguous int32 [k, PX] matrix on `dev`
    whose consecutive rows are `rows` (each [PX], or [j, PX] for j rows),
    as the kernels allocate them; else ValueError."""
    n = rows[0].shape[-1]
    base, at = rows[0].data_ptr(), 0
    for r in rows:
        if (r.dtype != torch.int32 or r.device != dev
                or not r.is_contiguous()
                or r.data_ptr() != base + at * n * r.element_size()):
            raise ValueError(f"ext_bsw_band_cuda: {what} must be consecutive "
                             f"int32 rows of one buffer, as the kernels "
                             f"write them")
        at += r.shape[0] if r.dim() == 2 else 1
    return base


def _stage_rows(st: Stage, dev) -> int:
    return _rows_ptr("the Stage rows", dev, [
        st.qbeg, st.slen, st.rid, st.slot, st.plens, st.lens, st.bl, st.h0])


def _left_rows(left: Left, dev) -> int:
    return _rows_ptr("the Left rows", dev, [left.qb, left.score,
                                            left.truesc, left.w, left.bl])


def select_warps(B: int, n_sm: int) -> int:
    """ext_select_kernel's warps a read: the most of 32, 16 and 8 that
    keep B blocks in one wave of `n_sm` SMs (a block an SM at 32 warps, 2
    at 16, 4 at 8: 64 registers a thread), else 8."""
    for warps, per_sm in ((32, 1), (16, 2), (8, 4)):
        if B <= per_sm * n_sm:
            return warps
    return 8


def ext_select_cuda(ch, order, kept, seed_live, seed_score, lens, dbns, opt,
                    R: int) -> Sel:
    """``ext_select``'s Sel: on CUDA tensors one launch of
    ext_select_kernel (``select_warps`` warps a read), or ValueError."""
    dev = ch.seed_qbeg.device
    if dev.type == "cpu":
        return ext_select(ch, order, kept, seed_live, seed_score, lens, dbns,
                          opt, R)
    _chain_check("ext_select_cuda", dev, ch, seed_live)
    _check("ext_select_cuda", dev, ("order", order, torch.int32),
           ("kept", kept, torch.int32), ("seed_score", seed_score,
                                         torch.int32),
           ("lens", lens, torch.int32), ("offsets", dbns.offsets,
                                         torch.int64))
    B, C, S = ch.seed_qbeg.shape
    pos64 = _pos64(ch)
    warps = select_warps(
        B, torch.cuda.get_device_properties(dev).multi_processor_count)
    n_cand = torch.empty((B,), dtype=torch.int32, device=dev)
    sel = torch.empty((B, R), dtype=torch.int32, device=dev)
    reg_of = torch.empty((B,), dtype=torch.bool, device=dev)
    rmax = torch.empty((2, B, C), dtype=torch.int64, device=dev)
    rmax0, rmax1 = rmax.unbind(0)
    LIB.launch(dev, "ext_select_launch", _args(
        *_chain_args(ch, seed_live), *_opt_args(opt, dbns.l_pac), B, order,
        kept, seed_score, lens, dbns.offsets, dbns.offsets.numel(), R,
        n_cand, sel, reg_of, rmax0, rmax1, warps), pos64)
    ext_select_cuda.launches += 1
    ext_select_cuda.launches64 += pos64
    return Sel(n_cand, sel, reg_of, rmax0, rmax1)


ext_select_cuda.launches = 0
ext_select_cuda.launches64 = 0


def ext_pairs_cuda(sel: Sel, PX: int, smem_cnt, M: int, coord_of,
                   ch_overflow, sw_of, frac_rep) -> Pairs:
    """``ext_pairs``'s Pairs: on CUDA tensors one launch of
    ext_pairs_kernel (one block), or ValueError."""
    dev = sel.n_cand.device
    if dev.type == "cpu":
        return ext_pairs(sel, PX, smem_cnt, M, coord_of, ch_overflow, sw_of,
                         frac_rep)
    b = torch.bool
    _check("ext_pairs_cuda", dev, ("n_cand", sel.n_cand, torch.int32),
           ("reg_overflow", sel.reg_overflow, b),
           ("smem_cnt", smem_cnt, torch.int32), ("coord_of", coord_of, b),
           ("ch_overflow", ch_overflow, b), ("sw_of", sw_of, b),
           ("frac_rep", frac_rep, torch.float32))
    B, R = sel.sel.shape
    ints = torch.empty((2 * PX + 1,), dtype=torch.int32, device=dev)
    p_read, p_cand, flag = ints.split([PX, PX, 1])
    flags = torch.empty((PX + 2 * B + 1,), dtype=b, device=dev)
    p_valid, read_pair_of, read_of, pair_of = flags.split([PX, B, B, 1])
    pair_of = pair_of.view(())
    meta = torch.empty((B, 2), dtype=torch.float32, device=dev)
    LIB.launch(dev, "ext_pairs_launch", _args(
        sel.n_cand, sel.reg_overflow, smem_cnt, M, coord_of, ch_overflow,
        sw_of, frac_rep, B, R, PX, p_read, p_cand, p_valid, read_pair_of,
        pair_of, read_of, meta, flag))
    ext_pairs_cuda.launches += 1
    return Pairs(p_read, p_cand, p_valid, read_pair_of, pair_of, read_of,
                 meta, flag)


ext_pairs_cuda.launches = 0


def ext_stage_cuda(pr: Pairs, sel: Sel, ch, codes, lens, ref, l_pac: int,
                   TL: int, opt) -> Stage:
    """``ext_stage``'s Stage: on CUDA tensors one launch of
    ext_stage_kernel (a warp a pair), or ValueError. ORs the left round-1
    length check into pr.flag."""
    dev = pr.read.device
    if dev.type == "cpu":
        return ext_stage(pr, sel, ch, codes, lens, ref, l_pac, TL, opt)
    i32 = torch.int32
    _chain_check("ext_stage_cuda", dev, ch, None)
    _check("ext_stage_cuda", dev, ("read", pr.read, i32),
           ("cand", pr.cand, i32), ("valid", pr.valid, torch.bool),
           ("flag", pr.flag, i32), ("sel", sel.sel, i32),
           ("rmax0", sel.rmax0, torch.int64), ("rmax1", sel.rmax1,
                                               torch.int64),
           ("codes", codes, i32), ("lens", lens, i32),
           ("ref", ref, torch.uint8))
    PX = pr.read.shape[0]
    B, L = codes.shape
    R = sel.sel.shape[1]
    pos64 = _pos64(ch)
    rows = torch.empty((STAGE_ROWS, PX), dtype=i32, device=dev)
    rbeg = torch.empty((PX,), dtype=torch.int64, device=dev)
    q = torch.empty((2, PX, L), dtype=i32, device=dev)
    t = torch.empty((2, PX, TL), dtype=i32, device=dev)
    q_l, q_r = q.unbind(0)
    t_l, t_r = t.unbind(0)
    LIB.launch(dev, "ext_stage_launch", _args(
        *_chain_args(ch, None), *_opt_args(opt, l_pac), pr.read, pr.cand,
        pr.valid, sel.sel, sel.rmax0, sel.rmax1, codes, lens, ref, R, L, TL,
        PX, rows, rbeg, q_l, t_l, q_r, t_r, pr.flag), pos64)
    ext_stage_cuda.launches += 1
    ext_stage_cuda.launches64 += pos64
    r = rows.unbind(0)
    return Stage(*r[:5], rows[5:9], rows[9:11], r[11], rbeg, q_l, t_l, q_r,
                 t_r)


ext_stage_cuda.launches = 0
ext_stage_cuda.launches64 = 0


def ext_bsw_band_cuda(phase: int, st: Stage, pr: Pairs, lens, r1,
                      left: Left, ch, seed_live, opt, stats: dict = None):
    """``ext_bsw_band``'s (BSW's [6, PX] rows, the phase's output): on
    CUDA tensors one launch of bsw_band_kernel (a warp a pair: the BSW
    round on ``bsw_inputs`` at BSW's K columns a lane, tiled past
    ``bsw_cuda.MAX_QL``, then band phase `phase`; r1 the round-1 rows in
    phases 1 and 3), or ValueError. Phases 0-2 OR their length check into
    pr.flag. `stats` is filled on CPU tensors only (BSW's counts)."""
    dev = pr.read.device
    if dev.type == "cpu":
        return ext_bsw_band(phase, st, pr, lens, r1, left, ch, seed_live,
                            opt, stats=stats)
    if phase not in (0, 1, 2, 3):
        raise ValueError(f"ext_bsw_band_cuda: phase {phase}")
    i32 = torch.int32
    q, lens, t, h0, w = bsw_inputs(phase, st, lens, left, opt)
    _chain_check("ext_bsw_band_cuda", dev, ch, seed_live)
    _check("ext_bsw_band_cuda", dev, ("r1", r1, i32),
           ("rbeg", st.rbeg, torch.int64), ("valid", pr.valid, torch.bool),
           ("read", pr.read, i32), ("flag", pr.flag, i32), ("qs", q, i32),
           ("ts", t, i32), ("lens", lens, i32), ("h0", h0, i32))
    PX = pr.read.shape[0]
    L, TL = q.shape[1], t.shape[1]
    if lens.shape != (2, PX) or (phase in (1, 3)) != (r1 is not None):
        raise ValueError("ext_bsw_band_cuda: the lengths are not [2, PX], "
                         "or r1 is not given exactly in phases 1 and 3")
    pos64 = _pos64(ch)
    st_ptr = _stage_rows(st, dev)
    lf_ptr = rb_in = None
    if phase >= 2:
        lf_ptr = _left_rows(left, dev)
        rb_in = left.rb
    k = bsw_cuda.lane_columns(L)
    sc = scoring(opt.mat)
    rows = torch.empty((6, PX), dtype=i32, device=dev)
    scratch = None
    if k == bsw_cuda.TILED:
        scratch = torch.empty((PX, 2, -(-(L + 1) // bsw_cuda.TILE)
                               * bsw_cuda.TILE), dtype=i32, device=dev)
    bl = lf = rb = fi = fl = packed = None
    if phase in (0, 2):
        bl = torch.empty((2, PX), dtype=i32, device=dev)
    elif phase == 1:
        lf = torch.empty((LEFT_ROWS, PX), dtype=i32, device=dev)
        rb = torch.empty((PX,), dtype=torch.int64, device=dev)
    else:
        fi = torch.empty((3, PX), dtype=i32, device=dev)
        fl = torch.empty((3, PX), dtype=torch.int64, device=dev)
        packed = torch.empty((PX, 14), dtype=i32, device=dev)
    LIB.launch(dev, "ext_bsw_band_launch", _args(
        *_chain_args(ch, seed_live), *_opt_args(opt, 0), phase, pos64,
        st_ptr, st.rbeg, pr.valid, pr.read, r1, lf_ptr, rb_in, L, TL, PX,
        bl, lf, rb, fi, fl, packed, pr.flag, q, t, lens, h0, rows, k, w,
        opt.zdrop, sc["sc_match"], sc["sc_mis"], sc["sc_n"], sc["mx"], 0,
        scratch))
    ext_bsw_band_cuda.launches += 1
    ext_bsw_band_cuda.launches64 += pos64
    bsw_cuda.banded_swa_batch_cuda.launches += 1
    if phase in (0, 2):
        return rows, bl
    if phase == 1:
        m = lf.unbind(0)
        return rows, Left(*m[:4], lf[4:6], rb)
    qe, score, truesc = fi.unbind(0)
    re, w_, seedcov = fl.unbind(0)
    return rows, Final(qe, score, truesc, re, w_, seedcov, packed)


ext_bsw_band_cuda.launches = 0
ext_bsw_band_cuda.launches64 = 0


WRAPPERS = (ext_select_cuda, ext_pairs_cuda, ext_stage_cuda,
            ext_bsw_band_cuda)


# ---- the kernels' loops on the CPU ------------------------------------------

def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _live(n_seeds, live, cs_b, cs_c, s) -> bool:
    return bool(live[cs_b, cs_c, s]) if live is not None \
        else s < int(n_seeds[cs_b, cs_c])


def _i32(v: int) -> int:
    """v wrapped to a signed 32-bit value (the kernels' int)."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _tdiv(x, y):
    """C's truncating division on int64 arrays."""
    q = np.abs(x) // np.abs(y)
    return np.where((x >= 0) == (y > 0), q, -q)


def _max_gaps(q, opt):
    """_cal_max_gap on an int64 array (C's truncating division)."""
    l_del = _tdiv(q * opt.a - opt.o_del, opt.e_del) + 1
    l_ins = _tdiv(q * opt.a - opt.o_ins, opt.e_ins) + 1
    return np.minimum(np.maximum(np.maximum(l_del, l_ins), 1), opt.w << 1)


def contig_search(offsets, pf: int):
    """The warp's 32-way search of ext_select_kernel for the first offset
    above pf: lane l probes ub + (l + 1) st - 1, st from the first power of
    32 whose 32 strides cover the offsets down to 1. Returns (ub, the
    largest probe at or below pf, the least above it, rounds); the probes
    are offsets[ub - 1] and offsets[ub] where those exist."""
    n = len(offsets)
    top = 1
    while top * 32 < n:
        top *= 32
    ub, below, above, rounds, st = 0, None, None, 0, top
    lanes = np.arange(32, dtype=np.int64)
    while st > 0:
        idx = ub + (lanes + 1) * st - 1
        ok = idx < n
        v = np.where(ok, offsets[np.minimum(idx, n - 1)], 0)
        le = ok & (v <= pf)
        k = int(le.sum())
        assert le[:k].all(), "the probes at or below pf are not a prefix"
        if k:
            below = int(v[k - 1])
        if k < 32 and ok[k]:
            above = int(v[k])
        ub += k * st
        st //= 32
        rounds += 1
    return ub, below, above, rounds


def ext_select_twin(ch, order, kept, seed_live, seed_score, lens, dbns, opt,
                    R: int, warps: int = 8) -> Sel:
    """ext_select_kernel's loops, a block of `warps` warps a read. Phase
    A: each warp's slots w, w + warps, ..., 32 at a time: their seed
    counts, a chain with no seed written at once (where the offsets lie
    in [0, 2 l_pac]); the others as items (slot, chunk of 32 seeds, up to
    the chain's last seed), SELECT_ITEMS items a load round, every load
    of a round before any is used; a chain reduced at its last chunk (one
    with no live seed written at once), the first live seed's rbeg from
    the lane that loaded it (lane 0's seed 0 where none is live), the
    contig by the 32-way search (``contig_search``, held to numpy's
    searchsorted), its offsets from the probes. Phase B: each thread's
    run of positions, scanned. Phase C: each kept chain with a live seed,
    its keys (staged where C x S <= SELECT_KEYS, up to its n_seeds
    without a seed-SW mask; else the chain's own), each live seed ranked
    by counting. Phase D: the tail. ``ext_select_twin.last_rounds`` keeps
    each chain's search rounds [B, C] (0: none)."""
    qb, ln, rbg = _np(ch.seed_qbeg), _np(ch.seed_len), _np(ch.seed_rbeg)
    ns, live = _np(ch.n_seeds), _np(seed_live)
    order, kept, score = _np(order), _np(kept), _np(seed_score)
    lens, offsets = _np(lens), _np(dbns.offsets).astype(np.int64)
    B, C, S = qb.shape
    l_pac = dbns.l_pac
    l_pac2 = 2 * l_pac
    n_seqs = len(offsets)
    off0 = int(offsets[0])
    off1 = int(offsets[1]) if n_seqs > 1 else l_pac
    dead_known = off0 >= 0 and int(offsets[-1]) <= l_pac2 and l_pac >= 0
    nt = 32 * warps
    staged = C * S <= SELECT_KEYS
    n_cand = np.zeros(B, np.int32)
    sel = np.full((B, R), -7, np.int32)         # every slot must be written
    reg_of = np.zeros(B, bool)
    rmax0 = np.zeros((B, C), np.int64)
    rmax1 = np.zeros((B, C), np.int64)
    rounds = np.zeros((B, C), np.int32)
    nch = -(-S // 32)
    slots = -(-C // warps)
    lanes = np.arange(32)
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min

    def walk(n):                                # chunks a chain walks
        return nch if live is not None else \
            -(-min(n, S) // 32) if n > 0 else 1
    for b in range(B):
        live_of = np.full(C, -1, np.int64)
        keys = np.full((C, S), -7, np.int64)
        rlen = int(lens[b])
        for w in range(warps):                  # A
            for win in range(0, slots, 32):
                todo = []
                for j in range(32):
                    c = w + (win + j) * warps
                    if win + j >= slots or c >= C:
                        continue
                    n = 0 if live is not None else int(ns[b, c])
                    if live is not None or n > 0 or not dead_known:
                        todo.append(c)
                    else:
                        rmax0[b, c], rmax1[b, c], live_of[c] = l_pac2, 0, 0
                items = [(c, k) for c in todo
                         for k in range(walk(int(ns[b, c])))]
                for i0 in range(0, len(items), SELECT_ITEMS):
                    loaded = []                 # the round's loads
                    for c, k in items[i0:i0 + SELECT_ITEMS]:
                        n = int(ns[b, c])
                        s = k * 32 + lanes
                        si = np.minimum(s, S - 1)
                        inn = (s < S) & ((live is not None) | (s < n))
                        lv = inn & (live[b, c, si] if live is not None
                                    else True)
                        loaded.append((c, k, n, s, si, lv,
                                       qb[b, c, si].astype(np.int64),
                                       ln[b, c, si].astype(np.int64),
                                       rbg[b, c, si].astype(np.int64),
                                       score[b, c, si].astype(np.int64)))
                    for c, k, n, s, si, lv, q, l, r, sc in loaded:
                        if k == 0:
                            v0 = np.full(32, big, np.int64)
                            v1 = np.full(32, small, np.int64)
                            nl = np.zeros(32, np.int64)
                            fm = np.full(32, S, np.int64)
                            frb = np.zeros(32, np.int64)
                        inn = s < S
                        flank = rlen - q - l
                        a0 = np.where(lv, r - (q + _max_gaps(q, opt)),
                                      l_pac2)
                        a1 = np.where(lv, r + l + flank
                                      + _max_gaps(flank, opt), 0)
                        v0 = np.where(inn, np.minimum(v0, a0), v0)
                        v1 = np.where(inn, np.maximum(v1, a1), v1)
                        nl += lv
                        take = inn & (fm == S)
                        frb = np.where(take & (lv | (s == 0)), r, frb)
                        fm = np.where(take & lv, s, fm)
                        if staged:
                            key = (sc << 16) | s
                            key = (key + (1 << 31)) % (1 << 32) - (1 << 31)
                            keys[c, si[inn]] = np.where(lv, key, -1)[inn]
                        if k < walk(n) - 1:
                            continue
                        if live is None and n < S:   # the seeds not walked
                            v0 = np.minimum(v0, l_pac2)
                            v1 = np.maximum(v1, 0)
                        if int(nl.sum()) == 0 and dead_known:
                            rmax0[b, c], rmax1[b, c], live_of[c] = \
                                l_pac2, 0, 0
                            continue
                        first = int(fm.min())
                        fr = int(frb[0 if first == S else first & 31])
                        m0, m1 = max(int(v0.min()), 0), min(int(v1.max()),
                                                            l_pac2)
                        rev = fr >= l_pac
                        pf = l_pac2 - 1 - fr if rev else fr
                        ub, below, above, rounds[b, c] = contig_search(
                            offsets, pf)
                        assert ub == int(np.searchsorted(offsets, pf,
                                                         side="right"))
                        bridging = m0 < l_pac < m1
                        if bridging and not rev:
                            m1 = l_pac
                        if bridging and rev:
                            m0 = l_pac
                        if pf >= l_pac or ub <= 1:
                            fb, fe = off0, off1
                        else:
                            fb = below
                            fe = above if ub < n_seqs else l_pac
                        rmax0[b, c] = max(m0, l_pac2 - fe if rev else fb)
                        rmax1[b, c] = min(m1, l_pac2 - fb if rev else fe)
                        live_of[c] = int(nl.sum())
        assert (live_of >= 0).all(), "a chain slot left without its row"
        ordp = np.where(kept[b] > 0, order[b], -1)
        per_pos = np.where(ordp >= 0, live_of[np.maximum(ordp, 0)], 0)
        run = -(-C // nt)                       # B: a thread's positions
        sums = [int(per_pos[t * run:(t + 1) * run].sum()) for t in range(nt)]
        base = np.zeros(C, np.int64)
        at = 0
        for t in range(nt):                     # the block's scan
            for p in range(t * run, min((t + 1) * run, C)):
                base[p] = at
                at += int(per_pos[p])
            assert at == sum(sums[:t + 1])
        total = at
        n_cand[b] = total
        reg_of[b] = total > R
        for p in range(C):                      # C: a warp a kept chain
            slot = int(ordp[p])
            if slot < 0 or base[p] >= R or live_of[slot] == 0:
                continue
            lim = S
            if staged:
                if live is None:
                    lim = min(int(ns[b, slot]), S)
                kk = keys[slot, :lim]
                assert (kk != -7).all(), "a key left unstaged"
            else:
                kk = np.array([_i32((int(score[b, slot, s]) << 16) | s)
                               if _live(ns, live, b, slot, s) else -1
                               for s in range(S)])
            for s in range(lim):
                if kk[s] == -1:
                    continue
                rank = int((kk > kk[s]).sum()) + (S - lim
                                                  if kk[s] < -1 else 0)
                if base[p] + rank < R:
                    assert sel[b, base[p] + rank] == -7, "written twice"
                    sel[b, base[p] + rank] = slot * S + s
        sel[b, min(total, R):] = 0              # D
    assert (sel != -7).all(), "a candidate slot left unwritten"
    ext_select_twin.last_rounds = rounds
    dev = ch.seed_qbeg.device
    t = lambda a: torch.as_tensor(a, device=dev)
    return Sel(t(n_cand), t(sel), t(reg_of), t(rmax0), t(rmax1))


def ext_pairs_twin(sel: Sel, PX: int, smem_cnt, M: int, coord_of,
                   ch_overflow, sw_of, frac_rep,
                   threads: int = PAIR_THREADS) -> Pairs:
    """ext_pairs_kernel's loop: one block of `threads` over the reads in
    chunks, a thread a read, the chunk scanned and carried, the chunk's
    pairs written by a binary search over its scanned counts."""
    n_cand, reg_of = _np(sel.n_cand), _np(sel.reg_overflow)
    smem_cnt, coord_of, ch_of = _np(smem_cnt), _np(coord_of), _np(ch_overflow)
    sw_of, frac_rep = _np(sw_of), _np(frac_rep)
    B, R = sel.sel.shape
    p_read = np.full(PX, -7, np.int32)
    p_cand = np.full(PX, -7, np.int32)
    p_valid = np.zeros(PX, bool)
    read_pair_of = np.zeros(B, bool)
    read_of = np.zeros(B, bool)
    meta = np.zeros((B, 2), np.float32)
    carry = 0
    for base in range(0, B, threads):
        n = min(B - base, threads)
        k = [min(max(int(n_cand[base + i]), 0), R) for i in range(n)]
        incl = [int(x) for x in np.cumsum(k)]
        chunk = incl[-1]
        for i in range(n):
            b = base + i
            rpo = k[i] > 0 and carry + incl[i] > PX
            ro = bool(smem_cnt[b] >= M or coord_of[b] or ch_of[b]
                      or reg_of[b] or rpo
                      or (sw_of is not None and sw_of[b]))
            read_pair_of[b], read_of[b] = rpo, ro
            meta[b] = (frac_rep[b], 1.0 if ro else 0.0)
        for t in range(carry, min(carry + chunk, PX)):
            local = t - carry
            lo, hi = 0, n - 1
            while lo < hi:
                mid = (lo + hi) >> 1
                if incl[mid] > local:
                    hi = mid
                else:
                    lo = mid + 1
            assert p_read[t] == -7, "pair written twice"
            p_read[t] = base + lo
            p_cand[t] = local - (incl[lo - 1] if lo else 0)
            p_valid[t] = True
        carry += chunk
    p_read[min(carry, PX):] = 0
    p_cand[min(carry, PX):] = 0
    dev = sel.n_cand.device
    t = lambda a: torch.as_tensor(a, device=dev)
    return Pairs(t(p_read), t(p_cand), t(p_valid), t(read_pair_of),
                 t(np.bool_(carry > PX)), t(read_of), t(meta),
                 torch.zeros((1,), dtype=torch.int32, device=dev))


def _clamped(v: int, rows: int, over: list) -> int:
    if v > rows:
        over[0] = True
        return rows
    return v


def ext_stage_twin(pr: Pairs, sel: Sel, ch, codes, lens, ref, l_pac: int,
                   TL: int, opt) -> Stage:
    """ext_stage_kernel's loop: a warp a pair, the scalars of the pair,
    the windows lane-strided with clamped indices; the left round-1
    lengths clamped and flagged past their rows (the flag ORed into
    pr.flag)."""
    p_read, p_cand, p_valid = _np(pr.read), _np(pr.cand), _np(pr.valid)
    selm, rm0, rm1 = _np(sel.sel), _np(sel.rmax0), _np(sel.rmax1)
    qb, ln, rbg, rid = (_np(ch.seed_qbeg), _np(ch.seed_len),
                        _np(ch.seed_rbeg), _np(ch.rid))
    codes, lens, ref = _np(codes), _np(lens), _np(ref)
    B, C, S = qb.shape
    L = codes.shape[1]
    PX = len(p_read)
    rows = np.zeros((STAGE_ROWS, PX), np.int32)
    rbeg_o = np.zeros(PX, np.int64)
    q_l = np.zeros((PX, L), np.int32)
    q_r = np.zeros((PX, L), np.int32)
    t_l = np.zeros((PX, TL), np.int32)
    t_r = np.zeros((PX, TL), np.int32)
    over = [False]
    top = 2 * l_pac - 1
    for p in range(PX):
        b, valid = int(p_read[p]), bool(p_valid[p])
        ss = int(selm[b, p_cand[p]])
        slot = ss // S
        q, sl = int(qb[b, slot, ss % S]), int(ln[b, slot, ss % S])
        rb = int(rbg[b, slot, ss % S])
        plens = int(lens[b]) if valid else 0
        qe, re0 = q + sl, rb + sl
        ql = q if valid else 0
        tl = _i32(rb - int(rm0[b, slot])) if valid else 0
        qr = plens - qe if valid else 0
        tr = _i32(int(rm1[b, slot]) - re0) if valid else 0
        do_left = valid and q > 0
        blq = _clamped(ql if do_left else 0, L, over)
        blt = _clamped(tl if do_left else 0, TL, over)
        rows[:, p] = (q, sl, rid[b, slot], slot, plens, ql, tl, qr, tr, blq,
                      blt, _i32(sl * opt.a))
        rbeg_o[p] = rb
        for j in range(L):
            q_l[p, j] = codes[b, min(max(q - 1 - j, 0), L - 1)]
            q_r[p, j] = codes[b, min(max(qe + j, 0), L - 1)]
        for j in range(TL):
            t_l[p, j] = ref[min(max(rb - 1 - j, 0), top)]
            t_r[p, j] = ref[min(max(re0 + j, 0), top)]
    if over[0]:
        pr.flag.bitwise_or_(1)
    dev = pr.read.device
    t = lambda a: torch.as_tensor(a, device=dev)
    r = t(rows)
    return Stage(*r[:5], r[5:9], r[9:11], r[11], t(rbeg_o), t(q_l), t(t_l),
                 t(q_r), t(t_r))


def ext_band_twin(phase: int, st: Stage, pr: Pairs, r1, r2, left: Left, ch,
                  seed_live, opt):
    """bsw_band_kernel's epilogue (band phase `phase`), warp p on pair p
    after its BSW round: the round's own results (r1 in phases 0 and 2,
    r2 in 1 and 3: the warp's registers), the picks, the lengths clamped
    and flagged past their rows, and in phase 3 the seed coverage over the
    lanes (lane l the seeds l, l + 32, ...), a warp sum."""
    p_valid, p_read = _np(pr.valid), _np(pr.read)
    qbeg, slen, plens = _np(st.qbeg), _np(st.slen), _np(st.plens)
    ql, tl, qr, tr = _np(st.lens)
    rbeg, slot, rid = _np(st.rbeg), _np(st.slot), _np(st.rid)
    r1 = _np(r1)
    r2 = _np(r2)
    L, TL = st.q_l.shape[1], st.t_l.shape[1]
    PX = len(p_valid)
    w, a = opt.w, opt.a
    accept = (w >> 1) + (w >> 2)
    over = [False]
    bl = np.zeros((2, PX), np.int32)
    lf = np.zeros((LEFT_ROWS, PX), np.int32)
    rb_o = np.zeros(PX, np.int64)
    fi = np.zeros((3, PX), np.int32)
    fl = np.zeros((3, PX), np.int64)
    packed = np.zeros((PX, 14), np.int32)
    if phase >= 2:
        lqb, lsc, ltr, lw = (_np(left.qb), _np(left.score), _np(left.truesc),
                             _np(left.w))
        lrb = _np(left.rb)
        cq, cl, cr = _np(ch.seed_qbeg), _np(ch.seed_len), _np(ch.seed_rbeg)
        ns, live = _np(ch.n_seeds), _np(seed_live)
    for p in range(PX):
        valid = bool(p_valid[p])
        q, sl = int(qbeg[p]), int(slen[p])
        do_left = valid and q > 0
        do_right = valid and q + sl < int(plens[p])
        if phase < 2:
            need2 = do_left and not int(r1[5, p]) < accept
            if phase == 0:
                bl[:, p] = (_clamped(int(ql[p]) if need2 else 0, L, over),
                            _clamped(int(tl[p]) if need2 else 0, TL, over))
                continue
            r = r2 if need2 else r1
            score_l = int(r[0, p]) if do_left else _i32(sl * a)
            gscore = int(r[4, p])
            ok = gscore <= 0 or gscore <= score_l - opt.pen_clip5
            lf[:, p] = (
                q - int(r[1, p]) if do_left and ok else 0, score_l,
                (score_l if ok else gscore) if do_left else _i32(sl * a),
                max(w << 1 if need2 else w, w) if do_left else w,
                _clamped(int(qr[p]) if do_right else 0, L, over),
                _clamped(int(tr[p]) if do_right else 0, TL, over))
            rb0 = int(rbeg[p])
            rb_o[p] = ((rb0 - int(r[2, p]) if ok else rb0 - int(r[3, p]))
                       if do_left else rb0)
            continue
        score_l = int(lsc[p])
        need2 = do_right and not (int(r1[0, p]) == score_l
                                  or int(r1[5, p]) < accept)
        if phase == 2:
            bl[:, p] = (_clamped(int(qr[p]) if need2 else 0, L, over),
                        _clamped(int(tr[p]) if need2 else 0, TL, over))
            continue
        r = r2 if need2 else r1
        wr = w << 1 if need2 else w
        qe, re0 = q + sl, int(rbeg[p]) + sl
        score_f = int(r[0, p]) if do_right else score_l
        gscore = int(r[4, p])
        ok = gscore <= 0 or gscore <= score_f - opt.pen_clip3
        qe_f = qe + int(r[1, p]) if do_right and ok else int(plens[p])
        re_f = (re0 + (int(r[2, p]) if ok else int(r[3, p]))
                if do_right else re0)
        truesc = int(ltr[p]) + (((score_f if ok else gscore) - score_l)
                                if do_right else 0)
        a_w = max(int(lw[p]), wr) if do_right else int(lw[p])
        qb, rb = int(lqb[p]), int(lrb[p])
        b, c = int(p_read[p]), int(slot[p])
        lanes = [0] * 32
        for s in range(cq.shape[2]):            # lane s % 32's seeds
            if not _live(ns, live, b, c, s):
                continue
            sq, sln, sr = int(cq[b, c, s]), int(cl[b, c, s]), int(cr[b, c, s])
            if sq >= qb and sq + sln <= qe_f and sr >= rb and \
                    sr + sln <= re_f:
                lanes[s % 32] += sln
        cov = sum(lanes)                        # the warp sum
        fi[:, p] = (qe_f, score_f, truesc)
        fl[:, p] = (re_f, a_w, cov)
        packed[p] = (int(valid), b, qb, qe_f, score_f, truesc, _i32(a_w),
                     _i32(cov), int(rid[p]), sl, rb & 0x7FFFFFFF, rb >> 31,
                     re_f & 0x7FFFFFFF, re_f >> 31)
    if over[0]:
        pr.flag.bitwise_or_(1)
    dev = pr.read.device
    t = lambda x: torch.as_tensor(x, device=dev)
    if phase in (0, 2):
        return t(bl)
    if phase == 1:
        m = t(lf)
        return Left(*m[:4], m[4:6], t(rb_o))
    m, n = t(fi), t(fl)
    return Final(m[0], m[1], m[2], n[0], n[1], n[2], t(packed))


def ext_bsw_band_twin(phase: int, st: Stage, pr: Pairs, lens, r1,
                      left: Left, ch, seed_live, opt, stats: dict = None):
    """bsw_band_kernel's launch: the BSW round (its row step's twin is
    tests/test_torch_bsw.py's; here the plain rows), then each warp's
    epilogue (``ext_band_twin``) on the round's rows as its registers."""
    q, ln, t, h0, w = bsw_inputs(phase, st, lens, left, opt)
    rows = banded_swa_rows(q, ln, t, h0, w, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, opt.zdrop, opt.mat, stats=stats)
    if phase in (0, 2):
        return rows, ext_band_twin(phase, st, pr, rows, None, left, ch,
                                   seed_live, opt)
    return rows, ext_band_twin(phase, st, pr, r1, rows, left, ch, seed_live,
                               opt)
