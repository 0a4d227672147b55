"""The CIGAR DP (banded global alignment with traceback) through the
hand-written CUDA kernel of csrc/kswg.cu.

``ksw_global_batch_cuda`` has the signature of the JAX package's
``ops/kswg.py::ksw_global_batch`` (its row loop, ``:67-143``, and its
traceback, ``:156-176``, are what the kernel replaces). On CUDA tensors
it launches ``kswg_kernel`` (one warp a pair, the codes staged in shared
memory, the row indexed by band position with a strip of R positions a
lane in registers, R each pair's own, one shuffle scan a row, 4-bit
directions kept in shared memory or, past its room, in a global scratch
that the traceback stages back a tile of rows at a time; ``plan`` sizes
the shared memory and the scratch from the shapes and from
``block_budget``, a block's share of an SM at the call's pair count) or
raises; on CPU tensors it runs the plain version, ``ops/kswg.py::ksw_global_batch``. There is no fallback
from the kernel to the plain version. ``kswg_twin`` follows the
kernel's loops in numpy (the band-indexed strips and their scans, the
nibble rows as the kernel stores them, the traceback from shared memory
or from tiles) and counts each pair's row passes, traceback steps and
tiles staged.

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

# the query width the wrapper takes (the codes of both sides and the rows
# of nibbles share one block's 227 KB of shared memory)
MAX_QL = 29024
# a block's shared memory (232,448 bytes on Hopper) less the profile table
# and slack: what `plan` may give the codes, a band's state and its rows
SMEM_BUDGET = 232448 - 1024
# an SM's shared memory on Hopper, and what the hardware keeps of it for
# each block resident there
SM_SMEM = 233472
BLOCK_RESERVED = 1024
# the least tile of rows the traceback stages, where a block's share
# leaves less
TILE_ROWS = 32
# the strips a lane may hold in registers; a wider band runs in segments
# of 32 x SEG_R positions
STRIPS = (1, 2, 3, 4, 6, 8, 12, 16)
SEG_R = 16


class _Prof(ctypes.Structure):
    _fields_ = [("v", ctypes.c_int * 25)]


_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = nvcc_build.Library(
    "kswg.cu", "kswg_cuda",
    {"kswg_launch": [_vp] * 12 + [_ci] * 7 + [_Prof] + [_ci] * 4},
    host_fns={"kswg_blocks_a_sm": []})
build = LIB.build            # compile csrc/kswg.cu; returns the path


def profile_table(mat) -> _Prof:
    """The arithmetic profile as the kernel reads it: 5 x 5, row-major
    (target code, query code)."""
    match, mis, n = profile_scores(mat)
    t = _Prof()
    t.v[:] = [n if a == 4 or b == 4 else (match if a == b else mis)
              for a in range(5) for b in range(5)]
    return t


def lane_bytes(R: int) -> int:
    """Bytes of one lane's nibbles a row: ceil(R / 2) rounded up to a
    power of 2."""
    return 1 if R <= 2 else 2 if R <= 4 else 4 if R <= 8 else 8


def _r16(n: int) -> int:
    return (n + 15) & ~15


def strip(w: int, QL: int, TL: int):
    """(R, S) of a band of half-width w at shapes QL, TL: the least strip R
    of STRIPS whose 32 R positions cover 2 w + 1 (w clamped into [0,
    max(QL, TL)], which changes no cell), else S segments of 32 x SEG_R."""
    w = min(max(int(w), 0), max(QL, TL))
    need = -(-(2 * w + 1) // 32)        # csrc/kswg.cu's strip_need
    R = next((r for r in STRIPS if r >= need), None)
    return (R, 1) if R is not None else (SEG_R, -(-need // SEG_R))


def row_bytes(R: int, S: int) -> int:
    """Bytes of a row's nibbles: a word of lane_bytes(R) a lane a
    segment."""
    return S * 32 * lane_bytes(R)


def state_bytes(R: int, S: int) -> int:
    """Shared memory of a segmented band's row state (H and E)."""
    return 2 * S * 32 * R * 4 if S > 1 else 0


def codes_bytes(QL: int, TL: int) -> int:
    """Shared memory of the staged codes (the target's with one more)."""
    return _r16(QL) + _r16(TL + 1)


def block_budget(P: int, n_sm: int, blocks_a_sm: int) -> int:
    """The shared memory a block of a call of P pairs (a block each) may
    take: SMEM_BUDGET while P <= n_sm, else an even share of an SM among
    the blocks the call puts on it at once, ceil(P / n_sm) but at most
    `blocks_a_sm` (what the kernel's registers allow), less what the
    hardware keeps a block and the profile table."""
    per_sm = min(max(-(-P // max(n_sm, 1)), 1), max(blocks_a_sm, 1))
    return min(SMEM_BUDGET, SM_SMEM // per_sm - BLOCK_RESERVED - 128)


def plan(QL: int, TL: int, w_max: int, budget: int = None):
    """(rest, zrb, zsb) of a launch from its shapes and a block's shared
    memory `budget` (``block_budget``; SMEM_BUDGET when None). `rest`, the
    shared memory past the codes: all the widest band's rows of nibbles
    (and its segments' state) when they fit in `budget`, else what
    `budget` leaves, but never less than a tile of TILE_ROWS rows while a
    block holds one; zrb the row bytes of the global scratch [P, TL, zrb]
    when a pair's rows may not fit (else 0); zsb the bytes a pair of the
    global scratch for a segmented band's state [P, zsb / 4] int32, which
    is there (else 0) when the state in shared memory would leave a whole
    block less than such a tile. Each pair takes its own strip
    (``strip``) and keeps its rows in shared memory when they fit in
    `rest`. Raises ValueError when the codes and one row of the widest
    band exceed a block."""
    budget = SMEM_BUDGET if budget is None else min(budget, SMEM_BUDGET)
    R, S = strip(w_max, QL, TL)
    RB, ST = row_bytes(R, S), state_bytes(R, S)
    room = SMEM_BUDGET - codes_bytes(QL, TL)   # a whole block's
    tile = min(TL, TILE_ROWS) * RB
    zsb = ST if ST + tile > room else 0
    st = ST - zsb                              # the state in shared memory
    if st + RB > room:
        raise ValueError(f"ksw_global_batch_cuda: QL={QL}, TL={TL} at a "
                         f"band of {32 * R * S} positions leave no room for "
                         f"one row of directions in shared memory")
    full = st + TL * RB
    rest = min(full, max(budget - codes_bytes(QL, TL), min(st + tile, room)))
    return rest, RB if rest < full else 0, zsb


# kswg_blocks_a_sm and the SM count of each device, asked once
_OCCUPANCY = {}


def occupancy(dev):
    """(SMs, kswg_kernel's blocks an SM at no dynamic shared memory) of a
    CUDA device."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _OCCUPANCY:
        with torch.cuda.device(dev):
            _OCCUPANCY[key] = (
                torch.cuda.get_device_properties(dev).multi_processor_count,
                LIB.call("kswg_blocks_a_sm"))
    return _OCCUPANCY[key]


def launch_plan(dev, P: int, QL: int, TL: int, w_max: int):
    """``plan`` at the block's share of `dev` for P pairs."""
    return plan(QL, TL, w_max, block_budget(P, *occupancy(dev)))


def launch(qs, q_lens, ts, t_lens, w_p, o_del: int, e_del: int, o_ins: int,
           e_ins: int, mat, w_max: int) -> KswgResult:
    """One launch on contiguous int32 CUDA tensors, as
    ``ksw_global_batch_cuda`` checks them; w_max >= every w_p (it sizes
    the shared memory; csrc/kswg.cu refuses a launch whose widest band
    gets less than a row). No host synchronisation."""
    P, QL = qs.shape
    TL = ts.shape[1]
    dev = qs.device
    rest, zrb, zsb = launch_plan(dev, P, QL, TL, w_max)
    # the rows of the pairs whose rows do not fit in shared memory, and a
    # wide band's state kept in global memory
    zb = torch.empty((P, TL, zrb), dtype=torch.uint8, device=dev) \
        if zrb else None
    zs = torch.empty((P, zsb // 4), dtype=torch.int32, device=dev) \
        if zsb else None
    score, n_ops, tdel, tins = (torch.empty((P,), dtype=torch.int32,
                                            device=dev) for _ in range(4))
    ops = torch.empty((P, QL + TL + 2), dtype=torch.int8, device=dev)
    if P:
        LIB.launch(dev, "kswg_launch", qs.data_ptr(), q_lens.data_ptr(),
                   ts.data_ptr(), t_lens.data_ptr(), w_p.data_ptr(),
                   zb.data_ptr() if zb is not None else None,
                   zs.data_ptr() if zs is not None else None,
                   score.data_ptr(), ops.data_ptr(), n_ops.data_ptr(),
                   tdel.data_ptr(), tins.data_ptr(), P, QL, TL, w_max, rest,
                   zrb, zsb, profile_table(mat), o_del, e_del, o_ins, e_ins)
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
    w_max = int(w_p.max()) if P else 0      # the strips' width
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
              o_ins: int, e_ins: int, mat, budget: int = None):
    """The kernel's loops in numpy, a pair at a time: (KswgResult of numpy
    arrays, passes [P] (segment passes over the rows), steps [P]
    (traceback steps), tiles [P] (tiles of rows the traceback staged; 0
    when the pair's rows stay in shared memory)). `budget` is a block's
    shared memory as ``plan`` takes it (SMEM_BUDGET when None); where
    ``plan`` keeps a wide band's state in global memory the twin leaves
    it out of the tile's room, as the kernel does. Each row of nibbles is packed as the kernel
    stores it, and the traceback reads it back from there."""
    qs, ts = np.asarray(qs, np.int64), np.asarray(ts, np.int64)
    P, QL = qs.shape
    TL = ts.shape[1]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    tab = np.array(profile_table(mat).v[:], np.int64).reshape(5, 5)
    w_all = np.asarray(w_p, np.int64)
    rest, _, zsb = plan(QL, TL, int(w_all.max()) if P else 0, budget)
    NEG = NEG_INF
    S_ops = QL + TL + 2
    score = np.zeros(P, np.int32)
    ops = np.full((P, S_ops), -1, np.int8)
    n_ops, tdel, tins = (np.zeros(P, np.int32) for _ in range(3))
    passes, steps, tiles = (np.zeros(P, np.int64) for _ in range(3))

    def excl(x, axis):                   # exclusive running max, -inf first
        run = np.maximum.accumulate(x, axis=axis)
        pad = np.full_like(np.take(run, [0], axis=axis), NEG)
        return np.concatenate([pad, np.delete(run, -1, axis=axis)],
                              axis=axis)

    for p in range(P):
        qlen = min(max(int(q_lens[p]), 0), QL)
        tlen = min(max(int(t_lens[p]), 0), TL)
        w = min(int(w_all[p]), max(qlen, tlen))
        R, S = strip(w, QL, TL)
        LB, SEG, RB = lane_bytes(R), 32 * R, row_bytes(R, S)
        NPOS = S * SEG
        kpos = np.arange(NPOS)
        tile_rows = (rest - (0 if zsb else state_bytes(R, S))) // RB
        qc = np.clip(qs[p, :qlen], 0, 4)
        tc = np.clip(ts[p, :tlen], 0, 4)
        c = kpos - w                     # the first row's columns
        h = np.where(c == 0, 0, np.where((c >= 1) & (c <= w) & (c <= qlen),
                                         -(o_ins + e_ins * c), NEG))
        est = np.full(NPOS, NEG, np.int64)
        rows = np.zeros((TL, RB), np.uint8)
        for i in range(tlen):
            passes[p] += S
            kb, ke = max(w - i, 0), min(2 * w + 1, qlen - i + w)
            h1_first = -(o_del + e_del * (i + 1)) if i <= w else NEG
            j = i - w + kpos
            inb = (kpos >= kb) & (kpos < ke)
            qp = tab[tc[i], np.where((j >= 0) & (j < qlen),
                                     qc[np.clip(j, 0, max(qlen - 1, 0))]
                                     if qlen else 0, 0)]
            Ein = np.append(est[1:], NEG)    # position k + 1
            M = np.maximum(h + qp, NEG)
            t_ins = np.maximum(M - oe_ins, NEG)
            key = np.where(inb, t_ins + e_ins * j, NEG).reshape(S, 32, R)
            ex = excl(key, 2)                # in the strip
            incl = np.maximum.accumulate(key.max(2), axis=1)   # the lanes
            lex = excl(incl, 1)
            carry = excl(incl[:, 31], 0)     # the segments before
            run = np.maximum(np.maximum(lex, carry[:, None])[:, :, None],
                             ex).reshape(NPOS)
            f = np.where(~inb | (kpos == kb), NEG,
                         np.maximum(run - e_ins * (j - 1), NEG))
            pre = np.maximum(M, Ein)
            dh = np.where(pre >= f, np.where(M >= Ein, 0, 1), 2)
            H = np.maximum(pre, f)
            t_del = np.maximum(M - oe_del, NEG)
            e_bit = (Ein - e_del) > t_del
            E_next = np.maximum(Ein - e_del, t_del)
            f_bit = (f - e_ins) > t_ins
            nib = (dh | (e_bit.astype(np.int64) << 2)
                   | (f_bit.astype(np.int64) << 3)).reshape(S, 32, R)
            nib = np.concatenate([nib, np.zeros((S, 32, 2 * LB - R),
                                                np.int64)], axis=2)
            rows[i] = (nib[:, :, 0::2] | (nib[:, :, 1::2] << 4)).reshape(RB)
            h = np.where(inb, H, np.where(kpos == kb - 1, h1_first, h))
            est = np.where(kpos < ke, E_next, NEG)
        # the score: the last row's h1_last when its band reaches qlen
        sc_v = 0 if qlen == 0 else (-(o_ins + e_ins * qlen) if qlen <= w
                                    else NEG)
        if tlen and w < 0:
            sc_v = NEG
        elif tlen and tlen + w >= qlen:
            i = tlen - 1
            kb, ke = max(w - i, 0), min(2 * w + 1, qlen - i + w)
            sc_v = (int(h[ke - 1]) if ke > kb else
                    -(o_del + e_del * tlen) if i <= w else NEG)
        score[p] = sc_v
        direct = tlen <= tile_rows
        i, k = tlen - 1, min(tlen + w, qlen) - 1
        which = sc = 0
        lo, tile = (0, rows) if direct else (tlen, None)
        while i >= 0 and k >= 0:
            if i < lo:                   # stage the tile ending at row i
                lo = max(i + 1 - tile_rows, 0)
                tile = rows[lo:i + 1].copy()
                tiles[p] += 1
            beg, end = max(i - w, 0), min(i + w + 1, qlen)
            d = 0
            if beg <= k < end:
                kk = k - i + w
                g, r = divmod(kk, SEG)
                t = r % R
                byte = tile[i - lo, (g * 32 + r // R) * LB + (t >> 1)]
                d = (int(byte) >> ((t & 1) * 4)) & 15
            which = (d & 3 if which == 0 else
                     (d >> 2) & 1 if which == 1 else ((d >> 3) & 1) * 2)
            ops[p, sc] = 0 if which == 0 else (2 if which == 1 else 1)
            sc += 1
            i -= which != 2
            k -= which != 1
        n_ops[p], steps[p] = sc, sc
        tdel[p], tins[p] = max(i + 1, 0), max(k + 1, 0)
    return (KswgResult(score=score, ops=ops, n_ops=n_ops, tail_del=tdel,
                       tail_ins=tins), passes, steps, tiles)
