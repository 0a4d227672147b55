"""Seed chaining and the chain filter through the hand-written CUDA kernels
of csrc/chain.cu.

Two wrappers, each replacing device loops of the JAX package's
``ops/chain.py``:
- ``chain_seeds_cuda``: ``chain_seeds_device`` (JAX ``:78``, its
  ``jax.lax.while_loop`` at ``:242``); plain version
  ``ops/chain.py::chain_seeds_device``;
- ``chain_filter_cuda``: ``chain_weights``, ``chain_filter_device`` and
  ``frac_rep_device`` (JAX ``:270``, ``:299``, ``:246``) in one launch;
  plain version ``ops/chain.py::chain_filter_frac_rep``.
On CUDA tensors each launches its kernel once (one warp a read, the
read's chain state in shared memory, its whole walk in the launch) or
raises; on CPU tensors each runs its plain version. Each kernel has two
forms: reference positions (rbeg, the keys, the seeds' rbeg plane, the
SMEM sizes the filter reads) int32 (``*_launch``) or int64
(``*_launch64``, the index's int64 layout), chosen by rbeg's dtype; an
int64 batch never runs the int32 form. There is no fallback
from a kernel to its plain version, and no host synchronisation: each
warp of ``chain_seeds_kernel`` walks its read's prefix of valid
coordinates, where the lockstep reads the batch-wide maximum back to the
host. Each wrapper has its plain version's signature and keeps a
``launches`` count and the last call's per-read ``last_steps`` and
``last_rounds`` (the dependent rounds of the read's warp, csrc/chain.cu),
and a ``launches64`` count of the int64 form's launches;
with ``stats`` they add the longest read's steps and rounds (device
tensors) under ``chain_steps`` (coordinates walked), ``chain_rounds``,
``chain_flt_steps`` (live chains weighed plus overlap tests) and
``chain_flt_rounds``.

Each kernel returns its plain version's arrays exactly and writes every
element of its outputs once, so the wrappers allocate them with
``torch.empty`` and nothing else: no fill, no scratch. At int64 the seed
planes are three int32 ones (qbeg, len, score) and an int64 rbeg plane. The source is
compiled with nvcc into ``build/torch_kernels/libchain_cuda.so`` at first
use (``ops/nvcc_build.py``) and bound with ctypes.

``chain_seeds_twin`` and ``chain_filter_twin`` are the kernels' loops in
plain Python on numpy arrays, 32 entries a warp step, tests of the
kernels' control flow on the CPU; each counts the steps and rounds its
kernel counts and asserts the facts the kernel rests on.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .chain import (Chains, DeviceBns, chain_filter_frac_rep,
                    chain_seeds_device)

WARP = 32

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ll, _cd = ctypes.c_longlong, ctypes.c_double
_SEEDS = [_vp, _vp, _ci, _ll] + [_vp] * 5 + [_ci] * 7 + [_vp] * 9
_FILTER = ([_vp, _vp, _ci, _ll] + [_ci] * 3 + [_vp] * 6
           + [_ci, _cd, _ci, _cd, _ci, _ci] + [_vp] * 4 + [_ci, _vp, _ci]
           + [_vp] * 6)
LIB = nvcc_build.Library("chain.cu", "chain_cuda", {
    "chain_seeds_launch": _SEEDS, "chain_seeds_launch64": _SEEDS + [_vp],
    "chain_filter_launch": _FILTER, "chain_filter_launch64": _FILTER},
    host_fns={"chain_max_chains": [_ci]})
build = LIB.build            # compile csrc/chain.cu; returns the library path
_SUFFIX = {torch.int32: "", torch.int64: "64"}


def _check(what: str, bns: DeviceBns, C: int, kernel: int, ints,
           positions) -> tuple:
    """(device, position dtype): the device of ints[0], CUDA, shared by
    every tensor and bns's arrays; `ints` int32; `positions` (reference
    positions and SMEM sizes) of one dtype, int32 or int64; C chains
    within one block's shared memory at that dtype (`kernel` 0
    chain_seeds, 1 chain_filter); or ValueError."""
    dev = ints[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in (*ints, *positions, bns.offsets,
                                     bns.is_alt)):
        raise ValueError(f"{what}: tensors on different devices")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{what}: indices and counts must be int32")
    pd = positions[0].dtype
    if pd not in _SUFFIX or any(t.dtype != pd for t in positions):
        raise ValueError(f"{what}: positions must be all int32 or all "
                         f"int64")
    if bns.offsets.dtype != torch.int64 or bns.is_alt.dtype != torch.bool:
        raise ValueError(f"{what}: bns offsets must be int64, is_alt bool")
    most = LIB.call("chain_max_chains", kernel + 2 * (pd == torch.int64))
    if C > most:
        raise ValueError(f"{what}: {C} chains a read pass the {most} whose "
                         f"state fits one block's shared memory")
    return dev, pd


def _bns_args(bns: DeviceBns) -> list:
    offsets, is_alt = bns.offsets.contiguous(), bns.is_alt.contiguous()
    return [offsets.data_ptr(), is_alt.data_ptr(), offsets.shape[0],
            bns.l_pac]


def chain_seeds_cuda(bns: DeviceBns, smems, rbeg, seed_idx, coord_valid, *,
                     w: int, max_chain_gap: int, max_chains: int,
                     max_seeds_per_chain: int, stats: dict = None) -> Chains:
    """Drop-in for ``chain_seeds_device`` (equal arrays). coord_valid
    [B, NC] is each read's prefix of valid coordinates (``slot < total``
    in ``expand_and_lookup``). On CPU tensors the plain version, with
    the lockstep's ``chain_steps`` in `stats`; on CUDA tensors one launch
    of chain_seeds_kernel, each warp walking its read's prefix, the
    longest read's coordinates and rounds added under ``chain_steps`` and
    ``chain_rounds`` as device tensors."""
    kw = dict(w=w, max_chain_gap=max_chain_gap, max_chains=max_chains,
              max_seeds_per_chain=max_seeds_per_chain)
    if rbeg.device.type == "cpu":
        return chain_seeds_device(bns, smems, rbeg, seed_idx, coord_valid,
                                  stats=stats, **kw)
    C, S = max_chains, max_seeds_per_chain
    dev, pd = _check("chain_seeds_cuda", bns, C, 0,
                     (seed_idx, smems.m, smems.n), (rbeg,))
    if coord_valid.device != dev or coord_valid.dtype != torch.bool:
        raise ValueError("chain_seeds_cuda: coord_valid must be bool on "
                         "the seeds' device")
    B, NC = rbeg.shape
    M = smems.m.shape[1]
    if seed_idx.shape != (B, NC) or coord_valid.shape != (B, NC) \
            or smems.m.shape[0] != B or smems.n.shape != smems.m.shape:
        raise ValueError("chain_seeds_cuda: read counts differ")
    i32, wide = torch.int32, pd == torch.int64
    key = torch.empty((B, C), dtype=pd, device=dev)
    slot = torch.empty((B, C), dtype=i32, device=dev)
    n = torch.empty((B,), dtype=i32, device=dev)
    rid = torch.empty((B, C), dtype=i32, device=dev)
    n_seeds = torch.empty((B, C), dtype=i32, device=dev)
    # int32: planes qbeg, rbeg, len, score; int64: qbeg, len, score, and
    # rbeg apart
    seeds = torch.empty((3 if wide else 4, B, C, S), dtype=i32, device=dev)
    srb = (torch.empty((B, C, S), dtype=pd, device=dev) if wide
           else seeds[1])
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    steps = torch.empty((B,), dtype=i32, device=dev)
    rounds = torch.empty((B,), dtype=i32, device=dev)
    if B:
        ins = [t.contiguous() for t in (rbeg, seed_idx, coord_valid,
                                        smems.m, smems.n)]
        LIB.launch(dev, "chain_seeds_launch" + _SUFFIX[pd], *_bns_args(bns),
                   *(t.data_ptr() for t in ins), B, NC, M, w, max_chain_gap,
                   C, S, key.data_ptr(), slot.data_ptr(),
                   n.data_ptr(), rid.data_ptr(), n_seeds.data_ptr(),
                   seeds.data_ptr(), overflow.data_ptr(), steps.data_ptr(),
                   rounds.data_ptr(), *([srb.data_ptr()] if wide else []))
        chain_seeds_cuda.launches += 1
        chain_seeds_cuda.launches64 += wide
        if stats is not None:
            for what, per_read in (("chain_steps", steps),
                                   ("chain_rounds", rounds)):
                stats[what] = stats.get(what, 0) + per_read.max()
    chain_seeds_cuda.last_steps = steps
    chain_seeds_cuda.last_rounds = rounds
    q, ln, sc = (seeds[0], seeds[1], seeds[2]) if wide else (
        seeds[0], seeds[2], seeds[3])
    return Chains(key=key, slot=slot, n=n, rid=rid, n_seeds=n_seeds,
                  seed_qbeg=q, seed_rbeg=srb, seed_len=ln, seed_score=sc,
                  overflow=overflow)


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, and the int64 form's
chain_seeds_cuda.launches = 0
chain_seeds_cuda.launches64 = 0
# the per-read step and round counts of the last call ([B] int32, on its
# device)
chain_seeds_cuda.last_steps = None
chain_seeds_cuda.last_rounds = None


def chain_filter_cuda(ch: Chains, bns: DeviceBns, smems, lens, *,
                      min_chain_weight: int, mask_level: float,
                      max_chain_gap: int, drop_ratio: float,
                      min_seed_len: int, max_chain_extend: int,
                      max_occ: int, stats: dict = None):
    """Drop-in for ``chain_filter_frac_rep`` (equal arrays): (order [B, C]
    slots in weight order, kept [B, C] by sorted position, w_by_slot
    [B, C], frac_rep [B] float32). On CPU tensors the plain version; on
    CUDA tensors one launch of chain_filter_kernel, the longest read's
    steps and rounds added under ``chain_flt_steps`` and
    ``chain_flt_rounds`` as device tensors."""
    kw = dict(min_chain_weight=min_chain_weight, mask_level=mask_level,
              max_chain_gap=max_chain_gap, drop_ratio=drop_ratio,
              min_seed_len=min_seed_len, max_chain_extend=max_chain_extend,
              max_occ=max_occ)
    if ch.n.device.type == "cpu":
        return chain_filter_frac_rep(ch, bns, smems, lens, **kw)
    arrs = (ch.n, ch.rid, ch.n_seeds, ch.seed_qbeg, ch.seed_rbeg,
            ch.seed_len, smems.m, smems.n, smems.s, smems.cnt, lens)
    B, C, S = ch.seed_qbeg.shape
    dev, pd = _check("chain_filter_cuda", bns, C, 1,
                     arrs[:4] + arrs[5:8] + arrs[9:], (arrs[4], arrs[8]))
    M = smems.m.shape[1]
    if any(t.shape != (B, C, S) for t in arrs[4:6]) \
            or any(t.shape != (B, C) for t in arrs[1:3]) \
            or any(t.shape != (B, M) for t in arrs[6:9]) \
            or any(t.shape != (B,) for t in (ch.n, smems.cnt, lens)):
        raise ValueError("chain_filter_cuda: shapes differ")
    i32 = torch.int32
    order = torch.empty((B, C), dtype=i32, device=dev)
    kept = torch.empty((B, C), dtype=i32, device=dev)
    w_slot = torch.empty((B, C), dtype=i32, device=dev)
    frac_rep = torch.empty((B,), dtype=torch.float32, device=dev)
    steps = torch.empty((B,), dtype=i32, device=dev)
    rounds = torch.empty((B,), dtype=i32, device=dev)
    if B:
        ins = [t.contiguous() for t in arrs]
        LIB.launch(dev, "chain_filter_launch" + _SUFFIX[pd], *_bns_args(bns),
                   B, C, S,
                   *(t.data_ptr() for t in ins[:6]),
                   min_chain_weight, float(mask_level), max_chain_gap,
                   float(drop_ratio), min_seed_len,
                   min(max_chain_extend, (1 << 31) - 1),
                   *(t.data_ptr() for t in ins[6:10]), M, ins[10].data_ptr(),
                   max_occ, order.data_ptr(), kept.data_ptr(),
                   w_slot.data_ptr(), frac_rep.data_ptr(), steps.data_ptr(),
                   rounds.data_ptr())
        chain_filter_cuda.launches += 1
        chain_filter_cuda.launches64 += pd == torch.int64
        if stats is not None:
            for what, per_read in (("chain_flt_steps", steps),
                                   ("chain_flt_rounds", rounds)):
                stats[what] = stats.get(what, 0) + per_read.max()
    chain_filter_cuda.last_steps = steps
    chain_filter_cuda.last_rounds = rounds
    return order, kept, w_slot, frac_rep


chain_filter_cuda.launches = 0
chain_filter_cuda.launches64 = 0
chain_filter_cuda.last_steps = None              # [B] int32, on its device
chain_filter_cuda.last_rounds = None


# ---- the kernels' loops on numpy arrays ---------------------------------

def _pos2rid(offsets, l_pac: int, pos_f: int) -> int:
    if pos_f >= l_pac:
        return -1
    return int(np.searchsorted(offsets, pos_f, side="right")) - 1


def _intv2rid(offsets, l_pac: int, rb: int, re: int) -> int:
    if rb < l_pac < re:
        return -2
    depos = lambda p: 2 * l_pac - 1 - p if p >= l_pac else p
    rid_b = _pos2rid(offsets, l_pac, depos(rb))
    rid_e = _pos2rid(offsets, l_pac, depos(re - 1 if rb < re else rb))
    return rid_b if rid_b == rid_e else -1


def _lanes(j0: int, end: int) -> range:
    """The entries of the warp step at j0 over [0, end)."""
    return range(j0, min(j0 + WARP, end))


def chain_seeds_twin(offsets, l_pac: int, m, n, rbeg, seed_idx,
                     coord_valid, *, w: int, max_chain_gap: int,
                     max_chains: int, max_seeds_per_chain: int):
    """csrc/chain.cu's chain_seeds_kernel in plain Python on numpy arrays,
    one read after another: the coordinates staged 32 at a time up to the
    first invalid one; at each stage every coordinate's lower chain, the
    live slot of the largest (key, slot) with key <= rbeg, kept up to
    date as new chains start; the stage's seeds tested side by side
    against the state by slot (rid, seed count, first and last seed),
    those before the first that changes it final, that one committed,
    the rest tested again; the sorted rows by rank at the end; the
    rounds as the kernel counts them. Asserts what the kernel rests on,
    against the sorted key array the one-thread design kept (ascending,
    each new key after the keys equal to it): that array ascends, a
    seed's lower chain is its last key <= rbeg whenever the seed is
    tested, and the ranks give that array; a lower chain's seed count
    lies in [1, S] (so the lockstep's clamped last-seed index is the last
    appended seed); every seed-plane element is written once. The form
    follows rbeg's dtype (int32 or int64: the keys and the rbeg plane).
    Returns (the Chains fields as numpy arrays, steps [B], rounds [B])."""
    offsets = np.asarray(offsets, np.int64)
    m, n = np.asarray(m), np.asarray(n)
    rbeg, seed_idx = np.asarray(rbeg), np.asarray(seed_idx)
    coord_valid = np.asarray(coord_valid, bool)
    B, NC = rbeg.shape
    M = m.shape[1]
    C, S = max_chains, max_seeds_per_chain
    pd = rbeg.dtype
    big = np.iinfo(pd).max // 4
    chunks = lambda k: -(-k // WARP)
    key = np.zeros((B, C), pd)
    slot = np.zeros((B, C), np.int32)
    n_out = np.zeros(B, np.int32)
    rid_t = np.zeros((B, C), np.int32)
    n_seeds = np.zeros((B, C), np.int32)
    seeds = np.zeros((4, B, C, S), np.int64)       # qbeg rbeg len score
    written = np.zeros((B, C, S), np.int32)
    overflow = np.zeros(B, bool)
    steps = np.zeros(B, np.int32)
    rounds = np.zeros(B, np.int32)
    for b in range(B):
        RD, NS, FQ, FR, LQ, LR, LL = ([0] * C for _ in range(7))
        nch, of, st, rnd = 0, False, 0, 0
        ref = []                                   # the sorted (key, slot)

        def put(c, s, q, r, ln):
            seeds[:, b, c, s] = (q, r, ln, ln)
            written[b, c, s] += 1

        rnd += 2                                   # the first chunk's loads
        for c0 in range(0, NC, WARP):
            vote = [bool(coord_valid[b, c]) for c in _lanes(c0, NC)]
            cnt = vote.index(False) if False in vote else len(vote)
            rnd += 1                               # the contig search
            staged = []
            for c in range(c0, c0 + cnt):
                s_rbeg = int(rbeg[b, c])
                si = min(max(int(seed_idx[b, c]), 0), M - 1)
                s_qbeg = int(m[b, si])
                s_len = int(n[b, si]) + 1 - s_qbeg
                staged.append((s_rbeg, s_qbeg, s_len, _intv2rid(
                    offsets, l_pac, s_rbeg, s_rbeg + s_len)))
            low = [-1] * len(staged)               # each lane's lower chain
            low_key = [0] * len(staged)
            for t, (s_rbeg, *_) in enumerate(staged):
                for c in range(nch):
                    if FR[c] <= s_rbeg and (low[t] < 0 or FR[c] >= low_key[t]):
                        low[t], low_key[t] = c, FR[c]
            rnd += chunks(nch)
            done = 0
            while done < cnt:                      # test, commit, again
                assert all(a <= z for (a, _), (z, _) in zip(ref, ref[1:])), \
                    "the sorted keys ascend"
                act, ln, over = [0] * cnt, [0] * cnt, [False] * cnt
                for t in range(done, cnt):
                    s_rbeg, s_qbeg, s_len, rid = staged[t]
                    if rid < 0:
                        continue
                    pos = sum(kk <= s_rbeg for kk, _ in ref)
                    ls = low[t]
                    assert ls == (ref[pos - 1][1] if pos else -1), \
                        "the lower chain is the last key <= rbeg"
                    merged = False
                    if ls >= 0:
                        ln[t] = NS[ls]
                        assert 1 <= ln[t] <= S, "a live chain holds 1-S seeds"
                        last_q, last_r, last_len = LQ[ls], LR[ls], LL[ls]
                        first_q, first_r = FQ[ls], FR[ls]
                        same_rid = rid == RD[ls]
                        contained = (same_rid and s_qbeg >= first_q
                                     and s_qbeg + s_len <= last_q + last_len
                                     and s_rbeg >= first_r
                                     and s_rbeg + s_len <= last_r + last_len)
                        diff_strand = ((last_r < l_pac or first_r < l_pac)
                                       and s_rbeg >= l_pac)
                        x, y = s_qbeg - last_q, s_rbeg - last_r
                        growable = (same_rid and not contained
                                    and not diff_strand and y >= 0
                                    and x - y <= w and y - x <= w
                                    and x - last_len < max_chain_gap
                                    and y - last_len < max_chain_gap)
                        if growable:
                            if ln[t] >= S:
                                over[t] = True
                            else:
                                act[t] = 1
                        merged = contained or growable
                    if not merged:
                        if nch >= C:
                            over[t] = True
                        else:
                            act[t] = 2
                rnd += 1
                f = next((t for t in range(done, cnt) if act[t]), cnt)
                of = of or any(over[done:f])
                if f >= cnt:
                    break
                s_rbeg, s_qbeg, s_len, rid = staged[f]
                if act[f] == 1:                    # seed f appends
                    ls = low[f]
                    put(ls, ln[f], s_qbeg, s_rbeg, s_len)
                    NS[ls] = ln[f] + 1
                    LQ[ls], LR[ls], LL[ls] = s_qbeg, s_rbeg, s_len
                else:                              # seed f: a new chain
                    put(nch, 0, s_qbeg, s_rbeg, s_len)
                    RD[nch], NS[nch] = rid, 1
                    FQ[nch] = LQ[nch] = s_qbeg
                    FR[nch] = LR[nch] = s_rbeg
                    LL[nch] = s_len
                    ref.insert(sum(kk <= s_rbeg for kk, _ in ref),
                               (s_rbeg, nch))
                    for u, (u_rbeg, *_) in enumerate(staged):
                        if s_rbeg <= u_rbeg and (low[u] < 0
                                                 or s_rbeg >= low_key[u]):
                            low[u], low_key[u] = nch, s_rbeg
                    nch += 1
                done = f + 1
            st = c0 + cnt
            if cnt < WARP:
                break
        for c in range(nch):                       # the rows, by rank
            r = sum(FR[c2] < FR[c] or (FR[c2] == FR[c] and c2 < c)
                    for c2 in range(nch))
            key[b, r], slot[b, r] = FR[c], c
        rnd += chunks(nch) ** 2
        assert [tuple(a) for a in zip(key[b, :nch], slot[b, :nch])] == ref, \
            "the ranks give the sorted keys"
        for c in range(C):
            live = c < nch
            if not live:
                key[b, c], slot[b, c] = big, 0
            rid_t[b, c] = RD[c] if live else -1
            n_seeds[b, c] = NS[c] if live else 0
            seeds[:, b, c, n_seeds[b, c]:] = 0     # what no seed wrote
            written[b, c, n_seeds[b, c]:] += 1
        n_out[b], overflow[b], steps[b], rounds[b] = nch, of, st, rnd
    assert (written == 1).all(), "every seed-plane element written once"
    q, r, ln, sc = (seeds[0].astype(np.int32), seeds[1].astype(pd),
                    *(p.astype(np.int32) for p in seeds[2:]))
    return (Chains(key=key, slot=slot, n=n_out, rid=rid_t, n_seeds=n_seeds,
                   seed_qbeg=q, seed_rbeg=r, seed_len=ln, seed_score=sc,
                   overflow=overflow), steps, rounds)


def _cover(beg, length, k: int) -> int:
    end = total = 0
    for i in range(k):
        bb, ll = int(beg[i]), int(length[i])
        total += ll if bb >= end else (bb + ll - end if bb + ll > end else 0)
        end = max(end, bb + ll)
    return total


def overlap_test(i: int, qb, qe, wt, alt, kept, first, *, mask_level: float,
                 max_chain_gap: int, drop_ratio: float, min_seed_len: int):
    """One sorted position i of chain_filter_kernel's overlap loop: the
    bits of the significant j < i and of the dominating ones, kept or
    not (lane i's row of its block), then, 32 words of 32 j a round,
    those of the kept j: j* is the lowest dominating kept j, and every
    significant kept j <= j* whose first is unset records i (in `first`,
    in place). Returns (kept[i], the j the serial loop visits: j* + 1, or
    i when nothing dominates, the rounds of words)."""
    sig, dom = [False] * i, [False] * i
    bi, ei, wi = qb[i], qe[i], wt[i]
    for j in range(i):
        b_max, e_min = max(qb[j], bi), min(qe[j], ei)
        min_l = min(qe[j] - qb[j], ei - bi)
        sig[j] = (not (alt[j] and not alt[i]) and e_min > b_max
                  and min_l < max_chain_gap
                  and float(e_min - b_max) >= min_l * mask_level)
        dom[j] = (sig[j] and float(wi) < wt[j] * drop_ratio
                  and wt[j] - wi >= (min_seed_len << 1))
    jstar, large, rounds = -1, False, 0
    for q0 in range(0, -(-i // WARP), WARP):
        rounds += 1
        live = [j for j in range(q0 * WARP, min((q0 + WARP) * WARP, i))
                if kept[j] > 0]
        doms = [j for j in live if dom[j]]
        hi = doms[0] if doms else i
        for j in live:
            if sig[j] and j <= hi:
                large = True
                if first[j] < 0:
                    first[j] = i
        if doms:
            jstar = hi
            break
    visited = jstar + 1 if jstar >= 0 else i
    return (0 if jstar >= 0 else (2 if large else 3)), visited, rounds


def chain_filter_twin(is_alt, ch, m, n, s, cnt, lens, *,
                      min_chain_weight: int, mask_level: float,
                      max_chain_gap: int, drop_ratio: float,
                      min_seed_len: int, max_chain_extend: int,
                      max_occ: int):
    """csrc/chain.cu's chain_filter_kernel in plain Python on numpy
    arrays (ch: Chains of numpy arrays), one read after another: the
    weights a lane a slot, each live slot's sorted position as its rank
    (larger keys, then equal keys of earlier slots), the overlap loop in
    blocks of 32 rows, each row's bits of the significant and dominating
    j, then the rows in order over the kept j (``overlap_test``), the
    kept = 1 and cap passes 32 at a time,
    frac_rep over the SMEMs over max_occ; steps and rounds as the kernel
    counts them. Asserts what the kernel rests on: no live key below -1
    (the empty slots follow in slot order), kept[j] final for j < i when
    i is tested, and no first set on a dropped chain (so the kept = 1 pass
    needs no order). Returns (order, kept, w_by_slot, frac_rep float32,
    steps, rounds) as numpy arrays."""
    is_alt = np.asarray(is_alt, bool)
    sq, sr, sn = (np.asarray(a) for a in (ch.seed_qbeg, ch.seed_rbeg,
                                         ch.seed_len))
    B, C, S = sq.shape
    M = np.asarray(m).shape[1]
    chunks = lambda k: -(-k // WARP)
    order = np.zeros((B, C), np.int32)
    kept = np.zeros((B, C), np.int32)
    w_slot = np.zeros((B, C), np.int32)
    frac_rep = np.zeros(B, np.float32)
    steps = np.zeros(B, np.int32)
    rounds = np.zeros(B, np.int32)
    flt = dict(mask_level=mask_level, max_chain_gap=max_chain_gap,
               drop_ratio=drop_ratio, min_seed_len=min_seed_len)
    for b in range(B):
        nch = min(max(int(ch.n[b]), 0), C)
        st, rnd = nch, 0
        KEY = [0] * C                              # by slot
        for c in range(nch):
            k = min(max(int(ch.n_seeds[b, c]), 0), S)
            wm = min(_cover(sq[b, c], sn[b, c], k),
                     _cover(sr[b, c], sn[b, c], k))
            w_slot[b, c] = min(wm, (1 << 30) - 1)
            KEY[c] = (int(w_slot[b, c]) if w_slot[b, c] >= min_chain_weight
                      else -1)
        n_heavy = sum(int(w_slot[b, c]) >= min_chain_weight
                      for c in range(nch))
        order[b, nch:] = np.arange(nch, C)
        rnd += 2 * chunks(nch)
        assert all(KEY[c] >= -1 for c in range(nch)), "no key below -1"
        QB, QE, W, ALT = [0] * C, [0] * C, [0] * C, [False] * C
        FIRST = [-1] * C
        for c in range(nch):
            r = sum(KEY[c2] > KEY[c] or (KEY[c2] == KEY[c] and c2 < c)
                    for c2 in range(nch))
            order[b, r] = c
            if r < n_heavy:
                k = min(max(int(ch.n_seeds[b, c]) - 1, 0), S - 1)
                rid = int(ch.rid[b, c])
                QB[r] = int(sq[b, c, 0])
                QE[r] = int(sq[b, c, k]) + int(sn[b, c, k])
                W[r] = KEY[c]
                ALT[r] = rid >= 0 and bool(is_alt[rid])
        rnd += chunks(nch) * (chunks(nch) + 1)
        KP = [None] * C
        if n_heavy > 0:
            KP[0] = 3
        for i0 in range(0, n_heavy, WARP):         # blocks of 32 rows
            i_end = min(i0 + WARP, n_heavy)
            rnd += -(-(i_end - 1) // WARP)         # the rows' bits
            for i in range(max(i0, 1), i_end):
                assert None not in KP[:i] and KP[i] is None, \
                    "kept[j] is final for j < i"
                KP[i], visited, ck = overlap_test(i, QB, QE, W, ALT, KP,
                                                  FIRST, **flt)
                st += visited
                rnd += ck
        assert all(FIRST[i] < 0 for i in range(n_heavy) if KP[i] == 0), \
            "no first on a dropped chain"
        for i0 in range(0, n_heavy, WARP):         # kept = 1, 32 at a time
            fs = [FIRST[i] if KP[i] > 0 else -1 for i in _lanes(i0, n_heavy)]
            for f in fs:
                if f >= 0:
                    KP[f] = 1
            rnd += 1
        r12 = 0                                    # the cap, prefix counts
        for i0 in range(0, n_heavy, WARP):
            lanes = _lanes(i0, n_heavy)
            is12 = [KP[i] in (1, 2) for i in lanes]
            for t, i in enumerate(lanes):
                if is12[t] and r12 + sum(is12[:t + 1]) >= max_chain_extend:
                    KP[i] = 0
            r12 += sum(is12)
            rnd += 1
        kept[b, :n_heavy] = KP[:n_heavy]
        # frac_rep over the sorted SMEMs over max_occ
        fb = fe = l_rep = 0
        n_sm = min(max(int(cnt[b]), 0), M)
        for i in range(n_sm):
            if int(s[b, i]) <= max_occ:
                continue
            sb, se = int(m[b, i]), int(n[b, i]) + 1
            if sb > fe:
                l_rep += fe - fb
                fb, fe = sb, se
            else:
                fe = max(fe, se)
        l_rep += fe - fb
        rnd += chunks(n_sm)
        frac_rep[b] = np.float32(l_rep) / np.float32(max(int(lens[b]), 1))
        steps[b], rounds[b] = st, rnd
    return order, kept, w_slot, frac_rep, steps, rounds
