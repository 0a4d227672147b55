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
On CUDA tensors each launches its kernel once (one thread a read, the
read's whole walk in the launch) or raises; on CPU tensors each runs its
plain version. There is no fallback from a kernel to its plain version,
and no host synchronisation: each thread of ``chain_seeds_kernel`` walks
its read's prefix of valid coordinates, where the lockstep reads the
batch-wide maximum back to the host. Each wrapper has its plain
version's signature and keeps a ``launches`` count and the
last call's per-read ``last_steps``; with ``stats`` they add the longest
read's steps (device tensors) under ``chain_steps`` (coordinates walked)
and ``chain_flt_steps`` (live chains weighed plus overlap tests).

Each kernel returns its plain version's arrays exactly. The source is
compiled with nvcc into ``build/torch_kernels/libchain_cuda.so`` at first
use (``ops/nvcc_build.py``) and bound with ctypes. The wrappers allocate
the outputs (chain_seeds' four [B, C, S] seed planes as one zeroed
buffer), the filter's [5, C, B] scratch and the step counts.

``chain_seeds_twin`` and ``chain_filter_twin`` are the kernels' loops in
plain Python on numpy arrays, tests of the kernels' control flow on the
CPU; each counts the steps its kernel counts.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .chain import (BIG, Chains, DeviceBns, chain_filter_frac_rep,
                    chain_seeds_device)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ll, _cd = ctypes.c_longlong, ctypes.c_double
LIB = nvcc_build.Library("chain.cu", "chain_cuda", {
    "chain_seeds_launch": ([_vp, _vp, _ci, _ll] + [_vp] * 5 + [_ci] * 7
                           + [_vp] * 8),
    "chain_filter_launch": ([_vp, _vp, _ci, _ll, _ci, _ci, _ci] + [_vp] * 6
                            + [_ci, _cd, _ci, _cd, _ci, _ci] + [_vp] * 4
                            + [_ci, _vp, _ci] + [_vp] * 6)})
build = LIB.build            # compile csrc/chain.cu; returns the library path


def _check(what: str, bns: DeviceBns, *tensors) -> torch.device:
    """The device of tensors[0]: CUDA, shared by every tensor and bns's
    arrays; int32 integer tensors; or ValueError."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in (*tensors, bns.offsets, bns.is_alt)):
        raise ValueError(f"{what}: tensors on different devices")
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError(f"{what}: positions, indices and counts must be "
                         f"int32 (the int32 genome layout)")
    if bns.offsets.dtype != torch.int64 or bns.is_alt.dtype != torch.bool:
        raise ValueError(f"{what}: bns offsets must be int64, is_alt bool")
    return dev


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
    of chain_seeds_kernel, each thread walking its read's prefix, the
    longest read's coordinates added under ``chain_steps`` as a device
    tensor."""
    kw = dict(w=w, max_chain_gap=max_chain_gap, max_chains=max_chains,
              max_seeds_per_chain=max_seeds_per_chain)
    if rbeg.device.type == "cpu":
        return chain_seeds_device(bns, smems, rbeg, seed_idx, coord_valid,
                                  stats=stats, **kw)
    dev = _check("chain_seeds_cuda", bns, rbeg, seed_idx, smems.m, smems.n)
    if coord_valid.device != dev or coord_valid.dtype != torch.bool:
        raise ValueError("chain_seeds_cuda: coord_valid must be bool on "
                         "the seeds' device")
    B, NC = rbeg.shape
    M = smems.m.shape[1]
    C, S = max_chains, max_seeds_per_chain
    if seed_idx.shape != (B, NC) or coord_valid.shape != (B, NC) \
            or smems.m.shape[0] != B or smems.n.shape != smems.m.shape:
        raise ValueError("chain_seeds_cuda: read counts differ")
    i32 = torch.int32
    key = torch.empty((B, C), dtype=i32, device=dev)
    slot = torch.empty((B, C), dtype=i32, device=dev)
    n = torch.empty((B,), dtype=i32, device=dev)
    rid = torch.empty((B, C), dtype=i32, device=dev)
    n_seeds = torch.empty((B, C), dtype=i32, device=dev)
    seeds = torch.zeros((4, B, C, S), dtype=i32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    steps = torch.empty((B,), dtype=i32, device=dev)
    if B:
        ins = [t.contiguous() for t in (rbeg, seed_idx, coord_valid,
                                        smems.m, smems.n)]
        LIB.launch(dev, "chain_seeds_launch", *_bns_args(bns),
                   *(t.data_ptr() for t in ins), B, NC, M, w, max_chain_gap,
                   C, S, key.data_ptr(), slot.data_ptr(), n.data_ptr(),
                   rid.data_ptr(), n_seeds.data_ptr(), seeds.data_ptr(),
                   overflow.data_ptr(), steps.data_ptr())
        chain_seeds_cuda.launches += 1
        if stats is not None:
            stats["chain_steps"] = stats.get("chain_steps", 0) + steps.max()
    chain_seeds_cuda.last_steps = steps
    return Chains(key=key, slot=slot, n=n, rid=rid, n_seeds=n_seeds,
                  seed_qbeg=seeds[0], seed_rbeg=seeds[1], seed_len=seeds[2],
                  seed_score=seeds[3], overflow=overflow)


# kernel launches since the last reset (main-path proof in chip_smoke.py)
chain_seeds_cuda.launches = 0
# the per-read step counts of the last call ([B] int32, on its device)
chain_seeds_cuda.last_steps = None


def chain_filter_cuda(ch: Chains, bns: DeviceBns, smems, lens, *,
                      min_chain_weight: int, mask_level: float,
                      max_chain_gap: int, drop_ratio: float,
                      min_seed_len: int, max_chain_extend: int,
                      max_occ: int, stats: dict = None):
    """Drop-in for ``chain_filter_frac_rep`` (equal arrays): (order [B, C]
    slots in weight order, kept [B, C] by sorted position, w_by_slot
    [B, C], frac_rep [B] float32). On CPU tensors the plain version; on
    CUDA tensors one launch of chain_filter_kernel, the longest read's
    steps added under ``chain_flt_steps`` as a device tensor."""
    kw = dict(min_chain_weight=min_chain_weight, mask_level=mask_level,
              max_chain_gap=max_chain_gap, drop_ratio=drop_ratio,
              min_seed_len=min_seed_len, max_chain_extend=max_chain_extend,
              max_occ=max_occ)
    if ch.n.device.type == "cpu":
        return chain_filter_frac_rep(ch, bns, smems, lens, **kw)
    arrs = (ch.n, ch.rid, ch.n_seeds, ch.seed_qbeg, ch.seed_rbeg,
            ch.seed_len, smems.m, smems.n, smems.s, smems.cnt, lens)
    dev = _check("chain_filter_cuda", bns, *arrs)
    B, C, S = ch.seed_qbeg.shape
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
    if B:
        ins = [t.contiguous() for t in arrs]
        scratch = torch.empty((5, C, B), dtype=i32, device=dev)
        LIB.launch(dev, "chain_filter_launch", *_bns_args(bns), B, C, S,
                   *(t.data_ptr() for t in ins[:6]), min_chain_weight,
                   float(mask_level), max_chain_gap, float(drop_ratio),
                   min_seed_len, min(max_chain_extend, (1 << 31) - 1),
                   *(t.data_ptr() for t in ins[6:10]), M, ins[10].data_ptr(),
                   max_occ, scratch.data_ptr(), order.data_ptr(),
                   kept.data_ptr(), w_slot.data_ptr(), frac_rep.data_ptr(),
                   steps.data_ptr())
        chain_filter_cuda.launches += 1
        if stats is not None:
            stats["chain_flt_steps"] = (stats.get("chain_flt_steps", 0)
                                        + steps.max())
    chain_filter_cuda.last_steps = steps
    return order, kept, w_slot, frac_rep


chain_filter_cuda.launches = 0
chain_filter_cuda.last_steps = None              # [B] int32, on its device


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


def chain_seeds_twin(offsets, l_pac: int, m, n, rbeg, seed_idx,
                     coord_valid, *, w: int, max_chain_gap: int,
                     max_chains: int, max_seeds_per_chain: int):
    """csrc/chain.cu's chain_seeds_kernel in plain Python on numpy
    arrays: the same walk, searches and clamps, one read after another.
    Returns (the Chains fields as numpy arrays, steps [B])."""
    offsets = np.asarray(offsets, np.int64)
    m, n = np.asarray(m), np.asarray(n)
    rbeg, seed_idx = np.asarray(rbeg), np.asarray(seed_idx)
    coord_valid = np.asarray(coord_valid, bool)
    B, NC = rbeg.shape
    M = m.shape[1]
    C, S = max_chains, max_seeds_per_chain
    key = np.full((B, C), BIG, np.int32)
    slot = np.zeros((B, C), np.int32)
    n_out = np.zeros(B, np.int32)
    rid_t = np.full((B, C), -1, np.int32)
    n_seeds = np.zeros((B, C), np.int32)
    seeds = np.zeros((4, B, C, S), np.int32)       # qbeg rbeg len score
    overflow = np.zeros(B, bool)
    steps = np.zeros(B, np.int32)
    for b in range(B):
        ky, sl, rd, ns = key[b], slot[b], rid_t[b], n_seeds[b]
        sq, sr, sn = seeds[0, b], seeds[1, b], seeds[2, b]
        nch, of = 0, False
        tot = 0                                    # the valid prefix
        while tot < NC and coord_valid[b, tot]:
            tot += 1
        for c in range(tot):
            s_rbeg = int(rbeg[b, c])
            si = min(max(int(seed_idx[b, c]), 0), M - 1)
            s_qbeg = int(m[b, si])
            s_len = int(n[b, si]) + 1 - s_qbeg
            rid = _intv2rid(offsets, l_pac, s_rbeg, s_rbeg + s_len)
            if rid < 0:
                continue
            pos, hi = 0, nch                       # upper bound, live keys
            while pos < hi:
                mid = (pos + hi) >> 1
                if ky[mid] <= s_rbeg:
                    pos = mid + 1
                else:
                    hi = mid
            merged = False
            if pos > 0:
                ls = int(sl[pos - 1])
                ln = int(ns[ls])
                li = min(max(ln - 1, 0), S - 1)
                last_q, last_r, last_len = (int(sq[ls, li]), int(sr[ls, li]),
                                            int(sn[ls, li]))
                first_q, first_r = int(sq[ls, 0]), int(sr[ls, 0])
                same_rid = rid == rd[ls]
                contained = (same_rid and s_qbeg >= first_q
                             and s_qbeg + s_len <= last_q + last_len
                             and s_rbeg >= first_r
                             and s_rbeg + s_len <= last_r + last_len)
                diff_strand = ((last_r < l_pac or first_r < l_pac)
                               and s_rbeg >= l_pac)
                x, y = s_qbeg - last_q, s_rbeg - last_r
                growable = (same_rid and not contained and not diff_strand
                            and y >= 0 and x - y <= w and y - x <= w
                            and x - last_len < max_chain_gap
                            and y - last_len < max_chain_gap)
                if growable:
                    if ln >= S:
                        of = True
                    else:
                        seeds[:, b, ls, ln] = (s_qbeg, s_rbeg, s_len, s_len)
                        ns[ls] = ln + 1
                merged = contained or growable
            if merged:
                continue
            if nch >= C:
                of = True
                continue
            seeds[:, b, nch, 0] = (s_qbeg, s_rbeg, s_len, s_len)
            ns[nch], rd[nch] = 1, rid
            ky[pos + 1:nch + 1] = ky[pos:nch].copy()
            sl[pos + 1:nch + 1] = sl[pos:nch].copy()
            ky[pos], sl[pos] = s_rbeg, nch
            nch += 1
        n_out[b], overflow[b], steps[b] = nch, of, tot
    return (Chains(key=key, slot=slot, n=n_out, rid=rid_t, n_seeds=n_seeds,
                   seed_qbeg=seeds[0], seed_rbeg=seeds[1], seed_len=seeds[2],
                   seed_score=seeds[3], overflow=overflow), steps)


def _cover(beg, length, k: int) -> int:
    end = total = 0
    for i in range(k):
        bb, ll = int(beg[i]), int(length[i])
        total += ll if bb >= end else (bb + ll - end if bb + ll > end else 0)
        end = max(end, bb + ll)
    return total


def chain_filter_twin(is_alt, ch, m, n, s, cnt, lens, *,
                      min_chain_weight: int, mask_level: float,
                      max_chain_gap: int, drop_ratio: float,
                      min_seed_len: int, max_chain_extend: int,
                      max_occ: int):
    """csrc/chain.cu's chain_filter_kernel in plain Python on numpy
    arrays (ch: Chains of numpy arrays): the same weights, insertion sort,
    overlap loop and passes, one read after another. Returns (order,
    kept, w_by_slot, frac_rep float32, steps) as numpy arrays."""
    is_alt = np.asarray(is_alt, bool)
    sq, sr, sn = (np.asarray(a) for a in (ch.seed_qbeg, ch.seed_rbeg,
                                         ch.seed_len))
    B, C, S = sq.shape
    M = np.asarray(m).shape[1]
    order = np.zeros((B, C), np.int32)
    kept = np.zeros((B, C), np.int32)
    w_slot = np.zeros((B, C), np.int32)
    frac_rep = np.zeros(B, np.float32)
    steps = np.zeros(B, np.int32)
    for b in range(B):
        nch = min(max(int(ch.n[b]), 0), C)
        ord_, kp, st = order[b], kept[b], 0
        ws = [0] * C                               # the sorted keys
        n_heavy = 0
        for c in range(nch):
            k = min(max(int(ch.n_seeds[b, c]), 0), S)
            wm = min(_cover(sq[b, c], sn[b, c], k),
                     _cover(sr[b, c], sn[b, c], k))
            wt = min(wm, (1 << 30) - 1)
            w_slot[b, c] = wt
            heavy = wt >= min_chain_weight
            key = wt if heavy else -1
            n_heavy += heavy
            j = c
            while j > 0 and ws[j - 1] < key:
                ord_[j], ws[j] = ord_[j - 1], ws[j - 1]
                j -= 1
            ord_[j], ws[j] = c, key
            st += 1
        ord_[nch:] = np.arange(nch, C)
        qb, qe, alt, first = [], [], [], []
        for j in range(n_heavy):
            sj = int(ord_[j])
            k = min(max(int(ch.n_seeds[b, sj]) - 1, 0), S - 1)
            rid = int(ch.rid[b, sj])
            qb.append(int(sq[b, sj, 0]))
            qe.append(int(sq[b, sj, k]) + int(sn[b, sj, k]))
            alt.append(rid >= 0 and bool(is_alt[rid]))
            first.append(-1)
        if n_heavy > 0:
            kp[0] = 3
        for i in range(1, n_heavy):
            bi, ei, wi = qb[i], qe[i], ws[i]
            large = drop = False
            for j in range(i):
                st += 1
                if kp[j] <= 0 or (alt[j] and not alt[i]):
                    continue
                b_max, e_min = max(qb[j], bi), min(qe[j], ei)
                min_l = min(qe[j] - qb[j], ei - bi)
                if (e_min <= b_max or min_l >= max_chain_gap
                        or not float(e_min - b_max) >= min_l * mask_level):
                    continue
                large = True
                if first[j] < 0:
                    first[j] = i
                if (float(wi) < ws[j] * drop_ratio
                        and ws[j] - wi >= (min_seed_len << 1)):
                    drop = True
                    break
            kp[i] = 0 if drop else (2 if large else 3)
        for i in range(n_heavy):
            if kp[i] > 0 and first[i] >= 0:
                kp[first[i]] = 1
        r12 = 0
        for i in range(n_heavy):
            if kp[i] in (1, 2):
                r12 += 1
                if r12 >= max_chain_extend:
                    kp[i] = 0
        # frac_rep over the sorted SMEMs
        fb = fe = l_rep = 0
        for i in range(min(max(int(cnt[b]), 0), M)):
            if int(s[b, i]) <= max_occ:
                continue
            sb, se = int(m[b, i]), int(n[b, i]) + 1
            if sb > fe:
                l_rep += fe - fb
                fb, fe = sb, se
            else:
                fe = max(fe, se)
        l_rep += fe - fb
        frac_rep[b] = np.float32(l_rep) / np.float32(max(int(lens[b]), 1))
        steps[b] = st
    return order, kept, w_slot, frac_rep, steps
