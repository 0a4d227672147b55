"""Seed chaining and chain filtering on tensors.

Counterpart of ``bwa_mem_scale_tpu/ops/chain.py`` (mem_chain_seeds and
mem_chain_flt, src/bwamem.cpp:528-960): per read a sorted key array of
chain anchors (the B-tree lower bound becomes a count of keys <= rbeg)
and a slot table with the chain data; seeds arrive in SMEM order, then
interval order, and are appended exactly as the reference inserts
them. Per-lane reads and writes are direct indexed gathers/scatters.

These are the plain versions of the two chaining kernels of
csrc/chain.cu (``ops/chain_cuda.py``), which the pipeline calls; the
lower-bound chain counts only the n live keys, so a seed at or above the
empty-key marker BIG (2^29 - 1, reached by reverse-strand hits once
l_pac passes ~268 Mbp) still finds its neighbour, as the reference's
B-tree does (the JAX package counts all C keys there).

Reference positions (rbeg, the chain keys and the seeds' rbeg plane) take
the dtype of the rbeg they are given, int32 or int64 as the index's
positions, and the empty key is that dtype's maximum // 4 (``big_key``),
as in the JAX package; every other field stays int32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# the key of an empty anchor position (int32 max // 4, as the JAX package)
BIG = np.iinfo(np.int32).max // 4


def big_key(dtype: torch.dtype) -> int:
    """The empty-anchor key of a position dtype: its maximum // 4."""
    return torch.iinfo(dtype).max // 4


@dataclasses.dataclass
class DeviceBns:
    """Contig metadata on device (bns_pos2rid / bns_intv2rid)."""
    offsets: torch.Tensor     # int64 [n_seqs]
    is_alt: torch.Tensor      # bool [n_seqs]
    l_pac: int

    @classmethod
    def from_host(cls, bns, device) -> "DeviceBns":
        dev = torch.device(device)
        return cls(offsets=torch.as_tensor(np.asarray(bns.offsets,
                                                      np.int64),
                                           device=dev),
                   is_alt=torch.as_tensor(np.asarray(bns.is_alt, bool),
                                          device=dev),
                   l_pac=int(bns.l_pac))

    def depos(self, pos):
        is_rev = pos >= self.l_pac
        pos_f = torch.where(is_rev, (self.l_pac << 1) - 1 - pos, pos)
        return pos_f, is_rev

    def pos2rid(self, pos_f):
        rid = (torch.searchsorted(self.offsets, pos_f.to(torch.int64),
                                  right=True) - 1).to(torch.int32)
        return torch.where(pos_f >= self.l_pac, -1, rid)

    def intv2rid(self, rb, re):
        rid_b = self.pos2rid(self.depos(rb)[0])
        re1 = torch.where(rb < re, re - 1, rb)
        rid_e = self.pos2rid(self.depos(re1)[0])
        rid = torch.where(rid_b == rid_e, rid_b, -1)
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        return torch.where(bridging, -2, rid)


class Chains(NamedTuple):
    """Per-read chain set (slot-ordered data + key-sorted permutation)."""
    key: torch.Tensor         # [B, C] sorted anchor rbeg (invalid =
                              #   big_key of rbeg's dtype)
    slot: torch.Tensor        # [B, C] data slot per sorted position
    n: torch.Tensor           # [B] number of chains
    rid: torch.Tensor         # [B, C] by slot
    n_seeds: torch.Tensor     # [B, C] by slot
    seed_qbeg: torch.Tensor   # [B, C, S]
    seed_rbeg: torch.Tensor   # [B, C, S] of rbeg's dtype
    seed_len: torch.Tensor    # [B, C, S]
    seed_score: torch.Tensor  # [B, C, S]
    overflow: torch.Tensor    # [B] any chain/seed capacity overflow


def chain_seeds_device(bns: DeviceBns, smems, rbeg, seed_idx, coord_valid,
                       *, w: int, max_chain_gap: int, max_chains: int,
                       max_seeds_per_chain: int,
                       stats: dict = None) -> Chains:
    """Chain the SA-expanded seeds of a batch (rbeg/seed_idx/
    coord_valid [B, NC] from expand_and_lookup, smems sorted)."""
    B, NC = rbeg.shape
    C, S = max_chains, max_seeds_per_chain
    dev = rbeg.device
    i32, pd = torch.int32, rbeg.dtype
    b = torch.arange(B, device=dev)
    si = seed_idx.long()
    qbeg_all = smems.m.gather(1, si)
    slen_all = smems.n.gather(1, si) + 1 - qbeg_all

    key = torch.full((B, C), big_key(pd), dtype=pd, device=dev)
    slot = torch.zeros((B, C), dtype=i32, device=dev)
    n = torch.zeros((B,), dtype=i32, device=dev)
    rid_t = torch.full((B, C), -1, dtype=i32, device=dev)
    n_seeds = torch.zeros((B, C), dtype=i32, device=dev)
    sq = torch.zeros((B, C, S), dtype=i32, device=dev)
    sr = torch.zeros((B, C, S), dtype=pd, device=dev)
    sl = torch.zeros((B, C, S), dtype=i32, device=dev)
    overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    col = torch.arange(C, device=dev)[None, :]

    # only as far as the longest coordinate list in the batch
    n_coord = int(coord_valid.sum(1).max()) if B else 0
    for c in range(n_coord):
        valid = coord_valid[:, c]
        s_rbeg = rbeg[:, c]
        s_qbeg = qbeg_all[:, c]
        s_len = slen_all[:, c]
        rid = bns.intv2rid(s_rbeg, s_rbeg + s_len)
        valid = valid & (rid >= 0)

        # lower-bound chain: largest live key <= rbeg (keys past n are
        # the empty key, which an int32 seed's rbeg can reach)
        pos = ((key <= s_rbeg[:, None]) & (col < n[:, None])).sum(
            1, dtype=i32)
        li = pos - 1
        has_lower = valid & (li >= 0)
        lslot = slot.gather(1, li.clamp(0, C - 1).long()[:, None])[:, 0]
        ls = lslot.long()

        # test_and_merge (src/bwamem.cpp:379-421)
        ln = n_seeds[b, ls]
        last_i = (ln - 1).clamp(0, S - 1).long()
        last_qbeg = sq[b, ls, last_i]
        last_rbeg = sr[b, ls, last_i]
        last_len = sl[b, ls, last_i]
        first_qbeg = sq[b, ls, 0]
        first_rbeg = sr[b, ls, 0]
        qend = last_qbeg + last_len
        rend = last_rbeg + last_len
        same_rid = rid == rid_t[b, ls]
        contained = (same_rid
                     & (s_qbeg >= first_qbeg) & (s_qbeg + s_len <= qend)
                     & (s_rbeg >= first_rbeg) & (s_rbeg + s_len <= rend))
        diff_strand = (((last_rbeg < bns.l_pac) | (first_rbeg < bns.l_pac))
                       & (s_rbeg >= bns.l_pac))
        x = s_qbeg - last_qbeg
        y = s_rbeg - last_rbeg
        growable = (same_rid & ~contained & ~diff_strand
                    & (y >= 0) & (x - y <= w) & (y - x <= w)
                    & (x - last_len < max_chain_gap)
                    & (y - last_len < max_chain_gap))
        grow = has_lower & growable
        merged = has_lower & (contained | growable)

        seed_of = grow & (ln >= S)
        do_app = grow & ~seed_of
        new = valid & ~merged
        chain_of = new & (n >= C)
        new_ok = new & ~chain_of

        # append at (lslot, ln) or start a chain at (n, 0): one write
        do_w = do_app | new_ok
        wslot = torch.where(do_app, lslot, n).clamp(max=C - 1).long()
        wpos = torch.where(do_app, ln, 0).clamp(max=S - 1).long()
        for arr, v in ((sq, s_qbeg), (sr, s_rbeg), (sl, s_len)):
            arr[b, wslot, wpos] = torch.where(do_w, v, arr[b, wslot, wpos])
        ns_old = n_seeds[b, wslot]
        n_seeds[b, wslot] = torch.where(
            do_app, ns_old + 1, torch.where(new_ok, 1, ns_old))
        rid_t[b, wslot] = torch.where(new_ok, rid, rid_t[b, wslot])
        overflow = overflow | seed_of | chain_of

        # sorted insert of (key, slot) after all keys <= rbeg
        shift = (new_ok[:, None] & (col > pos[:, None])
                 & (col <= n[:, None]))
        key_prev = torch.cat([key[:, :1], key[:, :-1]], dim=1)
        slot_prev = torch.cat([slot[:, :1], slot[:, :-1]], dim=1)
        isel = new_ok[:, None] & (col == pos[:, None])
        key = torch.where(isel, s_rbeg[:, None],
                          torch.where(shift, key_prev, key))
        slot = torch.where(isel, n[:, None],
                           torch.where(shift, slot_prev, slot))
        n = n + new_ok.to(i32)
    if stats is not None:
        stats["chain_steps"] = stats.get("chain_steps", 0) + n_coord
    return Chains(key=key, slot=slot, n=n, rid=rid_t, n_seeds=n_seeds,
                  seed_qbeg=sq, seed_rbeg=sr, seed_len=sl,
                  seed_score=sl.clone(), overflow=overflow)


def frac_rep_device(smems, lens, max_occ: int):
    """Per-read repetitive fraction (mem_chain_seeds prologue,
    src/bwamem.cpp:836-846). smems must be (m, n)-sorted."""
    B, M = smems.m.shape
    dev = smems.m.device
    valid = torch.arange(M, device=dev)[None, :] < smems.cnt[:, None]
    over = valid & (smems.s > max_occ)
    b = e = l_rep = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(M):
        sb = smems.m[:, i]
        se = smems.n[:, i] + 1
        act = over[:, i]
        new_seg = act & (sb > e)
        l_rep = torch.where(new_seg, l_rep + (e - b), l_rep)
        b = torch.where(new_seg, sb, b)
        e = torch.where(act, torch.where(new_seg, se, torch.maximum(e, se)),
                        e)
    l_rep = l_rep + (e - b)
    return l_rep.to(torch.float32) / lens.clamp(min=1).to(torch.float32)


def chain_weights(ch: Chains) -> torch.Tensor:
    """Per-chain weight (mem_chain_weight, src/bwamem.cpp:452-471).
    Returns [B, C] int32 by slot."""
    B, C, S = ch.seed_qbeg.shape
    dev = ch.seed_qbeg.device
    svalid = torch.arange(S, device=dev)[None, None, :] \
        < ch.n_seeds[:, :, None]

    def scan_axis(beg, length):
        end = wsum = torch.zeros((B, C), dtype=torch.int64, device=dev)
        for i in range(S):
            bb = beg[:, :, i]
            ll = length[:, :, i].to(torch.int64)
            act = svalid[:, :, i]
            add = torch.where(bb >= end, ll,
                              torch.where(bb + ll > end, bb + ll - end, 0))
            wsum = wsum + torch.where(act, add, 0)
            end = torch.where(act, torch.maximum(end, bb + ll), end)
        return wsum

    wq = scan_axis(ch.seed_qbeg.to(torch.int64), ch.seed_len)
    wr = scan_axis(ch.seed_rbeg.to(torch.int64), ch.seed_len)
    w = torch.minimum(wq, wr)
    return torch.clamp(w, max=(1 << 30) - 1).to(torch.int32)


def chain_filter_device(ch: Chains, bns: DeviceBns, *,
                        min_chain_weight: int, mask_level: float,
                        max_chain_gap: int, drop_ratio: float,
                        min_seed_len: int, max_chain_extend: int):
    """mem_chain_flt in lockstep. Returns (order [B, C] slot indices in
    weight-sorted order, kept [B, C] by sorted position (3 kept, 2 kept
    with a large overlap, 1 kept as another chain's first overlap,
    0 dropped), weights [B, C] by slot)."""
    B, C, S = ch.seed_qbeg.shape
    dev = ch.seed_qbeg.device
    b = torch.arange(B, device=dev)[:, None]
    w_by_slot = chain_weights(ch)
    slot_valid = torch.arange(C, device=dev)[None, :] < ch.n[:, None]
    heavy = slot_valid & (w_by_slot >= min_chain_weight)
    # weight descending (invalid last); ties keep slot order
    sort_w = torch.where(heavy, w_by_slot, -1)
    order = torch.argsort(-sort_w, dim=1, stable=True).to(torch.int32)
    o = order.long()
    n_valid = heavy.sum(1, dtype=torch.int32)

    w_sorted = sort_w.gather(1, o)
    ns = ch.n_seeds.gather(1, o)
    last_i = (ns - 1).clamp(0, S - 1).long()
    qbeg0 = ch.seed_qbeg[:, :, 0].gather(1, o)
    qend = ch.seed_qbeg[b, o, last_i] + ch.seed_len[b, o, last_i]
    rid_sorted = ch.rid.gather(1, o)
    alt = (rid_sorted >= 0) & bns.is_alt[rid_sorted.long().clamp(min=0)]
    # float64: jnp promotes int32 * python float to the x64 default
    w_drop = w_sorted.to(torch.float64) * drop_ratio

    kept = torch.zeros((B, C), dtype=torch.int32, device=dev)
    first = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    kept[:, 0] = torch.where(n_valid > 0, 3, 0)
    col = torch.arange(C, device=dev)[None, :]
    for i in range(1, C):
        active = i < n_valid
        bi, ei = qbeg0[:, i:i + 1], qend[:, i:i + 1]
        is_kept_j = (col < i) & (kept > 0)
        b_max = torch.maximum(qbeg0, bi)
        e_min = torch.minimum(qend, ei)
        alt_ok = ~alt | alt[:, i:i + 1]
        min_l = torch.minimum(qend - qbeg0, ei - bi)
        signif = ((e_min > b_max) & alt_ok & is_kept_j
                  & ((e_min - b_max) >= min_l.to(torch.float64)
                     * mask_level)
                  & (min_l < max_chain_gap))
        # weight-drop break: the first significant j that dominates i
        wi = w_sorted[:, i:i + 1]
        dom = (signif & (wi.to(torch.float64) < w_drop)
               & ((w_sorted - wi) >= (min_seed_len << 1)))
        drop = dom.any(1)
        jbreak = torch.where(drop, torch.argmax(dom.to(torch.int32), 1), C)
        processed = col <= jbreak[:, None]
        large_ovlp = (signif & processed).any(1)
        set_first = signif & processed & (first < 0) & active[:, None]
        first = torch.where(set_first, i, first)
        keep_i = active & ~drop
        kept = torch.where((col == i) & keep_i[:, None],
                           torch.where(large_ovlp, 2, 3)[:, None], kept)
    # chains referenced by a kept chain's `first` get kept = 1
    for i in range(C):
        f = first[:, i:i + 1]
        do = (kept[:, i:i + 1] > 0) & (f >= 0)
        kept = torch.where((col == f) & do, 1, kept)
    # cap the number of kept == 1/2 chains
    is12 = (kept == 1) | (kept == 2)
    rank12 = torch.cumsum(is12.to(torch.int32), 1)
    over_cap = is12 & (rank12 >= max_chain_extend) & (kept < 3)
    kept = torch.where(over_cap, 0, kept).to(torch.int32)
    return order, kept, w_by_slot


def chain_filter_frac_rep(ch: Chains, bns: DeviceBns, smems, lens, *,
                          min_chain_weight: int, mask_level: float,
                          max_chain_gap: int, drop_ratio: float,
                          min_seed_len: int, max_chain_extend: int,
                          max_occ: int, stats: dict = None):
    """The plain version of csrc/chain.cu's chain_filter_kernel, which
    also computes frac_rep in its launch: (order, kept, w_by_slot) of
    chain_filter_device and frac_rep_device's [B] float32. `stats` keeps
    the kernel wrapper's signature and gets nothing: the lockstep has no
    data-dependent loop to count."""
    return (*chain_filter_device(
        ch, bns, min_chain_weight=min_chain_weight, mask_level=mask_level,
        max_chain_gap=max_chain_gap, drop_ratio=drop_ratio,
        min_seed_len=min_seed_len, max_chain_extend=max_chain_extend),
        frac_rep_device(smems, lens, max_occ))
