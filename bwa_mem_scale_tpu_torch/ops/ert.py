"""ERT seeding: the suffix-trie descent, position-parallel.

Counterpart of ``bwa_mem_scale_tpu/ops/ert.py``. The sweep engine's FM
extension (``ops/smem.py``) is replaced by a descent of the SA-range trie
that ``index/ert.py`` builds (the reference's ERT walk,
src/ertseeding.cpp:836-975 getNextByteIdx / 2142 rightExtend, re-shaped
for independent lanes). Each lane (read, start column) takes one step a
column: on an internal node one (encoding, payload) load of its child for
the base, once its range is a single occurrence one reference-byte
compare (the reference's lazy leaf verification, src/ertseeding.cpp:2950).

Trie nodes carry true SA ranges, so the SmemBuf equals the FM seeder's in
(m, n, k, s); ``l`` (the reverse-complement side of the bi-interval) is
not in the trie and is emitted as 0, and no later stage reads it.

Three things live here:
- ``DeviceErt``: the trie on a device, with a synthetic root whose
  children are the depth-1 base ranges;
- ``ert_extend_all_positions``: the lockstep over lanes (run by
  ``ops/smem.py::run_lockstep``), the plain version of ``csrc/ert.cu``'s
  ``ert_extend_kernel`` and the CPU path;
- ``collect_smems_ert``: the JAX package's three passes around it, pass 2
  over the compacted reseed tasks (a fixed budget of 2B) and pass 3 from
  pass 1's merged records through ``smems_seed_strategy_merged`` (on
  the card ``csrc/sweep.cu``'s ``seed_strategy_merged_kernel``, the
  sweep's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.ert import ErtIndex
from .occ import host_tensor
from .smem import (SmemBuf, _emit_compact, _left_max_mask, concat_smems,
                   reseed_tasks, run_lockstep, smems_seed_strategy_merged)

CNT_BITS = 24
CNT_MASK = (1 << CNT_BITS) - 1


@dataclasses.dataclass
class DeviceErt:
    """The ERT on a device.

    rec [N + 1, 4, 2] int64: for node n and base a, (encoding, payload)
    of its child, so that a step's pair is one aligned 16-byte load. The
    encoding is the host trie's (>= 0 a node id, -1 empty, -(SA row) - 2 a
    single occurrence); the payload is (lo_or_pos << 24) | min(cnt, 2^24 -
    1), where lo_or_pos is the child's SA range start, or for a single
    occurrence its reference position (so the leaf walk needs no SA
    load, while the encoding keeps the SA row for k). Row N is the
    synthetic root. (The JAX package keeps the same values as [N + 1, 8]:
    four encodings, then four payloads.)"""

    rec: torch.Tensor      # [N + 1, 4, 2] int64
    root: int              # the synthetic root's id (N)
    count: torch.Tensor    # [5] int64, the C array (depth-1 range starts)
    max_depth: int

    @property
    def device(self) -> torch.device:
        return self.rec.device

    def nbytes(self) -> int:
        return self.rec.numel() * self.rec.element_size()

    @classmethod
    def from_host(cls, ert: ErtIndex, sa, count, device) -> "DeviceErt":
        """Pack the host trie on `device`, with the synthetic root (id N)
        whose children are the depth-1 ranges of `count`. `sa` is the full
        suffix array (row 0 the sentinel), a host array or a tensor (an
        index's SA already on the device), to resolve single occurrences'
        reference positions. The trie must come from the same text."""
        dev = torch.device(device)
        i64 = torch.int64
        N = ert.n_nodes
        sa_t = (sa if isinstance(sa, torch.Tensor)
                else host_tensor(sa, np.int64, dev))

        def payload(lo_rows, cnts):
            # a single occurrence carries SA[row], its reference position
            one = cnts == 1
            pos = sa_t[torch.where(one, lo_rows, 0)].to(i64)
            lo_or_pos = torch.where(one, pos, lo_rows)
            return (lo_or_pos << CNT_BITS) | cnts.clamp(max=CNT_MASK)

        enc = host_tensor(ert.child_ptr, np.int64, dev).reshape(N, 4)
        node_lo = host_tensor(ert.node_lo, np.int64, dev)
        node_cnt = host_tensor(ert.node_cnt, np.int64, dev)
        is_node, is_leaf = enc >= 0, enc <= -2
        at = enc.clamp(min=0)
        child_lo = torch.where(is_node, node_lo[at],
                               torch.where(is_leaf, -enc - 2, 0))
        child_cnt = torch.where(is_node, node_cnt[at], is_leaf.to(i64))
        rec = torch.empty((N + 1, 4, 2), dtype=i64, device=dev)
        rec[:N, :, 0] = enc
        rec[:N, :, 1] = torch.where(is_node | is_leaf,
                                    payload(child_lo, child_cnt), 0)
        del enc, child_lo, child_cnt, at
        # the synthetic root: the builder's depth-1 encodings
        cnt_t = host_tensor(count, np.int64, dev)
        lo1, cnt1 = cnt_t[:4], cnt_t[1:5] - cnt_t[:4]
        rec[N, :, 0] = host_tensor(ert.root_children, np.int64, dev)
        rec[N, :, 1] = torch.where(cnt1 == 0, 0, payload(lo1, cnt1))
        return cls(rec=rec, root=N, count=cnt_t, max_depth=int(ert.max_depth))


def ert_keys(merge_p3: bool) -> list:
    """The keys of ert_extend_all_positions' dict, in the JAX package's
    order."""
    keys = ["E", "k", "l", "s", "valid"]
    if merge_p3:
        keys += ["f3_s", "f3_E", "f3_k", "f3_l", "f3_ss", "died_s"]
    return keys


def ert_extend_all_positions(ert: DeviceErt, ref, codes, lens, min_intv,
                             check_initial: bool, p3_max_intv: int = 0,
                             p3_stop: int = 0,
                             pos_dtype: torch.dtype = torch.int64,
                             seq_len: int = None, stats: dict = None,
                             stats_key: str = "ert_ticks") -> dict:
    """Descend the trie from every start column of every read at once,
    lockstep over lanes (the plain version of ``csrc/ert.cu``'s
    ert_extend_kernel); the trie counterpart of
    ``smem.extend_all_positions``, with the same dict (``l`` and ``f3_l``
    zero).

    ref [>= seq_len] uint8 fw+rc codes, codes [B, L] int32, lens [B],
    min_intv [B]. Lane (b, p) starts at the root's child for its base:
    with check_initial its size must reach min_intv; it goes on only with
    a size > 0. Then one step a column j = p + t: an N or the read's end
    retires the lane with no record; a size below min_intv retires it
    (``died_s`` when merged); otherwise E = j + 1. Merged with pass 3
    (p3_max_intv, p3_stop > 0), the first step with t + 1 >= p3_stop
    whose size falls below p3_max_intv is recorded (f3_E = j, the step's
    k and size), whether the lane goes on or not. `seq_len` (2 l_pac)
    bounds the leaf walk. Keeps each lane's node and leaf steps in
    ``last_steps`` ([2, B, L] int32); `stats` gets the lockstep's ticks
    under `stats_key`."""
    B, L = codes.shape
    dev = codes.device
    pd = pos_dtype
    i32, i64 = torch.int32, torch.int64
    lens = lens.to(i32)
    pcol = torch.arange(L, dtype=i32, device=dev)[None, :]
    pcol64 = pcol.to(i64)
    mi = min_intv.to(pd)[:, None]
    base_ok = (pcol < lens[:, None]) & (codes < 4)
    merge_p3 = p3_max_intv > 0 and p3_stop > 0
    l_ref = seq_len if seq_len is not None else ref.shape[0]
    rec = ert.rec

    # step 1 from the synthetic root
    a0 = codes.clamp(0, 3).long()
    pair = rec[ert.root][a0]                          # [B, L, 2]
    enc, packed = pair[..., 0], pair[..., 1]
    s = (packed & CNT_MASK).to(pd)
    lo_or_pos = (packed >> CNT_BITS).to(pd)
    is_leaf0 = enc <= -2
    k = torch.where(is_leaf0, (-enc - 2).to(pd), lo_or_pos)
    # leaf walk offset: ref[leaf_pos + j] is the byte matching read base
    # j of this lane (leaf_pos = occurrence position - p)
    leaf_pos = torch.where(is_leaf0, lo_or_pos.to(i64) - pcol64, 0)
    active = base_ok & (s >= mi) if check_initial else base_ok
    active = active & (s > 0)
    E = torch.where(base_ok & (s >= (mi if check_initial else 1)),
                    pcol + 1, pcol)
    zb = lambda: torch.zeros((B, L), dtype=torch.bool, device=dev)
    zp = lambda: torch.zeros((B, L), dtype=pd, device=dev)
    st = dict(act=active, t=1, E=E, cur=torch.where(active, enc, -1),
              k=torch.where(active, k, 0), s=torch.where(active, s, 0),
              lp=leaf_pos, died_s=zb(), f3_s=zb(),
              f3_E=torch.zeros((B, L), dtype=i32, device=dev), f3_k=zp(),
              f3_ss=zp(),
              steps=torch.zeros((2, B, L), dtype=i32, device=dev))
    codes_pad = torch.cat([codes, torch.full((B, L + 2), 4,
                                             dtype=codes.dtype, device=dev)],
                          1)

    def body():
        t = st["t"]
        j = pcol + t
        a = codes_pad[:, min(t, codes_pad.shape[1] - L):][:, :L]
        act, cur, k, lp = st["act"], st["cur"], st["k"], st["lp"]
        do = act & (j < lens[:, None]) & (a < 4)
        on_node = cur >= 0
        ac = a.clamp(0, 3)
        # node lanes: one (encoding, payload) load
        pair = rec[cur.clamp(min=0), ac.long()]
        n_enc, n_packed = pair[..., 0], pair[..., 1]
        n_lop = n_packed >> CNT_BITS
        # leaf lanes: one reference-byte compare
        rpos = lp + j.to(i64)
        rbase = ref[rpos.clamp(0, l_ref - 1)].to(i32)
        lmatch = (rpos >= 0) & (rpos < l_ref) & (rbase == ac)
        ns = torch.where(on_node, (n_packed & CNT_MASK).to(pd),
                         lmatch.to(pd))
        new_leaf = on_node & (n_enc <= -2)
        nk = torch.where(on_node,
                         torch.where(new_leaf, (-n_enc - 2).to(pd),
                                     n_lop.to(pd)), k)
        nlp = torch.where(new_leaf, n_lop - pcol64, lp)
        ncur = torch.where(on_node, torch.where(n_enc >= 0, n_enc, -1), cur)
        sfail = do & (ns < mi)
        keep = do & ~sfail
        st["E"] = torch.where(keep, j + 1, st["E"])
        st["k"] = torch.where(keep, nk, k)
        st["s"] = torch.where(keep, ns, st["s"])
        st["lp"] = torch.where(keep, nlp, lp)
        st["cur"] = torch.where(keep, ncur, cur)
        if merge_p3:
            st["died_s"] = st["died_s"] | sfail
            fire = (do & ~st["f3_s"] & (ns < p3_max_intv)
                    & ((t + 1) >= p3_stop))
            st["f3_s"] = st["f3_s"] | fire
            st["f3_E"] = torch.where(fire, j, st["f3_E"])
            st["f3_k"] = torch.where(fire, nk, st["f3_k"])
            st["f3_ss"] = torch.where(fire, ns, st["f3_ss"])
        st["steps"][0] += (do & on_node).to(i32)
        st["steps"][1] += (do & ~on_node).to(i32)
        st["act"] = keep
        st["t"] = t + 1

    run_lockstep(body, lambda: st["act"], stats, stats_key)
    ert_extend_all_positions.last_steps = st["steps"]
    out = dict(E=st["E"], k=st["k"], l=torch.zeros_like(st["k"]), s=st["s"],
               valid=base_ok, f3_s=st["f3_s"], f3_E=st["f3_E"],
               f3_k=st["f3_k"], f3_l=torch.zeros_like(st["f3_k"]),
               f3_ss=st["f3_ss"], died_s=st["died_s"])
    return {f: out[f] for f in ert_keys(merge_p3)}


ert_extend_all_positions.last_steps = None   # [2, B, L] int32: node, leaf


class _ErtAsFmi:
    """What smems_seed_strategy_merged reads of an index (the C array at
    the position dtype), from the trie."""

    def __init__(self, ert: DeviceErt, pos_dtype):
        self.count = ert.count.to(pos_dtype)
        self.pos_dtype = pos_dtype


def collect_smems_ert(ert: DeviceErt, ref, codes, lens, *,
                      min_seed_len: int, split_len: int, split_width: int,
                      max_mem_intv: int, max_out: int = None,
                      pos_dtype: torch.dtype = torch.int64,
                      seq_len: int = None, stats: dict = None) -> SmemBuf:
    """The ERT engine's mem_collect_smem: the contract of
    ``smem.collect_smems_device`` (``l`` emitted as 0). Pass 1 merged with
    pass 3's records, pass 2 over the first 2B reseed tasks in flat order
    (a read that lost one saturates its count: the retry ladder's signal),
    pass 3's restart chain, then the per-read stable sort on (m, n).
    `seq_len` = the true fw+rc length (2 l_pac), bounding the leaf walks.
    The descents run through ``ert_cuda.ert_extend_all_positions_cuda``
    (the kernel on CUDA tensors, the plain version on CPU ones)."""
    from . import ert_cuda
    B, L = codes.shape
    dev = codes.device
    M = max_out or L
    pd = pos_dtype
    lens = lens.to(torch.int32)
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    merge = max_mem_intv > 0
    ext = ert_cuda.ert_extend_all_positions_cuda(
        ert, ref, codes, lens, ones, check_initial=True,
        p3_max_intv=max_mem_intv if merge else 0,
        p3_stop=(min_seed_len + 1) if merge else 0, pos_dtype=pd,
        seq_len=seq_len, stats=stats, stats_key="ert_ticks_p1")
    E = ext["E"]
    pcol, mask = _left_max_mask(E, L, min_seed_len)
    p1 = _emit_compact(mask, pcol.expand(B, L), E - 1, ext["k"], ext["l"],
                       ext["s"], SmemBuf.empty(B, M, dev, pd))

    # pass 2: the reseed tasks through the same descent, a fixed budget
    T = 2 * B
    t_read, t_x, t_mi, t_valid, reseed_of = reseed_tasks(
        p1, T, split_len, split_width)
    codes_t = torch.where(t_valid[:, None], codes[t_read], 4)
    lens_t = torch.where(t_valid, lens[t_read], 0)
    ext2 = ert_cuda.ert_extend_all_positions_cuda(
        ert, ref, codes_t.to(torch.int32), lens_t.to(torch.int32),
        t_mi.to(torch.int32), check_initial=True, pos_dtype=pd,
        seq_len=seq_len, stats=stats, stats_key="ert_ticks_p2")
    E2 = ext2["E"]
    pcol, mask2 = _left_max_mask(E2, L, min_seed_len)
    mask2 = (mask2 & t_valid[:, None] & (pcol <= t_x[:, None])
             & (E2 > t_x[:, None]))
    p2 = _emit_compact(mask2, pcol.expand(T, L), E2 - 1, ext2["k"],
                       ext2["l"], ext2["s"], SmemBuf.empty(B, M, dev, pd),
                       rows=t_read)

    parts = [p1, p2]
    if merge:
        parts.append(smems_seed_strategy_merged(
            _ErtAsFmi(ert, pd), codes, lens, ext, max_mem_intv,
            min_seed_len + 1, M, stats=stats))
    comb = concat_smems(*parts)
    valid = torch.cat([torch.arange(b.m.shape[1], device=dev)[None, :]
                       < b.cnt[:, None] for b in parts], dim=1)
    key = torch.where(valid, (comb.m.long() << 32) | comb.n.long(), 1 << 62)
    _, perm = torch.sort(key, dim=1, stable=True)
    g = lambda a: a.gather(1, perm)
    cnt = torch.where(reseed_of, comb.m.shape[1], comb.cnt)
    return SmemBuf(g(comb.m), g(comb.n), g(comb.k), g(comb.l), g(comb.s),
                   cnt.to(torch.int32))
