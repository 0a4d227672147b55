"""SMEM buffers, the compaction helpers the seeding engines share, and
the position-parallel sweep engine.

Counterpart of ``bwa_mem_scale_tpu/ops/smem.py``. The sweep
(``collect_smems_device``) finds every SMEM from the longest valid match
E(p) of each start column p: pass 1 and pass 3's failure records come
from one forward extension of every (read, start) lane
(``extend_all_positions``, optionally started from the FMA ladder table
of ``ops/fma.py``) and its emission, pass 2 runs the same extension over
the compacted reseed tasks, and pass 3 replays its restart chain from
the records (``smems_seed_strategy_merged``). Each pass (its extension
with its emission) and the merged stage run as the kernels of
``csrc/sweep.cu`` through ``ops/sweep_cuda.py`` on CUDA tensors; the
versions here (``sweep_pass_plain``: the lockstep
``extend_all_positions``, ``_left_max_mask`` and ``_emit_compact``;
``seed_strategy_merged_plain``: the glue with the lockstep
``strategy_chase``) are their plain versions and the CPU path. The glue
is torch ops in the JAX package's order, so every array equals its. With
a k-gram checkpoint table on the index the extension takes the JAX
loop's 2-step body (``body2``: two bases a tick, a trigram table's
bigram part). Out of scope: the non-merged ``smems_all_pos`` /
``smems_seed_strategy``, which no path of the JAX package reaches.

Scatters that JAX writes as ``.at[...].set(..., mode="drop")`` land here
in a buffer one slot wider than needed: dropped writes go to the extra
slot, which is cut off afterwards, so no write needs a host-side mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .occ import DeviceFMIndex, forward_ext, forward_ext2


class SmemBuf(NamedTuple):
    """Per-read SMEM output buffers ([B, M] each) + counts [B]: m, n and
    cnt int32, k, l and s of the index's position dtype."""
    m: torch.Tensor
    n: torch.Tensor
    k: torch.Tensor
    l: torch.Tensor
    s: torch.Tensor
    cnt: torch.Tensor

    @classmethod
    def empty(cls, B: int, M: int, device,
              pos_dtype: torch.dtype = torch.int32) -> "SmemBuf":
        z = lambda dt: torch.zeros((B, M), dtype=dt, device=device)
        i32 = torch.int32
        return cls(z(i32), z(i32), z(pos_dtype), z(pos_dtype), z(pos_dtype),
                   torch.zeros((B,), dtype=i32, device=device))


def compact_indices(flat: torch.Tensor, T: int):
    """Indices of the first T set lanes of the bool vector `flat`, in
    lane order. Returns (order [T] int32, valid [T] bool); order is 0
    on invalid slots."""
    n = flat.shape[0]
    rank = torch.cumsum(flat.to(torch.int32), 0) - 1
    tgt = torch.where(flat & (rank < T), rank, T).long()
    order = torch.zeros(T + 1, dtype=torch.int32, device=flat.device)
    order[tgt] = torch.arange(n, dtype=torch.int32, device=flat.device)
    valid = torch.arange(T, device=flat.device) < (rank[-1] + 1)
    return order[:T], valid


def concat_smems(*bufs: SmemBuf) -> SmemBuf:
    cat = lambda f: torch.cat([getattr(b, f) for b in bufs], dim=1)
    return SmemBuf(cat("m"), cat("n"), cat("k"), cat("l"), cat("s"),
                   sum(b.cnt for b in bufs))


def _emit_compact(mask, cols_m, cols_n, k, l, s, out: SmemBuf, rows=None):
    """Scatter every masked task record into its read's slots at once.

    mask/values [T, L], rows [T] = task -> read (tasks sorted by read;
    None: task t is read t). Slot = the read's running count + the
    emissions of its earlier tasks + the within-task rank, in column
    order; slots past the buffer width drop (the count still grows)."""
    B, M = out.m.shape
    T, L = mask.shape
    dev = mask.device
    rows = (torch.arange(T, device=dev) if rows is None else rows.long())
    rank = torch.cumsum(mask.to(torch.int32), 1) - 1
    counts_t = mask.sum(1, dtype=torch.int32)
    csum_ex = torch.cumsum(counts_t, 0, dtype=torch.int32) - counts_t
    first_csum = torch.full((B,), 1 << 30, dtype=torch.int32, device=dev)
    first_csum = first_csum.scatter_reduce(0, rows, csum_ex, "amin")
    base = (out.cnt[rows] + csum_ex - first_csum[rows])[:, None]
    counts_add = torch.zeros((B,), dtype=torch.int32, device=dev
                             ).index_add(0, rows, counts_t)
    col = torch.where(mask, base + rank, M).clamp(max=M).long()
    row_idx = rows[:, None].expand(T, L)

    def put(dst, v):
        wide = torch.cat([dst, dst[:, :1]], dim=1).clone()
        wide[row_idx, col] = v.to(dst.dtype)
        return wide[:, :M]

    return SmemBuf(put(out.m, cols_m), put(out.n, cols_n), put(out.k, k),
                   put(out.l, l), put(out.s, s), out.cnt + counts_add)


def reseed_tasks(p1: SmemBuf, T: int, split_len: int, split_width: int):
    """Pass 2's tasks from pass 1's SMEMs: the midpoint of each SMEM of
    at least split_len bases with at most split_width occurrences, at a
    minimum interval of its occurrences + 1, the first T in read order.
    Returns (t_read, t_x, t_mi, t_valid) [T] and the reads whose
    candidates overflowed the budget T [B]."""
    B, Me = p1.m.shape
    valid = torch.arange(Me, device=p1.m.device)[None, :] < p1.cnt[:, None]
    cand = (valid & ((p1.n + 1 - p1.m) >= split_len)
            & (p1.s <= split_width))
    flat = cand.reshape(B * Me)
    # reseed lane budget: candidates past T force the retry ladder
    order, t_valid = compact_indices(flat, T)
    rank = torch.cumsum(flat.to(torch.int32), 0) - 1
    reseed_of = (flat & (rank >= T)).reshape(B, Me).any(1)
    t_read = (order // Me).long()
    t_slot = (order % Me).long()
    t_x = (p1.n[t_read, t_slot] + 1 + p1.m[t_read, t_slot]) >> 1
    t_mi = torch.where(t_valid, p1.s[t_read, t_slot] + 1, 1)
    return t_read, t_x, t_mi, t_valid, reseed_of


def reseed_task_list(p1: SmemBuf, T: int, split_len: int, split_width: int):
    """``reseed_tasks`` and each read's first task and task count [B]
    int32 (its tasks are first .. first + count - 1): the plain version of
    ``smem_cuda.reseed_tasks_cuda``."""
    t_read, t_x, t_mi, t_valid, reseed_of = reseed_tasks(p1, T, split_len,
                                                         split_width)
    B = p1.m.shape[0]
    i32 = torch.int32
    count = torch.zeros((B + 1,), dtype=i32, device=p1.m.device).index_add_(
        0, torch.where(t_valid, t_read, B), torch.ones_like(t_x))[:B]
    first = torch.cumsum(count, 0, dtype=i32) - count
    return t_read, t_x, t_mi, t_valid, reseed_of, first, count


def merge_smems_plain(p1: SmemBuf, p2t: SmemBuf, p3, t_read, t_valid,
                      first, count, reseed_of, pass_of: bool) -> SmemBuf:
    """The seeding engines' glue after their walks (the plain version of
    ``smem_cuda.merge_smems_cuda``, with its signature): pass 2's task
    rows p2t [T, M] into their reads' rows by t_read and t_valid
    (``_emit_compact``; the kernel's first and count go unread here), the
    concat of pass 1, pass 2 and pass 3 (None: two passes), the stable
    per-read sort on (m << 16) | n with the invalid slots last, and the
    counts: the width where the read overflowed the task list (reseed_of)
    or, with pass_of (the one-hot engine), where pass 1, one of its
    pass-2 tasks or pass 3 reached M."""
    dev = p1.m.device
    B, M = p1.m.shape
    t_read = t_read.long()
    tmask = ((torch.arange(M, device=dev)[None, :] < p2t.cnt[:, None])
             & t_valid[:, None])
    p2 = _emit_compact(tmask, p2t.m, p2t.n, p2t.k, p2t.l, p2t.s,
                       SmemBuf.empty(B, M, dev, p1.k.dtype), rows=t_read)
    parts = [p1, p2] + ([] if p3 is None else [p3])
    of = reseed_of
    if pass_of:
        p2_of = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
        p2_of = p2_of.scatter_reduce(
            0, torch.where(t_valid, t_read, B),
            ((p2t.cnt >= M) & t_valid).to(torch.int32), "amax")[:B] > 0
        of = of | (p1.cnt >= M) | p2_of
        if p3 is not None:
            of = of | (p3.cnt >= M)
    comb = concat_smems(*parts)
    valid = torch.cat([torch.arange(M, device=dev)[None, :] < b.cnt[:, None]
                       for b in parts], dim=1)
    key = torch.where(valid, (comb.m << 16) | comb.n, 1 << 30)
    _, perm = torch.sort(key, dim=1, stable=True)
    g = lambda a: a.gather(1, perm)
    cnt = torch.where(of, comb.m.shape[1], comb.cnt)
    return SmemBuf(g(comb.m), g(comb.n), g(comb.k), g(comb.l), g(comb.s),
                   cnt.to(torch.int32))


# ---- the position-parallel sweep ------------------------------------------

# the lockstep machines (here and in ops/smem_oh.py) test their exit (a
# host sync on a GPU) once every CHECK_EVERY ticks; a retired lane is a
# strict no-op
CHECK_EVERY = 8


def sweep_window(fma, stop_min_len: int, p3_max_intv: int, p3_stop: int):
    """(merge_p3, K_eff): whether the sweep records pass 3's failures, and
    the steps its lanes take from the FMA ladder (0: none). K_eff stays
    below any stop length, so no stop or pass-3 failure falls inside the
    window; below 2 the table is not used."""
    merge_p3 = p3_max_intv > 0 and p3_stop > 0
    K_eff = 0
    if fma is not None:
        K_eff = fma.K if stop_min_len <= 0 else min(fma.K, stop_min_len - 1)
        if merge_p3:
            K_eff = min(K_eff, p3_stop - 1)
    return merge_p3, (K_eff if K_eff >= 2 else 0)


def sweep_keys(want_fail: bool, merge_p3: bool) -> list:
    """The keys of extend_all_positions' dict, in the JAX package's
    order."""
    keys = ["E", "k", "l", "s"]
    if want_fail:
        keys += ["fail_s", "fail_k", "fail_l", "fail_ss"]
    if merge_p3:
        keys += ["f3_s", "f3_E", "f3_k", "f3_l", "f3_ss", "died_s"]
    return keys + ["valid"]


def run_lockstep(body, pending, stats, key):
    """Run `body` until no lane is pending (`pending()`, a bool tensor),
    testing every CHECK_EVERY ticks; count the ticks into stats[key]."""
    ticks = 0
    while bool(pending().any()):
        for _ in range(CHECK_EVERY):
            body()
        ticks += CHECK_EVERY
    if stats is not None:
        stats[key] = stats.get(key, 0) + ticks


def extend_all_positions(fmi: DeviceFMIndex, codes, lens, min_intv,
                         check_initial: bool, want_fail: bool,
                         stop_min_len: int = 0, fma=None,
                         p3_max_intv: int = 0, p3_stop: int = 0,
                         n_pos: int = 0, stats: dict = None,
                         stats_key: str = "sweep_ticks"):
    """Forward-extend from every start column p < n_pos (default L) of
    every read at once, lockstep over lanes (the plain version of
    ``csrc/sweep.cu``'s sweep_extend_kernel).

    codes [B, L] int32, lens [B], min_intv [B] (per read or task).
    check_initial: the 1-bp interval itself needs >= min_intv
    occurrences (passes 1-2); pass 3 starts unconditionally. Returns a
    dict of [B, P] arrays: E (exclusive end of the longest valid match
    from p), k/l/s (its bi-interval), valid; with want_fail fail_s /
    fail_k / fail_l / fail_ss (the lane retired on an interval-size
    failure, and that interval); with p3_max_intv/p3_stop (pass 1 with
    min_intv 1) pass 3's merged records f3_s / f3_E / f3_k / f3_l /
    f3_ss (the first step of length >= p3_stop whose size drops below
    p3_max_intv) and died_s. With `fma` (``ops/fma.DeviceFmaTable``) the
    first K_eff steps come from the ladder (``sweep_window``). With a
    k-gram table (``fmi.kstep`` > 1) a tick extends every lane by two bases
    from one row fetch (the JAX loop's ``body2``), every record evaluated
    at both depths. Keeps each lane's single-base forward steps (occ
    extensions, the same at every K) in ``last_steps``; `stats` gets the
    lockstep's ticks under `stats_key`."""
    from .fma import fast_forward
    B, L = codes.shape
    P = n_pos or L
    dev = codes.device
    pd = fmi.pos_dtype
    count = fmi.count
    lens = lens.to(torch.int32)
    pcol = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    mi = min_intv.to(pd)[:, None]
    base_ok = (pcol < lens[:, None]) & (codes[:, :P] < 4)
    merge_p3, K_eff = sweep_window(fma, stop_min_len, p3_max_intv, p3_stop)
    zb = lambda: torch.zeros((B, P), dtype=torch.bool, device=dev)
    zp = lambda: torch.zeros((B, P), dtype=pd, device=dev)
    died_s = zb()
    if K_eff:
        E, k, l, s, act, ff_died = fast_forward(fmi, fma, codes, lens, mi,
                                                check_initial, K_eff, P)
        if merge_p3:
            died_s = ff_died
        off = K_eff - 1
    else:
        off = 0
        a0c = codes[:, :P].clamp(0, 3).long()
        k, l = count[a0c], count[3 - a0c]
        s = count[a0c + 1] - k
        act = base_ok & (s >= mi) if check_initial else base_ok
        E = torch.where(act, pcol + 1, pcol)
        k, l, s = (torch.where(act, v, 0) for v in (k, l, s))
    st = dict(E=E, k=k, l=l, s=s, fail_s=zb(), fail_k=zp(), fail_l=zp(),
              fail_ss=zp(), died_s=died_s, f3_s=zb(),
              f3_E=torch.zeros((B, P), dtype=torch.int32, device=dev),
              f3_k=zp(), f3_l=zp(), f3_ss=zp(),
              act=act, t=1,
              steps=torch.zeros((B, P), dtype=torch.int32, device=dev))
    # every lane takes the same relative offset a tick: one slice of a
    # padded copy (clamped once every lane has retired)
    codes_pad = torch.cat([codes, torch.full((B, L + 2), 4,
                                             dtype=codes.dtype, device=dev)],
                          1)

    def body():
        t = st["t"]
        j = pcol + off + t
        a = codes_pad[:, min(off + t, codes_pad.shape[1] - P):][:, :P]
        do = st["act"] & (j < lens[:, None]) & (a < 4)
        nk, nl, ns = forward_ext(fmi, st["k"], st["l"], st["s"],
                                 a.clamp(0, 3))
        sfail = do & (ns < mi)
        if stop_min_len > 0:
            # pass-3 rule: stop only once the seed is long enough
            sfail = sfail & ((j - pcol + 1) >= stop_min_len)
        keep = do & ~sfail
        st["E"] = torch.where(keep, j + 1, st["E"])
        for f, v in (("k", nk), ("l", nl), ("s", ns)):
            st[f] = torch.where(keep, v, st[f])
        if want_fail:
            st["fail_s"] = st["fail_s"] | sfail
            for f, v in (("fail_k", nk), ("fail_l", nl), ("fail_ss", ns)):
                st[f] = torch.where(sfail, v, st[f])
        if merge_p3:
            st["died_s"] = st["died_s"] | sfail
            fire = (do & ~st["f3_s"] & (ns < p3_max_intv)
                    & ((off + t + 1) >= p3_stop))
            st["f3_s"] = st["f3_s"] | fire
            st["f3_E"] = torch.where(fire, j, st["f3_E"])
            for f, v in (("f3_k", nk), ("f3_l", nl), ("f3_ss", ns)):
                st[f] = torch.where(fire, v, st[f])
        st["steps"] = st["steps"] + do.to(torch.int32)
        st["act"] = keep
        st["t"] = t + 1

    def body2():
        # two bases a tick: a lane whose walk ends after the first takes
        # the single-step result, every record evaluated at both depths
        t = st["t"]
        j = pcol + off + t
        c0 = min(off + t, codes_pad.shape[1] - P - 1)
        a = codes_pad[:, c0:][:, :P]
        b = codes_pad[:, c0 + 1:][:, :P]
        do1 = st["act"] & (j < lens[:, None]) & (a < 4)
        (k1, l1, s1), (k2, l2, s2) = forward_ext2(
            fmi, st["k"], st["l"], st["s"], a.clamp(0, 3), b.clamp(0, 3))
        sfail1 = do1 & (s1 < mi)
        if stop_min_len > 0:
            sfail1 = sfail1 & ((j - pcol + 1) >= stop_min_len)
        keep1 = do1 & ~sfail1
        do2 = keep1 & ((j + 1) < lens[:, None]) & (b < 4)
        sfail2 = do2 & (s2 < mi)
        if stop_min_len > 0:
            sfail2 = sfail2 & ((j - pcol + 2) >= stop_min_len)
        keep2 = do2 & ~sfail2
        pick = lambda c2, v2, c1, v1, v: torch.where(
            c2, v2, torch.where(c1, v1, v))
        st["E"] = pick(keep2, j + 2, keep1, j + 1, st["E"])
        for f, v1, v2 in (("k", k1, k2), ("l", l1, l2), ("s", s1, s2)):
            st[f] = pick(keep2, v2, keep1, v1, st[f])
        if want_fail:
            st["fail_s"] = st["fail_s"] | sfail1 | sfail2
            for f, v1, v2 in (("fail_k", k1, k2), ("fail_l", l1, l2),
                              ("fail_ss", s1, s2)):
                st[f] = pick(sfail1, v1, sfail2, v2, st[f])
        if merge_p3:
            st["died_s"] = st["died_s"] | sfail1 | sfail2
            fire1 = (do1 & ~st["f3_s"] & (s1 < p3_max_intv)
                     & ((off + t + 1) >= p3_stop))
            fire2 = (do2 & ~(st["f3_s"] | fire1) & (s2 < p3_max_intv)
                     & ((off + t + 2) >= p3_stop))
            st["f3_s"] = st["f3_s"] | fire1 | fire2
            st["f3_E"] = pick(fire1, j, fire2, j + 1, st["f3_E"])
            for f, v1, v2 in (("f3_k", k1, k2), ("f3_l", l1, l2),
                              ("f3_ss", s1, s2)):
                st[f] = pick(fire1, v1, fire2, v2, st[f])
        st["steps"] = st["steps"] + do1.to(torch.int32) + do2.to(torch.int32)
        st["act"] = keep2
        st["t"] = t + 2

    run_lockstep(body2 if fmi.kstep > 1 else body, lambda: st["act"], stats,
                 stats_key)
    extend_all_positions.last_steps = st["steps"]
    st["valid"] = base_ok
    return {f: st[f] for f in sweep_keys(want_fail, merge_p3)}


extend_all_positions.last_steps = None       # [B, P] int32, on its device


def strategy_chase(emit, E3, nxt, f3_k, f3_l, f3_ss, lens, max_out: int,
                   stats: dict = None) -> SmemBuf:
    """Pass 3's restart chain, lockstep over reads (part of the plain
    version of ``csrc/sweep.cu``'s seed_strategy_merged_kernel): from
    column 0 each read emits (pos, E3, f3_k, f3_l, f3_ss) where `emit`
    holds and moves to nxt[pos], while pos is inside the read and below
    P. All [B, P]; the emission past max_out is dropped while the count
    grows. Keeps each read's chase steps in ``last_steps``; `stats` gets
    the ticks under ``chase_ticks``."""
    B, P = emit.shape
    dev = emit.device
    M = max_out
    lens = lens.to(torch.int32)
    bidx = torch.arange(B, device=dev)
    bufs = [torch.zeros((B, M + 1), dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, f3_k.dtype, f3_k.dtype,
                       f3_k.dtype)]
    st = dict(pos=torch.zeros((B,), dtype=torch.int32, device=dev),
              cnt=torch.zeros((B,), dtype=torch.int32, device=dev),
              steps=torch.zeros((B,), dtype=torch.int32, device=dev))

    def pending():
        return (st["pos"] < lens) & (st["pos"] < P)

    def body():
        pos = st["pos"]
        act = pending()
        pc = pos.clamp(max=P - 1).long()
        em = act & emit[bidx, pc]
        col = torch.where(em, st["cnt"], M).clamp(max=M).long()
        for buf, v in zip(bufs, (pos, E3[bidx, pc], f3_k[bidx, pc],
                                 f3_l[bidx, pc], f3_ss[bidx, pc])):
            buf[bidx, col] = v.to(buf.dtype)
        st["cnt"] = st["cnt"] + em.to(torch.int32)
        st["steps"] = st["steps"] + act.to(torch.int32)
        st["pos"] = torch.where(act, nxt[bidx, pc], pos)

    run_lockstep(body, pending, stats, "chase_ticks")
    strategy_chase.last_steps = st["steps"]
    return SmemBuf(*(b[:, :M] for b in bufs), st["cnt"])


strategy_chase.last_steps = None             # [B] int32, on its device


def _left_max_mask(E, P: int, min_seed_len: int):
    """The columns whose match is left-maximal and long enough: E(p-1) <
    E(p) (or p = 0) and E(p) - p >= min_seed_len."""
    pcol = torch.arange(P, dtype=torch.int32, device=E.device)[None, :]
    E_prev = torch.cat([torch.zeros_like(E[:, :1]), E[:, :-1]], 1)
    return pcol, ((pcol == 0) | (E_prev < E)) & ((E - pcol) >= min_seed_len)


def sweep_pass_plain(fmi: DeviceFMIndex, codes, lens, min_seed_len: int,
                     max_out: int, fma=None, tasks=None,
                     p3_max_intv: int = 0, p3_stop: int = 0, n_pos: int = 0,
                     stats: dict = None, stats_key: str = "sweep_ticks_p1"):
    """One sweep pass and its emission, on any device (the plain version
    of ``csrc/sweep.cu``'s sweep_extend_kernel in its pass forms, through
    ``sweep_cuda.sweep_pass_cuda``). Pass 1 (`tasks` None): the sweep from
    every column p < n_pos with min_intv 1 (merged with pass 3 where
    p3_max_intv and p3_stop > 0), every left-maximal match of at least
    min_seed_len bases into its read's slots. Pass 2: `tasks` = (t_read,
    t_x, t_mi, t_valid) of ``reseed_tasks``, the sweep over each task's
    read at min_intv t_mi, the matches that also cover t_x into the
    task's read's slots in task order, then column order. Returns
    (SmemBuf [B, max_out], the pass-1 merged records pass 3's stage reads,
    or {})."""
    B, L = codes.shape
    P = n_pos or L
    dev = codes.device
    empty = SmemBuf.empty(B, max_out, dev, fmi.pos_dtype)
    if tasks is None:
        ext = extend_all_positions(
            fmi, codes, lens, torch.ones((B,), dtype=torch.int32, device=dev),
            check_initial=True, want_fail=False, fma=fma,
            p3_max_intv=p3_max_intv, p3_stop=p3_stop, n_pos=P, stats=stats,
            stats_key=stats_key)
        E = ext["E"]
        pcol, mask = _left_max_mask(E, P, min_seed_len)
        out = _emit_compact(mask, pcol.expand(B, P), E - 1, ext["k"],
                            ext["l"], ext["s"], empty)
        merged = p3_max_intv > 0 and p3_stop > 0
        return out, ({f: ext[f] for f in MERGED_RECORDS} if merged else {})
    t_read, t_x, t_mi, t_valid = tasks
    T = t_read.shape[0]
    codes_t = torch.where(t_valid[:, None], codes[t_read], 4)
    lens_t = torch.where(t_valid, lens[t_read], 0)
    ext = extend_all_positions(
        fmi, codes_t.to(torch.int32), lens_t.to(torch.int32),
        t_mi.to(torch.int32), check_initial=True, want_fail=False, fma=fma,
        n_pos=P, stats=stats, stats_key=stats_key)
    E = ext["E"]
    pcol, mask = _left_max_mask(E, P, min_seed_len)
    mask = (mask & t_valid[:, None] & (pcol <= t_x[:, None])
            & (E > t_x[:, None]))
    return _emit_compact(mask, pcol.expand(T, P), E - 1, ext["k"], ext["l"],
                         ext["s"], empty, rows=t_read), {}


# the pass-1 sweep's records that pass 3's merged stage reads
MERGED_RECORDS = ("E", "f3_E", "f3_k", "f3_l", "f3_ss", "f3_s", "died_s")


def smems_reseed(fmi: DeviceFMIndex, codes, lens, pass1: SmemBuf,
                 split_len: int, split_width: int, min_seed_len: int,
                 max_out: int, max_tasks: int = 0, fma=None,
                 n_pos: int = 0, stats: dict = None):
    """Pass 2: the re-seed at the midpoints of long low-occurrence pass-1
    SMEMs. Each becomes a (read, x, min_intv = s + 1) task; the first
    max_tasks (default 2B) run through the sweep, which emits the
    valid-maximal matches covering x (``sweep_cuda.sweep_pass_cuda``: one
    launch on CUDA tensors, ``sweep_pass_plain`` on CPU ones). Returns
    (SmemBuf, the reads that lost a task to the budget)."""
    from . import sweep_cuda
    B, L = codes.shape
    # ~1.5 reseed candidates a read is typical at 1-3% error; 2 a read
    # keeps drops (and the overflow retries they cause) rare
    T = max_tasks or 2 * B
    tasks = reseed_tasks(pass1, T, split_len, split_width)
    out, _ = sweep_cuda.sweep_pass_cuda(
        fmi, codes, lens, min_seed_len, max_out, fma=fma, tasks=tasks[:4],
        n_pos=n_pos or L, stats=stats, stats_key="sweep_ticks_p2")
    return out, tasks[4]


def smems_seed_strategy_merged(fmi: DeviceFMIndex, codes, lens, ext,
                               max_intv: int, stop_min_len: int,
                               max_out: int, n_pos: int = 0,
                               stats: dict = None) -> SmemBuf:
    """Pass 3 from the pass-1 sweep's merged records (``ext``). A lane
    whose walk died at s = 0 before stop_min_len walks on with an empty
    interval until the stop length, an N or the read's end, none of
    which emits: its end is reckoned here, not walked. Then the restart
    chain. On CUDA tensors the whole stage is one launch
    (``sweep_cuda.seed_strategy_merged_cuda``); on CPU tensors the plain
    version, ``seed_strategy_merged_plain``."""
    from . import sweep_cuda
    if codes.device.type != "cpu":
        return sweep_cuda.seed_strategy_merged_cuda(
            fmi, codes, lens, ext, max_intv, stop_min_len, max_out, n_pos,
            stats)
    return seed_strategy_merged_plain(fmi, codes, lens, ext, max_intv,
                                      stop_min_len, max_out, n_pos, stats)


def seed_strategy_merged_plain(fmi, codes, lens, ext, max_intv: int,
                               stop_min_len: int, max_out: int,
                               n_pos: int = 0,
                               stats: dict = None) -> SmemBuf:
    """The merged stage's plain version, on any device: the glue as torch
    operations in the JAX function's order, then the lockstep
    ``strategy_chase``, whose per-read steps it keeps in
    ``last_steps``."""
    B, L = codes.shape
    P = n_pos or L
    dev = codes.device
    pcol = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    base_ok = (pcol < lens[:, None]) & (codes[:, :P] < 4)
    # the first invalid column at or after p, over the whole read
    iota = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    inv = (codes >= 4) | (iota >= lens[:, None])
    first_inv = torch.where(inv, iota, L).flip(1).cummin(1).values.flip(1)
    limit = first_inv[:, :P] - pcol
    a0c = codes[:, :P].clamp(0, 3).long()
    s1 = fmi.count[a0c + 1] - fmi.count[a0c]
    died = ext["died_s"] | (base_ok & (s1 == 0))
    f3 = ext["f3_s"]
    zombie = base_ok & died & ~f3
    zfail = zombie & (stop_min_len <= limit)
    E3 = torch.where(f3, ext["f3_E"],
                     torch.where(zfail, pcol + stop_min_len - 1,
                                 torch.where(zombie, pcol + limit,
                                             ext["E"])))
    emit_col = base_ok & f3 & (ext["f3_ss"] > 0)
    fail3 = f3 | zfail
    hit_n = base_ok & ~fail3 & (E3 < lens[:, None])
    nxt = torch.where(base_ok & (fail3 | hit_n), E3 + 1,
                      torch.where(base_ok, lens[:, None], pcol + 1))
    nxt = torch.maximum(nxt, pcol + 1)
    out = strategy_chase(emit_col, E3.to(torch.int32), nxt.to(torch.int32),
                         ext["f3_k"], ext["f3_l"], ext["f3_ss"], lens,
                         max_out, stats=stats)
    seed_strategy_merged_plain.last_steps = getattr(strategy_chase,
                                                    "last_steps", None)
    return out


seed_strategy_merged_plain.last_steps = None  # [B] int32, on its device


def collect_smems_device(fmi: DeviceFMIndex, codes, lens, *,
                         min_seed_len: int, split_len: int,
                         split_width: int, max_mem_intv: int,
                         max_out: int = None, fma=None,
                         stats: dict = None) -> SmemBuf:
    """The sweep engine's three passes and the final per-read (m, n) sort
    (mem_collect_smem, src/bwamem.cpp:648-795). Pass 1 and pass 3 share
    one sweep (merged records); the reseed pass runs its own over the
    compacted task list. A read that lost a reseed task to the budget
    gets its count saturated to the buffer width (the retry ladder's
    signal). codes [B, L] int32, lens [B] int32, both on fmi's device;
    `fma` a DeviceFmaTable at fmi's position dtype, or None."""
    from . import sweep_cuda
    B, L = codes.shape
    dev = codes.device
    M = max_out or L
    # no SMEM can start past L - min_seed_len: skip those sweep lanes
    P = int(np.clip(L - min_seed_len + 1, 1, L))
    lens = lens.to(torch.int32)
    merge = max_mem_intv > 0
    p1, ext = sweep_cuda.sweep_pass_cuda(
        fmi, codes, lens, min_seed_len, M, fma=fma,
        p3_max_intv=max_mem_intv if merge else 0,
        p3_stop=(min_seed_len + 1) if merge else 0, n_pos=P, stats=stats,
        stats_key="sweep_ticks_p1")
    p2, reseed_of = smems_reseed(fmi, codes, lens, p1, split_len,
                                 split_width, min_seed_len, M, fma=fma,
                                 n_pos=P, stats=stats)
    parts = [p1, p2]
    if merge:
        parts.append(smems_seed_strategy_merged(
            fmi, codes, lens, ext, max_mem_intv, min_seed_len + 1, M,
            n_pos=P, stats=stats))
    comb = concat_smems(*parts)
    valid = torch.cat([torch.arange(b.m.shape[1], device=dev)[None, :]
                       < b.cnt[:, None] for b in parts], dim=1)
    # m, n < 2^15 for any supported read length
    key = torch.where(valid, (comb.m << 16) | comb.n, 1 << 30)
    _, perm = torch.sort(key, dim=1, stable=True)
    g = lambda a: a.gather(1, perm)
    cnt = torch.where(reseed_of, comb.m.shape[1], comb.cnt)
    return SmemBuf(g(comb.m), g(comb.n), g(comb.k), g(comb.l), g(comb.s),
                   cnt.to(torch.int32))
