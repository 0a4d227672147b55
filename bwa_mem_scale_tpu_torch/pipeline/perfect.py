"""EMF host side: location resolution, dedup, and record composition.

Counterpart of ``bwa_mem_scale_tpu/pipeline/perfect.py``: SE records
(``perfect_sam_records``) and PE regions (``perfect_regs``).

Implements get_perfect_locations (src/perfect_map.cpp:698-775),
perfect_dedup_patch (src/bwamem.cpp:2276 region), mem_perfect2sam's
record selection (src/bwamem.cpp:2328-2377) and mem_perfect2reg
(src/perfect_map.cpp:812-869) over the lookup results of ops/emf.py.

One intentional fix vs the reference: for reads longer than seed_len
matched on the reverse strand, the PE region uses the read's actual
forward-strand start (loc - extension) — the reference reuses the raw
seed location there (src/perfect_map.cpp:838).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .._shared.config import MemOptions, MEM_F_ALL
from .._shared.index.perfect import PerfectTable
from .._shared.ref.extend import AlnReg
from .._shared.ref.finalize import Aln
from ..ops.emf import RC_MATCHED

MAPQ_PERFECT_MATCH = 60  # src/perfect.h:64


def _fw_start(loc: int, is_rev: bool, l_seq: int, seed_len: int) -> int:
    return loc - (l_seq - seed_len) if is_rev else loc


def _verify_further(ref: np.ndarray, l_pac: int, loc: int, is_rev: bool,
                    read: np.ndarray, seed_len: int) -> bool:
    """Full-read exact check at a candidate seed location (host; used
    only for the rare multi-location reads longer than seed_len)."""
    l_seq = len(read)
    if l_seq == seed_len:
        return True
    start = _fw_start(loc, is_rev, l_seq, seed_len)
    if start < 0 or start + l_seq > l_pac:
        return False
    win = ref[start: start + l_seq]
    if is_rev:
        return bool(np.all(win == (3 - read[::-1])))
    return bool(np.all(win == read))


def perfect_locations(pt: PerfectTable, ref: np.ndarray, read: np.ndarray,
                      code: int, slot: int, loc0=None
                      ) -> List[Tuple[int, bool]]:
    """Ordered (location, is_rev) hits for a perfect-matched read.
    Ordering matches get_perfect_locations: forward-strand hits sorted
    by position first, then reverse-strand hits sorted by rb. loc0 is
    the probe's verified location — for multi-location-rescued reads
    (longer than the seed) it differs from the entry's representative,
    which then simply fails the _verify_further check below."""
    is_rev0 = code == RC_MATCHED
    ent_loc = int(pt.loc[slot]) if loc0 is None else int(loc0)
    fw_list, rc_list = pt.locations(slot)
    l_seq = len(read)

    def others(locs, is_rev):
        out = []
        for x in locs:
            x = int(x)
            if x == ent_loc:
                continue
            if _verify_further(ref, pt.l_pac, x, is_rev, read,
                               pt.seed_len):
                out.append((x, is_rev))
        if is_rev:
            out.reverse()  # descending loc = ascending rb
        return out

    if len(fw_list) + len(rc_list) <= 1:
        return [(ent_loc, is_rev0)]
    if not is_rev0:
        return ([(ent_loc, False)] + others(fw_list, False)
                + others(rc_list, True))
    return (others(rc_list, False) + [(ent_loc, True)]
            + others(fw_list, True))


def perfect_dedup(opt: MemOptions, hits: List[Tuple[int, bool]],
                  l_seq: int, seed_len: int, bns
                  ) -> List[Tuple[int, bool, int, int]]:
    """perfect_dedup_patch: drop near-identical same-strand hits.
    Returns (loc, is_rev, rid, pos) tuples."""
    ann = []
    for loc, is_rev in hits:
        rid = int(bns.pos2rid(loc))
        pos = _fw_start(loc, is_rev, l_seq, seed_len) \
            - bns.anns[rid].offset
        ann.append([loc, is_rev, rid, pos])
    n = len(ann)
    excluded = [False] * n
    for i in range(1, n):
        li, ri, rdi, pi = ann[i]
        j = i - 1
        while (j >= 0 and ann[j][2] == rdi and ann[j][1] == ri
               and pi < ann[j][3] + l_seq + opt.max_chain_gap):
            if not excluded[j] and \
                    ann[j][3] + l_seq - pi > opt.mask_level_redun * l_seq:
                excluded[j] = True
            j -= 1
    return [tuple(a) for a, ex in zip(ann, excluded) if not ex]


def perfect_sam_records(opt: MemOptions, bns, pt: PerfectTable,
                        ref: np.ndarray, read: np.ndarray,
                        code: int, slot: int, loc0=None) -> List[Aln]:
    """SE SAM records for a perfect-matched read (mem_perfect2sam)."""
    l_seq = len(read)
    hits = perfect_dedup(
        opt, perfect_locations(pt, ref, read, code, slot, loc0),
        l_seq, pt.seed_len, bns)
    score = l_seq * opt.a
    sub0 = score if len(hits) > 1 else 0

    def mk(rid, pos, is_rev, secondary) -> Aln:
        return Aln(pos=pos, rid=rid, flag=(0x100 if secondary else 0),
                   is_rev=bool(is_rev), is_alt=bool(bns.is_alt[rid]),
                   mapq=MAPQ_PERFECT_MATCH, NM=0,
                   cigar=[(l_seq, 0)], MD=str(l_seq), score=score,
                   sub=(sub0 if not secondary else -1))

    records: List[Aln] = []
    for want_alt in (False, True):
        if want_alt and records and not (opt.flag & MEM_F_ALL):
            break
        for loc, is_rev, rid, pos in hits:
            if bool(bns.is_alt[rid]) != want_alt:
                continue
            records.append(mk(rid, pos, is_rev, len(records) > 0))
            if not (opt.flag & MEM_F_ALL):
                break
    return records


def perfect_regs(opt: MemOptions, bns, pt: PerfectTable,
                 ref: np.ndarray, read: np.ndarray,
                 code: int, slot: int, loc0=None) -> List[AlnReg]:
    """PE path: perfect hits as alignment regions (mem_perfect2reg)."""
    l_seq = len(read)
    hits = perfect_dedup(
        opt, perfect_locations(pt, ref, read, code, slot, loc0),
        l_seq, pt.seed_len, bns)
    regs = []
    for loc, is_rev, rid, _pos in hits:
        start = _fw_start(loc, is_rev, l_seq, pt.seed_len)
        if not is_rev:
            rb, re = start, start + l_seq
        else:
            rb = 2 * pt.l_pac - (start + l_seq)
            re = 2 * pt.l_pac - start
        regs.append(AlnReg(
            rb=rb, re=re, qb=0, qe=l_seq, rid=rid,
            score=l_seq * opt.a, truesc=l_seq * opt.a, w=opt.w,
            seedcov=0, seedlen0=l_seq, frac_rep=0.0,
            is_alt=bool(bns.is_alt[rid])))
    return regs
