"""Seeded read batches for measurements on the card: one batch of the
4.6 Mbp single-end cell, one from a genome with repeats, one of long
exact reads from its repeats (the ERT's depth cap), one whose reads
reach the EMF probe's multi-location rescue, and one of phase 10's long
reads."""

from __future__ import annotations

import numpy as np

from ..index.build import build_index
from ..models.aligner import (demo_genome, simulate_reads,
                              simulate_reads_with_truth)


def se_batch(n_reads: int = 512, read_len: int = 101, sa_compx: int = None):
    """chip_smoke.py phase 4's genome (4.6 Mbp, seed 7) and reads (seed
    8, 1% substitutions, half reverse-complemented), its first n_reads
    reads with a substitution: the reads the EMF table leaves to the
    device, so phase 5's batch. Returns (the port's index, at sa_compx
    when given (0: the full SA, as the ERT needs), codes, lens)."""
    bns = demo_genome(4_600_000, seed=7, n_contigs=1)
    codes, lens, pos, is_rev = simulate_reads_with_truth(
        bns, 4 * n_reads, read_len, seed=8, err_rate=0.01)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int32)
    src = np.stack([bns.seq[p: p + read_len] for p in pos]).astype(np.int32)
    src[is_rev] = comp[src[is_rev][:, ::-1]]
    pick = np.flatnonzero((codes != src).any(1))[:n_reads]
    idx = build_index(bns) if sa_compx is None else build_index(bns, sa_compx)
    return idx, codes[pick], lens[pick]


REPEAT_UNIT = 1_000_000        # where repeat_genome's 150 bp unit starts


def repeat_genome():
    """A 2 Mbp genome in three contigs (the last alt): its first 1 kbp
    copied to 24 places (3 substitutions each), and a 150 bp unit at
    REPEAT_UNIT copied to 599 more places 1.5 kbp apart (more hits than
    max_occ). Returns (the BntSeq, the RandomState after the copies)."""
    bns = demo_genome(2_000_000, seed=42, n_contigs=3)
    bns.anns[-1].is_alt = True
    rng = np.random.RandomState(3)
    for k in range(1, 25):
        at = k * 40_000
        bns.seq[at:at + 1000] = bns.seq[:1000]
        bns.seq[at + rng.randint(0, 1000, 3)] = rng.randint(0, 4, 3)
    unit = REPEAT_UNIT
    for k in range(1, 600):
        at = unit + 1500 * k
        bns.seq[at:at + 150] = bns.seq[unit:unit + 150]
    return bns, rng


def repeat_batch(n_reads: int = 512, read_len: int = 101):
    """repeat_genome's genome and n_reads reads (1% substitutions), a
    quarter exact copies from the 1 kbp window and one in 32 from the
    unit, so that reads have tens of chains that overlap on the query,
    some SMEMs are repetitive and the interval stacks are deep. Returns
    (the port's index, codes, lens)."""
    bns, rng = repeat_genome()
    unit = REPEAT_UNIT
    codes, lens = simulate_reads(bns, n_reads, read_len, seed=8,
                                 err_rate=0.01)
    for i in range(0, n_reads, 4):
        start = rng.randint(0, 900)
        codes[i] = bns.seq[start:start + read_len]
    for i in range(2, n_reads, 32):
        start = unit + rng.randint(0, 150 - read_len)
        codes[i] = bns.seq[start:start + read_len]
    return build_index(bns), codes, lens


def depth_cap_batch(n_reads: int = 512, read_len: int = 400):
    """repeat_genome's genome indexed with the full SA (sa_compx 0, as the
    ERT needs) and n_reads exact reads of read_len bp from its 1 kbp
    window (copied to 24 places, 3 substitutions each), every second one
    reverse-complemented: stretches of several hundred bases occur more
    than once, so that ERT walks on trie nodes reach the depth cap (320)
    and the reads are longer than the cap. Returns (the port's index,
    codes, lens)."""
    bns, _ = repeat_genome()
    rng = np.random.RandomState(12)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int32)
    start = rng.randint(0, 1000 - read_len + 1, n_reads)
    codes = bns.seq[start[:, None] + np.arange(read_len)].astype(np.int32)
    codes[1::2] = comp[codes[1::2, ::-1]]
    lens = np.full(n_reads, read_len, np.int32)
    return build_index(bns, sa_compx=0), codes, lens


def rescue_batch(seed_len: int = 51, n_units: int = 64, copies: int = 4,
                 read_len: int = 101):
    """A 1 Mbp genome with n_units units of seed_len + 9 bp, each copied
    to `copies` places 3 kbp apart, so that the copies share a prefix
    longer than the seed and then differ; one exact read_len read a copy
    and strand, each starting with the unit's first seed_len bases (the
    reverse strand's as their reverse complement). An EMF table at
    seed_len holds one entry a unit whose location is one copy's, so the
    reads of the other copies reach the multi-location rescue. Returns
    (the port's index, codes, lens, each read's copy position)."""
    bns = demo_genome(1_000_000, seed=43, n_contigs=1)
    rng = np.random.RandomState(44)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    reads, where = [], []
    for k in range(n_units):
        unit = rng.randint(0, 4, seed_len + 9).astype(np.uint8)
        for j in range(copies):
            p = 2000 + (k * copies + j) * 3000
            bns.seq[p:p + len(unit)] = unit
            where.append(p)
    for p in where:
        reads.append(bns.seq[p:p + read_len])
        q = p + seed_len - read_len
        reads.append(comp[bns.seq[q:q + read_len][::-1]])
    codes = np.stack(reads).astype(np.int32)
    lens = np.full(len(reads), read_len, np.int32)
    return build_index(bns), codes, lens, np.repeat(where, 2)


def rescue_pairs(bns, n_pairs: int = 512, read_len: int = 101,
                 insert: int = 300, insert_sd: int = 30):
    """chip_smoke.py phase 15's pairs with seedless mates: n_pairs FR
    pairs from `bns` (seed 19, insert `insert` +- `insert_sd`), read 2
    reverse-complemented, every fourth read 2 with every tenth base
    changed: no 19-mer seed, so only mate rescue places it. Returns codes
    [2 n_pairs, read_len] int32, mates in turn (read 1 of pair i at 2i)."""
    rng = np.random.RandomState(19)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    frag = np.maximum(rng.normal(insert, insert_sd, n_pairs)
                      .astype(np.int64), read_len + 10)
    start = (rng.rand(n_pairs) * (bns.l_pac - frag)).astype(np.int64)
    pos = np.stack([start, start + frag - read_len], 1).reshape(-1)
    codes = bns.seq[pos[:, None] + np.arange(read_len)].astype(np.int32)
    codes[1::2] = comp[codes[1::2, ::-1]]
    codes[1::8, 5::10] = (codes[1::8, 5::10] + 1) % 4
    return codes


def long_batch(n_reads: int = 512, lo: int = 800, hi: int = 2500,
               seed: int = 10):
    """chip_smoke.py phase 4's genome and n_reads reads of lo-hi bp
    (uniform), 1% substitutions, every second one reverse-complemented,
    padded with N to hi: a batch of phase 10's long reads (the seed-SW
    filter's regime at default options). Returns (the port's index,
    codes [n_reads, hi], lens)."""
    bns = demo_genome(4_600_000, seed=7, n_contigs=1)
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], np.int32)
    lens = rng.randint(lo, hi + 1, n_reads).astype(np.int32)
    codes = np.full((n_reads, hi), 4, np.int32)
    for i, n in enumerate(lens):
        p = rng.randint(0, bns.l_pac - n)
        s = bns.seq[p: p + n].astype(np.int32)
        m = rng.rand(n) < 0.01
        s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
        codes[i, :n] = comp[s[::-1]] if i % 2 else s
    return build_index(bns), codes, lens
