"""EMF device lookup: the batched perfect-match probe, in PyTorch.

Counterpart of ``bwa_mem_scale_tpu/ops/emf.py``. Per read: canonicalise
the seed (the first seed_len bases), hash it, walk the linear-probe
table up to the first empty slot for the first fingerprint match, and
verify that candidate by comparing the full read against the reference
in both orientations (find_perfect_match_entry, src/perfect_map.cpp:
583-661, with __seedmatch_further, src/perfect.h:474). When the entry's
own location fails a read longer than the seed, the entry's
multi-location list is scanned in the reference's order, forward
sublist first, and the first match wins (seedmatch_further,
src/perfect_map.cpp:528-570); that loop runs only when some read needs
it.

``emf_lookup`` is the plain version, the JAX function's arithmetic on
tensors; ``ops/emf_cuda.py::emf_lookup_cuda`` launches the hand kernel
(``csrc/emf.cu``) on CUDA tensors. Both return the JAX package's four
arrays, every value included: a too-short read is still hashed and
probed from its padded columns, a read with an N still runs the checks
(N clipped to 3 in the reverse complement), a read with no candidate
reports the first probed slot.

Torch has no unsigned 64-bit arithmetic on the CPU, so the hash runs on
int64 bit patterns: multiplies wrap, and a logical shift right by s is
the arithmetic one masked to its 64 - s low bits. The table's uint32
fingerprints are held as int32 bit patterns.

Return codes are the reference's FIND_PERFECT_* (src/perfect.h:902):
0 no-table/short, 1 with-N, 2 not-matched, 3 fw-matched, 4 rc-matched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..index.perfect import PerfectTable, _M1, _M2, _MG
from .occ import host_tensor, ref_byte

NO_TABLE, WITH_N, NOT_MATCHED, FW_MATCHED, RC_MATCHED = range(5)


def _signed64(v) -> int:
    """A uint64 constant as the int64 with its bits."""
    v = int(v)
    return v - (1 << 64) if v >= 1 << 63 else v


M1, M2, MG = _signed64(_M1), _signed64(_M2), _signed64(_MG)


@dataclasses.dataclass
class DeviceEmf:
    """The EMF table's arrays on one device (JAX ``DeviceEmf``)."""

    loc: torch.Tensor       # int64 [ncap]; -1 = empty slot
    fp: torch.Tensor        # int32 [ncap] uint32 fingerprint bits
    cnt: torch.Tensor       # int32 [ncap]
    fwless: torch.Tensor    # uint8 [ncap] canonical orientation at loc
    mlidx: torch.Tensor     # int32 [ncap]; -1 = single location
    ml_off: torch.Tensor    # int64 [max(nml + 1, 2)]
    ml_nfw: torch.Tensor    # int32 [max(nml, 1)]
    ml_locs: torch.Tensor   # int64 [max(total, 1)]
    seed_len: int
    l_pac: int
    max_probe: int

    @property
    def device(self) -> torch.device:
        return self.loc.device

    @property
    def ncap(self) -> int:
        return int(self.loc.shape[0])

    def nbytes(self) -> int:
        """Device bytes of the table's arrays."""
        return sum(t.numel() * t.element_size() for t in (
            self.loc, self.fp, self.cnt, self.fwless, self.mlidx,
            self.ml_off, self.ml_nfw, self.ml_locs))

    @classmethod
    def from_host(cls, pt: PerfectTable, device) -> "DeviceEmf":
        """The host table on `device`, the variable tables padded (as the
        JAX package pads them) so that gathers stay in bounds when the
        table has no multi-location entry."""
        dev = torch.device(device)
        ml_off = np.asarray(pt.ml_off, np.int64)
        if ml_off.size < 2:
            ml_off = np.zeros(2, np.int64)
        ml_nfw = np.asarray(pt.ml_nfw, np.int32)
        if ml_nfw.size < 1:
            ml_nfw = np.zeros(1, np.int32)
        ml_locs = np.asarray(pt.ml_locs, np.int64)
        if ml_locs.size < 1:
            ml_locs = np.zeros(1, np.int64)
        fp = np.asarray(pt.fp, np.uint32).view(np.int32)
        return cls(loc=host_tensor(pt.loc, np.int64, dev),
                   fp=host_tensor(fp, np.int32, dev),
                   cnt=host_tensor(pt.cnt, np.int32, dev),
                   fwless=host_tensor(pt.fwless, np.uint8, dev),
                   mlidx=host_tensor(pt.mlidx, np.int32, dev),
                   ml_off=host_tensor(ml_off, np.int64, dev),
                   ml_nfw=host_tensor(ml_nfw, np.int32, dev),
                   ml_locs=host_tensor(ml_locs, np.int64, dev),
                   seed_len=int(pt.seed_len), l_pac=int(pt.l_pac),
                   max_probe=max(int(pt.max_probe), 1))


def _shr(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by s (1 <= s < 64)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's finaliser on int64 bit patterns (wrapping)."""
    k = k ^ _shr(k, 33)
    k = k * M1
    k = k ^ _shr(k, 33)
    k = k * M2
    return k ^ _shr(k, 33)


def seed_hash(canon: torch.Tensor, S: int) -> torch.Tensor:
    """The table's hash of canonical seeds canon [B, S] (values 0-3) as
    int64 bit patterns: big-endian 2-bit words of 32 bases, chained
    through fmix64 from h = S (``index/perfect.py::hash_words``)."""
    B = canon.shape[0]
    W = (S + 31) // 32
    padded = torch.zeros((B, W * 32), dtype=torch.int64, device=canon.device)
    padded[:, :S] = canon
    shifts = 2 * (31 - torch.arange(32, device=canon.device))
    # the 32 bases' bit fields are disjoint, so their sum is their OR
    words = (padded.reshape(B, W, 32) << shifts).sum(2)
    h = torch.full((B,), S, dtype=torch.int64, device=canon.device)
    for j in range(W):
        h = fmix64((h ^ words[:, j]) * MG)
    return h


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none: argmax)."""
    return torch.argmax(m.to(torch.int32), dim=1)


def emf_lookup(emf: DeviceEmf, ref: torch.Tensor, codes: torch.Tensor,
               lens: torch.Tensor, stats: Optional[dict] = None) -> dict:
    """codes [B, L] int32 (nt4) and lens [B] on emf's device, ref the
    fw+rc reference bytes. Returns code [B] int32, slot [B] int32, loc [B]
    int64 (the matched location for codes 3 and 4, else -1) and n_loc [B]
    int32, as the JAX function computes them. With `stats`, per-read
    work the probe needs: ``slots`` (probed up to the first candidate or
    empty slot), ``ref_bytes`` (reference bytes up to each checked
    window's first mismatch), ``cands`` (rescue list entries tried) and
    ``trips`` (dependent global trips: the read, each 32-slot probe
    round, the window, the list's offsets and each list entry)."""
    B, L = codes.shape
    S = emf.seed_len
    assert L >= S, "pad reads to at least seed_len before EMF lookup"
    dev = codes.device
    i64 = torch.int64
    codes = codes.to(torch.int32)
    lens = lens.to(torch.int32)
    iota = torch.arange(L, device=dev)
    in_len = iota[None, :] < lens[:, None]
    has_n = (in_len & (codes >= 4)).any(1)
    too_short = lens < S

    fw = codes[:, :S].clamp(0, 3)
    rcs = 3 - fw.flip(1)                       # the seed's reverse complement
    ridx = (lens[:, None] - 1 - iota[None, :]).clamp(0, L - 1).long()
    rcr = 3 - codes.gather(1, ridx).clamp(0, 3)    # the read's

    neq = fw != rcs
    first = _first_true(neq)
    bidx = torch.arange(B, device=dev)
    fwle = torch.where(neq.any(1), fw[bidx, first] < rcs[bidx, first], True)
    canon = torch.where(fwle[:, None], fw, rcs)
    h = seed_hash(canon, S)
    fpq = _shr(h, 32)
    fpq = torch.where(fpq >= 1 << 31, fpq - (1 << 32), fpq).to(torch.int32)

    ncap, P = emf.ncap, emf.max_probe
    slots = (h[:, None] + torch.arange(P, device=dev)) & (ncap - 1)  # [B, P]
    loc_p = emf.loc[slots]
    nonempty = loc_p >= 0
    alive = torch.cumprod(nonempty.to(torch.int32), dim=1) > 0
    cand = alive & (emf.fp[slots] == fpq[:, None])
    sel = _first_true(cand)
    has_cand = cand.any(1)
    slot = slots[bidx, sel]
    loc = torch.where(has_cand, loc_p[bidx, sel], 0)

    lens64 = lens.to(i64)
    pos_rc = loc - (lens64 - S)
    okf = loc + lens64 <= emf.l_pac
    okr = pos_rc >= 0
    reff = ref_byte(ref, loc[:, None] + iota, emf.l_pac)
    refr = ref_byte(ref, pos_rc[:, None] + iota, emf.l_pac)
    mis_f = in_len & (reff != codes)
    mis_r = in_len & (refr != rcr)
    fwm = has_cand & okf & ~mis_f.any(1)
    rcm = has_cand & okr & ~mis_r.any(1)

    mi0 = torch.where(has_cand, emf.mlidx[slot], -1)
    need = (has_cand & (lens > S) & ~fwm & ~rcm & (mi0 >= 0) & ~has_n
            & ~too_short)
    r_found = torch.zeros((B,), dtype=torch.bool, device=dev)
    r_loc = torch.zeros((B,), dtype=i64, device=dev)
    r_rev = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_tried = torch.zeros((B,), dtype=i64, device=dev)
    r_bytes = torch.zeros((B,), dtype=i64, device=dev)
    if bool(need.any()):
        # the JAX while_loop: list entry j of every active read a round
        mic = mi0.clamp(min=0).long()
        lo = emf.ml_off[mic]
        n_list = emf.ml_off[mic + 1] - lo
        nfw = lo + emf.ml_nfw[mic].to(i64)
        is_rev0 = (emf.fwless[slot] != 0) != fwle
        nL = emf.ml_locs.shape[0]
        active = need.clone()
        j = 0
        while bool(active.any()):
            cidx = lo + j
            in_list = active & (j < n_list)
            loc_c = emf.ml_locs[cidx.clamp(0, nL - 1)]
            isrev = torch.where(cidx < nfw, is_rev0, ~is_rev0)
            posr = loc_c - (lens64 - S)
            start = torch.where(isrev, posr, loc_c)
            okb = torch.where(isrev, posr >= 0, loc_c + lens64 <= emf.l_pac)
            win = ref_byte(ref, start[:, None] + iota, emf.l_pac)
            tgt = torch.where(isrev[:, None], rcr, codes)
            mis = in_len & (win != tgt)
            okm = in_list & okb & ~mis.any(1)
            newly = okm & ~r_found
            r_loc = torch.where(newly, loc_c, r_loc)
            r_rev = torch.where(newly, isrev, r_rev)
            r_found = r_found | okm
            if stats is not None:
                n_tried += in_list.to(i64)
                r_bytes += torch.where(in_list & okb,
                                       _need_bytes(mis, lens64, L), 0)
            active = active & ~okm & (j + 1 < n_list)
            j += 1
    fwm = fwm | (r_found & ~r_rev)
    rcm = rcm | (r_found & r_rev)
    loc = torch.where(r_found, r_loc, loc)
    code = torch.where(
        too_short, NO_TABLE, torch.where(
            has_n, WITH_N, torch.where(
                fwm, FW_MATCHED, torch.where(rcm, RC_MATCHED,
                                             NOT_MATCHED)))).to(torch.int32)
    if stats is not None:
        # the kernel stops at the first candidate or empty slot
        stop = torch.where(has_cand, sel,
                           torch.where(nonempty.all(1), P - 1,
                                       _first_true(~nonempty)))
        stats["slots"] = stop + 1
        stats["ref_bytes"] = (
            torch.where(has_cand & okf, _need_bytes(mis_f, lens64, L), 0)
            + torch.where(has_cand & okr, _need_bytes(mis_r, lens64, L), 0)
            + r_bytes)
        stats["cands"] = n_tried
        stats["trips"] = (1 + (stop + 32) // 32 + has_cand.to(i64)
                          + need.to(i64) + n_tried)
    return dict(code=code, slot=slot.to(torch.int32),
                loc=torch.where(fwm | rcm, loc, -1),
                n_loc=torch.where(has_cand, emf.cnt[slot], 0))


def _need_bytes(mis: torch.Tensor, lens64: torch.Tensor, L: int
                ) -> torch.Tensor:
    """Reference bytes a window's check reads up to its first mismatch
    (the read's in-length columns when none)."""
    n = lens64.clamp(0, L)
    return torch.where(mis.any(1), _first_true(mis) + 1, n)
