"""Suffix-array lookup (SAL) on tensors.

Counterpart of ``bwa_mem_scale_tpu/ops/sal.py``: every SMEM's SA
interval is sampled into at most max_occ coordinates, and rows that
are not sampled are resolved by an LF walk to the nearest sampled row
(get_sa_entry_compressed, src/FMI_search.cpp:2107-2379). The walk runs
over a flat compacted list of the valid coordinates; reads whose
coordinates fall past that list are flagged as overflow.

``expand_and_lookup``, the stage the pipeline runs, goes through
``sal_cuda.expand_and_lookup_cuda``: on CUDA tensors the two kernels of
``csrc/sal.cu`` (the counts, the coordinates and the walk, with no tensor
operation between them), on CPU tensors ``expand_and_lookup_plain``, the
same function as tensor code around ``sa_lookup_plain``, a lockstep loop
over the lanes. ``sa_lookup``, the bare walk of a batch of rows, runs
through ``smem_cuda.sa_walk_cuda``, which launches ``csrc/smem.cu``'s
``sa_walk_kernel`` on CUDA tensors (and counts the launches) and runs
``sa_lookup_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .occ import DeviceFMIndex, occ_b_and_base, sa_sample_at, take
from .sal_cuda import expand_and_lookup_cuda, flat_size
from .smem import SmemBuf
from .smem_cuda import sa_walk_cuda

CHECK_EVERY = 4


def sa_lookup(fmi: DeviceFMIndex, pos: torch.Tensor, valid: torch.Tensor,
              stats: dict = None) -> torch.Tensor:
    """Resolve SA[pos] for a batch of BWT row indices: pos [...], valid
    [...] bool (invalid lanes return 0). With the full SA resident
    (sa_compx 0: a single gather, no walk) the plain version; else
    ``sa_walk_cuda``: on CUDA tensors one launch of the walk's kernel, or
    an exception, on CPU tensors the plain version. `stats` gets the
    kernel's longest lane's walk under ``sal_steps`` (a device tensor),
    or the lockstep's ``sal_ticks``."""
    if fmi.sa_compx == 0:
        return sa_lookup_plain(fmi, pos, valid, stats)
    return sa_walk_cuda(fmi, pos, valid, stats)


def sa_lookup_plain(fmi: DeviceFMIndex, pos: torch.Tensor,
                    valid: torch.Tensor, stats: dict = None
                    ) -> torch.Tensor:
    """Resolve SA[pos] for a batch of BWT row indices (``sa_lookup``'s
    plain version, on any device).

    pos [...], valid [...] bool (invalid lanes return 0); the walk and
    its values run at the index's position dtype. A retired lane is a
    strict no-op, so the exit test runs every CHECK_EVERY LF steps."""
    if fmi.sa_compx == 0:
        # full SA resident: a single gather
        return torch.where(valid, sa_sample_at(fmi, pos), 0)
    compx_mask = (1 << fmi.sa_compx) - 1
    shape = pos.shape
    sp = pos.reshape(-1).to(fmi.pos_dtype)
    active = valid.reshape(-1).clone()
    offset = torch.zeros_like(sp)
    done_val = torch.zeros_like(sp)
    count4 = fmi.count[:4]
    ticks = 0
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            sampled = (sp & compx_mask) == 0
            samp = sa_sample_at(fmi, sp >> fmi.sa_compx)
            done_val = torch.where(active & sampled, samp + offset,
                                   done_val)
            active = active & ~sampled
            occ_b, b = occ_b_and_base(fmi, sp)
            hit_sentinel = active & (b == 4)
            done_val = torch.where(hit_sentinel, offset, done_val)
            active = active & ~hit_sentinel
            sp = torch.where(active, take(count4, b.clamp(0, 3)) + occ_b,
                             sp)
            offset = offset + active.to(sp.dtype)
        ticks += CHECK_EVERY
    if stats is not None:
        stats["sal_ticks"] = stats.get("sal_ticks", 0) + ticks
    return done_val.reshape(shape)


def expand_and_lookup(fmi: DeviceFMIndex, smems: SmemBuf, max_occ: int,
                      max_coords: int, flat_k: int = None,
                      stats: dict = None):
    """Sample each SMEM interval and resolve coordinates: on CUDA tensors
    one call of ``expand_and_lookup_cuda`` (two kernel launches, or an
    exception), on CPU tensors ``expand_and_lookup_plain``; the outputs
    are the plain version's. `stats` gets the kernels' longest lane's
    walk under ``sal_steps`` (a device tensor), or the lockstep's
    ``sal_ticks``."""
    return expand_and_lookup_cuda(fmi, smems, max_occ, max_coords,
                                  flat_k=flat_k, stats=stats)


def expand_and_lookup_plain(fmi: DeviceFMIndex, smems: SmemBuf,
                            max_occ: int, max_coords: int,
                            flat_k: int = None, stats: dict = None):
    """Sample each SMEM interval and resolve coordinates
    (``expand_and_lookup``'s plain version, on any device).

    Returns (rbeg [B, C] of the index's position dtype, seed_smem [B, C]
    (index into smems arrays),
    coord_valid [B, C], total [B], overflow [B]) with C = max_coords.
    Within a read, coordinates come in SMEM order, then interval order
    (mem_chain_seeds, src/bwamem.cpp:862-895). The SA walk covers a
    flat list of K valid coordinates (K = flat_k, default B*C//16
    rounded up to 1024, at least 4096); reads past K overflow."""
    B, M = smems.m.shape
    C = max_coords
    dev = smems.m.device
    valid = torch.arange(M, device=dev)[None, :] < smems.cnt[:, None]
    s = smems.s
    big = s > max_occ
    step = torch.where(big, s // max_occ, 1).to(s.dtype)
    n_i = torch.where(big,
                      torch.clamp((s + step - 1) // step, max=max_occ),
                      torch.clamp(s, max=max_occ))
    n_i = torch.where(valid, n_i, 0).to(torch.int32)
    csum = torch.cumsum(n_i, 1, dtype=torch.int32)
    overflow = csum[:, -1] > max_coords
    total = torch.clamp(csum[:, -1], max=max_coords)
    starts = csum - n_i                                   # [B, M]

    slot = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    coord_valid = slot < total[:, None]
    # owning SMEM of each slot: the last SMEM with n_i > 0 that starts
    # at or before it (a scatter-max of SMEM ids at their start slots,
    # forward-filled by a running max)
    tgt = torch.where((n_i > 0) & (starts < C), starts, C).long()
    mark = torch.full((B, C + 1), -1, dtype=torch.int32, device=dev)
    iota_m = torch.arange(M, dtype=torch.int32, device=dev)
    mark = mark.scatter_reduce(1, tgt, iota_m.expand(B, M), "amax")
    seed_idx = torch.cummax(mark[:, :C], dim=1).values.clamp(0, M - 1)
    si = seed_idx.long()
    starts_c = starts.gather(1, si)
    k_c = smems.k.gather(1, si)
    step_c = step.gather(1, si)
    pos = k_c + (slot - starts_c) * step_c                # [B, C]

    K = flat_size(B, C, flat_k)
    if B * C <= K:
        rbeg = sa_lookup_plain(fmi, pos, coord_valid, stats)
        return rbeg, seed_idx, coord_valid, total, overflow
    tot_c = torch.cumsum(total, 0, dtype=torch.int32)
    grand = tot_c[-1]
    overflow = overflow | ((tot_c > K) & (total > 0))
    j = torch.arange(K, dtype=torch.int32, device=dev)
    # fb[j] = #{b: tot_c[b] <= j}
    fb = torch.searchsorted(tot_c, j, right=True).to(torch.int32)
    fbc = fb.clamp(0, B - 1)
    fc = j - take(tot_c - total, fbc)
    f_valid = j < grand
    fcc = fc.clamp(0, C - 1)
    flat_idx = fbc.long() * C + fcc.long()
    pos_f = pos.reshape(B * C)[flat_idx]
    rbeg_f = sa_lookup_plain(fmi, pos_f, f_valid, stats)
    rbeg = torch.zeros((B * C + 1,), dtype=rbeg_f.dtype, device=dev)
    rbeg[torch.where(f_valid, flat_idx, B * C)] = rbeg_f
    return (rbeg[:B * C].reshape(B, C), seed_idx, coord_valid, total,
            overflow)
