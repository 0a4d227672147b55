"""SMEM buffers and the compaction helpers the seeding machines share.

Counterpart of the buffer half of ``bwa_mem_scale_tpu/ops/smem.py``
(``SmemBuf``, ``compact_indices``, ``concat_smems``, ``_emit_compact``);
the position-parallel sweep engine there is not ported.

Scatters that JAX writes as ``.at[...].set(..., mode="drop")`` land here
in a buffer one slot wider than needed: dropped writes go to the extra
slot, which is cut off afterwards, so no write needs a host-side mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def _emit_compact(mask, cols_m, cols_n, k, l, s, out: SmemBuf, rows):
    """Scatter every masked task record into its read's slots at once.

    mask/values [T, L], rows [T] = task -> read (tasks sorted by read).
    Slot = the read's running count + the emissions of its earlier
    tasks + the within-task rank, in column order; slots past the
    buffer width drop (the count still grows)."""
    B, M = out.m.shape
    T, L = mask.shape
    dev = mask.device
    rows = rows.long()
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
