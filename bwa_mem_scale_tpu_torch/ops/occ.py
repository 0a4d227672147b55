"""Device FM index: occ counting and backward extension on tensors.

Counterpart of ``bwa_mem_scale_tpu/ops/occ.py``, int32-position layout
only: the checkpointed BWT is one fused ``[nb, 8]`` int32 table (four
exclusive base counts, then four one-hot 32-bp block masks stored as
int32 bit patterns), so occ(p, *) is one row gather plus a masked
popcount. Mask bits are MSB-first (``CP_SHIFT = 5``).

Torch has no unsigned 32-bit shift on the CPU and no popcount op, so
masks are widened to int64 before shifting and counted with a SWAR
popcount. Every gather clamps its index into range, as a JAX gather
does, so lanes that carry stale state read in-range junk that callers
mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.artifacts import FMIndex, CP_SHIFT, CP_MASK

_M32 = 0xFFFFFFFF


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] along dim 0 with idx clamped into range (JAX gather
    semantics for in-bounds-or-junk indices)."""
    return t[idx.long().clamp(0, t.shape[0] - 1)]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


@dataclasses.dataclass
class DeviceFMIndex:
    """FM-index arrays resident on one device (int32 positions)."""

    count: torch.Tensor       # [5] int32 C-array
    cp_fused: torch.Tensor    # [nb, 8] int32 (counts | mask bits)
    sa_samples: torch.Tensor  # [ns] int32
    ref: torch.Tensor         # [2*l_pac] uint8 fw+rc reference
    sentinel_index: int
    sa_compx: int
    l_pac: int
    seq_len: int
    count_host: list          # the C array as host ints (kernel arguments)

    @property
    def device(self) -> torch.device:
        return self.cp_fused.device

    @classmethod
    def from_host(cls, idx: FMIndex, device) -> "DeviceFMIndex":
        if not idx.pos_fits_int32:
            raise NotImplementedError(
                "int64-position genomes (seq_len >= 2^31) are not ported "
                "yet: the port has the int32 layout only")
        fused = np.concatenate(
            [np.asarray(idx.cp_count).astype(np.int32),
             np.asarray(idx.cp_mask).view(np.int32).reshape(-1, 4)],
            axis=1)
        dev = torch.device(device)
        return cls(
            count=torch.as_tensor(np.asarray(idx.count, np.int32),
                                  device=dev),
            cp_fused=torch.as_tensor(fused, device=dev),
            sa_samples=torch.as_tensor(
                np.asarray(idx.sa_samples, np.int32), device=dev),
            ref=torch.as_tensor(np.array(idx.ref_string, np.uint8),
                                device=dev),
            sentinel_index=int(idx.sentinel_index),
            sa_compx=int(idx.sa_compx),
            l_pac=int(idx.bns.l_pac),
            seq_len=int(idx.seq_len),
            count_host=[int(v) for v in np.asarray(idx.count)],
        )


def _row_at(fmi: DeviceFMIndex, pp: torch.Tensor):
    """(counts [..., 4] int32, masks [..., 4] int64 in [0, 2^32), y)
    for the checkpoint rows holding positions pp."""
    row = take(fmi.cp_fused, pp >> CP_SHIFT)
    return row[..., :4], row[..., 4:].long() & _M32, (pp & CP_MASK).long()


def _top_mask(y: torch.Tensor) -> torch.Tensor:
    """The top y bits of a 32-bit word (y in [0, 31]); 0 for y == 0."""
    return ((1 << y) - 1) << (32 - y)


def ref_byte(ref: torch.Tensor, pos: torch.Tensor, l_pac: int
             ) -> torch.Tensor:
    """Reference base at fw+rc position(s) in [0, 2*l_pac) as int32
    (positions clamped into that range)."""
    return ref[pos.long().clamp(0, 2 * l_pac - 1)].to(torch.int32)


def occ_all4(fmi: DeviceFMIndex, pp: torch.Tensor) -> torch.Tensor:
    """occ(pp, c) for all four bases. pp [...], returns [..., 4]."""
    counts, masks, y = _row_at(fmi, pp)
    pc = popcount32(masks & _top_mask(y)[..., None])
    return counts + pc.to(torch.int32)


def backward_ext_all4(fmi: DeviceFMIndex, k, l, s):
    """Backward extension of intervals (k, l, s) by every base, with
    the reference's sentinel correction. Returns (k4, l4, s4), each
    [..., 4]. One gather over the doubled position set."""
    occ = occ_all4(fmi, torch.stack([k, k + s]))
    occ_sp, occ_ep = occ[0], occ[1]
    k4 = fmi.count[:4] + occ_sp
    s4 = occ_ep - occ_sp
    sent = ((k <= fmi.sentinel_index)
            & (k + s > fmi.sentinel_index)).to(k.dtype)
    l3 = l + sent
    l2 = l3 + s4[..., 3]
    l1 = l2 + s4[..., 2]
    l0 = l1 + s4[..., 1]
    return k4, torch.stack([l0, l1, l2, l3], dim=-1), s4


def sa_sample_at(fmi: DeviceFMIndex, idx: torch.Tensor) -> torch.Tensor:
    """SA sample at sample-index idx."""
    return take(fmi.sa_samples, idx)


def _base_from_masks(masks: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """BWT base at in-block offset y from one-hot masks; 4 when no
    mask has the bit (the sentinel row)."""
    bits = (masks >> (31 - y)[..., None]) & 1           # [..., 4]
    b = torch.argmax(bits, dim=-1).to(torch.int32)
    return torch.where(bits.sum(-1) == 0, 4, b)


def bwt_base_at(fmi: DeviceFMIndex, pos: torch.Tensor) -> torch.Tensor:
    """Base code of BWT[pos] ([...] int32); 4 at the sentinel row."""
    _, masks, y = _row_at(fmi, pos)
    return _base_from_masks(masks, y)


def occ_b_and_base(fmi: DeviceFMIndex, pos: torch.Tensor):
    """(occ(pos, BWT[pos]), BWT[pos]): the LF step of the SA walk."""
    counts, masks, y = _row_at(fmi, pos)
    b = _base_from_masks(masks, y)
    bc = b.long().clamp(0, 3)[..., None]
    mask_b = masks.gather(-1, bc)[..., 0]
    pc = popcount32(mask_b & _top_mask(y))
    return counts.gather(-1, bc)[..., 0] + pc.to(torch.int32), b
