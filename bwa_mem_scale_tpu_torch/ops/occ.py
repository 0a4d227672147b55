"""Device FM index: occ counting and backward extension on tensors.

Counterpart of ``bwa_mem_scale_tpu/ops/occ.py``. The checkpointed BWT is
one fused ``[nb, 8]`` int32 table (four exclusive base counts, then four
one-hot 32-bp block masks stored as int32 bit patterns), so occ(p, *) is
one row gather plus a masked popcount. Mask bits are MSB-first
(``CP_SHIFT = 5``).

Two layouts, chosen by ``DeviceFMIndex.from_host``:
- int32 positions (``seq_len < 2^31``): the row's counts are the counts;
  the C array and the SA samples are int32.
- int64 positions (``seq_len >= 2^31``, hg38's 6.2e9 fw+rc positions, or
  forced): the row keeps its 32 bytes, one sector a dependent FM step,
  with the low 32 bits of each count. The high word of a count never
  falls along the BWT, so it is a step function of the block: per base,
  the sorted blocks where it steps (``cp_hi_steps``, [4, HI_STEPS], at
  most HI_STEPS steps a base, so a base count below 9 x 2^32). At hg38
  no base count reaches 2^32 (the most common, A+T over fw+rc, is ~1.8e9)
  and the list is empty, so a step costs no second load. The C array,
  the sentinel row and the SA samples are int64 (8 bytes a sample, one
  load). The reference stays fw+rc bytes. This differs from the JAX
  package's TPU layout (a [nb, 4] uint8 high-count byte beside each row,
  a 5-byte SA, a forward-only reference); the arrays the functions
  return are the same, dtypes included.

Torch has no unsigned 32-bit shift on the CPU and no popcount op, so
masks are widened to int64 before shifting and counted with a SWAR
popcount. Every gather clamps its index into range at 64 bits, as a JAX
gather does, so lanes that carry stale state read in-range junk that
callers mask.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..index.artifacts import FMIndex, CP_SHIFT, CP_MASK

_M32 = 0xFFFFFFFF
# the high-word steps a base may have on the int64 layout, and the pad of
# an unused entry (a block no row reaches)
HI_STEPS = 8
NO_STEP = 1 << 62


def host_tensor(a, dtype, device) -> torch.Tensor:
    """The host array `a` as a tensor of numpy `dtype` on `device`. A
    read-only array (a map of an index file or of a staged store) goes to
    a card straight from the mapping, with no second host copy; on the CPU
    it is copied, so that the tensor owns writable memory."""
    a = np.asarray(a, dtype)
    dev = torch.device(device)
    if a.flags.writeable:
        return torch.as_tensor(a, device=dev)
    if dev.type == "cpu":
        return torch.from_numpy(a.copy())
    with warnings.catch_warnings():
        # torch warns of a read-only buffer; .to() only reads it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a).to(dev)


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


def hi_steps(cp_count: np.ndarray) -> np.ndarray:
    """[4, HI_STEPS] int64: for each base, the first block at which the
    high word (count >> 32) of its checkpoint count reaches 1, 2, ...
    (NO_STEP past the last). ValueError where the counts fall along the
    BWT or a base needs more than HI_STEPS steps."""
    hi = np.asarray(cp_count, np.int64) >> 32
    out = np.full((4, HI_STEPS), NO_STEP, np.int64)
    if not hi.size:
        return out
    if (hi < 0).any() or (np.diff(hi, axis=0) < 0).any():
        raise ValueError("checkpoint counts fall along the BWT")
    for c in range(4):
        n = int(hi[-1, c])
        if n > HI_STEPS:
            raise ValueError(f"base {c}'s count passes {HI_STEPS + 1} x "
                             f"2^32: more high-word steps than the layout "
                             f"holds")
        out[c, :n] = np.searchsorted(hi[:, c], np.arange(1, n + 1))
    return out


@dataclasses.dataclass
class DeviceFMIndex:
    """FM-index arrays resident on one device (module docstring: the two
    layouts)."""

    count: torch.Tensor       # [5] pos_dtype C-array
    cp_fused: torch.Tensor    # [nb, 8] int32 (counts or their low words
                              #   | mask bits)
    cp_hi_steps: Optional[torch.Tensor]   # int64 layout: [4, HI_STEPS]
                              #   int64 (hi_steps); None on the int32 one
    sa_samples: torch.Tensor  # [ns] pos_dtype
    ref: torch.Tensor         # [2*l_pac] uint8 fw+rc reference
    sentinel_index: int
    sa_compx: int
    l_pac: int
    seq_len: int
    count_host: list          # the C array as host ints (kernel arguments)
    hi_counts: list           # the steps of each base (kernel arguments)

    @property
    def device(self) -> torch.device:
        return self.cp_fused.device

    @property
    def pos_dtype(self) -> torch.dtype:
        return self.count.dtype

    def nbytes(self) -> int:
        """Device bytes of the index's arrays."""
        ts = (self.count, self.cp_fused, self.cp_hi_steps, self.sa_samples,
              self.ref)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    @classmethod
    def from_host(cls, idx: FMIndex, device,
                  force_int64: bool = False) -> "DeviceFMIndex":
        """The int64 layout when positions pass int32
        (``idx.pos_fits_int32`` false) or when forced, else the int32
        one."""
        wide = force_int64 or not idx.pos_fits_int32
        pos = np.int64 if wide else np.int32
        cnt = np.asarray(idx.cp_count)
        masks = np.asarray(idx.cp_mask).view(np.int32).reshape(-1, 4)
        dev = torch.device(device)
        steps = None
        if wide:
            cnt = np.asarray(cnt, np.int64)
            steps = hi_steps(cnt)
            low = (cnt & _M32).astype(np.uint32).view(np.int32)
        else:
            low = cnt.astype(np.int32)
        fused = np.concatenate([low, masks], axis=1)
        return cls(
            count=host_tensor(idx.count, pos, dev),
            cp_fused=torch.as_tensor(fused, device=dev),
            cp_hi_steps=(None if steps is None
                         else torch.as_tensor(steps, device=dev)),
            sa_samples=host_tensor(idx.sa_samples, pos, dev),
            ref=host_tensor(idx.ref_string, np.uint8, dev),
            sentinel_index=int(idx.sentinel_index),
            sa_compx=int(idx.sa_compx),
            l_pac=int(idx.bns.l_pac),
            seq_len=int(idx.seq_len),
            count_host=[int(v) for v in np.asarray(idx.count)],
            hi_counts=([] if steps is None else
                       [int((s != NO_STEP).sum()) for s in steps]),
        )


def _row_at(fmi: DeviceFMIndex, pp: torch.Tensor):
    """(counts [..., 4] pos_dtype, masks [..., 4] int64 in [0, 2^32), y)
    for the checkpoint rows holding positions pp (the block clamped at 64
    bits)."""
    blk = (pp.long() >> CP_SHIFT).clamp(0, fmi.cp_fused.shape[0] - 1)
    row = fmi.cp_fused[blk]
    counts = row[..., :4]
    if fmi.cp_hi_steps is not None:
        hi = (blk[..., None, None] >= fmi.cp_hi_steps).sum(-1)
        counts = (hi << 32) | (counts.long() & _M32)
    return counts, row[..., 4:].long() & _M32, (pp & CP_MASK).long()


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
    return counts + pc.to(counts.dtype)


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
    return counts.gather(-1, bc)[..., 0] + pc.to(counts.dtype), b


def forward_ext(fmi: DeviceFMIndex, k, l, s, a):
    """Forward extension of (k, l, s) by base a [...] (values 0..3): the
    backward extension of the swapped interval (l, k, s) by the
    complement 3 - a, swapped back (FMI_search.cpp:1477-1484)."""
    k4, l4, s4 = backward_ext_all4(fmi, l, k, s)
    c = (3 - a).long().clamp(0, 3)[..., None]
    pick = lambda v: v.gather(-1, c)[..., 0]
    return pick(l4), pick(k4), pick(s4)
