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

``DeviceFMIndex.from_host_cached`` keeps the JAX package's host layout
of such an index in ``<prefix>.devlayout3.npz`` (``_int64_layout``: the
same name, keys, dtypes and shapes, so either package reads the file the
other wrote) and builds the device layout above from it: a warm start
maps the file and skips the host transforms of the counts and samples.

With a k-gram checkpoint table (``index/kstep.py``, int32 layout only),
``cp_kstep`` holds it in the device layout ``kstep_rows`` makes: one
pair of row fetches extends an interval by two or three bases
(``backward_ext2``, ``backward_ext3``, ``forward_ext2``,
``forward_ext3``, ``backward_ext_steps_and_1``; the JAX package's
primitives of the same names). The plain versions here read the same
tensor as the kernels.

Torch has no unsigned 32-bit shift on the CPU and no popcount op, so
masks are widened to int64 before shifting and counted with a SWAR
popcount. Every gather clamps its index into range at 64 bits, as a JAX
gather does, so lanes that carry stale state read in-range junk that
callers mask.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..index.artifacts import FMIndex, CP_SHIFT, CP_MASK
from ..utils.npzmap import load_npz_mmap

_M32 = 0xFFFFFFFF
# the high-word steps a base may have on the int64 layout, and the pad of
# an unused entry (a block no row reaches)
HI_STEPS = 8
NO_STEP = 1 << 62
# past this many bytes the JAX package's cache packs the reference
# [n/128, 128] (a 1-D operand past 32-bit indices cannot be gathered on a
# TPU); the file keeps that shape here too
REF_2D_LIMIT = (1 << 31) - (1 << 20)
# SA samples combined on the device a chunk at a time (bounds the int64
# temporaries at genome scale)
_SA_CHUNK = 1 << 26


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
    return steps_of_high_words(np.asarray(cp_count, np.int64) >> 32)


def steps_of_high_words(hi: np.ndarray) -> np.ndarray:
    """hi_steps from the counts' high words `hi` [nb, 4], of any integer
    dtype (the cache's uint8 ``cp_hi`` is searched as it is)."""
    out = np.full((4, HI_STEPS), NO_STEP, np.int64)
    if not hi.size:
        return out
    if any((hi[:, c] < 0).any() or (hi[1:, c] < hi[:-1, c]).any()
           for c in range(4)):
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
    # the k-gram checkpoint table (int32 layout only): [nb, 40 | 168]
    # int32 in kstep_rows' layout, and its C2 [16] and C3 [64] (K = 3)
    # int32 tables, which the kernels read from the device
    cp_kstep: Optional[torch.Tensor] = None
    count2: Optional[torch.Tensor] = None
    count3: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.cp_fused.device

    @property
    def pos_dtype(self) -> torch.dtype:
        return self.count.dtype

    @property
    def kstep(self) -> int:
        """Bases a k-gram row fetch extends by: 3 (trigram table), 2
        (bigram) or 1 (no table)."""
        if self.cp_kstep is None:
            return 1
        return 3 if self.count3 is not None else 2

    def nbytes(self) -> int:
        """Device bytes of the index's arrays, the k-gram table's
        included."""
        ts = (self.count, self.cp_fused, self.cp_hi_steps, self.sa_samples,
              self.ref, self.cp_kstep, self.count2, self.count3)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    @classmethod
    def from_host(cls, idx: FMIndex, device, force_int64: bool = False,
                  cp2=None) -> "DeviceFMIndex":
        """The int64 layout when positions pass int32
        (``idx.pos_fits_int32`` false) or when forced, else the int32
        one. `cp2` (``index/kstep.Cp2Table``) uploads the k-gram table;
        the int64 layout refuses it, as the JAX package does."""
        wide = force_int64 or not idx.pos_fits_int32
        if cp2 is not None and wide:
            raise ValueError("k-step table is int32-path only")
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
        kstep = {}
        if cp2 is not None:
            kstep = dict(
                cp_kstep=torch.as_tensor(kstep_rows(cp2.fused), device=dev),
                count2=host_tensor(cp2.c2, np.int32, dev),
                count3=(None if cp2.c3 is None
                        else host_tensor(cp2.c3, np.int32, dev)))
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
            **kstep,
        )

    @staticmethod
    def _pack_ref(ref: np.ndarray) -> np.ndarray:
        """The JAX package's device reference: [n] bytes, zero-padded to a
        multiple of 128 from 4096 bytes on, and packed [n/128, 128] past
        REF_2D_LIMIT."""
        if ref.shape[0] <= REF_2D_LIMIT:
            if ref.shape[0] >= 4096:
                pad = (-ref.shape[0]) % 128
                if pad:
                    ref = np.concatenate(
                        [ref, np.zeros(pad, dtype=ref.dtype)])
            return ref
        pad = (-ref.shape[0]) % 128
        if pad:
            ref = np.concatenate([ref, np.zeros(pad, dtype=ref.dtype)])
        return ref.reshape(-1, 128)

    @classmethod
    def _int64_layout(cls, idx: FMIndex) -> dict:
        """The JAX package's host layout of an int64-position index, the
        arrays of the .devlayout3.npz cache: ``cp_fused32`` [nb, 8] uint32
        (the counts' low words | the masks), ``cp_hi`` [nb, 4] uint8 (the
        counts' high bytes), the SA samples' high byte ``sa_ms`` uint8
        and low word ``sa_ls`` uint32, and the forward strand ``ref``
        (``_pack_ref``)."""
        cnt = np.ascontiguousarray(idx.cp_count, dtype=np.int64)
        fused32 = np.concatenate(
            [(cnt & _M32).astype(np.uint32),
             np.asarray(idx.cp_mask).view(np.uint32).reshape(-1, 4)],
            axis=1)
        sa = np.ascontiguousarray(idx.sa_samples, dtype=np.int64)
        return dict(
            cp_fused32=fused32,
            cp_hi=(cnt >> 32).astype(np.uint8),
            sa_ms=(sa >> 32).astype(np.uint8),
            sa_ls=(sa & _M32).astype(np.uint32),
            ref=cls._pack_ref(
                np.asarray(idx.ref_string)[: idx.bns.l_pac]),
        )

    @classmethod
    def from_host_cached(cls, idx: FMIndex, device,
                         cp2=None) -> "DeviceFMIndex":
        """from_host, with the host layout of an index whose positions
        pass int32 kept in ``<source_prefix>.devlayout3.npz`` (written
        first when missing: a temporary name in the same directory, then
        renamed) and the device layout built from that file, tensor for
        tensor equal to ``from_host(force_int64=True)``. An int32 index,
        or one with no source_prefix (attached to a store), takes
        from_host; a k-step table on the wide layout raises, as in the
        JAX package."""
        prefix = getattr(idx, "source_prefix", None)
        if idx.pos_fits_int32 or not prefix:
            return cls.from_host(idx, device, cp2=cp2)
        if cp2 is not None:
            raise ValueError("k-step table is int32-path only")
        path = prefix + ".devlayout3.npz"
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **cls._int64_layout(idx))
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return cls._from_layout(idx, load_npz_mmap(path), path, device)

    @classmethod
    def _from_layout(cls, idx: FMIndex, z: dict, path: str,
                     device) -> "DeviceFMIndex":
        """The int64 device layout from the cache's arrays `z`; a
        ValueError naming `path` when they do not fit the index."""
        nb = np.asarray(idx.cp_count).shape[0]
        ns = len(idx.sa_samples)
        l_pac = int(idx.bns.l_pac)
        n_ref = l_pac + (-l_pac) % 128 if l_pac >= 4096 else l_pac
        want = dict(cp_fused32=((nb, 8), np.uint32),
                    cp_hi=((nb, 4), np.uint8), sa_ms=((ns,), np.uint8),
                    sa_ls=((ns,), np.uint32),
                    ref=((n_ref,) if l_pac <= REF_2D_LIMIT
                         else (n_ref // 128, 128), np.uint8))
        for k, (shape, dt) in want.items():
            if k not in z or z[k].shape != shape or z[k].dtype != dt:
                got = (f"{z[k].dtype} {z[k].shape}" if k in z
                       else "missing")
                raise ValueError(
                    f"{path}: {k} is {got}, the index needs "
                    f"{np.dtype(dt)} {shape} (a stale device-layout "
                    f"cache; remove it to rebuild)")
        dev = torch.device(device)
        steps = steps_of_high_words(z["cp_hi"])
        ms = host_tensor(z["sa_ms"], np.uint8, dev)
        ls = host_tensor(z["sa_ls"].view(np.int32), np.int32, dev)
        sa = torch.empty(ns, dtype=torch.int64, device=dev)
        for a in range(0, ns, _SA_CHUNK):
            b = min(a + _SA_CHUNK, ns)
            sa[a:b] = (ms[a:b].long() << 32) | (ls[a:b].long() & _M32)
        del ms, ls
        fw = host_tensor(z["ref"].reshape(-1)[:l_pac], np.uint8, dev)
        ref = torch.empty(2 * l_pac, dtype=torch.uint8, device=dev)
        ref[:l_pac] = fw
        ref[l_pac:] = 3 - fw.flip(0)
        return cls(
            count=host_tensor(idx.count, np.int64, dev),
            cp_fused=host_tensor(z["cp_fused32"].view(np.int32), np.int32,
                                 dev),
            cp_hi_steps=torch.as_tensor(steps, device=dev),
            sa_samples=sa,
            ref=ref,
            sentinel_index=int(idx.sentinel_index),
            sa_compx=int(idx.sa_compx),
            l_pac=l_pac,
            seq_len=int(idx.seq_len),
            count_host=[int(v) for v in np.asarray(idx.count)],
            hi_counts=[int((s != NO_STEP).sum()) for s in steps],
        )


def kstep_rows(fused: np.ndarray) -> np.ndarray:
    """The device layout of a k-gram table: the file's row
    (``index/kstep.py``: counts2[16] | masks2[16] | counts1[4] |
    masks1[4], K = 3 prefixed by counts3[64] | masks3[64]) regrouped so
    that what one step reads is one 32-byte group: the 1-step row
    (counts1 | masks1), then for each first base c1 the group
    counts2[4 c1 .. 4 c1 + 3] | masks2[4 c1 .. 4 c1 + 3], then (K = 3) for
    each pair p = 4 c1 + c2 the group counts3[4 p ..] | masks3[4 p ..].
    A 2-step reads two groups an end (the 1-step row and its c1 group), a
    3-step three; the bytes stay 160 or 672 a block. [nb, 40 | 168]
    int32."""
    f = np.asarray(fused, np.int32)
    nb, w = f.shape
    if w not in (40, 168):
        raise ValueError(f"a k-gram row has 40 or 168 words, not {w}")
    off = w - 40

    def groups(lo, n):
        cnt = f[:, lo:lo + 4 * n].reshape(nb, n, 1, 4)
        msk = f[:, lo + 4 * n:lo + 8 * n].reshape(nb, n, 1, 4)
        return np.concatenate([cnt, msk], axis=2).reshape(nb, 8 * n)

    parts = [f[:, off + 32:off + 40], groups(off, 4)]
    if off:
        parts.append(groups(0, 16))
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


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


# ---- the k-gram (k-step) extensions ---------------------------------------

def _pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[..., i] for a per-lane index i (the JAX package's _take_c)."""
    return v.gather(-1, i.long()[..., None])[..., 0]


def _suffix_sum(v: torch.Tensor) -> torch.Tensor:
    """suf[..., c] = sum over d > c of v[..., d]."""
    return torch.flip(torch.cumsum(torch.flip(v, [-1]), -1, dtype=v.dtype),
                      [-1]) - v


def _occ12_at(fmi: DeviceFMIndex, pp: torch.Tensor, want3: bool = False):
    """(occ1 [..., 4], occ2 [..., 16][, occ3 [..., 64] or None]) at
    positions pp from one k-gram row each (``kstep_rows``' layout; the
    row clamped into range)."""
    t = fmi.cp_kstep
    blk = (pp.long() >> CP_SHIFT).clamp(0, t.shape[0] - 1)
    row = t[blk]                                     # [..., 40 | 168]
    top = _top_mask((pp & CP_MASK).long())[..., None]
    sh = pp.shape

    def occ(g, n):
        g = g.reshape(*sh, n, 2, 4)
        pc = popcount32(g[..., 1, :].long() & _M32 & top[..., None])
        return (g[..., 0, :] + pc.to(g.dtype)).reshape(*sh, 4 * n)

    occ1 = occ(row[..., :8], 1)
    occ2 = occ(row[..., 8:40], 4)
    if not want3:
        return occ1, occ2
    return occ1, occ2, (occ(row[..., 40:], 16) if t.shape[1] > 40 else None)


def _sent(fmi: DeviceFMIndex, k, s):
    return ((k <= fmi.sentinel_index)
            & (k + s > fmi.sentinel_index)).to(k.dtype)


def _two_steps(fmi, occ1_k, occ1_e, occ2_k, occ2_e, k, l, s, c1, c2,
               occ3_k=None, occ3_e=None, c3=None):
    """The 2- (or 3-)step interval update from the occ values at k and
    k + s (see backward_ext2): each deeper step the same recipe one
    k-gram level up, with its own sentinel correction on the interval
    before it."""
    c1, c2 = c1.long(), c2.long()
    s1_4 = occ1_e - occ1_k
    k1 = fmi.count[c1] + _pick(occ1_k, c1)
    s1 = _pick(s1_4, c1)
    l1 = l + _sent(fmi, k, s) + _pick(_suffix_sum(s1_4), c1)

    pair = c1 * 4 + c2
    s2_16 = occ2_e - occ2_k
    k2 = fmi.count2[pair] + _pick(occ2_k, pair)
    s2 = _pick(s2_16, pair)
    grp = c1[..., None] * 4 + torch.arange(4, device=c1.device)
    s2_grp = s2_16.gather(-1, grp)                   # s''(c) of (c1 -> c)
    l2 = l1 + _sent(fmi, k1, s1) + _pick(_suffix_sum(s2_grp), c2)
    if c3 is None:
        return (k1, l1, s1), (k2, l2, s2)

    c3 = c3.long()
    tri = pair * 4 + c3
    s3_64 = occ3_e - occ3_k
    k3 = fmi.count3[tri] + _pick(occ3_k, tri)
    s3 = _pick(s3_64, tri)
    grp3 = pair[..., None] * 4 + torch.arange(4, device=c1.device)
    s3_grp = s3_64.gather(-1, grp3)
    l3 = l2 + _sent(fmi, k2, s2) + _pick(_suffix_sum(s3_grp), c3)
    return (k1, l1, s1), (k2, l2, s2), (k3, l3, s3)


def backward_ext2(fmi: DeviceFMIndex, k, l, s, c1, c2):
    """Backward extension by per-lane bases c1 then c2 from one k-gram row
    at k and one at k + s. Returns ((k1, l1, s1), (k2, l2, s2)): the
    single-step result, which callers need where a walk ends mid-stride,
    and the 2-step one; equal to two chained backward extensions."""
    o1, o2 = _occ12_at(fmi, torch.stack([k, k + s]))
    return _two_steps(fmi, o1[0], o1[1], o2[0], o2[1], k, l, s, c1, c2)


def backward_ext3(fmi: DeviceFMIndex, k, l, s, c1, c2, c3):
    """Three backward extensions from one trigram row at each end; equal
    to three chained backward extensions."""
    o1, o2, o3 = _occ12_at(fmi, torch.stack([k, k + s]), want3=True)
    return _two_steps(fmi, o1[0], o1[1], o2[0], o2[1], k, l, s, c1, c2,
                      occ3_k=o3[0], occ3_e=o3[1], c3=c3)


def backward_ext_steps_and_1(fmi: DeviceFMIndex, k, l, s, chars,
                             kB, lB, sB, cB, sides=()):
    """The K-step backward extension of (k, l, s) by chars[0..K-1] (K = 2
    or 3, 3 with the trigram table) and the single-step extensions of
    (kB, lB, sB) by cB and of each (kX, lX, sX, cX) in `sides`, all from
    one k-gram row fetch over every position. Returns (the K step
    tuples..., B's tuple, each side's tuple)."""
    want3 = len(chars) == 3
    parts = [k, k + s, kB, kB + sB]
    for kX, _, sX, _ in sides:
        parts += [kX, kX + sX]
    occ = _occ12_at(fmi, torch.stack(parts), want3=want3)
    o1, o2 = occ[0], occ[1]
    kw = {}
    if want3:
        kw = dict(occ3_k=occ[2][0], occ3_e=occ[2][1], c3=chars[2])
    steps = _two_steps(fmi, o1[0], o1[1], o2[0], o2[1], k, l, s, chars[0],
                       chars[1], **kw)

    def one_step(i, kX, lX, sX, cX):
        s1_4 = o1[i + 1] - o1[i]
        cX = cX.long()
        return (fmi.count[cX] + _pick(o1[i], cX), lX + _sent(fmi, kX, sX)
                + _pick(_suffix_sum(s1_4), cX), _pick(s1_4, cX))

    out = steps + (one_step(2, kB, lB, sB, cB),)
    for si, (kX, lX, sX, cX) in enumerate(sides):
        out = out + (one_step(4 + 2 * si, kX, lX, sX, cX),)
    return out


def forward_ext2(fmi: DeviceFMIndex, k, l, s, a, b):
    """Two forward extensions (append a, then b): backward_ext2 on the
    swapped interval by the complements, swapped back."""
    (k1, l1, s1), (k2, l2, s2) = backward_ext2(fmi, l, k, s, 3 - a, 3 - b)
    return (l1, k1, s1), (l2, k2, s2)


def forward_ext3(fmi: DeviceFMIndex, k, l, s, a, b, c):
    """Three forward extensions through the swap and complement."""
    t = backward_ext3(fmi, l, k, s, 3 - a, 3 - b, 3 - c)
    return tuple((v[1], v[0], v[2]) for v in t)
