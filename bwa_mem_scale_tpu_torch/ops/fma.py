"""FMA — the FM-index Accelerator (the reference's "smem-table").

Counterpart of ``bwa_mem_scale_tpu/ops/fma.py``. One ladder table
    ladder_{k,l,s}[4^K, K]   (k, l, s) after extending the j-th base
                             of each K-mer, j = 1..K
built by the search's own forward extension (``ops/occ.forward_ext``), so
resolving the first K steps of a sweep lane from it is bit-identical to
running them (the reference's all_smem_t, src/FMI_search.cpp:78-153,
:1414-1463). The sweep engine (``ops/smem.py::extend_all_positions``)
starts each lane from its K-mer's row; its kernel
(``csrc/sweep.cu``) reads that row itself, and ``fast_forward`` here is
the plain version of that start.

The file is the JAX package's: ``{prefix}.fma{K}.npz`` holding K and the
three ladders as int64, so a table written by either package loads in
the other. On the device the ladders take the index's position dtype:
3 x 4^11 x 11 entries at the default K = 11, 553.6 MB at int32 and 1.1
GB at int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .occ import DeviceFMIndex, forward_ext, host_tensor

DEFAULT_FMA_K = 11  # reference ALL_SMEM_MAX_BP (src/FMI_search.h:106)


@dataclasses.dataclass
class DeviceFmaTable:
    """The ladder table on a device, at the index's position dtype."""

    ladder_k: torch.Tensor   # [4^K, K]
    ladder_l: torch.Tensor   # [4^K, K]
    ladder_s: torch.Tensor   # [4^K, K]
    K: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ladder_k, self.ladder_l, self.ladder_s))


@dataclasses.dataclass
class FmaTable:
    """The host-side table (the reference's .all_smem.<K> file): int64
    ladders [4^K, K]."""

    K: int
    ladder_k: np.ndarray
    ladder_l: np.ndarray
    ladder_s: np.ndarray

    def to_device(self, pos_dtype: torch.dtype, device="cpu"
                  ) -> DeviceFmaTable:
        npd = np.int64 if pos_dtype == torch.int64 else np.int32
        return DeviceFmaTable(*(host_tensor(a, npd, device) for a in (
            self.ladder_k, self.ladder_l, self.ladder_s)), self.K)


def build_fma_table(fmi: DeviceFMIndex, K: int = DEFAULT_FMA_K,
                    chunk: int = 1 << 18) -> FmaTable:
    """Every K-mer's extension ladder, K - 1 forward steps over `chunk`
    K-mers at a time on fmi's device (build_all_smem_table,
    src/FMI_search.cpp:78-153). Returns the host table."""
    N = 4 ** K
    dev = fmi.device
    shifts = torch.as_tensor(2 * (K - 1 - np.arange(K)), device=dev)
    out = [np.empty((N, K), dtype=np.int64) for _ in range(3)]
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        b = (ids[:, None] >> shifts[None, :]) & 3
        a0 = b[:, 0]
        k, l = fmi.count[a0], fmi.count[3 - a0]
        s = fmi.count[a0 + 1] - k
        steps = [(k, l, s)]
        for j in range(1, K):
            k, l, s = forward_ext(fmi, k, l, s, b[:, j])
            steps.append((k, l, s))
        for i, o in enumerate(out):
            o[lo:hi] = torch.stack([st[i] for st in steps], 1).cpu().numpy()
    return FmaTable(K, *out)


def save_fma(fma: FmaTable, prefix: str) -> str:
    path = f"{prefix}.fma{fma.K}.npz"
    np.savez(path, K=np.int64(fma.K), ladder_k=fma.ladder_k,
             ladder_l=fma.ladder_l, ladder_s=fma.ladder_s)
    return path


def load_fma(path: str) -> FmaTable:
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    return FmaTable(K=int(z["K"]), ladder_k=z["ladder_k"],
                    ladder_l=z["ladder_l"], ladder_s=z["ladder_s"])


def fast_forward(fmi: DeviceFMIndex, fma: DeviceFmaTable, codes, lens, mi,
                 check_initial: bool, K_eff: int, n_pos: int = 0):
    """The first K_eff extension steps of every (read, start) lane from
    the ladder table: (E, k, l, s, active, died_s) [B, P] as
    ``extend_all_positions`` has them after K_eff lockstep steps. A
    lane's j* is the steps it survives in the window (every in-range
    non-N base, and with check_initial every ladder size >= its row's
    mi); E = p + j*, (k, l, s) = the ladder at j* (zeros for j* = 0);
    active = the lane extends past the window; died_s = it stopped on a
    size inside it. mi [B, 1] at fmi's position dtype."""
    B, L = codes.shape
    P = n_pos or L
    K = fma.K
    dev = codes.device
    pcol = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    codes_pad = torch.cat([codes, torch.full((B, K), 4, dtype=codes.dtype,
                                             device=dev)], 1)
    w = torch.stack([codes_pad[:, i:i + P] for i in range(K)], -1)
    in_read = ((pcol[..., None] + torch.arange(K, device=dev))
               < lens[:, None, None])
    base_ok = (w >= 0) & (w < 4) & in_read                    # [B, P, K]
    lead = torch.cumprod(base_ok[..., :K_eff].to(torch.int32), -1)
    cap = lead.sum(-1, dtype=torch.int32)                     # [B, P]
    pow4 = torch.as_tensor(4 ** (K - 1 - np.arange(K)), device=dev)
    km = (w.clamp(0, 3).long() * pow4).sum(-1)                # [B, P]
    s_lad = fma.ladder_s[km]                                  # [B, P, K]
    if check_initial:
        ok = (s_lad[..., :K_eff] >= mi[..., None]).to(torch.int32)
        n_ok = torch.cumprod(ok, -1).sum(-1, dtype=torch.int32)
        jstar = torch.minimum(n_ok, cap)
    else:
        jstar = cap
    jm1 = (jstar - 1).clamp(min=0).long()
    flat = km * K + jm1
    has = jstar >= 1
    k = torch.where(has, fma.ladder_k.reshape(-1)[flat], 0)
    l = torch.where(has, fma.ladder_l.reshape(-1)[flat], 0)
    s = torch.where(has, s_lad.gather(-1, jm1[..., None])[..., 0], 0)
    E = pcol + jstar
    active = (jstar == K_eff) & ((pcol + K_eff) < lens[:, None])
    return E, k, l, s, active, jstar < cap
