"""Banded Smith-Waterman extension through the hand-written CUDA kernel.

``banded_swa_batch_cuda`` has the signature of the JAX package's
``banded_swa_batch_pallas`` and replaces it. On CUDA tensors it
launches ``csrc/bsw.cu`` or raises; on CPU tensors it runs the plain
PyTorch version (``ops/bsw.py``). There is no fallback from the kernel
to the plain version.

The kernel runs one warp per pair; lane l holds K = ceil((QL + 1) / 32)
columns of the DP row. It is instantiated for the K of ``K_VALUES``, in
registers up to K = 8 (queries up to 255 columns) and in shared memory
up to K = 24 (``MAX_QL`` = 767 columns). A wider query, which reaches
BSW once ``-W`` > 0 lifts the seed-SW threshold (22 W: 880 columns
under ``-x pacbio``, unbounded in W), takes the ``TILED`` instantiation:
the row walked in tiles of ``TILE`` columns, held in a per-pair scratch
of device memory that the wrapper allocates. Every width runs.

The kernel is compiled with nvcc into a shared library with a plain C
interface at first use (``build/torch_kernels/libbsw_cuda.so``, rebuilt
when the source's hash changes; ``ops/nvcc_build.py``) and bound with
ctypes. It takes the arrays as the caller has them (row-major, codes
clamped in the kernel) and computes each pair's band itself, so the
wrapper checks the arrays and the lengths, allocates the [6, P] output
and launches on the current stream. The length check costs one host
synchronisation: a length past its row count would make the kernel read
out of bounds, and must raise before the launch. ``bsw_rows`` is the
launch alone. ``seed_chain_extend`` launches the kernel's body
(``csrc/bsw_warp.cuh``) from ``ops/extend_cuda.py::ext_bsw_band_cuda``
instead, with the extension's band phase as each warp's epilogue, on
lengths that the extension's kernels have tested against the rows on the
device, clamped and flagged (``fetch_extend`` raises on the flag with
the same message), so the extension runs with no host synchronisation;
those launches count in ``banded_swa_batch_cuda.launches`` too.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc_build
from .bsw import (BswBatchResult, banded_swa_batch,
                  banded_swa_rows, scoring)

# columns a lane: the instantiations of csrc/bsw.cu's bsw_launch
K_VALUES = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24)
MAX_QL = 32 * K_VALUES[-1] - 1
TILED = 0            # bsw_launch's k of the column-tiled instantiation
TILE = 256           # its columns a tile (32 lanes x 8)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = nvcc_build.Library("bsw.cu", "bsw_cuda",
                         {"bsw_launch": [_vp] * 6 + [_ci] * 15 + [_vp]})
build = LIB.build            # compile csrc/bsw.cu; returns the library path


def lane_columns(QL: int) -> int:
    """The instantiated K (columns a lane) for a query of QL columns;
    ``TILED`` past ``MAX_QL``."""
    need = -(-(QL + 1) // 32)
    for k in K_VALUES:
        if k >= need:
            return k
    return TILED


def _check(name, t, ndim, device):
    if t.dtype != torch.int32 or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: expected a {ndim}-d int32 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def bsw_rows(qs, lens, ts, h0, w: int, o_del: int, e_del: int, o_ins: int,
             e_ins: int, zdrop: int, mat, end_bonus: int = 0,
             stats: dict = None) -> torch.Tensor:
    """BSW's [6, P] int32 rows (score, qle, tle, gtle, gscore, max_off)
    for qs [P, QL], ts [P, TL], lens [2, P] (the query and target
    lengths) and h0 [P], all int32. On CUDA tensors the launch alone,
    with no length check and no synchronisation: the caller has checked
    the lengths against the rows. On CPU tensors the plain version
    (``ops/bsw.py::banded_swa_rows``, which fills `stats`)."""
    if qs.device.type == "cpu":
        return banded_swa_rows(qs, lens, ts, h0, w, o_del, e_del, o_ins,
                               e_ins, zdrop, mat, end_bonus, stats=stats)
    dev = qs.device
    for name, t, nd in (("qs", qs, 2), ("ts", ts, 2), ("lens", lens, 2),
                        ("h0", h0, 1)):
        _check(name, t, nd, dev)
    P = qs.shape[0]
    if (ts.shape[0] != P or lens.shape != (2, P) or h0.shape[0] != P
            or not all(t.is_contiguous() for t in (qs, ts, lens, h0))):
        raise ValueError("bsw_rows: shapes differ or are not contiguous")
    QL = qs.shape[1]
    k = lane_columns(QL)
    sc = scoring(mat)
    out = torch.empty((6, P), dtype=torch.int32, device=dev)
    scratch = None
    if k == TILED:
        scratch = torch.empty((P, 2, -(-(QL + 1) // TILE) * TILE),
                              dtype=torch.int32, device=dev)
    if P:
        LIB.launch(dev, "bsw_launch", qs.data_ptr(), ts.data_ptr(),
                   lens.data_ptr(), lens.data_ptr() + 4 * P, h0.data_ptr(),
                   out.data_ptr(), P, QL, ts.shape[1], k, w, o_del, e_del,
                   o_ins, e_ins, zdrop, sc["sc_match"], sc["sc_mis"],
                   sc["sc_n"], sc["mx"], end_bonus,
                   None if scratch is None else scratch.data_ptr())
        banded_swa_batch_cuda.launches += 1
    return out


def banded_swa_batch_cuda(qs, q_lens, ts, t_lens, h0, w: int, o_del: int,
                          e_del: int, o_ins: int, e_ins: int, zdrop: int,
                          mat, end_bonus: int = 0, stats: dict = None
                          ) -> BswBatchResult:
    """Drop-in for ``banded_swa_batch_pallas`` (bit-equal results).
    qs [P, QL], ts [P, TL], q_lens/t_lens/h0 [P], all int32. `stats`
    is filled by the plain version only (CPU tensors)."""
    dev = qs.device
    if dev.type == "cpu":
        return banded_swa_batch(qs, q_lens, ts, t_lens, h0, w, o_del,
                                e_del, o_ins, e_ins, zdrop, mat,
                                end_bonus, stats=stats)
    if dev.type != "cuda":
        raise ValueError(f"banded_swa_batch_cuda: unsupported device {dev}")
    for name, t, nd in (("qs", qs, 2), ("ts", ts, 2), ("q_lens", q_lens, 1),
                        ("t_lens", t_lens, 1), ("h0", h0, 1)):
        _check(name, t, nd, dev)
    P, QL = qs.shape
    if ts.shape[0] != P or any(t.shape[0] != P
                               for t in (q_lens, t_lens, h0)):
        raise ValueError("banded_swa_batch_cuda: pair counts differ")
    if bool(((q_lens > QL) | (t_lens > ts.shape[1])).any()):
        raise ValueError("banded_swa_batch_cuda: a length exceeds its "
                         "row count")
    return BswBatchResult(*bsw_rows(
        qs.contiguous(), torch.stack([q_lens, t_lens]), ts.contiguous(),
        h0.contiguous(), w, o_del, e_del, o_ins, e_ins, zdrop,
        mat, end_bonus).unbind(0))


# kernel launches since the last reset (main-path proof in chip_smoke.py)
banded_swa_batch_cuda.launches = 0
