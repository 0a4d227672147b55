"""Banded Smith-Waterman extension through the hand-written CUDA kernel.

``banded_swa_batch_cuda`` has the signature of the JAX package's
``banded_swa_batch_pallas`` and replaces it. On CUDA tensors it
launches ``csrc/bsw.cu`` or raises; on CPU tensors it runs the plain
PyTorch version (``ops/bsw.py``). There is no fallback from the kernel
to the plain version.

The kernel is compiled with nvcc into a shared library with a plain C
interface at first use (``build/torch_kernels/libbsw_cuda.so``, rebuilt
when the source's hash changes; ``ops/nvcc_build.py``) and bound with
ctypes. The wrapper
clamps base codes to [0, 4], sorts pairs by effective target length (a
warp runs as long as its longest lane), transposes every array to
[row, pair] for coalesced access, allocates outputs and DP scratch,
launches on the current stream, and undoes the permutation.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc_build
from .bsw import BswBatchResult, band_per_pair, banded_swa_batch, scoring

SOURCE = os.path.join(nvcc_build.REPO, "csrc", "bsw.cu")
LIB_PATH = nvcc_build.lib_path("bsw_cuda")
BLOCK = 32          # threads per block: one warp, spread over the SMs

_lib = None
build_seconds = None   # wall time of the last build in this process


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile csrc/bsw.cu unless a library built from the same source
    exists. Returns the library path; sets ``build_seconds`` when it
    compiled. verbose prints ptxas's register / spill report."""
    global build_seconds
    path, seconds = nvcc_build.build(SOURCE, "bsw_cuda", force, verbose)
    if seconds is not None:
        build_seconds = seconds
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bsw_launch.argtypes = [vp, vp, vp, vp, vp] + [ci] * 11 + [vp]
        lib.bsw_launch.restype = ci
        _lib = lib
    return _lib


def _check(name, t, ndim, device):
    if t.dtype != torch.int32 or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: expected a {ndim}-d int32 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def banded_swa_batch_cuda(qs, q_lens, ts, t_lens, h0, w: int, o_del: int,
                          e_del: int, o_ins: int, e_ins: int, zdrop: int,
                          mat, end_bonus: int = 0, stats: dict = None
                          ) -> BswBatchResult:
    """Drop-in for ``banded_swa_batch_pallas`` (bit-equal results).
    qs [P, QL], ts [P, TL], q_lens/t_lens/h0 [P], all int32."""
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
    # the kernel indexes rows by length: lengths past the row counts
    # would read and write out of bounds
    if bool(((q_lens > QL) | (t_lens > ts.shape[1])).any()):
        raise ValueError("banded_swa_batch_cuda: a length exceeds its "
                         "row count")
    sc = scoring(mat)
    w_p = band_per_pair(q_lens, w, o_del, e_del, o_ins, e_ins, sc["mx"],
                        end_bonus)
    # lane-coherence sort: dead lanes first, then by target length
    eff_t = torch.where((t_lens > 0) & (q_lens > 0), t_lens, 0)
    perm = torch.argsort(eff_t, stable=True)
    qs_t = qs[perm].clamp(0, 4).t().contiguous()           # [QL, P]
    ts_t = ts[perm].clamp(0, 4).t().contiguous()           # [TL, P]
    meta = torch.stack([q_lens, t_lens, h0, w_p])[:, perm].contiguous()
    out = torch.empty((6, P), dtype=torch.int32, device=dev)
    eh = torch.empty((2, QL + 2, P), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bsw_launch(meta.data_ptr(), qs_t.data_ptr(),
                            ts_t.data_ptr(), out.data_ptr(), eh.data_ptr(),
                            P, QL, o_del, e_del, o_ins, e_ins, zdrop,
                            sc["sc_match"], sc["sc_mis"], sc["sc_n"],
                            BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"bsw_launch failed: CUDA error {rc}")
    banded_swa_batch_cuda.launches += 1
    res = torch.empty_like(out)
    res[:, perm] = out
    return BswBatchResult(score=res[0], qle=res[1] + 1, tle=res[2] + 1,
                          gtle=res[3] + 1, gscore=res[4], max_off=res[5])


# kernel launches since the last reset (main-path proof in chip_smoke.py)
banded_swa_batch_cuda.launches = 0
