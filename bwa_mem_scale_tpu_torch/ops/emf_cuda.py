"""The EMF perfect-match probe through the hand-written CUDA kernel of
csrc/emf.cu.

``emf_lookup_cuda`` has the signature of ``ops/emf.py::emf_lookup`` (the
JAX package's ``ops/emf.py:89 emf_lookup``, its rescue loop ``:200``
included, is what the kernel replaces). On CUDA tensors it launches
``emf_lookup_kernel`` (one warp a read) or raises; on CPU tensors it
runs the plain version. There is no fallback from the kernel to the
plain version. The launch synchronises nothing.

The source is compiled with nvcc into
``build/torch_kernels/libemf_cuda.so`` at first use
(``ops/nvcc_build.py``) and bound with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc_build
from .emf import DeviceEmf, emf_lookup

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = nvcc_build.Library(
    "emf.cu", "emf_cuda",
    {"emf_lookup_launch": [_vp, _vp, _ci, _ci, _vp, _cll] + [_vp] * 8
                          + [_cll, _cll, _ci, _ci] + [_vp] * 4})
build = LIB.build            # compile csrc/emf.cu; returns the path

# the table's fields and their dtypes, as the kernel reads them
_TABLE = (("loc", torch.int64), ("fp", torch.int32), ("cnt", torch.int32),
          ("fwless", torch.uint8), ("mlidx", torch.int32),
          ("ml_off", torch.int64), ("ml_nfw", torch.int32),
          ("ml_locs", torch.int64))


def launch(emf: DeviceEmf, ref, codes, lens) -> dict:
    """One launch on contiguous CUDA tensors, as ``emf_lookup_cuda``
    checks them; no host synchronisation."""
    B, L = codes.shape
    dev = codes.device
    out = dict(code=torch.empty((B,), dtype=torch.int32, device=dev),
               slot=torch.empty((B,), dtype=torch.int32, device=dev),
               loc=torch.empty((B,), dtype=torch.int64, device=dev),
               n_loc=torch.empty((B,), dtype=torch.int32, device=dev))
    if B:
        LIB.launch(dev, "emf_lookup_launch", codes.data_ptr(),
                   lens.data_ptr(), B, L, ref.data_ptr(), emf.l_pac,
                   *(getattr(emf, f).data_ptr() for f, _ in _TABLE),
                   emf.ncap, emf.ml_locs.shape[0], emf.seed_len,
                   emf.max_probe, out["code"].data_ptr(),
                   out["slot"].data_ptr(), out["loc"].data_ptr(),
                   out["n_loc"].data_ptr())
        _LOOKUP_FN.launches += 1
    return out


def emf_lookup_cuda(emf: DeviceEmf, ref, codes, lens) -> dict:
    """code [B] int32, slot [B] int32, loc [B] int64 and n_loc [B] int32,
    equal to the plain version's. codes [B, L] and lens [B] int32, ref
    the fw+rc reference bytes, all on emf's device."""
    dev = codes.device
    if dev.type == "cpu":
        return emf_lookup(emf, ref, codes, lens)
    if dev.type != "cuda":
        raise ValueError(f"emf_lookup_cuda: unsupported device {dev}")
    for name, x, nd, dt in (("codes", codes, 2, torch.int32),
                            ("lens", lens, 1, torch.int32),
                            ("ref", ref, 1, torch.uint8)):
        if x.dtype != dt or x.dim() != nd or x.device != dev:
            raise ValueError(f"emf_lookup_cuda: {name}: expected a {nd}-d "
                             f"{dt} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for f, dt in _TABLE:
        x = getattr(emf, f)
        if x.dtype != dt or x.dim() != 1 or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"emf_lookup_cuda: table {f}: expected a "
                             f"contiguous 1-d {dt} tensor on {dev}")
    B, L = codes.shape
    if lens.shape[0] != B:
        raise ValueError("emf_lookup_cuda: codes and lens differ in reads")
    if L < emf.seed_len:
        raise ValueError(f"emf_lookup_cuda: reads padded to {L} columns, "
                         f"below the seed length {emf.seed_len}")
    if ref.shape[0] != 2 * emf.l_pac:
        raise ValueError("emf_lookup_cuda: ref is not the table's fw+rc "
                         "reference")
    return launch(emf, ref.contiguous(), codes.contiguous(),
                  lens.contiguous())


# kernel launches since the last reset (main-path proof in chip_smoke.py),
# counted through _LOOKUP_FN, so a swap of the module name (to record the
# calls) keeps the count
emf_lookup_cuda.launches = 0
_LOOKUP_FN = emf_lookup_cuda
