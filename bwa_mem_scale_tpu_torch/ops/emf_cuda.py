"""The EMF perfect-match probe through the hand-written CUDA kernel of
csrc/emf.cu.

``emf_lookup_cuda`` has the signature of ``ops/emf.py::emf_lookup`` (the
JAX package's ``ops/emf.py:89 emf_lookup``, its rescue loop ``:200``
included, is what the kernel replaces). On CUDA tensors it launches
``emf_lookup_kernel`` (one warp a read) or raises; on CPU tensors it
runs the plain version. There is no fallback from the kernel to the
plain version. The launch synchronises nothing.

``emf_lookup_twin`` is the kernel's rounds in plain Python on numpy
arrays, a test of its control flow on the CPU: it returns the same four
arrays and counts each read's dependent global trips (the read, a probe
round, the windows, two a group of rescue entries), from which
chip_smoke.py's phase 11 takes the latency floor.

The source is compiled with nvcc into
``build/torch_kernels/libemf_cuda.so`` at first use
(``ops/nvcc_build.py``) and bound with ctypes.
"""

from __future__ import annotations

import ctypes

import numpy as np
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


def emf_lookup_twin(emf: DeviceEmf, ref, codes, lens) -> dict:
    """csrc/emf.cu's emf_lookup_kernel in plain Python, one read (warp)
    after another, in its rounds: trip 1 the read (has_n, the seed's
    orientation and hash), then probe rounds of 32 slots (each slot's
    fields at once) to the first candidate or empty slot, then both
    windows at the candidate in one trip (the rescue list's offsets
    beside them), then for a rescue groups of G entries (8 lanes an entry
    up to 113 columns, so 4 a group), two trips a group: the entries,
    then their windows. Returns code, slot, loc and n_loc as the kernel
    writes them, and trips [B] int64, each read's dependent trips."""
    from ..index.perfect import hash_words, pack_words
    tab = {f: getattr(emf, f).cpu().numpy() for f, _ in _TABLE}
    ref = ref.cpu().numpy() if isinstance(ref, torch.Tensor) else ref
    codes = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor)
                       else codes).astype(np.int64)
    lens = np.asarray(lens.cpu() if isinstance(lens, torch.Tensor)
                      else lens).astype(np.int64)
    B, L = codes.shape
    S, l_pac, P = emf.seed_len, emf.l_pac, emf.max_probe
    l2, mask, n_locs = 2 * l_pac, emf.ncap - 1, tab["ml_locs"].shape[0]
    clip3 = lambda c: min(max(int(c), 0), 3)
    q = np.clip(codes, -1, 5)                 # the staged bytes
    fw = np.clip(q[:, :S], 0, 3)
    rc = 3 - fw[:, ::-1]
    neq = fw != rc
    first = neq.argmax(1)
    fwle = np.where(neq.any(1), fw[np.arange(B), first] < rc[np.arange(B),
                                                               first], True)
    canon = np.where(fwle[:, None], fw, rc).astype(np.uint8)
    hs = hash_words(pack_words(canon), S)
    out = {k: np.zeros(B, dt) for k, dt in (
        ("code", np.int32), ("slot", np.int32), ("loc", np.int64),
        ("n_loc", np.int32), ("trips", np.int64))}
    for b in range(B):
        ln = int(lens[b])
        n = min(max(ln, 0), L)
        trips = 1                             # the read
        has_n = bool((codes[b, :n] >= 4).any())
        too_short = ln < S
        h = int(hs[b])
        fpq = h >> 32
        slot, has_cand, loc = h & mask, False, 0
        for r0 in range(0, P, 32):            # a probe round
            trips += 1
            js = range(r0, min(r0 + 32, P))
            ss = [(h + j) & mask for j in js]
            empty = [int(tab["loc"][s]) < 0 for s in ss]
            stop = empty.index(True) if True in empty else len(ss)
            cand = [i for i in range(stop) if
                    int(tab["fp"][ss[i]]) & 0xFFFFFFFF == fpq]
            if cand:
                has_cand, slot = True, ss[cand[0]]
                loc = int(tab["loc"][slot])
                break
            if stop < len(ss):
                break

        def matches(start, rev):
            for i in range(n):
                p = min(max(start + i, 0), l2 - 1)
                k = min(max(ln - 1 - i, 0), L - 1)
                want = 3 - clip3(q[b, k]) if rev else int(q[b, i])
                if int(ref[p]) != want:
                    return False
            return True

        fwm = rcm = False
        if has_cand:
            trips += 1                        # both windows
            pos_rc = loc - (ln - S)
            fwm = loc + ln <= l_pac and matches(loc, False)
            rcm = pos_rc >= 0 and matches(pos_rc, True)
            mli = int(tab["mlidx"][slot])
            if (ln > S and not has_n and not too_short and mli >= 0
                    and not fwm and not rcm):
                lo = int(tab["ml_off"][mli])
                hi = int(tab["ml_off"][mli + 1])
                nfw_end = lo + int(tab["ml_nfw"][mli])
                is_rev0 = (int(tab["fwless"][slot]) != 0) != bool(fwle[b])
                cpw = (n + 30) >> 4
                G = 32 // (8 if cpw <= 8 else 16 if cpw <= 16 else 32)
                for e0 in range(lo, hi, G):
                    trips += 2                # the entries, their windows
                    hit = None
                    for c in range(e0, min(e0 + G, hi)):
                        lc = int(tab["ml_locs"][min(max(c, 0), n_locs - 1)])
                        isrev = is_rev0 if c < nfw_end else not is_rev0
                        posr = lc - (ln - S)
                        okb = posr >= 0 if isrev else lc + ln <= l_pac
                        if okb and matches(posr if isrev else lc, isrev):
                            hit = (lc, isrev)
                            break
                    if hit is not None:
                        loc = hit[0]
                        rcm, fwm = hit[1], not hit[1]
                        break
        out["code"][b] = (0 if too_short else 1 if has_n else 3 if fwm
                          else 4 if rcm else 2)
        out["slot"][b] = slot
        out["loc"][b] = loc if fwm or rcm else -1
        out["n_loc"][b] = int(tab["cnt"][slot]) if has_cand else 0
        out["trips"][b] = trips
    return out
