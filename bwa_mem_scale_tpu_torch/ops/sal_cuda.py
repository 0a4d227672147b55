"""The SA lookup stage through the hand-written CUDA kernels of csrc/sal.cu.

``expand_and_lookup_cuda`` has the signature of its plain version,
``ops/sal.py::expand_and_lookup_plain``, and replaces the JAX package's
``ops/sal.py`` ``expand_and_lookup`` together with its LF walk
(``sa_lookup``'s ``jax.lax.while_loop``): every SMEM's SA interval sampled
into at most max_occ coordinates and each coordinate resolved, in two
kernel launches on the current stream (a warp a read for the counts, a
thread a coordinate for the walk) with no host synchronisation and no
tensor operation but the outputs' allocation. On CUDA tensors it launches
them or raises; on CPU tensors it runs the plain version. There is no
fallback from the kernels to the plain version. Both have an int32 and an
int64 form, picked by ``fmi.pos_dtype``; ``sa_compx`` 0 (the full SA) is
the walk's first step, a gather. The wrapper keeps a ``launches`` count
(calls that launched the pair; ``launches64`` the int64 form's) and the
last call's per-lane ``last_steps`` ([K] int32 on the flat path, [B * C]
on the grid path; 0 where nothing was walked), and with ``stats`` adds
the longest lane's steps under ``sal_steps`` (a device tensor, which the
kernels compute). The flat list's scan over reads is a decoupled look-back
whose words persist, one buffer a stream, across calls (``_lookback``):
made zeroed on a stream's first call, so steady state allocates nothing
else. The batch has no limit but B * C < 2^31.

``expand_lookup_twin`` is the two kernels' loops in plain Python on numpy
arrays (the warp's scan, the look-back, the binary searches, each
thread's walk), a test
of their control flow on the CPU at small sizes; it counts what they
count. The source is compiled with nvcc into
``build/torch_kernels/libsal_cuda.so`` at first use
(``ops/nvcc_build.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem import SmemBuf
from .smem_cuda import _FMI, _SUFFIX, _TwinFmi, _check, _fmi_args, _twin_walk

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# after the index (_fmi_args): samples, their count and compx; k, s (each
# with its two strides) and cnt (with its stride); B, M, C, K, max_occ; the
# look-back's epoch, words and their count; the ten buffers
_SAL = {pd: [_vp, n, _ci] + [_vp, _ll, _ll] * 2 + [_vp, _ll] + [_ci] * 4
        + [n, ctypes.c_uint, _vp, _ll] + [_vp] * 10
        for pd, n in ((torch.int32, _ci), (torch.int64, _ll))}
LIB = nvcc_build.Library("sal.cu", "sal_cuda", {
    f"sal_lookup_launch{_SUFFIX[pd]}": _FMI[pd] + _SAL[pd] for pd in _SAL})
build = LIB.build            # compile csrc/sal.cu; returns the library path

WARP = 32                    # a read's SMEMs and slots, 32 a step
THREADS = 128                # the walk kernel's threads a block
READS = 4                    # the counting kernel's reads (warps) a block
SMEM_MAX = 232448            # shared memory a block (csrc/fmi_step.cuh)
EPOCHS = 2 ** 31             # look-back epochs 1 .. EPOCHS - 1 a buffer

# the look-back words of each (device, stream): [int64 tensor, last epoch];
# a call on that stream takes the next epoch, so a word left by an earlier
# call never reads as published and nothing is zeroed between calls
_LOOKBACK: dict = {}
_LOOKBACK_LOCK = threading.Lock()


def _lookback(dev: torch.device, n: int):
    """(words, epoch) for a call on dev's current stream needing n words:
    the stream's buffer (zeroed when first made, or remade larger or when
    its epochs run out) and the next epoch."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _LOOKBACK_LOCK:
        ent = _LOOKBACK.get(key)
        if ent is None or ent[0].numel() < n or ent[1] + 1 >= EPOCHS:
            ent = _LOOKBACK[key] = [
                torch.zeros(max(n, 1024), dtype=torch.int64, device=dev), 0]
        ent[1] += 1
        return ent[0], ent[1]


def flat_size(B: int, C: int, flat_k: int = None) -> int:
    """K, the flat coordinate list's length: flat_k, or B * C / 16
    rounded up to 1024 and at least 4096. B * C <= K takes the grid
    path."""
    return flat_k or max(4096, (B * C // 16 + 1023) // 1024 * 1024)


def expand_and_lookup_cuda(fmi: DeviceFMIndex, smems: SmemBuf,
                           max_occ: int, max_coords: int,
                           flat_k: int = None, stats: dict = None):
    """Drop-in for ``sal.expand_and_lookup_plain`` (equal arrays, every
    slot): (rbeg [B, C] of fmi's position dtype, seed_idx [B, C] int32,
    coord_valid [B, C] bool, total [B] int32, overflow [B] bool), C =
    max_coords. On CPU tensors the plain version; on CUDA tensors the two
    kernels of csrc/sal.cu. Raises ValueError on a shape or type the
    kernels do not take."""
    if smems.m.device.type == "cpu":
        from .sal import expand_and_lookup_plain
        return expand_and_lookup_plain(fmi, smems, max_occ, max_coords,
                                       flat_k, stats)
    what = "expand_and_lookup_cuda"
    k, s, cnt, samples = smems.k, smems.s, smems.cnt, fmi.sa_samples
    dev = _check(what, fmi, smems.m, k, s, cnt, samples)
    B, M = smems.m.shape
    C = int(max_coords)
    pd = fmi.pos_dtype
    if k.dtype != pd or s.dtype != pd or samples.dtype != pd:
        raise ValueError(f"{what}: k, s and the SA samples must be {pd}")
    if cnt.dtype != torch.int32 or cnt.shape != (B,):
        raise ValueError(f"{what}: cnt must be [B] int32")
    if k.shape != (B, M) or s.shape != (B, M):
        raise ValueError(f"{what}: k and s must be [B, M]")
    if not samples.is_contiguous() or not 0 <= fmi.sa_compx <= 30:
        raise ValueError(f"{what}: SA samples not contiguous, or sa_compx "
                         f"{fmi.sa_compx} outside [0, 30]")
    if (M < 1 or 4 * (M + READS + 1) > SMEM_MAX or C < 1 or max_occ < 1
            or B * C >= 2 ** 31 - THREADS):
        raise ValueError(f"{what}: B={B}, M={M}, C={C}, max_occ={max_occ} "
                         f"not taken")
    K = flat_size(B, C, flat_k)
    grid = B * C <= K
    if K >= 2 ** 31 - THREADS:
        raise ValueError(f"{what}: a flat list of {K} not taken")
    rbeg = torch.empty((B, C), dtype=pd, device=dev)
    seed_idx = torch.empty((B, C), dtype=torch.int32, device=dev)
    coord_valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    steps = torch.empty((B * C if grid else K,), dtype=torch.int32,
                        device=dev)
    longest = torch.empty((), dtype=torch.int32, device=dev)
    # scratch, one allocation: the starts [B, M], the flat list's map [K]
    # and its length [1]
    scratch = torch.empty((B * M + (0 if grid else K) + 1,),
                          dtype=torch.int32, device=dev)
    at = scratch.data_ptr()
    if B:
        words, epoch = _lookback(dev, 0 if grid else B)
        try:
            LIB.launch(dev, "sal_lookup_launch" + _SUFFIX[pd],
                       *_fmi_args(fmi), samples.data_ptr(), samples.shape[0],
                       fmi.sa_compx, k.data_ptr(), *k.stride(), s.data_ptr(),
                       *s.stride(), cnt.data_ptr(), cnt.stride(0), B, M, C,
                       0 if grid else K, int(max_occ), epoch,
                       words.data_ptr(), words.numel(), at, at + 4 * B * M,
                       at + 4 * (scratch.numel() - 1), rbeg.data_ptr(),
                       seed_idx.data_ptr(), coord_valid.data_ptr(),
                       total.data_ptr(), overflow.data_ptr(),
                       steps.data_ptr(), longest.data_ptr())
        except RuntimeError as e:
            raise RuntimeError(f"{what}: B={B}, M={M}, C={C}, K={K}, "
                               f"grid={grid}: {e}") from None
        expand_and_lookup_cuda.launches += 1
        expand_and_lookup_cuda.launches64 += pd == torch.int64
        if stats is not None:     # no 0 + tensor: that is one more op
            stats["sal_steps"] = (longest if "sal_steps" not in stats
                                  else stats["sal_steps"] + longest)
    expand_and_lookup_cuda.last_steps = steps
    return rbeg, seed_idx, coord_valid, total, overflow


# launches of the kernel pair since the last reset (main-path proof in
# chip_smoke.py):
expand_and_lookup_cuda.launches = 0
expand_and_lookup_cuda.launches64 = 0
expand_and_lookup_cuda.last_steps = None     # [K or B * C] int32, on device


def _count(sv: int, max_occ: int) -> int:
    """An SMEM's sampled coordinates (csrc/sal.cu sal_count)."""
    if sv > max_occ:
        step = sv // max_occ
        return min((sv + step - 1) // step, max_occ)
    return min(sv, max_occ)


def _warp_scan(v: list) -> list:
    """The kernels' inclusive shuffle scan over 32 lanes: at distance d
    each lane at or past d adds the value d lanes below it."""
    v = list(v)
    d = 1
    while d < WARP:
        v = [v[i] + (v[i - d] if i >= d else 0) for i in range(WARP)]
        d *= 2
    return v


def _upper(a, n: int, x: int) -> int:
    """The kernels' binary search: the first i < n with a[i] > x, else
    n."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _look_back(words: list, i: int) -> int:
    """Warp 0's look-back for block i > 0 (csrc/sal.cu lb_exclusive): the
    words of blocks i - 1, i - 2, ... ((inclusive, sum), every one
    published), 32 a step, summed to the nearest inclusive one; before
    block 0 an inclusive 0."""
    excl, top = 0, i - 1
    while True:
        w = [words[top - ln] if top - ln >= 0 else (True, 0)
             for ln in range(WARP)]
        inc = [ln for ln in range(WARP) if w[ln][0]]
        first = inc[0] if inc else WARP - 1
        excl += sum(v for _, v in w[:first + 1])
        if inc:
            return excl
        top -= WARP


def expand_lookup_twin(count, cp_fused, sentinel_index: int, sa_samples,
                       sa_compx: int, k, s, cnt, max_occ: int,
                       max_coords: int, flat_k: int = None, hi_steps=None,
                       order=None):
    """csrc/sal.cu's sal_count_kernel then sal_walk_kernel in plain Python
    on numpy arrays (k and s [B, M], cnt [B]; the int64 form with
    `hi_steps`): the same loops, look-back, searches and walk, one warp or
    thread after another. Every counting block publishes its sum before
    any looks back, and the blocks look back in `order` (default: last to
    first, so each sums its predecessors' own sums back to block 0), one
    interleaving the card may run. Asserts that the two write every output
    element. Returns ((rbeg, seed_idx, coord_valid, total, overflow),
    steps [N] int32)."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    samples = np.asarray(sa_samples)
    k, s, cnt = np.asarray(k), np.asarray(s), np.asarray(cnt)
    B, M = k.shape
    C = max_coords
    K = flat_size(B, C, flat_k)
    grid = B * C <= K
    N = B * C if grid else K
    R = min(READS, (SMEM_MAX - 4 * (READS + 1)) // (4 * M))
    blocks = -(-B // R)
    junk = -(2 ** 31) + 7                     # no kernel writes this
    rbeg = np.full((B, C), junk, samples.dtype)
    seed_idx = np.full((B, C), junk, np.int32)
    coord_valid = np.full((B, C), junk, np.int64)
    total = np.full((B,), junk, np.int32)
    overflow = np.full((B,), junk, np.int64)
    starts = np.full((B, M), junk, np.int64)
    slot_of = np.full((max(K, 1),), junk, np.int64)
    steps = np.full((N,), junk, np.int32)
    tots, carries = [0] * (blocks * R), [0] * (blocks * R)
    # sal_count_kernel: a warp a read
    for b in range(B):
        nv = min(max(int(cnt[b]), 0), M)
        st = [junk] * M                       # the warp's shared starts
        carry, last = 0, -1
        for m0 in range(0, nv, WARP):
            n = [_count(int(s[b, m0 + ln]), max_occ) if m0 + ln < nv
                 else 0 for ln in range(WARP)]
            inc = _warp_scan(n)
            for ln in range(min(WARP, nv - m0)):
                st[m0 + ln] = starts[b, m0 + ln] = carry + inc[ln] - n[ln]
            nz = [ln for ln in range(WARP) if n[ln] > 0]
            if nz:
                last = m0 + nz[-1]
            carry += inc[WARP - 1]
        tot = min(carry, C)
        tots[b], carries[b] = tot, carry
        for c in range(C):
            if c < tot:
                seed_idx[b, c] = _upper(st, nv, c) - 1
            else:
                seed_idx[b, c] = max(last, 0)
                rbeg[b, c] = 0
            coord_valid[b, c] = c < tot
    base = [0] * blocks
    if not grid:                              # publish, then look back
        agg = [sum(tots[i * R:i * R + R]) for i in range(blocks)]
        words = [(i == 0, agg[i]) for i in range(blocks)]
        for i in (range(blocks - 1, 0, -1) if order is None else order):
            if i:
                base[i] = _look_back(words, i)
                words[i] = (True, base[i] + agg[i])
        grand = base[-1] + agg[-1]
    for b in range(B):
        past_k = False
        if not grid:                          # place in the flat list
            first = base[b // R] + sum(tots[b // R * R:b])
            past_k = tots[b] > 0 and first + tots[b] > K
            for c in range(tots[b]):
                if first + c < K:
                    slot_of[first + c] = b * C + c
                else:
                    rbeg[b, c] = 0
        total[b], overflow[b] = tots[b], carries[b] > C or past_k

    # sal_walk_kernel: a thread a coordinate
    for t in range(N):
        steps[t] = 0
        if grid:
            b, c = divmod(t, C)
            if c >= total[b]:
                continue
        elif t < grand:
            b, c = divmod(int(slot_of[t]), C)
        else:
            continue
        m = int(seed_idx[b, c])
        sv, start = int(s[b, m]), int(starts[b, m])
        step = sv // max_occ if sv > max_occ else 1
        rbeg[b, c], steps[t] = _twin_walk(
            fm, samples, sa_compx, int(k[b, m]) + (c - start) * step)
    for a in (rbeg, seed_idx, coord_valid, total, overflow, steps):
        assert (a != junk).all(), "an output element was never written"
    return (rbeg, seed_idx, coord_valid.astype(bool), total,
            overflow.astype(bool)), steps
