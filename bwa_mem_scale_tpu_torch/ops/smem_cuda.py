"""SMEM seeding passes 1 and 2 through the hand-written CUDA kernel.

``one_pos_machine_cuda`` has the signature of the plain
``ops/smem_oh.py::one_pos_machine`` and replaces the JAX package's
``one_pos_machine_oh`` (a ``jax.lax.while_loop``). On CUDA tensors it
launches ``csrc/smem.cu`` once (one thread a task, the whole walk in the
launch) or raises; on CPU tensors it runs the plain version. There is no
fallback from the kernel to the plain version.

The kernel returns the plain version's ``SmemBuf`` array for array,
lanes that overflowed their stacks or their emission depth included. It
is compiled with nvcc into ``build/torch_kernels/libsmem_cuda.so`` at
first use (``ops/nvcc_build.py``) and bound with ctypes. The wrapper
allocates the zeroed outputs, the interval-stack scratch
``[2][4][SD + 1][T]`` int32 and the per-lane step counts, and launches on
the current stream with no host synchronisation. With ``stats`` it adds
the longest lane's steps (dependent occ steps) under ``seed_steps_p1`` /
``seed_steps_p2`` as a device tensor, read once by ``tick_report``.

``one_pos_twin`` is the kernel's loop in plain Python on numpy arrays, a
test of the kernel's control flow on the CPU at small sizes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem import SmemBuf

SOURCE = os.path.join(nvcc_build.REPO, "csrc", "smem.cu")
LIB_PATH = nvcc_build.lib_path("smem_cuda")

_lib = None
build_seconds = None   # wall time of the last build in this process


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile csrc/smem.cu unless a library built from the same source
    exists. Returns the library path; sets ``build_seconds`` when it
    compiled."""
    global build_seconds
    path, seconds = nvcc_build.build(SOURCE, "smem_cuda", force, verbose)
    if seconds is not None:
        build_seconds = seconds
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.one_pos_launch.argtypes = ([vp] + [ci] * 7 + [vp, vp, ci, ci]
                                       + [vp] * 4 + [ci] * 5 + [vp] * 5)
        lib.one_pos_launch.restype = ci
        _lib = lib
    return _lib


def one_pos_machine_cuda(fmi: DeviceFMIndex, codes, lens, t_read, t_x,
                         t_mi, t_valid, chain_restarts: bool,
                         min_seed_len: int, max_out: int,
                         stack_depth: int = None, stats: dict = None,
                         stats_key: str = "seed_ticks") -> SmemBuf:
    """Drop-in for ``one_pos_machine`` (equal arrays). codes [B, L] and
    lens [B] int32; t_read, t_x, t_mi [T] integer; t_valid [T] bool, all
    on fmi's device. `stats` gets the lockstep's tick count from the
    plain version (CPU tensors) and the kernel's longest lane's steps
    under ``stats_key`` with "ticks" read as "steps" (CUDA tensors)."""
    dev = codes.device
    if dev.type == "cpu":
        from .smem_oh import one_pos_machine
        return one_pos_machine(fmi, codes, lens, t_read, t_x, t_mi, t_valid,
                               chain_restarts, min_seed_len, max_out,
                               stack_depth, stats, stats_key)
    if dev.type != "cuda":
        raise ValueError(f"one_pos_machine_cuda: unsupported device {dev}")
    B, L = codes.shape
    T = t_read.shape[0]
    SD = stack_depth or L
    if codes.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("one_pos_machine_cuda: codes and lens must be "
                         "int32")
    if any(t.device != dev for t in (lens, t_read, t_x, t_mi, t_valid,
                                     fmi.cp_fused)):
        raise ValueError("one_pos_machine_cuda: tensors on different "
                         "devices")
    if lens.shape != (B,) or any(t.shape != (T,)
                                 for t in (t_x, t_mi, t_valid)):
        raise ValueError("one_pos_machine_cuda: task or read counts differ")
    i32 = torch.int32
    out = torch.zeros((5, T, max_out), dtype=i32, device=dev)
    cnt = torch.empty((T,), dtype=i32, device=dev)
    steps = torch.empty((T,), dtype=i32, device=dev)
    if T:
        args = [codes.contiguous(), lens.contiguous(),
                t_read.to(i32).contiguous(), t_x.to(i32).contiguous(),
                t_mi.to(i32).contiguous(),
                t_valid.to(torch.bool).contiguous()]
        stk = torch.empty((2, 4, SD + 1, T), dtype=i32, device=dev)
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.one_pos_launch(
                fmi.cp_fused.data_ptr(), fmi.cp_fused.shape[0],
                *fmi.count_host,
                fmi.sentinel_index, args[0].data_ptr(), args[1].data_ptr(),
                B, L, *(a.data_ptr() for a in args[2:]), T,
                int(chain_restarts), min_seed_len, max_out, SD,
                stk.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                steps.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"one_pos_launch failed: CUDA error {rc}")
        one_pos_machine_cuda.launches += 1
        if stats is not None:
            key = stats_key.replace("ticks", "steps")
            stats[key] = stats.get(key, 0) + steps.max()
    one_pos_machine_cuda.last_steps = steps
    return SmemBuf(*out.unbind(0), cnt)


# kernel launches since the last reset (main-path proof in chip_smoke.py)
one_pos_machine_cuda.launches = 0
# the per-lane step counts of the last call ([T] int32, on its device)
one_pos_machine_cuda.last_steps = None


def one_pos_twin(count, cp_fused, sentinel_index: int, codes, lens, t_read,
                 t_x, t_mi, t_valid, chain_restarts: bool,
                 min_seed_len: int, max_out: int, stack_depth: int = None):
    """csrc/smem.cu's one_pos_kernel in plain Python on numpy arrays: the
    same nested loops, clamps and stack scratch, one task after another.
    Returns (m, n, k, l, s, cnt, steps) as numpy arrays."""
    count = [int(v) for v in count]
    cp = np.asarray(cp_fused, np.int64)
    nb = cp.shape[0]
    codes = np.asarray(codes)
    B, L = codes.shape
    T = len(t_read)
    SD = stack_depth or L
    M = max_out
    out = np.zeros((5, T, M), np.int32)
    cnt_out = np.zeros(T, np.int32)
    steps_out = np.zeros(T, np.int32)
    stk = np.zeros((2, 4, SD + 1), np.int64)    # one task's stacks

    def occ4(pp):
        r = min(max(pp >> 5, 0), nb - 1)
        y = pp & 31
        top = 0 if y == 0 else (0xFFFFFFFF << (32 - y)) & 0xFFFFFFFF
        return [int(cp[r, c]) + bin(int(cp[r, 4 + c]) & 0xFFFFFFFF
                                     & top).count("1")
                for c in range(4)]

    def ext(k, l, s, c):
        a, b = occ4(k), occ4(k + s)
        s4 = [b[i] - a[i] for i in range(4)]
        sent = int(k <= sentinel_index < k + s)
        return count[c] + a[c], l + sent + sum(s4[c + 1:]), s4[c]

    for t in range(T):
        rd = min(max(int(t_read[t]), 0), B - 1)
        q = codes[rd]
        n_len = int(lens[rd]) if t_valid[t] else 0
        mi = int(t_mi[t])
        cnt = steps = wA = 0
        of = False

        def code(i):
            return int(q[min(max(i, 0), L - 1)])

        def push(buf, c, vals):
            nonlocal of
            stk[buf, :, min(c, SD)] = vals
            of |= c + 1 > SD
            return c + 1

        def read(buf, i):
            return [int(v) for v in stk[buf, :, min(max(i, 0), SD - 1)]]

        def emit(*vals):
            nonlocal cnt
            if cnt < M:
                out[:, t, cnt] = vals
            cnt += 1

        x = int(t_x[t])
        while True:                                  # start positions
            xa = code(x) if x < n_len else 4
            if xa >= 4:
                x += 1
                if chain_restarts and x < n_len:
                    continue
                break
            ck, cl = count[xa], count[3 - xa]
            cs, cn = count[xa + 1] - count[xa], x
            j, nx, cA = x + 1, x + 1, 0
            while j < n_len:                         # forward
                nx = j + 1
                a = code(j)
                if a >= 4:
                    break
                nl, nk, ns = ext(cl, ck, cs, 3 - a)
                steps += 1
                if ns != cs:
                    cA = push(wA, cA, (ck, cl, cs, cn))
                if ns < mi:
                    nx = j
                    break
                ck, cl, cs, cn = nk, nl, ns, j
                j += 1
            if cs >= mi:
                cA = push(wA, cA, (ck, cl, cs, cn))
            mA, rev, j = x, True, x - 1
            while True:                              # backward rounds
                a = code(j) if j >= 0 else 4
                if a >= 4 or cA == 0:
                    if cA > 0:
                        pk, pl, ps, pn = read(wA, cA - 1 if rev else 0)
                        if pn - mA + 1 >= min_seed_len:
                            emit(mA, pn, pk, pl, ps)
                    break
                cB, curr_s, hit = 0, -1, False
                for p in range(cA):
                    pk, pl, ps, pn = read(wA, cA - 1 - p if rev else p)
                    nk, nl, ns = ext(pk, pl, ps, a)
                    steps += 1
                    if hit:
                        keep = ns >= mi and ns != curr_s
                    elif ns < mi:
                        hit = pn - mA + 1 >= min_seed_len
                        if hit:
                            emit(mA, pn, pk, pl, ps)
                        keep = False
                    else:
                        keep = hit = ns != curr_s
                    if keep:
                        cB = push(wA ^ 1, cB, (nk, nl, ns, pn))
                        curr_s = ns
                wA ^= 1
                cA, mA, rev, j = cB, j, False, j - 1
            if not chain_restarts:
                break
            x = max(nx, x + 1)
            if x >= n_len:
                break
        cnt_out[t] = M + 1 if of else cnt
        steps_out[t] = steps
    return (*out, cnt_out, steps_out)
