"""The readlane seeding engine through the hand-written CUDA kernels of
csrc/readlane.cu.

Two wrappers, each with the signature of its plain version and each
replacing a ``jax.lax.while_loop`` of the JAX package's
``ops/smem_rl.py``:
- ``readlane_one_pos_cuda``: SMEM passes 1 and 2 (plain
  ``ops/smem_rl.py::one_pos_machine``; JAX ``one_pos_machine``);
- ``readlane_strategy_cuda``: SMEM pass 3 (plain
  ``ops/smem_rl.py::seed_strategy_machine``; JAX
  ``seed_strategy_machine``).
Each keeps a pool of worker lanes (``lanes``, or one a task when it is
None) that pull their next task from an atomic counter: passes 1-2 a warp
a lane (one-warp blocks), pass 3 a thread a lane, ``strategy_lanes_a_warp``
lanes a block. On CUDA tensors each launches its kernel once or raises;
on CPU tensors each runs its plain version (imported at the call). There
is no fallback from a kernel to its plain version. Each kernel has an
int32 and an int64 form (``fmi.pos_dtype``) and, with a k-gram table on an
int32 index (``fmi.kstep`` 2 or 3), a k-step form. Each wrapper keeps a
``launches`` count (every form), ``launches64`` (the int64 form),
``launches_k`` (the k-step forms), and the last call's per-lane
``last_steps`` (occ steps: single bases at every K) and ``last_ticks``
(the loop iterations that make an occ trip: passes 1-2 forward row
fetches plus backward chunks, pass 3 row fetches). With ``stats`` it adds
the longest lane's steps and ticks under ``stats_key`` ("rl_ticks_p1" and
"rl_steps_p1"; "_p2", "_p3" the same), device tensors read once by
``tick_report``. ``with_ticks`` (the lockstep's tick counts) is the plain
machines' alone.

The wrappers allocate the outputs (the kernel writes every slot of each
row a task owns; rows no task owns, past the task count, are zeros), the
counter and the per-lane counts, and, where a warp's codes and stacks
pass 227 KB, the stacks' scratch ``[lanes][2][L + 1]`` entries of 16
bytes (32 at int64); they launch on the current stream with no host
synchronisation. The source is compiled with nvcc into
``build/torch_kernels/libreadlane_cuda.so`` at first use
(``ops/nvcc_build.py``).

``readlane_twin`` and ``readlane_strategy_twin`` are the kernels' loops in
plain Python on numpy arrays, a lane's tasks one after another (passes
1-2 each as one warp runs it, ``smem_cuda.warp_task``, with its stacks
carried from task to task) under an explicit pull order (the task each
pull takes goes to the lane named) or, by default, the lane that finishes
first by ticks; each counts what its kernel counts.
"""

from __future__ import annotations

import ctypes
import heapq

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem import SmemBuf
from .smem_cuda import (_FMI, _KFORM, _SUFFIX, _RowOut, _TwinFmi, _TwinK,
                        _check, _codes_int32, _fmi_args, _kform_args,
                        _smem_fields, _smem_out, warp_task)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# after the index (_fmi_args, or the k-step forms' _kform_args): passes 1-2 codes, lens, B, L,
# five task arrays, N, T, chain_restarts, min_seed_len, M, R, then the
# stacks, the counter, out, cnt, steps, ticks; pass 3 codes, lens, B, L,
# T, lanes a warp, max_intv, min_seed_len, M, then the counter, out, cnt,
# steps, ticks
_ONE_POS = [_vp, _vp, _ci, _ci] + [_vp] * 5 + [_ci] * 6 + [_vp] * 6
_P3 = [_vp, _vp] + [_ci] * 7 + [_vp] * 5
LIB = nvcc_build.Library("readlane.cu", "readlane_cuda", {
    **{f"{fn}{_SUFFIX[pd]}": _FMI[pd] + tail for pd in _FMI
       for fn, tail in (("readlane_one_pos_launch", _ONE_POS),
                        ("readlane_strategy_launch", _P3))},
    # the k-step forms: the k-gram table alone (smem_cuda._kform_args)
    "readlane_one_pos_launch_k": _KFORM + _ONE_POS,
    "readlane_strategy_launch_k": _KFORM + _P3},
    host_fns={"readlane_stacks_in_shared": [_ci],
              "readlane_stacks_in_shared64": [_ci]})
build = LIB.build        # compile csrc/readlane.cu; returns the library path

# pass 3's worker lanes a one-warp block (csrc/readlane.cu), and the shared
# memory a block can take for their codes (227 KB)
P3_LANES = 8
SMEM_MAX = 232448


def strategy_lanes_a_warp(L: int, lanes: int) -> int:
    """Pass 3's worker lanes a block for reads of L columns and a pool of
    `lanes`: P3_LANES, fewer where that many slots of L codes (each
    rounded up to 16 bytes) pass 227 KB or the pool is smaller; 0 where
    one slot does not fit."""
    return min(P3_LANES, SMEM_MAX // ((L + 15) // 16 * 16), lanes)


def _form(fn: str, fmi: DeviceFMIndex) -> list:
    """The launch function and index arguments of `fn`'s form for fmi:
    int32 or int64, or with a k-gram table the k-step form, which reads
    that table alone (``_kform_args``)."""
    if fmi.kstep > 1:
        return [f"{fn}_k", *_kform_args(fmi)]
    return [fn + _SUFFIX[fmi.pos_dtype], *_fmi_args(fmi)]


def _account(wrapper, fmi: DeviceFMIndex, steps, ticks, stats, key):
    """One launch in `wrapper`'s counts, its per-lane counts kept, and
    the longest lane's in `stats`."""
    wrapper.launches += 1
    wrapper.launches64 += fmi.pos_dtype == torch.int64
    wrapper.launches_k += fmi.kstep > 1
    wrapper.last_steps, wrapper.last_ticks = steps, ticks
    if stats is not None and steps.numel():
        for what, per_lane in (("steps", steps), ("ticks", ticks)):
            k = key.replace("ticks", what)
            stats[k] = stats.get(k, 0) + per_lane.max()


def readlane_one_pos_cuda(fmi: DeviceFMIndex, codes, lens, t_read, t_x,
                          t_mi, t_valid, chain_restarts: bool,
                          min_seed_len: int, max_out: int,
                          n_rows: int = None, with_ticks: bool = False,
                          lanes: int = None, out_rows=None,
                          stats: dict = None, stats_key: str = "rl_ticks"):
    """Drop-in for ``smem_rl.one_pos_machine`` (equal arrays). codes [B,
    L] and lens [B] int32; t_read, t_x, t_mi [N] integer, t_valid [N]
    bool, out_rows [N] integer (distinct rows) or None, all on fmi's
    device."""
    if codes.device.type == "cpu":
        from .smem_rl import one_pos_machine
        return one_pos_machine(fmi, codes, lens, t_read, t_x, t_mi, t_valid,
                               chain_restarts, min_seed_len, max_out, n_rows,
                               with_ticks, lanes, out_rows, stats, stats_key)
    what = "readlane_one_pos_cuda"
    rows = t_read if out_rows is None else out_rows
    dev = _check(what, fmi, codes, lens, t_read, t_x, t_mi, t_valid, rows)
    _codes_int32(what, codes, lens)
    if with_ticks:
        raise ValueError(f"{what}: with_ticks counts the lockstep's ticks "
                         f"(the plain machine's)")
    B, L = codes.shape
    N = t_read.shape[0]
    T = int(lanes) if lanes else N
    M = max_out
    R = n_rows or (B if out_rows is None else N)
    if lens.shape != (B,) or any(t.shape != (N,)
                                 for t in (t_x, t_mi, t_valid, rows)):
        raise ValueError(f"{what}: task or read counts differ")
    i32 = torch.int32
    pd = fmi.pos_dtype
    out, fields = _smem_out(R, M, pd, dev)
    cnt = torch.empty((R,), dtype=i32, device=dev)
    if R > N:                     # rows past the task count are nobody's
        out.zero_()
        cnt.zero_()
    # each lane writes its counts
    steps = torch.empty((T,), dtype=i32, device=dev)
    ticks = torch.empty((T,), dtype=i32, device=dev)
    if N and T:
        args = [t.to(i32).contiguous() for t in (t_read, t_x, t_mi)]
        args += [t_valid.to(torch.bool).contiguous(),
                 rows.to(i32).contiguous()]
        c, ln = codes.contiguous(), lens.contiguous()
        # the stacks in each warp's shared memory, or past 227 KB a
        # scratch (entries of 16 bytes, 32 at int64)
        stk = (None if LIB.call("readlane_stacks_in_shared"
                                + _SUFFIX[pd], L)
               else torch.empty((T, 2, L + 1, 4 * pd.itemsize),
                                dtype=torch.uint8, device=dev))
        ctr = torch.zeros((1,), dtype=i32, device=dev)
        LIB.launch(dev, *_form("readlane_one_pos_launch", fmi),
                   c.data_ptr(), ln.data_ptr(), B, L,
                   *(a.data_ptr() for a in args), N, T, int(chain_restarts),
                   min_seed_len, M, R, None if stk is None else stk.data_ptr(),
                   ctr.data_ptr(),
                   out.data_ptr(), cnt.data_ptr(), steps.data_ptr(),
                   ticks.data_ptr())
        _account(_ONE_POS_FN, fmi, steps, ticks, stats, stats_key)
    else:
        _ONE_POS_FN.last_steps, _ONE_POS_FN.last_ticks = steps, ticks
    return SmemBuf(*fields, cnt)


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# every form, the int64 form's and the k-step forms'; the per-lane occ
# steps and iterations of the last call ([lanes] int32, on its device)
readlane_one_pos_cuda.launches = 0
readlane_one_pos_cuda.launches64 = 0
readlane_one_pos_cuda.launches_k = 0
readlane_one_pos_cuda.last_steps = None
readlane_one_pos_cuda.last_ticks = None
# the wrapper itself, for its counts: a caller may swap the module's name
_ONE_POS_FN = readlane_one_pos_cuda


def readlane_strategy_cuda(fmi: DeviceFMIndex, codes, lens, max_intv: int,
                           min_seed_len: int, max_out: int,
                           with_ticks: bool = False, lanes: int = None,
                           stats: dict = None):
    """Drop-in for ``smem_rl.seed_strategy_machine`` (equal arrays), read
    b in row b. codes [B, L] and lens [B] int32 on fmi's device. `stats`
    gets ``rl_steps_p3`` and ``rl_ticks_p3``."""
    if codes.device.type == "cpu":
        from .smem_rl import seed_strategy_machine
        return seed_strategy_machine(fmi, codes, lens, max_intv,
                                     min_seed_len, max_out, with_ticks,
                                     lanes, stats)
    what = "readlane_strategy_cuda"
    dev = _check(what, fmi, codes, lens)
    _codes_int32(what, codes, lens)
    if with_ticks:
        raise ValueError(f"{what}: with_ticks counts the lockstep's ticks "
                         f"(the plain machine's)")
    B, L = codes.shape
    T = int(lanes) if lanes else B
    if lens.shape != (B,):
        raise ValueError(f"{what}: read counts differ")
    i32 = torch.int32
    out, fields = _smem_out(B, max_out, fmi.pos_dtype, dev)
    cnt = torch.empty((B,), dtype=i32, device=dev)
    steps = torch.empty((T,), dtype=i32, device=dev)
    ticks = torch.empty((T,), dtype=i32, device=dev)
    if B and T:
        c, ln = codes.contiguous(), lens.contiguous()
        ctr = torch.zeros((1,), dtype=i32, device=dev)
        rw = strategy_lanes_a_warp(L, T)
        if rw < 1:
            raise ValueError(f"{what}: reads of {L} columns do not fit a "
                             f"block's shared memory")
        LIB.launch(dev, *_form("readlane_strategy_launch", fmi),
                   c.data_ptr(), ln.data_ptr(), B, L, T, rw, int(max_intv),
                   min_seed_len, max_out, ctr.data_ptr(), out.data_ptr(),
                   cnt.data_ptr(), steps.data_ptr(), ticks.data_ptr())
        _account(_STRATEGY_FN, fmi, steps, ticks, stats, "rl_ticks_p3")
    else:
        _STRATEGY_FN.last_steps, _STRATEGY_FN.last_ticks = steps, ticks
    return SmemBuf(*fields, cnt)


readlane_strategy_cuda.launches = 0
readlane_strategy_cuda.launches64 = 0
readlane_strategy_cuda.launches_k = 0
readlane_strategy_cuda.last_steps = None      # [lanes] int32, on its device
readlane_strategy_cuda.last_ticks = None      # [lanes] int32, on its device
_STRATEGY_FN = readlane_strategy_cuda


# ---- the kernels' loops on the CPU -----------------------------------------


def _schedule(N: int, T: int, run, pull) -> None:
    """Run tasks 0..N-1 on T lanes: `run(lane, task)` returns the task's
    ticks. With `pull` (a lane a task) task i goes to lane pull[i];
    without, a lane takes the next task at the tick it finishes its last,
    lanes finishing together in lane order."""
    if pull is not None:
        for t in range(N):
            run(int(pull[t]), t)
        return
    free = [(0, lane) for lane in range(T)]
    for t in range(N):
        at, lane = heapq.heappop(free)
        heapq.heappush(free, (at + run(lane, t), lane))


def _code_of(q, L: int):
    """The read's code at column i, the column clamped to [0, L - 1] and
    the code clipped to [0, 4] (the kernels' staged bytes)."""
    def code(i):
        v = int(q[min(max(i, 0), L - 1)])
        return 0 if v < 0 else min(v, 4)
    return code


def readlane_twin(count, cp_fused, sentinel_index: int, codes, lens, t_read,
                  t_x, t_mi, t_valid, chain_restarts: bool,
                  min_seed_len: int, max_out: int, n_rows: int = None,
                  lanes: int = None, out_rows=None, pull=None,
                  hi_steps=None, kstep=None):
    """csrc/readlane.cu's readlane_one_pos_kernel in plain Python on numpy
    arrays: each lane's tasks one after another, each as one warp runs it
    (``smem_cuda.warp_task``, which asserts the two orders of the ballot
    rule), the stacks [2][L + 1] a lane carried from task to task
    (`hi_steps`: the int64 form; `kstep`: ``smem_cuda.kstep_tables``'
    k-gram table, the forward walk K bases a fetch). `pull` names the lane
    of each task in task order; None gives each task to the lane that
    finishes its tasks first by ticks. Returns (m, n, k, l, s, cnt, steps
    [lanes], ticks [lanes]) as numpy arrays: ticks are the lane's rounds
    (forward row fetches plus backward chunks)."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    kt = None if kstep is None else _TwinK(fm, *kstep)
    codes = np.asarray(codes)
    B, L = codes.shape
    N = len(t_read)
    T = int(lanes) if lanes else N
    R = n_rows or (B if out_rows is None else N)
    rows_t = np.asarray(t_read if out_rows is None else out_rows)
    out = np.zeros((5, R, max_out), np.int64)
    cnt_out = np.zeros(R, np.int32)
    steps_out, ticks_out = np.zeros(T, np.int32), np.zeros(T, np.int32)
    stk = np.zeros((T, 2, L + 1, 4), np.int64)

    def run(lane: int, t: int) -> int:
        rd = min(max(int(t_read[t]), 0), B - 1)
        n_len = int(lens[rd]) if t_valid[t] else 0
        row = int(rows_t[t])
        emit = _RowOut(out[:, row])
        # the depth L: no stack overflows (no latch)
        steps, rounds, _ = warp_task(
            fm, kt, _code_of(codes[rd], L), n_len, int(t_mi[t]),
            int(t_x[t]), chain_restarts, min_seed_len, L, stk[lane], emit,
            f"readlane_twin: task {t}")
        cnt_out[row] = emit.cnt
        steps_out[lane] += steps
        ticks_out[lane] += rounds
        return rounds

    _schedule(N, T, run, pull)
    return (*_smem_fields(out, hi_steps), cnt_out, steps_out, ticks_out)


def readlane_strategy_twin(count, cp_fused, sentinel_index: int, codes, lens,
                           max_intv: int, min_seed_len: int, max_out: int,
                           lanes: int = None, pull=None, hi_steps=None,
                           kstep=None):
    """csrc/readlane.cu's readlane_strategy_kernel in plain Python on
    numpy arrays: each lane's reads one after another through the flat
    loop of one row fetch an iteration (one base, or with `kstep` two; the
    `seek` to the next walk folded into the iteration), under `pull` as
    ``readlane_twin``. Returns (m, n, k, l, s, cnt, steps [lanes], ticks
    [lanes]): ticks are the lane's iterations, its row fetches."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    C = fm.count
    kt = None if kstep is None else _TwinK(fm, *kstep)
    codes = np.asarray(codes)
    B, L = codes.shape
    T = int(lanes) if lanes else B
    out = np.zeros((5, B, max_out), np.int64)
    cnt_out = np.zeros(B, np.int32)
    steps_out, ticks_out = np.zeros(T, np.int32), np.zeros(T, np.int32)

    def run(lane: int, rd: int) -> int:
        code = _code_of(codes[rd], L)
        n_len = int(lens[rd])
        emit = _RowOut(out[:, rd])
        steps = ticks = 0
        st = {}                                  # x, j, a, ck, cl, cs

        def seek(start):
            """The next walk with an ext to make from `start`; False at
            the read's end."""
            x = start
            while True:
                while x < n_len and code(x) >= 4:
                    x += 1
                j = x + 1
                if j >= n_len:
                    return False
                if code(j) < 4:
                    break
                x = j + 1
            xa = code(x)
            st.update(x=x, j=j, a=code(j), ck=C[xa], cl=C[3 - xa],
                      cs=C[xa + 1] - C[xa])
            return True

        def take(nk, nl, ns, an):
            """One base with its extension made: (True while the walk
            goes on, whether the read has a walk left)."""
            nonlocal steps
            x, j = st["x"], st["j"]
            steps += 1
            if ns < max_intv and j + 1 - x >= min_seed_len:
                if ns > 0:
                    emit(x, j, nk, nl, ns)
                return False, seek(j + 1)
            st.update(ck=nk, cl=nl, cs=ns, a=an, j=j + 1)
            if j + 1 >= n_len:
                return False, False
            if an >= 4:
                return False, seek(j + 2)
            return True, True

        live = seek(0)
        while live:                          # one row fetch an iteration
            j, a = st["j"], st["a"]
            an = code(j + 1)
            ticks += 1
            if kt is None:
                nl, nk, ns = fm.ext(st["cl"], st["ck"], st["cs"], 3 - a)
                _, live = take(nk, nl, ns, an)
            else:
                (nl, nk, ns), (nl2, nk2, ns2) = kt.ext_k(
                    st["cl"], st["ck"], st["cs"], [3 - a, 3 - min(an, 3)])
                go, live = take(nk, nl, ns, an)
                if go:
                    _, live = take(nk2, nl2, ns2, code(j + 2))
        cnt_out[rd] = emit.cnt
        steps_out[lane] += steps
        ticks_out[lane] += ticks
        return ticks

    _schedule(B, T, run, pull)
    return (*_smem_fields(out, hi_steps), cnt_out, steps_out, ticks_out)
