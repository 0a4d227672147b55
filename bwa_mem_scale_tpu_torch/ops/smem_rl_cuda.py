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
Each launches one thread a worker lane (``lanes``, or one a task when it
is None), a lane pulling its next task from an atomic counter. On CUDA
tensors each launches its kernel once or raises; on CPU tensors each runs
its plain version (imported at the call). There is no fallback from a
kernel to its plain version. Each kernel has an int32 and an int64 form
(``fmi.pos_dtype``) and, with a k-gram table on an int32 index
(``fmi.kstep`` 2 or 3), a k-step form. Each wrapper keeps a ``launches``
count (every form), ``launches64`` (the int64 form), ``launches_k`` (the
k-step forms), and the last call's per-lane ``last_steps`` (occ steps:
single bases at every K) and ``last_ticks`` (loop iterations). With
``stats`` it adds the longest lane's steps and ticks under ``stats_key``
("rl_ticks_p1" and "rl_steps_p1"; "_p2", "_p3" the same), device tensors
read once by ``tick_report``. ``with_ticks`` (the lockstep's tick counts)
is the plain machines' alone.

The wrappers allocate the outputs (the kernel writes every slot of each
row a task owns; rows no task owns, past the task count, are zeros), the
stacks' scratch ``[lanes][2][L + 1]`` entries of 16 bytes (32 at int64),
the counter and the per-lane counts, and launch on the current stream with
no host synchronisation. The source is compiled with nvcc into
``build/torch_kernels/libreadlane_cuda.so`` at first use
(``ops/nvcc_build.py``).

``readlane_twin`` and ``readlane_strategy_twin`` are the kernels' loops in
plain Python on numpy arrays, a lane's tasks one after another with its
stacks carried from task to task, under an explicit pull order (the task
each pull takes goes to the lane named) or, by default, the order the
lockstep machine's refill gives; each counts what its kernel counts.
"""

from __future__ import annotations

import ctypes
import heapq

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem import SmemBuf
from .smem_cuda import (_FMI, _SUFFIX, _TwinFmi, _TwinK, _check,
                        _codes_int32, _fmi_args, _kstep_args, _smem_fields,
                        _smem_out)
from .smem_oh import P_INIT, P_FWD, P_BSCAN, P_BTAIL

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# after the index (and the k-step table): passes 1-2 codes, lens, B, L,
# five task arrays, N, T, chain_restarts, min_seed_len, M, R, then the
# stacks, the counter, out, cnt, steps, ticks; pass 3 codes, lens, B, L,
# T, max_intv, min_seed_len, M, then the counter, out, cnt, steps, ticks
_ONE_POS = [_vp, _vp, _ci, _ci] + [_vp] * 5 + [_ci] * 6 + [_vp] * 6
_P3 = [_vp, _vp] + [_ci] * 6 + [_vp] * 5
LIB = nvcc_build.Library("readlane.cu", "readlane_cuda", {
    **{f"{fn}{_SUFFIX[pd]}": _FMI[pd] + tail for pd in _FMI
       for fn, tail in (("readlane_one_pos_launch", _ONE_POS),
                        ("readlane_strategy_launch", _P3))},
    "readlane_one_pos_launch_k": _FMI[torch.int32]
    + [_vp, _ci, _vp, _vp, _ci] + _ONE_POS,
    "readlane_strategy_launch_k": _FMI[torch.int32] + [_vp, _ci, _vp]
    + _P3})
build = LIB.build        # compile csrc/readlane.cu; returns the library path


def _form(fn: str, fmi: DeviceFMIndex, ks) -> list:
    """The launch function and index arguments of `fn`'s form for fmi:
    int32 or int64, or with a k-gram table the k-step form (ks: passes
    1-2's K, None for pass 3)."""
    if fmi.kstep > 1:
        return [f"{fn}_k", *_fmi_args(fmi), *_kstep_args(fmi, ks)]
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
    if R > N:                     # rows past the task count are nobody's
        out.zero_()
    cnt = torch.zeros((R,), dtype=i32, device=dev)
    steps = torch.zeros((T,), dtype=i32, device=dev)
    ticks = torch.zeros((T,), dtype=i32, device=dev)
    if N and T:
        args = [t.to(i32).contiguous() for t in (t_read, t_x, t_mi)]
        args += [t_valid.to(torch.bool).contiguous(),
                 rows.to(i32).contiguous()]
        c, ln = codes.contiguous(), lens.contiguous()
        stk = torch.empty((T, 2, L + 1, 4 * pd.itemsize), dtype=torch.uint8,
                          device=dev)
        ctr = torch.zeros((1,), dtype=i32, device=dev)
        LIB.launch(dev, *_form("readlane_one_pos_launch", fmi, fmi.kstep),
                   c.data_ptr(), ln.data_ptr(), B, L,
                   *(a.data_ptr() for a in args), N, T, int(chain_restarts),
                   min_seed_len, M, R, stk.data_ptr(), ctr.data_ptr(),
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
    steps = torch.zeros((T,), dtype=i32, device=dev)
    ticks = torch.zeros((T,), dtype=i32, device=dev)
    if B and T:
        c, ln = codes.contiguous(), lens.contiguous()
        ctr = torch.zeros((1,), dtype=i32, device=dev)
        LIB.launch(dev, *_form("readlane_strategy_launch", fmi, None),
                   c.data_ptr(), ln.data_ptr(), B, L, T, int(max_intv),
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
    lanes finishing together in lane order (the lockstep's refill)."""
    if pull is not None:
        for t in range(N):
            run(int(pull[t]), t)
        return
    free = [(0, lane) for lane in range(T)]
    for t in range(N):
        at, lane = heapq.heappop(free)
        heapq.heappush(free, (at + run(lane, t), lane))


class _Rows:
    """The kernels' RowOut on numpy arrays: [5, R, M] fields, a count a
    row."""

    def __init__(self, R: int, M: int):
        self.out = np.zeros((5, R, M), np.int64)
        self.cnt = np.zeros(R, np.int32)
        self.M = M

    def emit(self, row: int, cnt: int, *vals) -> int:
        if cnt < self.M:
            self.out[:, row, cnt] = vals
        return cnt + 1


def _code_of(q, L: int):
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
    arrays: each lane's tasks one after another, a tick an iteration, the
    stacks [2][L + 1] a lane carried from task to task (`hi_steps`: the
    int64 form; `kstep`: ``smem_cuda.kstep_tables``' k-gram table, the
    forward walk K bases a fetch). `pull` names the lane of each task in
    task order; None gives the lockstep's refill order. Returns (m, n, k,
    l, s, cnt, steps [lanes], ticks [lanes]) as numpy arrays."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    C = fm.count
    kt = None if kstep is None else _TwinK(fm, *kstep)
    ks = 1 if kt is None else (3 if kt.c3 is not None else 2)
    codes = np.asarray(codes)
    B, L = codes.shape
    N = len(t_read)
    T = int(lanes) if lanes else N
    R = n_rows or (B if out_rows is None else N)
    rows_t = np.asarray(t_read if out_rows is None else out_rows)
    rows = _Rows(R, max_out)
    steps_out, ticks_out = np.zeros(T, np.int32), np.zeros(T, np.int32)
    stk = np.zeros((T, 2, L + 1, 4), np.int64)
    wA = [0] * T

    def run(lane: int, t: int) -> int:
        rd = min(max(int(t_read[t]), 0), B - 1)
        code = _code_of(codes[rd], L)
        n_len = int(lens[rd]) if t_valid[t] else 0
        mi, row, x = int(t_mi[t]), int(rows_t[t]), int(t_x[t])
        st = stk[lane]
        cnt = steps = ticks = 0
        phase = P_INIT
        j = nx = cn = cA = cB = mA = p = 0
        rev = False
        ck = cl = cs = 0
        curr_s = -1

        def push(buf, c, vals):
            st[buf, min(c, L)] = vals
            return c + 1

        while True:
            ticks += 1
            if phase == P_INIT:
                xa = code(x)
                nx = x + 1
                if x < n_len and xa < 4:
                    ck, cl, cs, cn = C[xa], C[3 - xa], C[xa + 1] - C[xa], x
                    j, cA, phase = x + 1, 0, P_FWD
                    continue
                if chain_restarts and x + 1 < n_len:
                    x += 1
                    continue
                break
            fwd = phase == P_FWD
            a = code(j)
            e = [0, 0, 0, 0]
            if not fwd:
                si = cA - 1 - p if rev else p
                e = [int(v) for v in st[wA[lane], min(max(si, 0), L - 1)]]
            dead = (phase == P_BSCAN and p == 0
                    and (j < 0 or a >= 4 or cA == 0))
            need = ((j < n_len and a < 4) if fwd else
                    (not dead if phase == P_BSCAN else p < cA))
            res = [(0, 0, 0)] * ks          # (k, l, s) after d + 1 bases
            if need:
                kk, ll, ss = (cl, ck, cs) if fwd else e[:3]
                c0 = 3 - a if fwd else a
                if kt is None:
                    res = [fm.ext(kk, ll, ss, c0)]
                else:
                    cc = [c0] + [(3 - min(code(j + d), 3)) if fwd else 0
                                 for d in range(1, ks)]
                    res = kt.ext_k(kk, ll, ss, cc)
            if fwd:
                ek, el, es, en = pk, pl, ps, pn = ck, cl, cs, cn
                gate = cont = True
                for d in range(ks):          # (1-step: d = 0 only)
                    jd = j + d
                    run_d = (gate and jd < n_len
                             and (a if d == 0 else code(jd)) < 4)
                    sl, sk, ss = res[d]      # swapped back
                    if run_d:
                        steps += 1
                        if ss != ps:
                            cA = push(wA[lane], cA, (pk, pl, ps, pn))
                    fail = run_d and ss < mi
                    cont = run_d and not fail
                    if gate and jd < n_len:
                        nx = jd + 1
                    if fail:
                        nx = jd
                    if cont:
                        ek, el, es, en = sk, sl, ss, jd
                    pk, pl, ps, pn = sk, sl, ss, jd
                    gate = cont
                if not cont and es >= mi:
                    cA = push(wA[lane], cA, (ek, el, es, en))
                ck, cl, cs, cn = ek, el, es, en
                if cont:
                    j += ks
                else:
                    mA, phase, j, rev, p, curr_s, cB = (x, P_BSCAN, x - 1,
                                                        True, 0, -1, 0)
                continue
            if dead:                         # the position's end
                if cA > 0 and e[3] - mA + 1 >= min_seed_len:
                    cnt = rows.emit(row, cnt, mA, e[3], *e[:3])
                if chain_restarts:
                    x2 = max(nx, x + 1)
                    if x2 < n_len:
                        x, phase = x2, P_INIT
                        continue
                break
            if need:
                steps += 1
            nk, nl, ns = res[0]
            if phase == P_BSCAN:
                die = ns < mi
                emit_sc = die and e[3] - mA + 1 >= min_seed_len
                keep = not die and ns != curr_s
                if emit_sc:
                    cnt = rows.emit(row, cnt, mA, e[3], *e[:3])
                if emit_sc or keep:
                    phase = P_BTAIL
                p += 1
                over = not (emit_sc or keep) and p >= cA
            else:
                keep = p < cA and ns >= mi and ns != curr_s
                p += 1
                over = p >= cA
            if keep:
                cB = push(wA[lane] ^ 1, cB, (nk, nl, ns, e[3]))
                curr_s = ns
            if over:
                wA[lane] ^= 1
                cA, cB, mA, j, rev, p, curr_s, phase = (cB, 0, j, j - 1,
                                                        False, 0, -1,
                                                        P_BSCAN)
        rows.cnt[row] = cnt
        steps_out[lane] += steps
        ticks_out[lane] += ticks
        return ticks

    _schedule(N, T, run, pull)
    return (*_smem_fields(rows.out, hi_steps), rows.cnt, steps_out,
            ticks_out)


def readlane_strategy_twin(count, cp_fused, sentinel_index: int, codes, lens,
                           max_intv: int, min_seed_len: int, max_out: int,
                           lanes: int = None, pull=None, hi_steps=None,
                           kstep=None):
    """csrc/readlane.cu's readlane_strategy_kernel in plain Python on
    numpy arrays: each lane's reads one after another, a tick an iteration
    (with `kstep`, two bases a fetch), under `pull` as ``readlane_twin``.
    Returns (m, n, k, l, s, cnt, steps [lanes], ticks [lanes])."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    C = fm.count
    kt = None if kstep is None else _TwinK(fm, *kstep)
    codes = np.asarray(codes)
    B, L = codes.shape
    T = int(lanes) if lanes else B
    rows = _Rows(B, max_out)
    steps_out, ticks_out = np.zeros(T, np.int32), np.zeros(T, np.int32)

    def run(lane: int, rd: int) -> int:
        code = _code_of(codes[rd], L)
        n_len = int(lens[rd])
        cnt = steps = ticks = 0
        x = j = 0
        ck = cl = cs = 0
        phase = P_INIT
        while True:
            ticks += 1
            if phase == P_INIT:
                xa = code(x)
                if x < n_len and xa < 4:
                    ck, cl, cs = C[xa], C[3 - xa], C[xa + 1] - C[xa]
                    j, phase = x + 1, P_FWD
                    continue
                if x + 1 < n_len:
                    x += 1
                    continue
                break
            a = code(j)
            j_in = j < n_len
            r1 = j_in and a < 4
            if kt is None:
                nk = nl = ns = 0
                if r1:
                    steps += 1
                    nl, nk, ns = fm.ext(cl, ck, cs, 3 - a)
                hit = r1 and ns < max_intv and j + 1 - x >= min_seed_len
                if hit and ns > 0:
                    cnt = rows.emit(rd, cnt, x, j, nk, nl, ns)
                nxv = j + 1 if j_in else j
                end = not r1 or hit
                if not end:
                    ck, cl, cs, j = nk, nl, ns, j + 1
            else:
                b = code(j + 1)
                res = [(0, 0, 0)] * 2
                if r1:
                    res = kt.ext_k(cl, ck, cs, [3 - a, 3 - min(b, 3)])
                (nl, nk, ns), (nl2, nk2, ns2) = res
                hit1 = r1 and ns < max_intv and j + 1 - x >= min_seed_len
                cont1 = r1 and not hit1
                j2_in = j + 1 < n_len
                r2 = cont1 and j2_in and b < 4
                hit2 = r2 and ns2 < max_intv and j + 2 - x >= min_seed_len
                cont2 = r2 and not hit2
                steps += int(r1) + int(r2)
                if hit1 and ns > 0:
                    cnt = rows.emit(rd, cnt, x, j, nk, nl, ns)
                elif hit2 and ns2 > 0:
                    cnt = rows.emit(rd, cnt, x, j + 1, nk2, nl2, ns2)
                nxv = ((j + 2 if j2_in else j + 1) if cont1
                       else (j + 1 if j_in else j))
                end = not cont2
                if cont2:
                    ck, cl, cs, j = nk2, nl2, ns2, j + 2
            if end:
                if nxv >= n_len:
                    break
                x, phase = nxv, P_INIT
        rows.cnt[rd] = cnt
        steps_out[lane] += steps
        ticks_out[lane] += ticks
        return ticks

    _schedule(B, T, run, pull)
    return (*_smem_fields(rows.out, hi_steps), rows.cnt, steps_out,
            ticks_out)
