"""The FM-index walks through the hand-written CUDA kernels of csrc/smem.cu.

Three wrappers, each with the signature of its plain version and each
replacing a ``jax.lax.while_loop`` of the JAX package:
- ``one_pos_machine_cuda``: SMEM passes 1 and 2 (plain
  ``ops/smem_oh.py::one_pos_machine``; JAX ``one_pos_machine_oh``), one
  warp a task;
- ``seed_strategy_machine_cuda``: SMEM pass 3 (plain
  ``ops/smem_oh.py::seed_strategy_machine``; JAX
  ``seed_strategy_machine_oh``), one thread a read;
- ``sa_walk_cuda``: the SA lookup's LF walk, which
  ``ops/sal.py::sa_lookup`` calls (plain ``sa_lookup_plain``; JAX
  ``sa_lookup``), one thread a coordinate; the pipeline's
  ``expand_and_lookup`` runs ``ops/sal_cuda.py`` (csrc/sal.cu) instead.
On CUDA tensors each launches its kernel once (the whole walk in the
launch) or raises; on CPU tensors each runs its plain version (imported
at the call: the plain versions' modules import this one). There is no
fallback from a kernel to its plain version. Each kernel has two forms,
one for each layout of ``ops/occ.py``: positions int32 (the
``*_launch`` functions) or int64 (``*_launch64``), chosen by
``fmi.pos_dtype``; an int64 index never runs the int32 form. Each wrapper
keeps a ``launches`` count (both forms), a ``launches64`` count (the
int64 form) and the last call's per-lane ``last_steps`` (the ext calls);
``one_pos_machine_cuda`` and ``seed_strategy_machine_cuda`` also keep
``last_rounds`` (the dependent occ round trips on each task's path).

With a k-gram checkpoint table on the index (``fmi.kstep`` 2 or 3, int32
layout only) the wrappers launch the k-step forms, which read that table
alone (``_kform_args``: the C array, the sentinel and the table, no
``cp_fused``): ``one_pos_launch_k`` (the forward walk K bases a row
fetch, a backward round that fits one chunk K rounds a fetch) and
``seed_strategy_launch_k`` (two bases a fetch, a trigram table's bigram
groups), counted in ``launches_k`` as well; steps still count single bases,
rounds the row fetches.

Each kernel returns its plain version's arrays exactly, lanes that
overflowed their stacks or their emission depth included. The source is
compiled with nvcc into ``build/torch_kernels/libsmem_cuda.so`` at first
use (``ops/nvcc_build.py``) and bound with ctypes. The wrappers allocate
the outputs (each kernel writes every slot, zeros past a lane's
count; at int64, m and n int32 and k, l and s int64 in one buffer), any
scratch (passes 1-2: the interval stacks ``[T][2][SD + 1]`` entries of
16 bytes, 32 at int64, only where one warp's shared memory cannot hold
them) and the per-lane counts, and launch on the current stream
with no host synchronisation. With ``stats`` they add the longest lane's
steps under ``seed_steps_p1`` / ``seed_steps_p2`` / ``seed_steps_p3``
(``sal_steps`` in ``sa_lookup``), and for passes 1-2 the longest task's
rounds under ``seed_rounds_p1`` / ``seed_rounds_p2``, as device tensors
read once by ``tick_report``.

``one_pos_twin``, ``seed_strategy_twin`` and ``sa_walk_twin`` are the
kernels' loops in plain Python on numpy arrays, tests of the kernels'
control flow on the CPU at small sizes; each counts what its kernel
counts.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem import SmemBuf

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the index arguments of each form (_fmi_args), then each kernel's own
_FMI = {torch.int32: [_vp] + [_ci] * 7,
        torch.int64: [_vp] + [_ll] * 7 + [_vp] + [_ci] * 4}
_ONE_POS = [_vp, _vp, _ci, _ci] + [_vp] * 4 + [_ci] * 5 + [_vp] * 5
_P3 = [_vp, _vp] + [_ci] * 6 + [_vp] * 3
_KFORM = [_ci] * 6 + [_vp, _ci, _ci, _vp, _vp, _ci]
_SAL = {torch.int32: [_vp, _ci, _ci, _vp, _vp, _ci] + [_vp] * 2,
        torch.int64: [_vp, _ll, _ci, _vp, _vp, _ci] + [_vp] * 2}
_SUFFIX = {torch.int32: "", torch.int64: "64"}
LIB = nvcc_build.Library("smem.cu", "smem_cuda", {
    **{f"{fn}{_SUFFIX[pd]}": _FMI[pd] + tail
       for pd in _FMI
       for fn, tail in (("one_pos_launch", _ONE_POS),
                        ("seed_strategy_launch", _P3),
                        ("sa_walk_launch", _SAL[pd]))},
    # the k-step forms: the C array and the sentinel, the k-gram table,
    # its rows and width in int4s, its C2 and C3 tables and K (_kform_args);
    # pass 3 also each read's rounds
    **{"one_pos_launch_k": _KFORM + _ONE_POS,
       "seed_strategy_launch_k": _KFORM + _P3 + [_vp]}},
    host_fns={"one_pos_stacks_in_shared": [_ci, _ci],
              "one_pos_stacks_in_shared64": [_ci, _ci]})
build = LIB.build            # compile csrc/smem.cu; returns the library path


def _fmi_args(fmi: DeviceFMIndex) -> list:
    """The launch arguments every kernel takes first: the checkpoint
    table and its rows, the C array and the sentinel row; on the int64
    layout also the high-word step table and each base's step count."""
    args = [fmi.cp_fused.data_ptr(), fmi.cp_fused.shape[0],
            *fmi.count_host, fmi.sentinel_index]
    if fmi.pos_dtype == torch.int64:
        args += [fmi.cp_hi_steps.data_ptr(), *fmi.hi_counts]
    return args


def _kform_args(fmi: DeviceFMIndex) -> list:
    """The index arguments of the k-step forms of passes 1-3, which read
    the k-gram table alone: the C array and the sentinel, the k-gram rows,
    their count and width in int4s, the C2 and C3 tables (C3 null at K =
    2) and K."""
    t = fmi.cp_kstep
    return [*fmi.count_host, fmi.sentinel_index, t.data_ptr(), t.shape[0],
            t.shape[1] // 4, fmi.count2.data_ptr(),
            None if fmi.count3 is None else fmi.count3.data_ptr(), fmi.kstep]


def _form(fn: str, fmi: DeviceFMIndex) -> str:
    """The launch function of `fn`'s form for fmi's position dtype."""
    return fn + _SUFFIX[fmi.pos_dtype]


def _count(wrapper, fmi: DeviceFMIndex, kstep: bool = False) -> None:
    """One launch of `wrapper`'s kernel, in its form's counts."""
    wrapper.launches += 1
    wrapper.launches64 += fmi.pos_dtype == torch.int64
    wrapper.launches_k += kstep


def _smem_out(n: int, M: int, pos_dtype, dev):
    """(the kernel's output buffer, SmemBuf's m, n, k, l, s) for n lanes
    of M slots: [5][n][M] int32 at int32 positions; at int64, m and n
    [2][n][M] int32 then k, l and s [3][n][M] int64, in one buffer."""
    if pos_dtype == torch.int32:
        out = torch.empty((5, n, M), dtype=torch.int32, device=dev)
        return out, out.unbind(0)
    nm = n * M
    out = torch.empty((32 * nm,), dtype=torch.uint8, device=dev)
    mn = out[:8 * nm].view(torch.int32).view(2, n, M)
    kls = out[8 * nm:].view(torch.int64).view(3, n, M)
    return out, (*mn.unbind(0), *kls.unbind(0))


def _check(what: str, fmi: DeviceFMIndex, *tensors) -> torch.device:
    """The device of tensors[0]: CUDA, shared by every tensor and fmi's
    tables, or ValueError."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    tables = (fmi.cp_fused, fmi.count) + (
        () if fmi.cp_hi_steps is None else (fmi.cp_hi_steps,)) + tuple(
        t for t in (fmi.cp_kstep, fmi.count2, fmi.count3) if t is not None)
    if any(t.device != dev for t in (*tensors, *tables)):
        raise ValueError(f"{what}: tensors on different devices")
    if fmi.pos_dtype not in _SUFFIX:
        raise ValueError(f"{what}: positions of {fmi.pos_dtype}")
    return dev


def _codes_int32(what: str, codes, lens) -> None:
    if codes.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{what}: codes and lens must be int32")


def add_walk_stats(stats: dict, stats_key: str, steps, rounds) -> None:
    """Add a walk launch's longest lane's steps and rounds ([lanes] device
    tensors; rounds None: not counted) to `stats` under `stats_key` with
    "ticks" read as "steps" and "rounds"; into a DeferredStats, keep them
    unreduced."""
    if isinstance(stats, DeferredStats):
        stats.pending.append((stats_key, steps, rounds))
        return
    for what, per_lane in (("steps", steps), ("rounds", rounds)):
        if per_lane is not None:
            key = stats_key.replace("ticks", what)
            stats[key] = stats.get(key, 0) + per_lane.max()


class DeferredStats(dict):
    """A stats dict for one call whose walk launches' counts wait: the
    wrappers leave each launch's per-lane steps and rounds in ``pending``
    (no reduction between the call's launches); ``fold`` adds all of it
    to the caller's stats."""

    def __init__(self):
        super().__init__()
        self.pending = []

    def fold(self, stats: dict) -> None:
        for key, v in self.items():
            stats[key] = stats.get(key, 0) + v
        for key, steps, rounds in self.pending:
            add_walk_stats(stats, key, steps, rounds)


def one_pos_machine_cuda(fmi: DeviceFMIndex, codes, lens, t_read, t_x,
                         t_mi, t_valid, chain_restarts: bool,
                         min_seed_len: int, max_out: int,
                         stack_depth: int = None, stats: dict = None,
                         stats_key: str = "seed_ticks") -> SmemBuf:
    """Drop-in for ``one_pos_machine`` (equal arrays). codes [B, L] and
    lens [B] int32; t_read, t_x, t_mi [T] integer; t_valid [T] bool, all
    on fmi's device. `stats` gets the lockstep's tick count from the
    plain version (CPU tensors), or the kernel's longest task's steps and
    rounds under ``stats_key`` with "ticks" read as "steps" and "rounds"
    (CUDA tensors)."""
    if codes.device.type == "cpu":
        from .smem_oh import one_pos_machine
        return one_pos_machine(fmi, codes, lens, t_read, t_x, t_mi, t_valid,
                               chain_restarts, min_seed_len, max_out,
                               stack_depth, stats, stats_key)
    dev = _check("one_pos_machine_cuda", fmi, codes, lens, t_read, t_x,
                 t_mi, t_valid)
    _codes_int32("one_pos_machine_cuda", codes, lens)
    B, L = codes.shape
    T = t_read.shape[0]
    SD = stack_depth or L
    if lens.shape != (B,) or any(t.shape != (T,)
                                 for t in (t_x, t_mi, t_valid)):
        raise ValueError("one_pos_machine_cuda: task or read counts differ")
    i32 = torch.int32
    out, fields = _smem_out(T, max_out, fmi.pos_dtype, dev)
    cnt = torch.empty((T,), dtype=i32, device=dev)
    steps = torch.empty((T,), dtype=i32, device=dev)
    rounds = torch.empty((T,), dtype=i32, device=dev)
    if T:
        args = [codes.contiguous(), lens.contiguous(),
                t_read.to(i32).contiguous(), t_x.to(i32).contiguous(),
                t_mi.to(i32).contiguous(),
                t_valid.to(torch.bool).contiguous()]
        # the stacks in each warp's shared memory, or past 227 KB a scratch
        # (entries of 16 bytes, 32 at int64)
        stk = (None if LIB.call(_form("one_pos_stacks_in_shared", fmi), L, SD)
               else torch.empty((T, 2, SD + 1, 4 * fmi.pos_dtype.itemsize),
                                dtype=torch.uint8, device=dev))
        ks = fmi.kstep
        form = (["one_pos_launch_k", *_kform_args(fmi)] if ks > 1 else
                [_form("one_pos_launch", fmi), *_fmi_args(fmi)])
        LIB.launch(dev, *form, args[0].data_ptr(), args[1].data_ptr(), B, L,
                   *(a.data_ptr() for a in args[2:]), T, int(chain_restarts),
                   min_seed_len, max_out, SD,
                   None if stk is None else stk.data_ptr(), out.data_ptr(),
                   cnt.data_ptr(), steps.data_ptr(), rounds.data_ptr())
        _count(one_pos_machine_cuda, fmi, ks > 1)
        if stats is not None:
            add_walk_stats(stats, stats_key, steps, rounds)
    one_pos_machine_cuda.last_steps = steps
    one_pos_machine_cuda.last_rounds = rounds
    return SmemBuf(*fields, cnt)


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, the int64 form's and the k-step forms'
one_pos_machine_cuda.launches = 0
one_pos_machine_cuda.launches64 = 0
one_pos_machine_cuda.launches_k = 0
# the per-task ext calls and dependent occ round trips of the last call
# ([T] int32 each, on its device)
one_pos_machine_cuda.last_steps = None
one_pos_machine_cuda.last_rounds = None


def seed_strategy_machine_cuda(fmi: DeviceFMIndex, codes, lens,
                               max_intv: int, min_seed_len: int,
                               max_out: int, stats: dict = None) -> SmemBuf:
    """Drop-in for ``seed_strategy_machine`` (equal arrays), one lane a
    read. codes [B, L] and lens [B] int32 on fmi's device. `stats` gets
    the lockstep's ``seed_ticks_p3`` from the plain version (CPU tensors)
    or the kernel's longest lane's steps and rounds under
    ``seed_steps_p3`` and ``seed_rounds_p3`` (CUDA tensors)."""
    if codes.device.type == "cpu":
        from .smem_oh import seed_strategy_machine
        return seed_strategy_machine(fmi, codes, lens, max_intv,
                                     min_seed_len, max_out, stats)
    dev = _check("seed_strategy_machine_cuda", fmi, codes, lens)
    _codes_int32("seed_strategy_machine_cuda", codes, lens)
    B, L = codes.shape
    if lens.shape != (B,):
        raise ValueError("seed_strategy_machine_cuda: read counts differ")
    i32 = torch.int32
    out, fields = _smem_out(B, max_out, fmi.pos_dtype, dev)
    cnt = torch.empty((B,), dtype=i32, device=dev)
    steps = torch.empty((B,), dtype=i32, device=dev)
    kstep = fmi.kstep > 1
    # a row fetch a step at K = 1
    rounds = torch.empty((B,), dtype=i32, device=dev) if kstep else steps
    if B:
        c, ln = codes.contiguous(), lens.contiguous()
        form = (["seed_strategy_launch_k", *_kform_args(fmi)] if kstep else
                [_form("seed_strategy_launch", fmi), *_fmi_args(fmi)])
        LIB.launch(dev, *form, c.data_ptr(), ln.data_ptr(), B, L,
                   int(max_intv), min_seed_len, max_out, 0, out.data_ptr(),
                   cnt.data_ptr(), steps.data_ptr(),
                   *([rounds.data_ptr()] if kstep else []))
        _count(seed_strategy_machine_cuda, fmi, kstep)
        if stats is not None:
            add_walk_stats(stats, "seed_ticks_p3", steps, rounds)
    seed_strategy_machine_cuda.last_steps = steps
    seed_strategy_machine_cuda.last_rounds = rounds
    return SmemBuf(*fields, cnt)


seed_strategy_machine_cuda.launches = 0
seed_strategy_machine_cuda.launches64 = 0
seed_strategy_machine_cuda.launches_k = 0
seed_strategy_machine_cuda.last_steps = None     # [B] int32, on its device
seed_strategy_machine_cuda.last_rounds = None    # [B] int32, on its device


# ---- the one-hot stage's glue (csrc/smem_glue.cu) ---------------------------

_SMEM6 = [_vp] * 6                  # an SmemBuf: m, n, k, l, s, cnt
GLUE = nvcc_build.Library("smem_glue.cu", "smem_glue_cuda", {
    **{f"reseed_tasks_launch{sfx}": [_vp] * 4 + [_ci] * 4 + [_ll] + [_vp] * 7
       for sfx in _SUFFIX.values()},
    **{f"merge_smems_launch{sfx}": _SMEM6 * 3 + [_vp] * 3 + [_ci] * 4
       + [_vp] + _SMEM6 for sfx in _SUFFIX.values()}})
build_glue = GLUE.build      # compile csrc/smem_glue.cu; returns the path

MERGE_WARPS = 8              # merge_smems_kernel's warps a block
# the shared memory a block may take (227 KB); monkeypatch it small to
# give merge_smems_kernel its device scratch at ordinary widths
MERGE_SMEM_BUDGET = 232448
MERGE_M_MAX = 46340          # M x M < 2^31: a pass-2 entry's source index
TASK_THREADS = 1024          # reseed_tasks_kernel's one block: a chunk
KEY_INVALID = 1 << 30        # an invalid slot's sort key


def merge_plan(M: int, parts: int, budget: int = None) -> tuple:
    """(warps a block, whether the staging sits in shared memory) of
    merge_smems_kernel for rows of M slots a pass and `parts` passes: W =
    parts x M staged pairs of 8 bytes a warp, 8 warps a block while they
    fit `budget` (default MERGE_SMEM_BUDGET), fewer past it, and past one
    warp's share a device scratch [B][W] with 8 warps. Raises ValueError
    for M past MERGE_M_MAX, a width no pipeline makes."""
    if M > MERGE_M_MAX:
        raise ValueError(f"merge_smems_cuda: {M} slots a pass (at most "
                         f"{MERGE_M_MAX})")
    per = parts * M * 8
    budget = MERGE_SMEM_BUDGET if budget is None else budget
    if per > budget:
        return MERGE_WARPS, False
    return min(MERGE_WARPS, budget // per), True


def _glue_check(what: str, *bufs) -> torch.device:
    """The device of bufs[0] (SmemBufs, or None): CUDA, shared by every
    field; m, n and cnt int32, k, l and s of one position dtype; or
    ValueError."""
    dev = bufs[0].m.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    pd = bufs[0].k.dtype
    for b in bufs:
        if b is None:
            continue
        if any(f.device != dev for f in b):
            raise ValueError(f"{what}: tensors on different devices")
        if (any(f.dtype != torch.int32 for f in (b.m, b.n, b.cnt))
                or any(f.dtype != pd for f in (b.k, b.l, b.s))
                or pd not in _SUFFIX):
            raise ValueError(f"{what}: m, n and cnt must be int32, k, l and "
                             f"s of one position dtype (int32 or int64)")
    return dev


def reseed_tasks_cuda(p1: SmemBuf, T: int, split_len: int,
                      split_width: int):
    """Pass 2's task list from pass 1's SmemBuf [B, M]: (t_read, t_x,
    t_mi, t_valid [T], reseed_of [B], each read's first task and task
    count [B]), the values of the plain version ``smem.reseed_task_list``
    (the CPU path). On CUDA tensors one launch of csrc/smem_glue.cu's
    reseed_tasks_kernel (t_read, t_x and t_mi int32, t_valid and
    reseed_of bool, in two allocations) or ValueError; no
    synchronisation."""
    if p1.m.device.type == "cpu":
        from .smem import reseed_task_list
        return reseed_task_list(p1, T, split_len, split_width)
    dev = _glue_check("reseed_tasks_cuda", p1)
    B, M = p1.m.shape
    if B == 0 or M == 0 or B * M >= 1 << 31 or T < 0:
        raise ValueError(f"reseed_tasks_cuda: {B} reads of {M} slots, "
                         f"{T} tasks")
    ints = torch.empty((3 * T + 2 * B,), dtype=torch.int32, device=dev)
    t_read, t_x, t_mi, first, count = ints.split([T, T, T, B, B])
    flags = torch.empty((T + B,), dtype=torch.bool, device=dev)
    t_valid, reseed_of = flags.split([T, B])
    pd = p1.k.dtype
    src = [f.contiguous() for f in (p1.m, p1.n, p1.s, p1.cnt)]
    GLUE.launch(dev, "reseed_tasks_launch" + _SUFFIX[pd],
                *(f.data_ptr() for f in src), B, M, T, split_len,
                split_width, *(t.data_ptr() for t in (
                    t_read, t_x, t_mi, t_valid, reseed_of, first, count)))
    reseed_tasks_cuda.launches += 1
    reseed_tasks_cuda.launches64 += pd == torch.int64
    return t_read, t_x, t_mi, t_valid, reseed_of, first, count


reseed_tasks_cuda.launches = 0
reseed_tasks_cuda.launches64 = 0


def merge_smems_cuda(p1: SmemBuf, p2t: SmemBuf, p3, t_read, t_valid, first,
                     count, reseed_of, pass_of: bool) -> SmemBuf:
    """The SmemBuf [B, W] of the plain version ``smem.merge_smems_plain``
    (the CPU path, which reads t_read and t_valid) from pass 1 [B, M],
    pass 2's task rows p2t [T, M], pass 3 [B, M] or None (W = 3 M or 2 M)
    and the task list (the kernel reads each read's first task and task
    count, as ``reseed_tasks_cuda`` gives them, and reseed_of). On CUDA
    tensors one launch of csrc/smem_glue.cu's merge_smems_kernel (the
    staging planned by ``merge_plan``; its scratch allocated where the
    plan says) or ValueError; no synchronisation."""
    if p1.m.device.type == "cpu":
        from .smem import merge_smems_plain
        return merge_smems_plain(p1, p2t, p3, t_read, t_valid, first, count,
                                 reseed_of, pass_of)
    dev = _glue_check("merge_smems_cuda", p1, p2t, p3)
    B, M = p1.m.shape
    pd = p1.k.dtype
    parts = 2 if p3 is None else 3
    if (p2t.m.shape[1] != M or p2t.k.dtype != pd
            or (p3 is not None and (p3.m.shape != (B, M) or p3.k.dtype != pd))
            or any(t.shape != (B,) or t.device != dev
                   for t in (first, count, reseed_of))
            or first.dtype != torch.int32 or count.dtype != torch.int32
            or reseed_of.dtype != torch.bool or B == 0 or M == 0):
        raise ValueError("merge_smems_cuda: shapes, dtypes or devices of "
                         "the passes and the task list differ")
    warps, shared = merge_plan(M, parts)
    W = parts * M
    out, fields = _smem_out(B, W, pd, dev)
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    scratch = (None if shared else
               torch.empty((B, W, 2), dtype=torch.int32, device=dev))
    src = [f.contiguous() for buf in (p1, p2t, p3) if buf is not None
           for f in buf] + [t.contiguous() for t in (first, count, reseed_of)]
    ptrs = [f.data_ptr() for f in src]
    if p3 is None:
        ptrs[12:12] = [None] * 6
    GLUE.launch(dev, "merge_smems_launch" + _SUFFIX[pd], *ptrs, B, M,
                int(pass_of), warps,
                None if scratch is None else scratch.data_ptr(),
                *(f.data_ptr() for f in fields), cnt.data_ptr())
    merge_smems_cuda.launches += 1
    merge_smems_cuda.launches64 += pd == torch.int64
    return SmemBuf(*fields, cnt)


merge_smems_cuda.launches = 0
merge_smems_cuda.launches64 = 0


def sa_walk_cuda(fmi: DeviceFMIndex, pos: torch.Tensor,
                 valid: torch.Tensor, stats: dict = None) -> torch.Tensor:
    """Drop-in for ``sa_lookup_plain`` (equal values): SA[pos] for BWT
    rows pos [...] where valid [...] (0 elsewhere), values and walk at
    fmi's position dtype. On CPU tensors the
    plain version, with the lockstep's ``sal_ticks`` in `stats`. On CUDA
    tensors, with fmi.sa_compx in [1, 30], one launch of sa_walk_kernel:
    keeps ``last_steps`` (each lane's walk iterations, one dependent row
    or sample load each) and adds the longest under ``sal_steps`` in
    `stats` (a device tensor). No synchronisation."""
    if pos.device.type == "cpu":
        from .sal import sa_lookup_plain
        return sa_lookup_plain(fmi, pos, valid, stats)
    dev = _check("sa_walk_cuda", fmi, pos, valid, fmi.sa_samples)
    if not 1 <= fmi.sa_compx <= 30:
        raise ValueError(f"sa_walk_cuda: sa_compx {fmi.sa_compx} has no "
                         f"walk (0 is a single gather)")
    pd = fmi.pos_dtype
    if valid.shape != pos.shape or fmi.sa_samples.dtype != pd:
        raise ValueError("sa_walk_cuda: valid's shape differs from pos's, "
                         "or the SA samples' dtype from the positions'")
    p = pos.reshape(-1).to(pd).contiguous()
    v = valid.reshape(-1).to(torch.bool).contiguous()
    samples = fmi.sa_samples.contiguous()
    N = p.shape[0]
    out = torch.empty((N,), dtype=pd, device=dev)
    steps = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        LIB.launch(dev, _form("sa_walk_launch", fmi), *_fmi_args(fmi),
                   samples.data_ptr(), samples.shape[0], fmi.sa_compx,
                   p.data_ptr(), v.data_ptr(), N, out.data_ptr(),
                   steps.data_ptr())
        _count(sa_walk_cuda, fmi)
        if stats is not None:
            stats["sal_steps"] = stats.get("sal_steps", 0) + steps.max()
    sa_walk_cuda.last_steps = steps
    return out.reshape(pos.shape)


sa_walk_cuda.launches = 0
sa_walk_cuda.launches64 = 0
sa_walk_cuda.launches_k = 0
sa_walk_cuda.last_steps = None                   # [N] int32, on its device


def twin_tables(fmi: DeviceFMIndex) -> tuple:
    """(count, cp_fused, sentinel_index) of fmi as the twins take them
    first, then their ``hi_steps`` keyword: the int64 layout's step table,
    or None."""
    steps = fmi.cp_hi_steps
    return (fmi.count.cpu().numpy(), fmi.cp_fused.cpu().numpy(),
            fmi.sentinel_index,
            None if steps is None else steps.cpu().numpy())


class _TwinFmi:
    """The kernels' checkpoint-occ step on numpy arrays (csrc/smem.cu's
    cp_row, occ4 and ext, with their clamps), for the twins; with
    `hi_steps` (the int64 layout) a row's counts are its low words plus
    each base's high word from the step table, as the int64 forms decode
    them."""

    def __init__(self, count, cp_fused, sentinel_index: int, hi_steps=None):
        self.count = [int(v) for v in count]
        self.cp = np.asarray(cp_fused, np.int64)
        self.sentinel = int(sentinel_index)
        self.hi = (None if hi_steps is None else
                   [[int(v) for v in row] for row in np.asarray(hi_steps)])
        self.seen = set()            # the rows (blocks) read so far

    def row(self, pp: int):
        """(counts, masks as unsigned ints, y) of position pp's row."""
        blk = min(max(pp >> 5, 0), self.cp.shape[0] - 1)
        self.seen.add(blk)
        r = self.cp[blk].tolist()
        cnt = r[:4]
        if self.hi is not None:
            cnt = [(v & 0xFFFFFFFF) | (sum(blk >= b for b in steps) << 32)
                   for v, steps in zip(cnt, self.hi)]
        return cnt, [v & 0xFFFFFFFF for v in r[4:]], pp & 31

    @staticmethod
    def top_bits(y: int) -> int:
        return 0 if y == 0 else (0xFFFFFFFF << (32 - y)) & 0xFFFFFFFF

    def occ4(self, pp: int):
        cnt, msk, y = self.row(pp)
        top = self.top_bits(y)
        return [c + (m & top).bit_count() for c, m in zip(cnt, msk)]

    def ext(self, k: int, l: int, s: int, c: int):
        a, b = self.occ4(k), self.occ4(k + s)
        s4 = [b[i] - a[i] for i in range(4)]
        sent = int(k <= self.sentinel < k + s)
        return self.count[c] + a[c], l + sent + sum(s4[c + 1:]), s4[c]


def kstep_tables(fmi: DeviceFMIndex):
    """The twins' ``kstep`` keyword for fmi: (k-gram rows, C2, C3 or None)
    as numpy arrays, or None without a table."""
    if fmi.cp_kstep is None:
        return None
    return (fmi.cp_kstep.cpu().numpy(), fmi.count2.cpu().numpy(),
            None if fmi.count3 is None else fmi.count3.cpu().numpy())


class _TwinK:
    """csrc/fmi_step.cuh's ext_k / ext_kt on numpy arrays: KS = len(c)
    bases from the 32-byte groups of one k-gram row at each end (the
    1-step row, the first base's bigram group, the pair's trigram
    group)."""

    def __init__(self, fm: _TwinFmi, cp_kstep, count2, count3=None):
        self.fm = fm
        self.cp = np.asarray(cp_kstep, np.int64)
        self.c2 = [int(v) for v in count2]
        self.c3 = None if count3 is None else [int(v) for v in count3]
        self.ks = 2 if count3 is None else 3

    def occ(self, pp: int, g: int):
        blk = min(max(pp >> 5, 0), self.cp.shape[0] - 1)
        self.fm.seen.add((blk, g))   # a 32-byte group of the k-gram row
        row = self.cp[blk, 8 * g: 8 * g + 8]
        top = _TwinFmi.top_bits(pp & 31)
        return [int(row[i]) + bin(int(row[4 + i]) & 0xFFFFFFFF & top
                                  ).count("1") for i in range(4)]

    def ext_k(self, k: int, l: int, s: int, c: list, live: int = None
              ) -> list:
        """The intervals after 1, ..., live bases of c (all of them by
        default), the groups of the first `live` steps read."""
        live = len(c) if live is None else live
        grp = ([0, 1 + c[0], 5 + 4 * c[0] + c[1]][:len(c)] if len(c) > 1
               else [0])
        base = [self.fm.count[c[0]]]
        if len(c) > 1:
            base.append(self.c2[4 * c[0] + c[1]])
        if len(c) > 2:
            base.append(self.c3[16 * c[0] + 4 * c[1] + c[2]])
        ends = (k, k + s)                    # every group at these two
        out = []
        for d, cd in enumerate(c[:live]):
            a, b = (self.occ(pp, grp[d]) for pp in ends)
            s4 = [b[i] - a[i] for i in range(4)]
            sent = int(k <= self.fm.sentinel < k + s)
            k, l, s = base[d] + a[cd], l + sent + sum(s4[cd + 1:]), s4[cd]
            out.append((k, l, s))
        return out


WARP = 32                # a warp's lanes: one backward-round chunk


class _RowOut:
    """A task's emissions into its output row ([5, M], a view of a twin's
    output): an emission past M dropped while the count grows."""

    def __init__(self, row):
        self.row, self.cnt = row, 0

    def __call__(self, *vals):
        if self.cnt < self.row.shape[1]:
            self.row[:, self.cnt] = vals
        self.cnt += 1


def warp_task(fm: _TwinFmi, kt, code, n_len: int, mi: int, x: int,
              chain_restarts: bool, min_seed_len: int, SD: int, stk, emit,
              where: str, events=None) -> tuple:
    """csrc/one_pos_task.cuh's one_pos_task in plain Python: one task's
    walk as one warp runs it, over `stk` ([2][SD + 1][4] stack slots) and
    the read's clipped codes `code(i)`, emitting through `emit(m, n, k, l,
    s)`: the serial forward walk, then each backward round in chunks of
    WARP simulated lanes with the ballot-form keep/emit rule. With `kt` (a
    ``_TwinK``: K = 3 with a C3 table, else 2) every occ step reads the
    k-gram table: the forward walk K bases a fetch, and a backward round
    whose entries fit one chunk (and the stack) K rounds a fetch, the rule
    applied K times over the lanes each sub-round keeps. Raises
    AssertionError, naming `where`, where a round or sub-round breaks the
    two orders that rule rests on (along p the new sizes never fall and
    the entries' ends never rise). `events` (a Counter) counts the k-step
    rounds' shapes: "chunked" (a round taken 1-step), "fused", the
    k-step rounds that end at the read's "start" or an "N", and
    "sentinel" (a sub-round after the first whose entries hold the
    sentinel row). Returns (steps, rounds, whether a stack count passed
    SD)."""
    count = fm.count
    events = collections.Counter() if events is None else events
    ks = 1 if kt is None else kt.ks
    ext = fm.ext if kt is None else (
        lambda k, l, s, c: kt.ext_k(k, l, s, [c])[0])
    steps = rounds = wA = 0
    of = False

    def push(buf, c, vals):
        nonlocal of
        stk[buf, min(c, SD)] = vals
        of |= c + 1 > SD
        return c + 1

    def read(buf, i):
        return [int(v) for v in stk[buf, min(max(i, 0), SD - 1)]]

    def in_order(pairs, at):
        """The two orders along a round's entries: (new size, end)."""
        for p in range(1, len(pairs)):
            if pairs[p][0] < pairs[p - 1][0] or pairs[p][1] > pairs[p - 1][1]:
                raise AssertionError(f"{where}, round at j={at}, entry {p}: "
                                     f"sizes or ends out of order")

    def fused_round(j, cA, mA, rev):
        """K backward rounds from one fetch (the kernel's k-step round):
        (the entries the last sub-round kept, as stack slots, or None where
        the backward rounds end)."""
        nonlocal steps, rounds
        ents = [read(wA, cA - 1 - p if rev else p) for p in range(cA)]
        cc = [code(j)] + [code(j - d) if j - d >= 0 else 4
                          for d in range(1, ks)]
        live = 1                             # the bases before an end
        while live < ks and cc[live] < 4:
            live += 1
        ch = [c if c < 4 else 0 for c in cc]
        res = [kt.ext_k(*e[:3], ch, live) for e in ents]
        rounds += 1
        inn = list(range(cA))                # the sub-round's lanes
        cur = [tuple(e[:3]) for e in ents]   # each lane's interval
        m = mA
        events["fused"] += 1
        for d in range(ks):
            if d and inn and d >= live:
                events["start" if j - d < 0 else "N"] += 1
            if d and (d >= live or not inn):     # the walk's end
                if inn and ents[inn[0]][3] - m + 1 >= min_seed_len:
                    emit(m, ents[inn[0]][3], *cur[inn[0]])
                return None
            steps += len(inn)
            events["sentinel"] += d > 0 and any(
                cur[p][0] <= fm.sentinel < cur[p][0] + cur[p][2] for p in inn)
            ns = [res[p][d][2] for p in inn]
            in_order([(v, ents[p][3]) for v, p in zip(ns, inn)], j - d)
            p0 = inn[0]                          # only it emits
            if ns[0] < mi and ents[p0][3] - m + 1 >= min_seed_len:
                emit(m, ents[p0][3], *cur[p0])
            kept = [p for i, p in enumerate(inn) if ns[i] >= mi and ns[i]
                    != (-1 if i == 0 or ns[i - 1] < mi else ns[i - 1])]
            for p in inn:
                cur[p] = res[p][d]
            inn, m = kept, j - d
        return [(*cur[p], ents[p][3]) for p in inn]

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
        go = True
        while go and j < n_len:                  # forward, serial
            nx = j + 1
            cc = [code(j + d) for d in range(ks)]
            if cc[0] >= 4:
                break
            if kt is None:
                res = [ext(cl, ck, cs, 3 - cc[0])]
            else:                                # KS bases a fetch
                live = 1
                while live < ks and j + live < n_len and cc[live] < 4:
                    live += 1
                res = kt.ext_k(cl, ck, cs, [3 - min(c, 3) for c in cc],
                               live)
            rounds += 1
            for d, (nl, nk, ns) in enumerate(res):
                if d:                            # mid-stride ends
                    if j >= n_len:
                        go = False
                        break
                    nx = j + 1
                    if cc[d] >= 4:
                        go = False
                        break
                steps += 1
                if ns != cs:
                    cA = push(wA, cA, (ck, cl, cs, cn))
                if ns < mi:
                    nx = j
                    go = False
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
            if kt is not None and cA <= min(WARP, SD):
                kept = fused_round(j, cA, mA, rev)
                if kept is None:
                    break
                for i, vals in enumerate(kept):
                    stk[wA ^ 1, i] = vals
                wA ^= 1
                cA, mA, rev, j = len(kept), j - (ks - 1), False, j - ks
                continue
            events["chunked"] += kt is not None
            cB, prev, last = 0, 0, None
            for c0 in range(0, cA, WARP):        # a chunk: one trip
                lanes = []                       # (entry, nk, nl, ns)
                for p in range(c0, min(c0 + WARP, cA)):
                    e = read(wA, cA - 1 - p if rev else p)
                    lanes.append((e, *ext(*e[:3], a)))
                    ns, pn = lanes[-1][3], e[3]
                    if last is not None and (ns < last[0] or pn > last[1]):
                        raise AssertionError(
                            f"{where}, round at j={j}, entry {p}: sizes or "
                            f"ends out of order")
                    last = (ns, pn)
                steps += len(lanes)
                rounds += 1
                if c0 == 0:                      # only entry 0 emits
                    (pk, pl, ps, pn), _, _, ns = lanes[0]
                    if ns < mi and pn - mA + 1 >= min_seed_len:
                        emit(mA, pn, pk, pl, ps)
                ballot = 0
                for lane, (_, _, _, ns) in enumerate(lanes):
                    up = prev if lane == 0 else lanes[lane - 1][3]
                    cur = -1 if c0 + lane == 0 or up < mi else up
                    ballot |= int(ns >= mi and ns != cur) << lane
                for lane, (e, nk, nl, ns) in enumerate(lanes):
                    if ballot >> lane & 1:
                        i = cB + bin(ballot & ((1 << lane) - 1)).count("1")
                        stk[wA ^ 1, min(i, SD)] = (nk, nl, ns, e[3])
                cB += bin(ballot).count("1")
                prev = lanes[-1][3]
            of |= cB > SD
            wA ^= 1
            cA, mA, rev, j = cB, j, False, j - 1
        if not chain_restarts:
            break
        x = max(nx, x + 1)
        if x >= n_len:
            break
    return steps, rounds, of


def one_pos_twin(count, cp_fused, sentinel_index: int, codes, lens, t_read,
                 t_x, t_mi, t_valid, chain_restarts: bool,
                 min_seed_len: int, max_out: int, stack_depth: int = None,
                 hi_steps=None, kstep=None, events=None):
    """csrc/smem.cu's one_pos_kernel in plain Python on numpy arrays, one
    task (warp) after another through ``warp_task`` (with `kstep`,
    ``kstep_tables``' k-gram table, the k-step form, which reads that
    table alone; with `hi_steps` (``twin_tables``) the int64 form). Raises
    AssertionError where a round breaks the two orders of the ballot rule.
    Returns (m, n, k, l, s, cnt, steps, rounds) as numpy arrays, k, l and
    s int64 for the int64 form; ``last_reads`` keeps the set of 32-byte
    rows (1-step table) or (row, group) k-gram groups the call read.
    `events`: ``warp_task``'s, summed over the tasks."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    kt = None if kstep is None else _TwinK(fm, *kstep)
    codes = np.asarray(codes)
    B, L = codes.shape
    T = len(t_read)
    SD = stack_depth or L
    M = max_out
    out = np.zeros((5, T, M), np.int64)
    cnt_out, steps_out, rounds_out = (np.zeros(T, np.int32) for _ in range(3))
    stk = np.zeros((2, SD + 1, 4), np.int64)     # one warp's stacks

    for t in range(T):
        rd = min(max(int(t_read[t]), 0), B - 1)
        q = codes[rd]
        n_len = int(lens[rd]) if t_valid[t] else 0

        def code(i, q=q):
            return min(int(q[min(max(i, 0), L - 1)]), 4)

        row = _RowOut(out[:, t])
        steps, rounds, of = warp_task(
            fm, kt, code, n_len, int(t_mi[t]), int(t_x[t]), chain_restarts,
            min_seed_len, SD, stk, row, f"one_pos_twin: task {t}", events)
        cnt_out[t] = M + 1 if of else row.cnt
        steps_out[t], rounds_out[t] = steps, rounds
    one_pos_twin.last_reads = fm.seen
    return (*_smem_fields(out, hi_steps), cnt_out, steps_out, rounds_out)


one_pos_twin.last_reads = None


def _smem_fields(out, hi_steps) -> tuple:
    """A twin's [5, n, M] output as SmemBuf's m, n (int32) and k, l, s
    (int64 for the int64 form, else int32)."""
    pd = np.int32 if hi_steps is None else np.int64
    return (out[0].astype(np.int32), out[1].astype(np.int32),
            *(o.astype(pd) for o in out[2:]))


def seed_strategy_twin(count, cp_fused, sentinel_index: int, codes, lens,
                       max_intv: int, min_seed_len: int, max_out: int,
                       hi_steps=None, kstep=None):
    """csrc/smem.cu's seed_strategy_kernel in plain Python on numpy
    arrays, one read after another: the same flat loop of one row fetch
    an iteration, its `seek` to the next walk and its clamps (the int64
    form with `hi_steps`). With `kstep` (``kstep_tables``' k-gram table)
    two bases a fetch, a trigram table's bigram groups. Returns (m, n, k,
    l, s, cnt, steps, rounds) as numpy arrays; ``last_reads`` keeps the
    set of rows (K = 1) or (row, group) k-gram groups it read."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    kt = None if kstep is None else _TwinK(fm, *kstep)
    C = fm.count
    codes = np.asarray(codes)
    B, L = codes.shape
    M = max_out
    out = np.zeros((5, B, M), np.int64)
    cnt_out, steps_out, rounds_out = (np.zeros(B, np.int32)
                                      for _ in range(3))
    for t in range(B):
        q, n_len = codes[t], int(lens[t])
        cnt = steps = rounds = 0
        st = {}                                      # x, j, ck, cl, cs

        def code(i):
            return min(int(q[min(max(i, 0), L - 1)]), 4)

        def seek(start):
            """The next walk with an ext to make from `start` (the
            kernel's seek); False at the read's end."""
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
            st.update(x=x, j=j, ck=C[xa], cl=C[3 - xa], cs=C[xa + 1] - C[xa])
            return True

        def take(nk, nl, ns):
            """One base with its extension made (the kernel's take):
            True while the walk goes on, else the next walk sought."""
            nonlocal cnt, steps
            x, j = st["x"], st["j"]
            steps += 1
            if ns < max_intv and j + 1 - x >= min_seed_len:
                if ns > 0:
                    if cnt < M:
                        out[:, t, cnt] = (x, j, nk, nl, ns)
                    cnt += 1
                return False, seek(j + 1)
            st.update(ck=nk, cl=nl, cs=ns, j=j + 1)
            if j + 1 >= n_len:
                return False, False
            if code(j + 1) >= 4:
                return False, seek(j + 2)
            return True, True

        live = seek(0)
        while live:                          # one row fetch an iteration
            j = st["j"]
            rounds += 1
            if kt is None:
                nl, nk, ns = fm.ext(st["cl"], st["ck"], st["cs"],
                                    3 - code(j))
                _, live = take(nk, nl, ns)
            else:
                res = kt.ext_k(st["cl"], st["ck"], st["cs"],
                               [3 - code(j), 3 - min(code(j + 1), 3)])
                for nl, nk, ns in res:
                    go, live = take(nk, nl, ns)
                    if not go:
                        break
        cnt_out[t] = cnt
        steps_out[t] = steps
        rounds_out[t] = rounds
    seed_strategy_twin.last_reads = fm.seen
    return (*_smem_fields(out, hi_steps), cnt_out, steps_out, rounds_out)


seed_strategy_twin.last_reads = None


def reseed_tasks_twin(m, n, s, cnt, T: int, split_len: int,
                      split_width: int):
    """csrc/smem_glue.cu's reseed_tasks_kernel in plain Python on pass 1's
    m, n, s [B, M] and cnt [B] (numpy arrays): the block's chunks of
    TASK_THREADS reads, a thread a read counting its candidates, the
    block's exclusive scan of the counts plus the carry of the earlier
    chunks, each thread writing its tasks from its rank up to T; then the
    list's tail. Asserts that every output slot is written once. Returns
    (t_read, t_x, t_mi int32 [T], t_valid [T], reseed_of [B] bool, first,
    count int32 [B])."""
    m, n, s, cnt = (np.asarray(a) for a in (m, n, s, cnt))
    B, M = m.shape
    t_read, t_x, t_mi = (np.zeros(T, np.int32) for _ in range(3))
    t_valid, reseed_of = np.zeros(T, bool), np.zeros(B, bool)
    first, count = np.zeros(B, np.int32), np.zeros(B, np.int32)
    writes, read_writes = np.zeros(T, np.int64), np.zeros(B, np.int64)

    def cand(b, j):
        return (int(n[b, j]) + 1 - int(m[b, j]) >= split_len
                and int(s[b, j]) <= split_width)

    carry = 0
    for base in range(0, B, TASK_THREADS):
        reads = range(base, min(base + TASK_THREADS, B))
        k = [min(max(int(cnt[b]), 0), M) for b in reads]
        c = [sum(cand(b, j) for j in range(kb)) for b, kb in zip(reads, k)]
        excl = np.concatenate([[0], np.cumsum(c)])       # the block's scan
        for i, b in enumerate(reads):
            r0 = carry + int(excl[i])
            kept = max(0, min(c[i], T - r0))
            first[b], count[b], reseed_of[b] = min(r0, T), kept, c[i] > kept
            read_writes[b] += 1
            r = r0
            for j in range(k[i]):
                if r >= r0 + kept:
                    break
                if cand(b, j):
                    t_read[r], t_valid[r] = b, True
                    t_x[r] = (int(n[b, j]) + 1 + int(m[b, j])) >> 1
                    t_mi[r] = int(s[b, j]) + 1
                    writes[r] += 1
                    r += 1
        carry += int(excl[-1])
    x0 = (int(n[0, 0]) + 1 + int(m[0, 0])) >> 1
    for r in range(min(carry, T), T):                    # the list's tail
        t_read[r], t_x[r], t_mi[r], t_valid[r] = 0, x0, 1, False
        writes[r] += 1
    assert (writes == 1).all() and (read_writes == 1).all(), \
        "reseed_tasks_twin: a slot not written once"
    return t_read, t_x, t_mi, t_valid, reseed_of, first, count


def _sort_key(m: int, n: int) -> int:
    """(m << 16) | n as int32, wrapping as the kernel's and torch's do."""
    v = ((int(m) << 16) | (int(n) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def merge_smems_twin(p1, p2t, p3, first, count, reseed_of, pass_of: bool,
                     budget: int = None):
    """csrc/smem_glue.cu's merge_smems_kernel in plain Python, a read (a
    warp) after another: p1 and p3 (or None) as (m, n, k, l, s, cnt) of
    [B, M] and [B] arrays, p2t the same of [T, M] and [T], first / count /
    reseed_of [B] as reseed_tasks_twin gives them. The read's valid
    entries staged in concat order as (key, source) pairs, pass 2's
    placed by a scan over its tasks in chunks of WARP and dropped from
    position M on; each valid entry ranked against the staged keys; the
    invalid slots after them in concat order (the exact rule for them
    where a key reaches 1 << 30); cnt. Keeps merge_plan's (warps, in
    shared memory) for the shapes and `budget` in ``last_plan``, and
    asserts that every output slot is written once. Returns (m, n, k, l,
    s, cnt) as numpy arrays, k, l and s of p1's k dtype."""
    p1, p2t = [np.asarray(a) for a in p1], [np.asarray(a) for a in p2t]
    p3 = None if p3 is None else [np.asarray(a) for a in p3]
    first, count, reseed_of = (np.asarray(a) for a in (first, count,
                                                        reseed_of))
    B, M = p1[0].shape
    parts = 2 if p3 is None else 3
    W = parts * M
    merge_smems_twin.last_plan = merge_plan(M, parts, budget)
    out = [np.zeros((B, W), p1[i].dtype) for i in range(5)]
    cnt_out = np.zeros(B, np.int32)
    writes = np.zeros((B, W), np.int64)
    for b in range(B):
        c1raw = int(p1[5][b])
        c3raw = 0 if p3 is None else int(p3[5][b])
        c1, c3 = min(max(c1raw, 0), M), min(max(c3raw, 0), M)
        f, nt = int(first[b]), int(count[b])
        st = {j: (_sort_key(p1[0][b, j], p1[1][b, j]), j) for j in range(c1)}
        p2cnt, of2 = 0, False
        for t0 in range(0, nt, WARP):                    # a chunk of tasks
            raw = [int(p2t[5][f + t]) for t in range(t0, min(t0 + WARP, nt))]
            ct = [min(max(v, 0), M) for v in raw]
            of2 |= any(v >= M for v in raw)
            off = p2cnt + np.concatenate([[0], np.cumsum(ct)])
            p2cnt += sum(ct)
            for i, cti in enumerate(ct):
                o = int(off[i])
                if o >= M:
                    break
                t = f + t0 + i
                for c in range(min(cti, M - o)):
                    assert c1 + o + c not in st
                    st[c1 + o + c] = (_sort_key(p2t[0][t, c], p2t[1][t, c]),
                                      (t0 + i) * M + c)
        c2 = min(p2cnt, M)
        for j in range(c3):
            st[c1 + c2 + j] = (_sort_key(p3[0][b, j], p3[1][b, j]), j)
        V = c1 + c2 + c3
        assert sorted(st) == list(range(V)), "merge_smems_twin: staging"
        keys = [st[i][0] for i in range(V)]
        big = any(kv >= KEY_INVALID for kv in keys)
        cp = [c1, c2, c3]

        def put(r, src, row):
            for i, o in enumerate(out):
                o[b, r] = 0 if src is None else src[i][row]
            writes[b, r] += 1

        for i in range(V):                               # the valid entries
            kv, y = st[i]
            r = sum(kq < kv or (kq == kv and q < i)
                    for q, kq in enumerate(keys))
            part = 0 if i < c1 else 1 if i < c1 + c2 else 2
            if big and kv >= KEY_INVALID:
                r += W - V if kv > KEY_INVALID else sum(M - cp[p]
                                                        for p in range(part))
            if part == 1:
                put(r, p2t, (f + y // M, y % M))
            else:
                put(r, p3 if part else p1, (b, y))
        lt = sum(kq < KEY_INVALID for kq in keys) if big else V
        for x in range(W - V):                           # the invalid slots
            p, o = 0, x
            while o >= M - cp[p]:
                o -= M - cp[p]
                p += 1
            o += cp[p]
            r = lt + x
            if big:
                idx = p * M + o
                for q, kq in enumerate(keys):
                    pq = 0 if q < c1 else 1 if q < c1 + c2 else 2
                    oq = q - (c1 if pq else 0) - (c2 if pq > 1 else 0)
                    r += kq == KEY_INVALID and pq * M + oq < idx
            put(r, None if p == 1 else p3 if p else p1, (b, o))
        of = bool(reseed_of[b]) or (pass_of and (
            c1raw >= M or of2 or (p3 is not None and c3raw >= M)))
        cnt_out[b] = W if of else c1raw + p2cnt + c3raw
    assert (writes == 1).all(), "merge_smems_twin: a slot not written once"
    return (*out, cnt_out)


merge_smems_twin.last_plan = None


def _twin_walk(fm: _TwinFmi, samples, sa_compx: int, sp: int) -> tuple:
    """csrc/sal_walk.cuh's walk from BWT row sp, with its clamps: (the SA
    value, the rows and samples loaded)."""
    mask, offset, steps = (1 << sa_compx) - 1, 0, 0
    while True:
        steps += 1
        if sp & mask == 0:                           # a sampled row
            i = min(max(sp >> sa_compx, 0), samples.shape[0] - 1)
            return int(samples[i]) + offset, steps
        cnt, msk, y = fm.row(sp)
        b = next((c for c in range(4) if msk[c] >> (31 - y) & 1), 4)
        if b == 4:                                   # the sentinel row
            return offset, steps
        sp = fm.count[b] + cnt[b] + bin(msk[b] & fm.top_bits(y)).count("1")
        offset += 1


def sa_walk_twin(count, cp_fused, sentinel_index: int, sa_samples,
                 sa_compx: int, pos, valid, hi_steps=None):
    """csrc/smem.cu's sa_walk_kernel in plain Python on numpy arrays: the
    same walk and clamps, one lane after another, over pos [...] and
    valid [...] (the int64 form with `hi_steps`). Returns (values [...]
    of the samples' dtype, steps [N] int32)."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    samples = np.asarray(sa_samples)
    pos = np.asarray(pos)
    flat_pos = pos.reshape(-1).astype(samples.dtype)
    flat_valid = np.asarray(valid).reshape(-1)
    out = np.zeros(flat_pos.shape, samples.dtype)
    steps_out = np.zeros(flat_pos.shape, np.int32)
    for t in np.flatnonzero(flat_valid):
        out[t], steps_out[t] = _twin_walk(fm, samples, sa_compx,
                                          int(flat_pos[t]))
    return out.reshape(pos.shape), steps_out
