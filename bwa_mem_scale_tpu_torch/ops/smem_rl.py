"""The readlane seeding engine: read-per-lane SMEM machines with a pool
of worker lanes.

Counterpart of ``bwa_mem_scale_tpu/ops/smem_rl.py``. Each worker lane runs
one task (read, start x, minimum interval) at a time through the
lockstep micro-op machine of getSMEMsOnePosOneThread
(src/FMI_search.cpp:1372-1660): INIT, FWD, BSCAN and BTAIL phases, one FM
extension a lane a tick, with the reference's quirks (the double push of
the failing forward interval, the backward scan's first-hit break and
distinct-s tail, next_x = j on an interval failure). With ``lanes``
below the task count a lane that finishes pulls the next unassigned task
in the same tick, ranked by lane over the lanes finishing together (a
cumsum), as the JAX machine does: kt_for's dynamic scheduling
(src/kthread.cpp:41-77). A task's emissions land in its own output row,
so any ``lanes`` gives the same arrays.

The JAX package's one-hot machines are these machines at one lane a task
(its docstring says so), so both engines share the port's lockstep
(``smem_oh.lockstep_one_pos``, ``lockstep_strategy``): here at full
depth (the read length L, provably enough), every pass emitting at full
depth. The machines follow the JAX machines tick for tick, the k-step
branches (``use2``: K bases a FWD tick, the round's next entries beside a
backward tick) included, so ``with_ticks`` returns the JAX machines' tick
counts; each lane's ``last_steps`` counts single-base extensions, the
same at every K.

On CUDA tensors ``collect_smems_rl`` runs the passes through the kernels
of ``csrc/readlane.cu`` (``ops/smem_rl_cuda.py``: one thread a worker
lane, tasks pulled with an atomic counter); on CPU tensors through the
lockstep machines here. A lane that reaches DONE is a strict no-op, so
the loops test their exit condition once every ``smem.CHECK_EVERY`` ticks.
"""

from __future__ import annotations

import torch

from .occ import DeviceFMIndex
from .smem import SmemBuf
from .smem_cuda import merge_smems_cuda, reseed_tasks_cuda
from .smem_oh import lockstep_one_pos, lockstep_strategy
from .smem_rl_cuda import readlane_one_pos_cuda, readlane_strategy_cuda


def one_pos_machine(fmi: DeviceFMIndex, codes, lens, t_read, t_x, t_mi,
                    t_valid, chain_restarts: bool, min_seed_len: int,
                    max_out: int, n_rows: int = None,
                    with_ticks: bool = False, lanes: int = None,
                    out_rows=None, stats: dict = None,
                    stats_key: str = "rl_ticks"):
    """The JAX readlane ``one_pos_machine``: getSMEMsOnePos for a backlog
    of N tasks (t_read, t_x, t_mi, t_valid [N]) on `lanes` worker lanes
    (default one a task), at full depth (``smem_oh.lockstep_one_pos``).
    With chain_restarts a task restarts at next_x until its read ends
    (pass 1); without it runs one position (pass 2).

    Task i emits into row out_rows[i] (default t_read[i]) of an output of
    n_rows rows (default B without out_rows, else N; the JAX machine's
    `out` buffer), M = max_out slots a row; rows must be distinct among
    tasks. Returns that SmemBuf, with with_ticks also (tick, done_at
    [lanes], phase_ticks [5]) as the JAX machine's. Keeps each lane's
    single-base extensions in ``one_pos_machine.last_steps``."""
    B = codes.shape[0]
    N = t_read.shape[0]
    rows = t_read if out_rows is None else out_rows
    R = n_rows or (B if out_rows is None else N)
    buf, one_pos_machine.last_steps, ticks = lockstep_one_pos(
        fmi, codes, lens, t_read, t_x, t_mi, t_valid, chain_restarts,
        min_seed_len, max_out, rows, R, lanes=lanes, with_ticks=with_ticks,
        stats=stats, stats_key=stats_key)
    return (buf, ticks) if with_ticks else buf


def seed_strategy_machine(fmi: DeviceFMIndex, codes, lens, max_intv: int,
                          min_seed_len: int, max_out: int,
                          with_ticks: bool = False, lanes: int = None,
                          stats: dict = None):
    """The JAX readlane ``seed_strategy_machine``: pass 3 on `lanes`
    worker lanes (default one a read, ``smem_oh.lockstep_strategy``),
    read b in row b; with with_ticks also the ticks run. Keeps each
    lane's single-base extensions in
    ``seed_strategy_machine.last_steps``."""
    buf, seed_strategy_machine.last_steps, tick = lockstep_strategy(
        fmi, codes, lens, max_intv, min_seed_len, max_out, lanes=lanes,
        with_ticks=with_ticks, stats=stats, stats_key="rl_ticks_p3")
    return (buf, tick) if with_ticks else buf


def collect_smems_rl(fmi: DeviceFMIndex, codes, lens, *,
                     min_seed_len: int, split_len: int, split_width: int,
                     max_mem_intv: int, max_out: int = None,
                     lanes: int = None, stats: dict = None) -> SmemBuf:
    """Three-pass SMEM collection (mem_collect_smem,
    src/bwamem.cpp:648-795) on the readlane machines, each pass on
    `lanes` worker lanes (default one a task): all SMEMs, the reseed of
    long low-occurrence SMEMs from their midpoints (a budget of 2 B
    tasks; a read past it reports cnt = the buffer width), the seed
    strategy; then a stable per-read sort on (m << 16) | n. Equal to
    ``collect_smems_oh`` at full depth. codes [B, L] int32, lens [B]
    int32, on fmi's device; each pass through the kernel wrappers (the
    machines here on CPU tensors), the task list and the merge through
    the one-hot engine's (``reseed_tasks_cuda``, ``merge_smems_cuda``
    without its pass overflow: only the task list's saturates)."""
    dev = codes.device
    B, L = codes.shape
    M = max_out or L
    T = 2 * B
    bidx = torch.arange(B, dtype=torch.int32, device=dev)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows = torch.arange(T, dtype=torch.int32, device=dev)
    p1 = readlane_one_pos_cuda(fmi, codes, lens, bidx, zi, zi + 1, lens > 0,
                               True, min_seed_len, M, lanes=lanes,
                               stats=stats, stats_key="rl_ticks_p1")
    t_read, t_x, t_mi, t_valid, reseed_of, first, count = reseed_tasks_cuda(
        p1, T, split_len, split_width)
    p2t = readlane_one_pos_cuda(
        fmi, codes, lens, t_read, t_x, t_mi, t_valid, False, min_seed_len,
        M, lanes=lanes, out_rows=rows, stats=stats, stats_key="rl_ticks_p2")
    p3 = None
    if max_mem_intv > 0:
        p3 = readlane_strategy_cuda(fmi, codes, lens, max_mem_intv,
                                    min_seed_len + 1, M, lanes=lanes,
                                    stats=stats)
    return merge_smems_cuda(p1, p2t, p3, t_read, t_valid, first, count,
                            reseed_of, False)
