"""SMEM seeding machines: lockstep over lanes, one task a lane at a time.

Counterpart of ``bwa_mem_scale_tpu/ops/smem_oh.py`` and of the machines of
``bwa_mem_scale_tpu/ops/smem_rl.py``, which are one machine: the JAX
package states that the one-hot machine's output matches the readlane
machine's at one lane a task, bit for bit. The JAX machines express every
per-lane read and write one-hot over [T, L] panels because XLA on a TPU
serialises per-lane gathers; a GPU gathers natively, so here the read
codes, interval stacks and emission buffers are read and written with
direct indexed gathers and scatters. Control flow and emission order
follow the JAX machines tick for tick (INIT, FWD, BSCAN, BTAIL; the
double push of the failing forward interval, the first-hit break, the
distinct-s tail and next_x = j on failure of getSMEMsOnePosOneThread,
src/FMI_search.cpp:1372-1660), so the output ``SmemBuf`` is equal array
for array.

``lockstep_one_pos`` and ``lockstep_strategy`` run a backlog of tasks on
a pool of worker lanes: with fewer lanes than tasks a lane that finishes
pulls the next unassigned task in the same tick, ranked by lane over the
lanes finishing together (a cumsum), as the JAX readlane machines do
(kt_for's dynamic scheduling, src/kthread.cpp:41-77). A task's emissions
land in its own output row, so the pool does not change the arrays; with
``with_ticks`` they return the JAX machines' tick counts. The one-hot
engine (``one_pos_machine``, ``seed_strategy_machine``,
``collect_smems_oh``) runs one lane a task, a task's row its lane, with
bounded depths; the readlane engine (``ops/smem_rl.py``) runs the pool at
full depth.

The machines run at the index's position dtype (``fmi.pos_dtype``): the
intervals (k, l, s), the interval stacks and the emitted k, l and s are
int32 or int64 as the JAX machines' are; read positions and counts stay
int32.

The contract kept: output order, and ``cnt`` forced to the buffer
width whenever a read overflowed its emission depth, its interval-stack
depth or the reseed lane budget, so the caller's capacity check sends
it to the retry ladder.

A lane that reaches DONE is a strict no-op, so the loops test their
exit condition (a host sync on a GPU) once every ``smem.CHECK_EVERY``
ticks (``smem.run_lockstep``).

With a k-gram checkpoint table on the index (``fmi.kstep`` 2 or 3,
``index/kstep.py``) the machines take the JAX machines' k-step branches
(``use2``) tick for tick: passes 1-2 extend the forward walk K bases a
tick, pushing at each depth where the size changes, and a backward tick
takes the round's next entry (and, in the tail at K = 3, the one after)
beside it from the same row fetch; pass 3 extends two bases a tick (a
trigram table's bigram part). The output is the 1-step machines'; each
lane's steps still count single-base extensions.

``collect_smems_oh`` runs passes 1 and 2 through
``smem_cuda.one_pos_machine_cuda`` and pass 3 through
``smem_cuda.seed_strategy_machine_cuda``: one launch of a
``csrc/smem.cu`` kernel a pass on CUDA tensors, the lockstep machines
here (``one_pos_machine``, ``seed_strategy_machine``) on CPU tensors.
"""

from __future__ import annotations

import torch

from .occ import (DeviceFMIndex, backward_ext_all4,
                  backward_ext_steps_and_1, forward_ext2)
from .smem import SmemBuf, run_lockstep
from .smem_cuda import (DeferredStats, merge_smems_cuda,
                        one_pos_machine_cuda, reseed_tasks_cuda,
                        seed_strategy_machine_cuda)

P_INIT = 0
P_FWD = 1
P_BSCAN = 2
P_BTAIL = 3
P_DONE = 4


def _sel4(v4: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """v4[t, c[t]] for a base index c in [0, 3]."""
    return v4.gather(-1, c.long()[..., None])[..., 0]


class _RowEmitter:
    """Append buffers [R, M] plus one trash column, a count a row: an
    emission lands at its row's count, a write past the width is dropped
    while the count grows. The lanes emitting in one tick own distinct
    rows (one task a lane, one row a task)."""

    def __init__(self, R: int, M: int, device, pos_dtype):
        self.M = M
        self.bufs = [torch.zeros((R, M + 1), dtype=dt, device=device)
                     for dt in (torch.int32, torch.int32, pos_dtype,
                                pos_dtype, pos_dtype)]
        self.cnt = torch.zeros((R,), dtype=torch.int32, device=device)

    def emit(self, mask, rows, *vals):
        col = torch.where(mask, self.cnt[rows], self.M).clamp(max=self.M)
        for buf, v in zip(self.bufs, vals):
            buf[rows, col.long()] = v.to(buf.dtype)
        self.cnt.index_add_(0, rows, mask.to(torch.int32))

    def result(self) -> SmemBuf:
        m, n, k, l, s = (b[:, :self.M] for b in self.bufs)
        return SmemBuf(m, n, k, l, s, self.cnt)


def lockstep_one_pos(fmi: DeviceFMIndex, codes, lens, t_read, t_x, t_mi,
                     t_valid, chain_restarts: bool, min_seed_len: int,
                     max_out: int, rows, n_rows: int, lanes: int = None,
                     stack_depth: int = None, with_ticks: bool = False,
                     stats: dict = None, stats_key: str = "seed_ticks"):
    """getSMEMsOnePos for a backlog of N tasks (t_read, t_x, t_mi,
    t_valid [N]) on `lanes` worker lanes (default one a task). With
    chain_restarts a task restarts at next_x until its read ends (pass 1);
    without it runs one position (pass 2). Task i emits into row rows[i]
    of n_rows rows of max_out slots; rows are distinct among tasks (one
    task a row, the JAX machines' contract).

    stack_depth (default the read length L, provably enough) bounds the
    interval stacks; a task that overflows them reports cnt = max_out + 1
    (one lane a task only: a pool runs at full depth). With a k-gram
    table (``fmi.kstep`` K > 1) a FWD tick extends K bases and a backward
    tick takes a side entry (two in the tail at K = 3), as the JAX
    machine's ``use2`` branch. Returns (SmemBuf, each lane's single-base
    occ extensions [lanes], and with with_ticks the JAX machine's (tick,
    done_at [lanes], phase_ticks [5]), else None)."""
    dev = codes.device
    N = t_read.shape[0]
    T = int(lanes) if lanes else N
    B, L = codes.shape
    M = max_out
    pd = fmi.pos_dtype
    count = fmi.count
    ks = fmi.kstep
    use2, tail3 = ks > 1, ks > 2
    i32 = torch.int32
    SD = stack_depth or L
    if SD < L and T != N:
        raise ValueError("a stack depth below the read length runs one "
                         "lane a task")
    out = _RowEmitter(n_rows, M, dev, pd)
    if N == 0 or T == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out.result(), torch.zeros((T,), dtype=i32, device=dev), (
            (z, torch.zeros((T,), dtype=i32, device=dev),
             torch.zeros((5,), dtype=torch.int64, device=dev))
            if with_ticks else None)
    lane = torch.arange(T, device=dev)
    t_read = t_read.long().clamp(0, B - 1)
    t_x = t_x.to(i32)
    t_mi = t_mi.to(pd)
    t_valid = t_valid.to(torch.bool)
    t_rows = rows.long()

    def task(ti):
        """(read, length, min_intv, row, x) of tasks ti (in range)."""
        rd = t_read[ti]
        return (rd, torch.where(t_valid[ti], lens[rd], 0).to(i32), t_mi[ti],
                t_rows[ti], t_x[ti])

    ti0 = lane.clamp(max=N)
    live0 = ti0 < N
    rd, ln, mi, row, x0 = task(ti0.clamp(max=N - 1))
    i32v = lambda v: torch.full((T,), v, dtype=i32, device=dev)
    pos = lambda v: torch.full((T,), v, dtype=pd, device=dev)
    st = dict(
        phase=torch.where(live0, P_INIT, P_DONE).to(i32),
        rd=rd, len=torch.where(live0, ln, 0), mi=mi, row=row, x=x0,
        nx=x0 + 1, j=i32v(0), ck=pos(0), cl=pos(0), cs=pos(0), cn=i32v(0),
        cntA=i32v(0), cntB=i32v(0), mA=i32v(0), p=i32v(0),
        rev=torch.zeros((T,), dtype=torch.bool, device=dev),
        curr_s=pos(-1), steps=i32v(0),
        of=torch.zeros((T,), dtype=torch.bool, device=dev),
        nexti=torch.tensor(min(T, N), dtype=torch.int64, device=dev))
    if with_ticks:
        # the ticks run, each lane's finishing tick (0 for a lane that never
        # had a task) and the lane-ticks a phase
        st.update(tick=torch.zeros((), dtype=torch.int64, device=dev),
                  done_at=torch.where(live0, -1, 0).to(i32),
                  phase_ticks=torch.zeros((5,), dtype=torch.int64,
                                          device=dev))
    # interval stacks [2, T, SD + 1] a field (k, l, s, n): lane t's A stack
    # is buffer wA[t], its B stack the other; column SD takes dropped pushes
    stk = [torch.zeros((2, T, SD + 1), dtype=dt, device=dev)
           for dt in (pd, pd, pd, i32)]
    wA = torch.zeros((T,), dtype=torch.long, device=dev)

    flat = codes.reshape(-1)

    def code(col):
        return flat[st["rd"] * L + col.long().clamp(0, L - 1)]

    def read_a(i):
        ic = i.long().clamp(0, SD - 1)
        return [f[wA, lane, ic] for f in stk]

    def push(buf, entries, cnt):
        """Ordered pushes (do, k, l, s, n) at cnt into stack `buf`."""
        for do, *vals in entries:
            col = torch.where(do, cnt, SD).clamp(0, SD).long()
            for f, v in zip(stk, vals):
                f[buf, lane, col] = v.to(f.dtype)
            cnt = cnt + do.to(i32)
        return cnt

    def body():
        nonlocal wA
        phase = st["phase"]
        is_init = phase == P_INIT
        is_fwd = phase == P_FWD
        is_bs = phase == P_BSCAN
        is_bt = phase == P_BTAIL
        lens_t, mi = st["len"], st["mi"]
        x, j, p = st["x"], st["j"], st["p"]
        cntA0, cntB = st["cntA"], st["cntB"]
        ck, cl, cs, cn = st["ck"], st["cl"], st["cs"], st["cn"]

        xa = code(x)
        a_j = code(j)
        x_ok = (x < lens_t) & (xa < 4)
        xac = xa.clamp(0, 3).long()
        ik = count[xac]
        il = count[3 - xac]
        is_ = count[xac + 1] - ik

        scan_i = torch.where(st["rev"], cntA0 - 1 - p, p)
        pk, pl, ps, pn = read_a(scan_i)
        pm = st["mA"]
        ext_k = torch.where(is_fwd, ck, pk)
        ext_l = torch.where(is_fwd, cl, pl)
        ext_s = torch.where(is_fwd, cs, ps)
        ac = a_j.clamp(0, 3)
        sel1 = torch.where(is_fwd, 3 - ac, ac)
        kk = torch.where(is_fwd, ext_l, ext_k)
        ll = torch.where(is_fwd, ext_k, ext_l)
        if use2:
            # the K-step tick: FWD lanes K bases, backward lanes the round's
            # next entry (two in the tail at K = 3) from the same fetch
            step_cs = [code(j + d) for d in range(1, ks)]
            nxt = lambda d: read_a(torch.where(st["rev"], cntA0 - 1 - d - p,
                                               p + d))
            pk2, pl2, ps2, pn2 = nxt(1)
            sides = []
            if tail3:
                pk3, pl3, ps3, pn3 = nxt(2)
                sides = [(pk3, pl3, ps3, ac)]
            sels = [sel1] + [torch.where(is_fwd, 3 - cd.clamp(0, 3), 0)
                             for cd in step_cs]
            res = backward_ext_steps_and_1(fmi, kk, ll, ext_s, tuple(sels),
                                           pk2, pl2, ps2, ac, sides=sides)
            if tail3:
                nkC, nlC, nsC = res[-1]
                res = res[:-1]
            fsteps, (nkB, nlB, nsB) = res[:-1], res[-1]
            ka, la, ns = fsteps[0]
            fw_steps = [(t[1], t[0], t[2]) for t in fsteps]
        else:
            k4, l4, s4 = backward_ext_all4(fmi, kk, ll, ext_s)
            ka, la, ns = _sel4(k4, sel1), _sel4(l4, sel1), _sel4(s4, sel1)
        nk = torch.where(is_fwd, la, ka)
        nl = torch.where(is_fwd, ka, la)

        # ---- FWD
        j_in = j < lens_t
        a_ok = a_j < 4
        f_run = is_fwd & j_in & a_ok
        if use2:
            prev = (ck, cl, cs, cn)
            ek, el, es, en = prev
            entries, nx, gate, f_steps = [], st["nx"], is_fwd, 0
            for d in range(ks):
                jd = j + d
                cd = a_j if d == 0 else step_cs[d - 1]
                run_d = gate & (jd < lens_t) & (cd < 4)
                sk, sl, ss = fw_steps[d]
                fail_d = run_d & (ss < mi)
                cont_d = run_d & ~fail_d
                entries.append((run_d & (ss != prev[2]),) + prev)
                nx = torch.where(gate & (jd < lens_t), jd + 1, nx)
                nx = torch.where(fail_d, jd, nx)
                ek = torch.where(cont_d, sk, ek)
                el = torch.where(cont_d, sl, el)
                es = torch.where(cont_d, ss, es)
                en = torch.where(cont_d, jd, en)
                prev = (sk, sl, ss, jd)
                gate = cont_d
                f_steps = f_steps + run_d.to(i32)
            f_end = is_fwd & ~cont_d
            entries.append((f_end & (es >= mi), ek, el, es, en))
            cntA = push(wA, entries, cntA0)
            ck2, cl2, cs2, cn2 = ek, el, es, en
            j2 = torch.where(cont_d, j + ks, j)
        else:
            s_fail = f_run & (ns < mi)
            f_cont = f_run & ~s_fail
            f_end = is_fwd & (~j_in | ~a_ok | s_fail)
            cntA = push(wA, [(f_run & (ns != cs), ck, cl, cs, cn),
                             (f_end & (cs >= mi), ck, cl, cs, cn)], cntA0)
            nx = torch.where(is_fwd & j_in, j + 1, st["nx"])
            nx = torch.where(s_fail, j, nx)
            ck2 = torch.where(f_cont, nk, ck)
            cl2 = torch.where(f_cont, nl, cl)
            cs2 = torch.where(f_cont, ns, cs)
            cn2 = torch.where(f_cont, j, cn)
            j2 = torch.where(f_cont, j + 1, j)
            f_steps = f_run.to(i32)
        mA = torch.where(f_end, x, st["mA"])
        phase2 = torch.where(f_end, P_BSCAN, phase)
        j2 = torch.where(f_end, x - 1, j2)
        rev = st["rev"] | f_end
        p2 = torch.where(f_end, 0, p)
        curr_s = torch.where(f_end, -1, st["curr_s"])
        cntB = torch.where(f_end, 0, cntB)

        # ---- BSCAN: the round's prologue, then the scan
        b_dead = is_bs & (p == 0) & ((j < 0) | (a_j >= 4) | (cntA0 == 0))
        long_enough = (pn - pm + 1) >= min_seed_len
        emit0 = b_dead & (cntA0 > 0) & long_enough
        bs_run = is_bs & ~b_dead
        die = bs_run & (ns < mi)
        emit_sc = die & long_enough
        keep_sc = bs_run & ~die & (ns != st["curr_s"])
        hit = emit_sc | keep_sc
        b_steps = bs_run.to(i32) + (is_bt & (p < cntA0)).to(i32)
        if use2:
            nb_ok = (p + 1) < cntA0
            cont_scan = bs_run & ~hit & nb_ok
            die2 = cont_scan & (nsB < mi)
            emit_sc2 = die2 & ((pn2 - pm + 1) >= min_seed_len)
            keep_sc2 = cont_scan & ~die2 & (nsB != st["curr_s"])
            hit2 = emit_sc2 | keep_sc2
            cs_mid_s = torch.where(keep_sc, ns, st["curr_s"])
            keep_tl2s = (bs_run & hit & nb_ok & (nsB >= mi)
                         & (nsB != cs_mid_s))
            e2 = emit_sc2
            out.emit(emit0 | emit_sc | e2, st["row"], pm,
                     torch.where(e2, pn2, pn), torch.where(e2, pk2, pk),
                     torch.where(e2, pl2, pl), torch.where(e2, ps2, ps))
            hit = hit | hit2
            b_steps = b_steps + ((bs_run & nb_ok)
                                 | (is_bt & (p + 1 < cntA0))).to(i32)
            if tail3:
                b_steps = b_steps + (is_bt & (p + 2 < cntA0)).to(i32)
        else:
            out.emit(emit0 | emit_sc, st["row"], pm, pn, pk, pl, ps)
        phase2 = torch.where(hit, P_BTAIL, phase2)

        # ---- BTAIL
        keep_tl = is_bt & (p < cntA0) & (ns >= mi) & (ns != st["curr_s"])
        keep_b = keep_sc | keep_tl
        if use2:
            cs_mid = torch.where(keep_b, ns, curr_s)
            keep_tl2 = (is_bt & (p + 1 < cntA0) & (nsB >= mi)
                        & (nsB != cs_mid))
            keep2 = keep_tl2 | keep_sc2 | keep_tl2s
            entries_b = [(keep_b, nk, nl, ns, pn),
                         (keep2, nkB, nlB, nsB, pn2)]
            curr_s2 = torch.where(keep2, nsB, cs_mid)
            if tail3:
                keep_tl3 = (is_bt & (p + 2 < cntA0) & (nsC >= mi)
                            & (nsC != curr_s2))
                entries_b.append((keep_tl3, nkC, nlC, nsC, pn3))
                curr_s2 = torch.where(keep_tl3, nsC, curr_s2)
            cntB = push(1 - wA, entries_b, cntB)
            curr_s = curr_s2
            badv = torch.where(is_bt, 3 if tail3 else 2,
                               torch.where(bs_run & nb_ok, 2, 1))
        else:
            cntB = push(1 - wA, [(keep_b, nk, nl, ns, pn)], cntB)
            curr_s = torch.where(keep_b, ns, curr_s)
            badv = 1
        st["steps"] = st["steps"] + f_steps + b_steps
        if SD < L:
            # the stack-overflow latch, before the epilogue resets counts
            st["of"] = st["of"] | (cntA > SD) | (cntB > SD)

        p2 = torch.where(bs_run | is_bt, p + badv, p2)
        scan_out = bs_run & ~hit & (p + badv >= cntA0)
        tail_out = ((is_bt | (bs_run & hit)) & (p + badv >= cntA0) if use2
                    else is_bt & (p + 1 >= cntA0))
        round_over = scan_out | tail_out
        # round epilogue: prev <- curr by swapping the buffers' roles
        wA = wA ^ round_over.long()
        cntA = torch.where(round_over, cntB, cntA)
        cntB = torch.where(round_over, 0, cntB)
        mA = torch.where(round_over, j, mA)
        j2 = torch.where(round_over, j - 1, j2)
        rev = rev & ~round_over
        p2 = torch.where(round_over, 0, p2)
        curr_s = torch.where(round_over, -1, curr_s)
        phase2 = torch.where(round_over, P_BSCAN, phase2)

        # ---- position end -> INIT / the task's end
        if chain_restarts:
            x2 = torch.where(b_dead, torch.maximum(st["nx"], x + 1), x)
            fin_pos = b_dead & (x2 >= lens_t)
            phase2 = torch.where(b_dead & ~fin_pos, P_INIT, phase2)
        else:
            x2 = x
            fin_pos = b_dead

        # ---- INIT
        init_bad = is_init & ~x_ok
        if chain_restarts:
            x2 = torch.where(init_bad, x + 1, x2)
            fin_init = init_bad & (x2 >= lens_t)
            phase2 = torch.where(init_bad & ~fin_init, P_INIT, phase2)
        else:
            fin_init = init_bad
        init_go = is_init & x_ok
        st["ck"] = torch.where(init_go, ik, ck2)
        st["cl"] = torch.where(init_go, il, cl2)
        st["cs"] = torch.where(init_go, is_, cs2)
        st["cn"] = torch.where(init_go, x, cn2)
        st["j"] = torch.where(init_go, x + 1, j2)
        st["nx"] = torch.where(is_init, x + 1, nx)
        st["cntA"] = torch.where(init_go, 0, cntA)
        phase2 = torch.where(init_go, P_FWD, phase2)

        # ---- a finished task: the lane pulls the next from the backlog
        fin = fin_pos | fin_init
        if T < N:
            rank = torch.cumsum(fin.to(torch.int64), 0) - 1
            ti2 = st["nexti"] + rank
            has = fin & (ti2 < N)
            n_rd, n_ln, n_mi, n_row, n_x = task(ti2.clamp(0, N - 1))
            st["rd"] = torch.where(has, n_rd, st["rd"])
            st["len"] = torch.where(has, n_ln, lens_t)
            st["mi"] = torch.where(has, n_mi, mi)
            st["row"] = torch.where(has, n_row, st["row"])
            x2 = torch.where(has, n_x, x2)
            phase2 = torch.where(fin, torch.where(has, P_INIT, P_DONE),
                                 phase2)
            st["nexti"] = st["nexti"] + fin.sum()
        else:
            phase2 = torch.where(fin, P_DONE, phase2)
        st["x"] = x2
        if with_ticks:
            live = (phase != P_DONE).any()
            st["done_at"] = torch.where(
                (st["done_at"] < 0) & (phase2 == P_DONE),
                (st["tick"] + 1).to(i32), st["done_at"])
            st["phase_ticks"] = st["phase_ticks"] + torch.bincount(
                phase.long(), minlength=5) * live
            st["tick"] = st["tick"] + live.to(torch.int64)
        st["phase"] = phase2
        st.update(cntB=cntB, mA=mA, p=p2, rev=rev, curr_s=curr_s)

    run_lockstep(body, lambda: st["phase"] != P_DONE, stats, stats_key)
    buf = out.result()
    if SD < L:
        # one lane a task: a lane's flag is its task's row's
        of = torch.zeros((n_rows,), dtype=torch.bool, device=dev)
        of[st["row"]] = st["of"]
        buf = buf._replace(cnt=torch.where(of, max_out + 1, buf.cnt))
    return buf, st["steps"], (
        (st["tick"], st["done_at"], st["phase_ticks"]) if with_ticks
        else None)


def one_pos_machine(fmi: DeviceFMIndex, codes, lens, t_read, t_x, t_mi,
                    t_valid, chain_restarts: bool, min_seed_len: int,
                    max_out: int, stack_depth: int = None,
                    stats: dict = None, stats_key: str = "seed_ticks"
                    ) -> SmemBuf:
    """The one-hot engine's passes 1 and 2: ``lockstep_one_pos`` on one
    lane a task, task t emitting into output row t, its stacks
    stack_depth deep (default L). Keeps each lane's single-base occ
    extensions (the kernel's steps, the same at every K) in
    ``one_pos_machine.last_steps``."""
    N = t_read.shape[0]
    buf, one_pos_machine.last_steps, _ = lockstep_one_pos(
        fmi, codes, lens, t_read, t_x, t_mi, t_valid, chain_restarts,
        min_seed_len, max_out, torch.arange(N, device=codes.device), N,
        stack_depth=stack_depth, stats=stats, stats_key=stats_key)
    return buf


def lockstep_strategy(fmi: DeviceFMIndex, codes, lens, max_intv: int,
                      min_seed_len: int, max_out: int, lanes: int = None,
                      with_ticks: bool = False, stats: dict = None,
                      stats_key: str = "seed_ticks_p3"):
    """Pass 3 (bwtSeedStrategyAllPosOneThread,
    src/FMI_search.cpp:1662-1730) on `lanes` worker lanes (default one a
    read), a lane pulling the next read as it finishes one; two bases a
    tick with a k-gram table (the JAX machine's ``use2`` branch). Read b
    emits into row b. Returns (SmemBuf, each lane's single-base occ
    extensions [lanes], the ticks run or None)."""
    dev = codes.device
    B, L = codes.shape
    T = int(lanes) if lanes else B
    count = fmi.count
    pd = fmi.pos_dtype
    use2 = fmi.kstep > 1
    i32 = torch.int32
    out = _RowEmitter(B, max_out, dev, pd)
    if B == 0 or T == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out.result(), torch.zeros((T,), dtype=i32, device=dev), (
            z if with_ticks else None)
    lane = torch.arange(T, device=dev)
    rd0 = lane.clamp(max=B)
    live0 = rd0 < B
    rd0 = rd0.clamp(max=B - 1)
    i32v = lambda v: torch.full((T,), v, dtype=i32, device=dev)
    pos = lambda v: torch.full((T,), v, dtype=pd, device=dev)
    st = dict(phase=torch.where(live0, P_INIT, P_DONE).to(i32), rd=rd0,
              len=torch.where(live0, lens[rd0], 0).to(i32), x=i32v(0),
              j=i32v(0), ck=pos(0), cl=pos(0), cs=pos(0), steps=i32v(0),
              nextr=torch.tensor(min(T, B), dtype=torch.int64, device=dev),
              tick=torch.zeros((), dtype=torch.int64, device=dev))

    flat = codes.reshape(-1)

    def code(col):
        return flat[st["rd"] * L + col.long().clamp(0, L - 1)]

    def body():
        phase, x, j, lens_t = st["phase"], st["x"], st["j"], st["len"]
        is_init = phase == P_INIT
        is_fwd = phase == P_FWD
        xa = code(x)
        a_j = code(j)
        x_ok = (x < lens_t) & (xa < 4)
        xac = xa.clamp(0, 3).long()
        ac = a_j.clamp(0, 3)
        j_in = j < lens_t
        a_ok = a_j < 4
        msl_at = lambda col: (col - x + 1) >= min_seed_len
        if use2:
            b_j = code(j + 1)
            (nk, nl, ns), (nk2, nl2, ns2) = forward_ext2(
                fmi, st["ck"], st["cl"], st["cs"], ac, b_j.clamp(0, 3))
            r1 = is_fwd & j_in & a_ok
            hit1 = r1 & (ns < max_intv) & msl_at(j)
            cont1 = r1 & ~hit1
            j2_in = (j + 1) < lens_t
            r2 = cont1 & j2_in & (b_j < 4)
            hit2 = r2 & (ns2 < max_intv) & msl_at(j + 1)
            cont2 = r2 & ~hit2
            st["steps"] = st["steps"] + r1.to(i32) + r2.to(i32)
            out.emit((hit1 & (ns > 0)) | (hit2 & (ns2 > 0)), st["rd"], x,
                     torch.where(hit1, j, j + 1), torch.where(hit1, nk, nk2),
                     torch.where(hit1, nl, nl2), torch.where(hit1, ns, ns2))
            f_end = is_fwd & ~cont2
            ck = torch.where(cont2, nk2, st["ck"])
            cl = torch.where(cont2, nl2, st["cl"])
            cs = torch.where(cont2, ns2, st["cs"])
            j2 = torch.where(cont2, j + 2, j)
            nx = torch.where(cont1, torch.where(j2_in, j + 2, j + 1),
                             torch.where(j_in, j + 1, j))
        else:
            k4, l4, s4 = backward_ext_all4(fmi, st["cl"], st["ck"],
                                           st["cs"])
            sel = 3 - ac
            nk, nl, ns = _sel4(l4, sel), _sel4(k4, sel), _sel4(s4, sel)
            f_run = is_fwd & j_in & a_ok
            st["steps"] = st["steps"] + f_run.to(i32)
            hit = f_run & (ns < max_intv) & msl_at(j)
            out.emit(hit & (ns > 0), st["rd"], x, j, nk, nl, ns)
            f_end = is_fwd & (~j_in | ~a_ok | hit)
            f_cont = f_run & ~hit
            ck = torch.where(f_cont, nk, st["ck"])
            cl = torch.where(f_cont, nl, st["cl"])
            cs = torch.where(f_cont, ns, st["cs"])
            j2 = torch.where(f_cont, j + 1, j)
            nx = torch.where(j_in, j + 1, j)
        nx = torch.where(is_init, x + 1, nx)
        x2 = torch.where(f_end, nx, x)
        fin_f = f_end & (x2 >= lens_t)
        phase2 = torch.where(f_end & ~fin_f, P_INIT, phase)
        init_bad = is_init & ~x_ok
        xb = torch.where(init_bad, x + 1, x2)
        fin_i = init_bad & (xb >= lens_t)
        phase2 = torch.where(init_bad & ~fin_i, P_INIT, phase2)
        init_go = is_init & x_ok
        c_x = count[xac]
        st["ck"] = torch.where(init_go, c_x, ck)
        st["cl"] = torch.where(init_go, count[3 - xac], cl)
        st["cs"] = torch.where(init_go, count[xac + 1] - c_x, cs)
        st["j"] = torch.where(init_go, x + 1, j2)
        phase2 = torch.where(init_go, P_FWD, phase2)
        # a finished read: the lane pulls the next one
        fin = fin_f | fin_i
        if T < B:
            rank = torch.cumsum(fin.to(torch.int64), 0) - 1
            r2 = st["nextr"] + rank
            has = fin & (r2 < B)
            safe = r2.clamp(0, B - 1)
            st["rd"] = torch.where(has, safe, st["rd"])
            st["len"] = torch.where(has, lens[safe].to(i32), lens_t)
            xb = torch.where(has, 0, xb)
            phase2 = torch.where(fin, torch.where(has, P_INIT, P_DONE),
                                 phase2)
            st["nextr"] = st["nextr"] + fin.sum()
        else:
            phase2 = torch.where(fin, P_DONE, phase2)
        st["x"], st["phase"] = xb, phase2
        if with_ticks:
            st["tick"] = st["tick"] + (phase != P_DONE).any().to(
                torch.int64)

    run_lockstep(body, lambda: st["phase"] != P_DONE, stats, stats_key)
    return out.result(), st["steps"], st["tick"] if with_ticks else None


def seed_strategy_machine(fmi: DeviceFMIndex, codes, lens, max_intv: int,
                          min_seed_len: int, max_out: int,
                          stats: dict = None) -> SmemBuf:
    """The one-hot engine's pass 3: ``lockstep_strategy`` on one lane a
    read. Keeps each lane's single-base occ extensions in
    ``seed_strategy_machine.last_steps``."""
    buf, seed_strategy_machine.last_steps, _ = lockstep_strategy(
        fmi, codes, lens, max_intv, min_seed_len, max_out, stats=stats)
    return buf


def collect_smems_oh(fmi: DeviceFMIndex, codes, lens, *,
                     min_seed_len: int, split_len: int,
                     split_width: int, max_mem_intv: int,
                     max_out: int = None, emit_depth: int = None,
                     stack_depth: int = None, reseed_factor: int = 2,
                     stats: dict = None) -> SmemBuf:
    """Three-pass SMEM collection (mem_collect_smem,
    src/bwamem.cpp:648-795): all SMEMs, the reseed of long
    low-occurrence SMEMs from their midpoints, and the seed strategy;
    then a stable per-read sort on (m << 16) | n.

    codes [B, L] int32, lens [B] int32, both on fmi's device. On CUDA
    tensors five launches (four with max_mem_intv 0) and no tensor
    operation between them but their outputs' allocations: pass 1, the
    task list (``reseed_tasks_cuda``), pass 2, pass 3, the merge
    (``merge_smems_cuda``); the walks' steps and rounds go into `stats`
    after the last. On CPU tensors the plain versions."""
    dev = codes.device
    B, L = codes.shape
    M = max_out or L
    Me = min(emit_depth, M) if emit_depth else M
    T = reseed_factor * B
    bidx = torch.arange(B, dtype=torch.int32, device=dev)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    # on the card the walks' counts are reduced after the last launch
    st = (stats if stats is None or dev.type == "cpu"
          else DeferredStats())
    p1 = one_pos_machine_cuda(fmi, codes, lens, bidx, zi, zi + 1, lens > 0,
                              True, min_seed_len, Me, stack_depth, st,
                              "seed_ticks_p1")
    t_read, t_x, t_mi, t_valid, reseed_of, first, count = reseed_tasks_cuda(
        p1, T, split_len, split_width)
    p2t = one_pos_machine_cuda(fmi, codes, lens, t_read, t_x, t_mi,
                               t_valid, False, min_seed_len, Me,
                               stack_depth, st, "seed_ticks_p2")
    p3 = None
    if max_mem_intv > 0:
        p3 = seed_strategy_machine_cuda(fmi, codes, lens, max_mem_intv,
                                        min_seed_len + 1, Me, st)
    out = merge_smems_cuda(p1, p2t, p3, t_read, t_valid, first, count,
                           reseed_of, True)
    if st is not stats:
        st.fold(stats)
    return out
