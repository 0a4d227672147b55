"""The sweep engine's kernels through the hand-written CUDA of
csrc/sweep.cu.

Two wrappers, each with the signature of its plain version in
``ops/smem.py`` and each replacing code of the JAX package's
``ops/smem.py``:
- ``sweep_pass_cuda``: pass 1 or pass 2 of the sweep in one launch of
  sweep_extend_kernel's pass form: the forward extension from every
  (read, start column) lane (pass 2: every reseed task's lanes, the
  task list read in the launch), each lane started from the FMA ladder
  table in at most two dependent trips, then the left-maximal mask and
  each read's SMEM slots ranked and written in the launch (plain
  ``sweep_pass_plain``: ``extend_all_positions``, ``_left_max_mask`` and
  ``_emit_compact``; JAX ``extend_all_positions`` with
  ``ops/fma.py::fast_forward`` and the emission of
  ``collect_smems_device`` / ``smems_reseed``). Pass 2 takes its tasks
  in ``smem.reseed_tasks``' order (the valid ones first, sorted by
  read), which the kernel assumes and does not check;
- ``seed_strategy_merged_cuda``: pass 3's merged stage, the column glue
  and the restart chain in one launch (plain
  ``seed_strategy_merged_plain``; JAX ``smems_seed_strategy_merged``),
  one warp a read, no torch operation but the outputs' allocations.
On CUDA tensors each launches its kernel once or raises; on CPU tensors
each runs its plain version. There is no fallback from a kernel to its
plain version. Each kernel has an int32 and an int64 form, picked by the
position dtype (``fmi.pos_dtype``), as in ``ops/smem_cuda.py``, whose
index arguments and output layout these wrappers share. Each keeps a
``launches`` count (all forms), a ``launches64`` count (the int64 form)
and, with a k-gram checkpoint table on the index (``fmi.kstep`` > 1,
int32 layout), the sweep's k-step forms (two bases a row fetch, after
the FMA start) in ``launches_k``. With ``stats`` the pass launch adds
its longest lane's steps, the total and the longest lane's row fetches
to device counters itself (pass 1: ``sweep_steps_p1``,
``sweep_total_p1``, ``sweep_rounds_p1`` over every lane; pass 2:
``sweep_walked_steps_p2``, ``sweep_walked_total_p2``,
``sweep_walked_rounds_p2`` over the lanes it walks, each task's columns
up to its t_x), as the merged stage's kernel adds ``chase_steps`` and
``chase_total`` (0-d int64 tensors); no torch operation runs for them.
Each lane's steps are written only where asked (``keep_steps`` on the
pass wrapper, ``last_steps`` / ``last_rounds``); the merged stage keeps
each read's chase steps.

``sweep_extend_twin`` and ``seed_strategy_merged_twin`` are the kernels'
loops in plain Python on numpy arrays, tests of the kernels' control flow
on the CPU at small sizes; each counts what its kernel counts, the sweep
twin also each lane's dependent trips before its first step and the
distinct checkpoint rows and ladder sectors a launch reads (its bytes
bound). The source is compiled with nvcc into
``build/torch_kernels/libsweep_cuda.so`` at first use
(``ops/nvcc_build.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem_cuda import (_FMI, _SUFFIX, _TwinFmi, _TwinK, _check,
                        _codes_int32, _count, _fmi_args, _form, _smem_out)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PASS = [_vp] * 6 + [_ci] * 8 + [_vp] * 3 + [_ci] * 2 + [_vp] * 11
_MERGED = [_vp] * 10 + [_ci] * 5 + [_vp] * 6
_KSTEP = [_vp, _ci, _vp]
LIB = nvcc_build.Library("sweep.cu", "sweep_cuda", {
    **{f"sweep_pass_launch{_SUFFIX[pd]}": _FMI[pd] + _PASS for pd in _FMI},
    "sweep_pass_launch_k": _FMI[torch.int32] + _KSTEP + _PASS,
    **{f"seed_strategy_merged_launch{_SUFFIX[pd]}": _MERGED
       for pd in _FMI}})
build = LIB.build            # compile csrc/sweep.cu; returns the library path


def _kstep_args(fmi: DeviceFMIndex) -> list:
    """The k-step form's table arguments, after _fmi_args (_KSTEP): the
    k-gram rows, their width in int4s and the C2 table."""
    t = fmi.cp_kstep
    return [t.data_ptr(), t.shape[1] // 4, fmi.count2.data_ptr()]


def _add_stats(stats, key: str, steps: torch.Tensor,
               rounds: torch.Tensor = None) -> None:
    """The longest lane's steps under key ("ticks" read as "steps"), the
    total under key ("ticks" read as "total") and, with `rounds`, the
    longest lane's row fetches ("ticks" read as "rounds")."""
    if stats is None:
        return
    vals = [("steps", steps.max()), ("total", steps.sum())]
    if rounds is not None:
        vals.append(("rounds", rounds.max()))
    for what, v in vals:
        k = key.replace("ticks", what)
        stats[k] = stats.get(k, 0) + v


# the pass-1 records that pass 3's merged stage reads, as the launch
# writes them: int32 (E, f3_E), position (f3_k, f3_l, f3_ss), bool (f3_s,
# died_s) planes
_REC_PLANES = (("E", "f3_E"), ("f3_k", "f3_l", "f3_ss"), ("f3_s", "died_s"))


def sweep_pass_cuda(fmi: DeviceFMIndex, codes, lens, min_seed_len: int,
                    max_out: int, fma=None, tasks=None, p3_max_intv: int = 0,
                    p3_stop: int = 0, n_pos: int = 0, stats: dict = None,
                    stats_key: str = "sweep_ticks_p1"):
    """``smem.sweep_pass_plain``'s function (an equal SmemBuf and equal
    records): one launch of sweep_extend_kernel's pass form on CUDA
    tensors, the plain version on CPU ones. Pass 1 (`tasks` None): every
    read's left-maximal matches of at least min_seed_len bases, merged
    with pass 3 where p3_max_intv and p3_stop > 0 (then also the records
    pass 3's stage reads); pass 2: `tasks` = (t_read, t_x, t_mi, t_valid)
    as ``smem.reseed_tasks`` orders them, the valid tasks first and sorted
    by read: the kernel finds each read's tasks by a search that assumes
    this order and does not check it (another order gives wrong slots);
    the matches covering each task's column. Returns (SmemBuf [B,
    max_out], the records: a dict of [B, P] tensors, empty but for merged
    pass 1). codes [B, L] and lens [B] int32, `fma` a DeviceFmaTable at
    fmi's position dtype, or None. With `stats` the kernel adds its
    longest and total steps and its longest row fetches to three device
    counters (`stats_key` with "ticks" read as "steps", "total" and
    "rounds"; pass 2 as "walked_steps", "walked_total" and
    "walked_rounds": the lanes up to each task's column, which the kernel
    walks, while the plain version's lockstep runs every lane); no other
    torch operation runs for them. With ``keep_steps`` set on the wrapper
    the launch also writes each lane's steps (and row fetches) into
    ``last_steps`` (``last_rounds``)."""
    from .smem import SmemBuf, sweep_pass_plain, sweep_window
    if codes.device.type == "cpu":
        return sweep_pass_plain(fmi, codes, lens, min_seed_len, max_out,
                                fma, tasks, p3_max_intv, p3_stop, n_pos,
                                stats, stats_key)
    what = "sweep_pass_cuda"
    if tasks is not None:            # pass 2 keeps no pass-3 records
        p3_max_intv = p3_stop = 0
    merge, K_eff = sweep_window(fma, 0, p3_max_intv, p3_stop)
    lad = ()
    if K_eff:
        lad = (fma.ladder_k, fma.ladder_l, fma.ladder_s)
        if any(t.dtype != fmi.pos_dtype or not t.is_contiguous()
               or t.data_ptr() % 16 for t in lad):
            raise ValueError(f"{what}: the FMA ladders must be contiguous, "
                             f"16-byte aligned and of the index's position "
                             f"dtype")
    dev = _check(what, fmi, codes, lens, *lad, *(tasks or ()))
    _codes_int32(what, codes, lens)
    B, L = codes.shape
    P = n_pos or L
    if lens.shape != (B,) or not 0 < P <= L:
        raise ValueError(f"{what}: read counts differ or n_pos {P} is "
                         f"outside [1, {L}]")
    i32, pd = torch.int32, fmi.pos_dtype
    task_ptrs, T = [None] * 4, 0
    if tasks is not None:
        t_read, t_x, t_mi, t_valid = tasks
        T = t_read.shape[0]
        if any(t.shape != (T,) for t in tasks) or t_valid.dtype != torch.bool:
            raise ValueError(f"{what}: the task arrays differ in shape, or "
                             f"t_valid is not bool")
        # reseed_tasks' dtypes: no conversion on the main path
        tl = [t_read.to(torch.int64).contiguous(), t_x.to(i32).contiguous(),
              t_mi.to(pd).contiguous(),
              t_valid.contiguous().view(torch.uint8)]
        task_ptrs = [t.data_ptr() for t in tl]
    out, fields = _smem_out(B, max_out, pd, dev)
    cnt = torch.empty((B,), dtype=i32, device=dev)
    recs = [None] * 3
    if merge:
        recs = [torch.empty((len(n), B, P), dtype=dt, device=dev)
                for n, dt in zip(_REC_PLANES, (i32, pd, torch.uint8))]
    kstep = fmi.kstep > 1
    steps = rounds = None
    if _PASS_FN.keep_steps:
        rows = T if tasks is not None else B
        steps = torch.zeros((rows, P), dtype=i32, device=dev)
        rounds = (torch.zeros((rows, P), dtype=i32, device=dev) if kstep
                  else steps)
    acc = [None] * 4
    if stats is not None and B:
        words = ("steps", "total", "rounds")
        if tasks is not None:
            words = tuple(f"walked_{w}" for w in words)
        acc = [_counter(stats, stats_key.replace("ticks", w), dev).data_ptr()
               for w in words]
        acc.append(_run_words(dev, 4).data_ptr())
    if B:
        form = (["sweep_pass_launch_k", *_fmi_args(fmi),
                 *_kstep_args(fmi)] if kstep else
                [_form("sweep_pass_launch", fmi), *_fmi_args(fmi)])
        ptrs = [t.data_ptr() for t in lad] or [None] * 3
        ptr = lambda t: None if t is None else t.data_ptr()
        c, ln = codes.contiguous(), lens.contiguous()
        LIB.launch(dev, *form, c.data_ptr(), ln.data_ptr(), *task_ptrs, T,
                   B, L, P, min_seed_len, max_out, p3_max_intv, p3_stop,
                   *ptrs, fma.K if K_eff else 0, K_eff, out.data_ptr(),
                   cnt.data_ptr(),
                   *(ptr(r) for r in recs), ptr(steps),
                   ptr(rounds) if kstep else None, *acc)
        _count(_PASS_FN, fmi, kstep)
    _PASS_FN.last_steps, _PASS_FN.last_rounds = steps, rounds
    ext = {}
    if merge:
        for names, r in zip(_REC_PLANES, recs):
            ext.update(zip(names, r.view(torch.bool) if r.dtype ==
                           torch.uint8 else r))
    return SmemBuf(*fields, cnt), ext


def walked_steps(steps: torch.Tensor, tasks=None) -> torch.Tensor:
    """The plain version's per-lane steps [rows, P] as the pass launch
    walks its lanes: pass 2 (`tasks`) leaves each lane past its task's
    column unwalked (steps 0); pass 1 walks every lane."""
    if tasks is None:
        return steps
    pcol = torch.arange(steps.shape[1], device=steps.device)[None, :]
    return torch.where(pcol <= tasks[1].to(steps.device)[:, None], steps, 0)


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, the int64 form's and the k-step form's; with keep_steps (off on
# the main path) each lane's steps and row fetches of the last call
sweep_pass_cuda.launches = 0
sweep_pass_cuda.launches64 = 0
sweep_pass_cuda.launches_k = 0
sweep_pass_cuda.keep_steps = False
sweep_pass_cuda.last_steps = None       # [B | T, P] int32, or None
sweep_pass_cuda.last_rounds = None
_PASS_FN = sweep_pass_cuda


# each kernel's running maxima and ticket on each (device, stream): the
# merged stage's two words, the sweep's four; zeroed when first made, left
# zero by every launch
_RUN: dict = {}
_RUN_LOCK = threading.Lock()


def _run_words(dev: torch.device, n: int = 2) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, n)
    with _RUN_LOCK:
        if key not in _RUN:
            _RUN[key] = torch.zeros((n,), dtype=torch.int64, device=dev)
        return _RUN[key]


def _counter(stats: dict, key: str, dev: torch.device) -> torch.Tensor:
    """stats[key] as the 0-d int64 counter on dev that the kernel adds to:
    made the first time (with any earlier value in it)."""
    v = stats.get(key)
    if not (isinstance(v, torch.Tensor) and v.device == dev
            and v.dtype == torch.int64 and v.dim() == 0):
        c = torch.zeros((), dtype=torch.int64, device=dev)
        if v is not None:
            c += v
        v = stats[key] = c
    return v


def seed_strategy_merged_cuda(fmi, codes, lens, ext, max_intv: int,
                              stop_min_len: int, max_out: int,
                              n_pos: int = 0, stats: dict = None):
    """Drop-in for ``smem.smems_seed_strategy_merged`` (an equal SmemBuf):
    one launch of seed_strategy_merged_kernel on CUDA tensors, the plain
    version (``smem.seed_strategy_merged_plain``) on CPU ones. `fmi`
    gives the C array (``count``, [5] at the records' position dtype);
    codes [B, L] and lens [B] int32; `ext` the pass-1 sweep's merged
    records over the first P = n_pos or L columns (died_s, f3_s bool;
    f3_E, E int32; f3_k, f3_l, f3_ss of the position dtype), each
    contiguous. No torch operation runs but the outputs'
    allocations (and, the first time a `stats` dict is given, its two
    counters)."""
    from .smem import SmemBuf, seed_strategy_merged_plain
    if codes.device.type == "cpu":
        return seed_strategy_merged_plain(fmi, codes, lens, ext, max_intv,
                                          stop_min_len, max_out, n_pos,
                                          stats)
    what = "seed_strategy_merged_cuda"
    dev = codes.device
    pd = fmi.count.dtype
    B, L = codes.shape
    P = n_pos or L
    recs = [ext[f] for f in ("died_s", "f3_s", "f3_E", "E", "f3_k", "f3_l",
                             "f3_ss")]
    ts = (fmi.count, codes, lens, *recs)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what}: tensors on {dev} and elsewhere")
    want = (torch.bool, torch.bool, torch.int32, torch.int32, pd, pd, pd)
    if (pd not in _SUFFIX or fmi.count.shape != (5,)
            or codes.dtype != torch.int32 or lens.dtype != torch.int32
            or lens.shape != (B,) or not 0 < P <= L
            or any(t.dtype != d or t.shape != (B, P)
                   for t, d in zip(recs, want))
            or not all(t.is_contiguous() for t in ts)):
        raise ValueError(f"{what}: shapes, dtypes or layouts differ from "
                         f"the plain version's")
    out, fields = _smem_out(B, max_out, pd, dev)
    cs = torch.empty((2, B), dtype=torch.int32, device=dev)
    cnt, steps = cs.unbind(0)
    if B:
        acc = [None] * 3
        if stats is not None:
            acc = [_counter(stats, "chase_steps", dev).data_ptr(),
                   _counter(stats, "chase_total", dev).data_ptr(),
                   _run_words(dev).data_ptr()]
        LIB.launch(dev, f"seed_strategy_merged_launch{_SUFFIX[pd]}",
                   *(t.data_ptr() for t in ts), B, L, P, stop_min_len,
                   max_out, out.data_ptr(), cnt.data_ptr(),
                   steps.data_ptr(), *acc)
        _MERGED_FN.launches += 1
        _MERGED_FN.launches64 += pd == torch.int64
    _MERGED_FN.last_steps = steps
    return SmemBuf(*fields, cnt)


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, and the int64 form's; each read's chase steps of the last call
seed_strategy_merged_cuda.launches = 0
seed_strategy_merged_cuda.launches64 = 0
seed_strategy_merged_cuda.last_steps = None      # [B] int32
_MERGED_FN = seed_strategy_merged_cuda


# the twin's per-lane planes, int32, position and bool
_I_PLANES = ("E", "f3_E", "steps", "rounds")
_P_PLANES = ("k", "l", "s", "fail_k", "fail_l", "fail_ss", "f3_k", "f3_l",
             "f3_ss")
_B_PLANES = ("fail_s", "f3_s", "died_s", "valid")


def sweep_extend_twin(count, cp_fused, sentinel_index: int, codes, lens,
                      min_intv, check_initial: bool, stop_min_len: int = 0,
                      p3_max_intv: int = 0, p3_stop: int = 0, n_pos: int = 0,
                      ladders=None, K_eff: int = 0, hi_steps=None,
                      kstep=None, emit=None, tasks=None) -> dict:
    """csrc/sweep.cu's sweep_extend_kernel in plain Python on numpy
    arrays, one lane after another: the FMA start from the lane's ladder
    row (`ladders` = (k, l, s) [4^K, K] with K_eff >= 2, else none): the
    row's first `cap` sizes in one trip (with check_initial), then k and l
    at j* - 1 in a second; then one forward step a column (two a row
    fetch with `kstep`, ``smem_cuda.kstep_tables``' k-gram table) until an
    N, the read's end or a size failure. With `hi_steps`
    (``smem_cuda.twin_tables``) the int64 form. Returns every output plane
    of the plain ``extend_all_positions`` by name over the lanes' rows
    (the kernel writes only those its passes read; `check_initial` False
    and `stop_min_len`, which its passes do not take, follow the plain
    version), steps and rounds (row fetches) included, ``start_trips`` (each lane's dependent ladder
    trips before its first FM step), ``rows`` (the distinct 32-byte
    checkpoint rows, k-step groups, the steps read) and
    ``ladder_sectors`` (the distinct 32-byte ladder sectors the starts
    read). With `emit` = (min_seed_len, max_out) the pass forms'
    emission too, under ``smem``: (m, n, k, l, s, cnt) of each read, the
    left-maximal matches ranked in lane order into the read's slots.
    With `tasks` = (t_read, t_x, t_mi, t_valid) pass 2: a row of lanes a
    task over its read (none for an invalid task, and none past t_x: the
    kernel does not walk them; `min_intv` unused), the matches covering
    t_x, a read's tasks in task order."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    kt = None if kstep is None else _TwinK(fm, *kstep)
    C = fm.count
    codes = np.asarray(codes)
    B, L = codes.shape
    P = n_pos or L
    merge = p3_max_intv > 0 and p3_stop > 0
    pd = np.int32 if hi_steps is None else np.int64
    if tasks is None:
        lane_rows = [(b, int(lens[b]), int(min_intv[b])) for b in range(B)]
    else:
        t_read, t_x, t_mi, t_valid = (np.asarray(a) for a in tasks)
        lane_rows = [(int(t_read[t]), int(lens[t_read[t]]) if t_valid[t]
                      else 0, int(t_mi[t])) for t in range(len(t_read))]
    R = len(lane_rows)
    out = {f: np.zeros((R, P), np.int32) for f in _I_PLANES}
    out.update({f: np.zeros((R, P), pd) for f in _P_PLANES})
    out.update({f: np.zeros((R, P), bool) for f in _B_PLANES})
    out["start_trips"] = np.zeros((R, P), np.int32)
    clip = lambda c: min(max(c, 0), 3)
    sectors = set()
    if K_eff:
        lk, ll, ls = (np.asarray(a) for a in ladders)
        K = lk.shape[1]
        pb = lk.dtype.itemsize
    for r, (b, n_len, mi) in enumerate(lane_rows):

        def code(i):
            return min(int(codes[b, i]), 4) if i < L else 4

        for p in range(P):
            if tasks is not None and p > int(t_x[r]):
                continue                 # past the task's column: not walked
            c0 = code(p)
            base_ok = p < n_len and c0 < 4
            k = l = s = 0
            died = fs = f3s = False
            fk = fl = fss = f3k = f3l = f3ss = f3E = steps = trips = 0
            if K_eff:                            # the K-mer's ladder row
                cap, lead, km = 0, True, 0
                for i in range(K):
                    c = code(p + i)
                    if i < K_eff:
                        lead = lead and 0 <= c < 4 and p + i < n_len
                        cap += lead
                    km = 4 * km + clip(c)
                row = km * K
                jstar = cap
                if check_initial:
                    # trip 1: the row's first cap sizes, all at once
                    sv = [int(ls[km, i]) for i in range(cap)]
                    sectors.update((2, (row + i) * pb // 32)
                                   for i in range(cap))
                    trips += cap > 0
                    jstar = 0
                    while jstar < cap and sv[jstar] >= mi:
                        jstar += 1
                if jstar:                        # trip 2: k and l at j* - 1
                    k, l, s = (int(a[km, jstar - 1]) for a in (lk, ll, ls))
                    at = (row + jstar - 1) * pb // 32
                    sectors.update((0, at), (1, at))
                    if not check_initial:
                        sectors.add((2, at))
                    trips += 1
                E = p + jstar
                act = jstar == K_eff and p + K_eff < n_len
                died = merge and jstar < cap
                off = K_eff - 1
            else:                                # the 1-bp interval
                a0 = clip(c0)
                k, l, s = C[a0], C[3 - a0], C[a0 + 1] - C[a0]
                act = base_ok and (not check_initial or s >= mi)
                if not act:
                    k = l = s = 0
                E = p + 1 if act else p
                off = 0
            t, rounds = 1, 0
            while act:                   # one row fetch: one or two steps
                j = p + off + t
                a = code(j)
                if j >= n_len or a >= 4:
                    break
                rounds += 1
                if kt is None:
                    res = [fm.ext(l, k, s, 3 - clip(a))]
                else:
                    res = kt.ext_k(l, k, s, [3 - a, 3 - clip(code(j + 1))])
                for d, (nl, nk, ns) in enumerate(res):
                    if d and (j + 1 >= n_len or code(j + 1) >= 4):
                        act = False              # the walk ends mid-stride
                        break
                    steps += 1
                    if (merge and not f3s and ns < p3_max_intv
                            and off + t + 1 >= p3_stop):
                        f3s, f3E, f3k, f3l, f3ss = True, j + d, nk, nl, ns
                    if ns < mi and (stop_min_len <= 0
                                    or j + d - p + 1 >= stop_min_len):
                        fs, fk, fl, fss = True, nk, nl, ns
                        died = died or merge
                        act = False
                        break
                    E, k, l, s = j + d + 1, nk, nl, ns
                    t += 1
            for f, v in (("E", E), ("f3_E", f3E), ("steps", steps),
                         ("rounds", rounds), ("start_trips", trips),
                         ("k", k), ("l", l), ("s", s), ("fail_k", fk),
                         ("fail_l", fl), ("fail_ss", fss), ("f3_k", f3k),
                         ("f3_l", f3l), ("f3_ss", f3ss), ("fail_s", fs),
                         ("f3_s", f3s), ("died_s", died),
                         ("valid", base_ok)):
                out[f][r, p] = v
    out["rows"] = len(fm.seen)
    out["ladder_sectors"] = len(sectors)
    if emit is not None:
        out["smem"] = _twin_emit(out, lane_rows, B, P, *emit,
                                 None if tasks is None else tasks[1], pd)
    return out


def _twin_emit(out, lane_rows, B: int, P: int, min_seed_len: int, M: int,
               t_x, pd):
    """The pass forms' emission of sweep_extend_twin: each read's lanes in
    the kernel's order (its rows, then columns), a lane emitting where p
    = 0 or the lane before it has a smaller E, E - p >= min_seed_len and
    (pass 2) p <= t_x < E; slot r of the read is its r-th emission, those
    past M dropped while cnt counts them. Returns (m, n, k, l, s, cnt)."""
    sm = [np.zeros((B, M), np.int32), np.zeros((B, M), np.int32),
          *(np.zeros((B, M), pd) for _ in range(3))]
    cnt = np.zeros(B, np.int32)
    E = out["E"]
    for r, (b, n_len, _) in enumerate(lane_rows):
        if t_x is not None and not n_len:
            continue                             # an invalid task
        for p in range(P):
            e = int(E[r, p])
            em = (p == 0 or E[r, p - 1] < e) and e - p >= min_seed_len
            if t_x is not None:
                em = em and p <= t_x[r] < e
            if em:
                if cnt[b] < M:
                    for a, v in zip(sm, (p, e - 1, out["k"][r, p],
                                         out["l"][r, p], out["s"][r, p])):
                        a[b, cnt[b]] = v
                cnt[b] += 1
    return (*sm, cnt)


def seed_strategy_merged_twin(count, codes, lens, ext, stop_min_len: int,
                              max_out: int, n_pos: int = 0):
    """csrc/sweep.cu's seed_strategy_merged_kernel in plain Python on
    numpy arrays, one read (warp) after another: the invalid and
    zero-count column masks a word each 32 columns, the chase from column
    0 evaluating the glue only at the columns it visits (first_invalid for
    a zombie), the emitted columns, then the M slots. `ext` the merged
    records as numpy arrays [B, P]. Returns (m, n, k, l, s, cnt, steps),
    k, l and s of the records' dtype."""
    count = np.asarray(count)
    codes = np.asarray(codes)
    B, L = codes.shape
    P = n_pos or L
    M = max_out
    W = (L + 31) // 32
    pd = np.asarray(ext["f3_k"]).dtype
    empty = [count[a + 1] == count[a] for a in range(4)]
    out = np.zeros((5, B, M), np.int64)
    cnt_out = np.zeros(B, np.int32)
    steps_out = np.zeros(B, np.int32)
    for b in range(B):
        n_len = int(lens[b])
        inv, zero = [0] * W, [0] * W
        for col in range(32 * W):
            c = int(codes[b, col]) if col < L else 4
            bad = c >= 4 or col >= n_len
            if bad:
                inv[col >> 5] |= 1 << (col & 31)
            elif empty[min(max(c, 0), 3)]:
                zero[col >> 5] |= 1 << (col & 31)

        def first_invalid(p):
            i = p >> 5
            m = inv[i] & (~0 << (p & 31)) & 0xFFFFFFFF
            while m == 0 and i + 1 < W:
                i += 1
                m = inv[i]
            return min(L, 32 * i + (m & -m).bit_length() - 1) if m else L

        pos = cnt = steps = 0
        em = []
        while pos < n_len and pos < P:
            steps += 1
            base_ok = not (inv[pos >> 5] >> (pos & 31)) & 1
            f3 = bool(ext["f3_s"][b, pos])
            died = (bool(ext["died_s"][b, pos])
                    or bool((zero[pos >> 5] >> (pos & 31)) & 1))
            zombie = base_ok and died and not f3
            zfail = False
            E3 = int(ext["E"][b, pos])
            if f3:
                E3 = int(ext["f3_E"][b, pos])
            elif zombie:
                limit = first_invalid(pos) - pos
                zfail = stop_min_len <= limit
                E3 = pos + (stop_min_len - 1 if zfail else limit)
            if base_ok and f3 and ext["f3_ss"][b, pos] > 0:
                if cnt < M:
                    em.append(pos)
                cnt += 1
            fail3 = f3 or zfail
            hit_n = base_ok and not fail3 and E3 < n_len
            nxt = ((E3 + 1 if fail3 or hit_n else n_len) if base_ok
                   else pos + 1)
            pos = max(nxt, pos + 1)
        for j, col in enumerate(em):
            out[:, b, j] = (col, ext["f3_E"][b, col], ext["f3_k"][b, col],
                            ext["f3_l"][b, col], ext["f3_ss"][b, col])
        cnt_out[b], steps_out[b] = cnt, steps
    return (out[0].astype(np.int32), out[1].astype(np.int32),
            *(o.astype(pd) for o in out[2:]), cnt_out, steps_out)
