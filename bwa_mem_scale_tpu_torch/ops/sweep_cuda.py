"""The sweep engine's two kernels through the hand-written CUDA of
csrc/sweep.cu.

Two wrappers, each with the signature of its plain version in
``ops/smem.py`` and each replacing code of the JAX package's
``ops/smem.py``:
- ``extend_all_positions_cuda``: the forward extension from every (read,
  start column) lane, with the FMA ladder table as each lane's start
  (plain ``extend_all_positions``; JAX ``extend_all_positions`` with
  ``ops/fma.py::fast_forward``), one thread a lane;
- ``seed_strategy_merged_cuda``: pass 3's merged stage, the column glue
  and the restart chain in one launch (plain
  ``seed_strategy_merged_plain``; JAX ``smems_seed_strategy_merged``),
  one warp a read, no torch operation but the outputs' allocations.
On CUDA tensors each launches its kernel once or raises; on CPU tensors
each runs its plain version. There is no fallback from a kernel to its
plain version. Each kernel has an int32 and an int64 form, picked by the
position dtype (``fmi.pos_dtype``), as in ``ops/smem_cuda.py``, whose
index arguments and output layout these wrappers share. Each keeps a
``launches`` count (both forms), a ``launches64`` count (the int64 form)
and the last call's ``last_steps`` (forward steps a lane for the sweep,
chase iterations a read for the merged stage). With ``stats`` the sweep
adds the longest lane's steps (``sweep_steps_p1`` / ``sweep_steps_p2``),
the total (``sweep_total_p1`` / ``sweep_total_p2``) and the longest
lane's row fetches (``sweep_rounds_p1`` / ``sweep_rounds_p2``,
``last_rounds``) as device tensors; the merged stage's kernel adds its
longest read's chase steps and the total to two device counters of its
own, ``chase_steps`` and ``chase_total`` (0-d int64 tensors). With a
k-gram checkpoint table on the index (``fmi.kstep`` > 1, int32 layout)
the sweep launches its k-step form (``sweep_extend_launch_k``: two bases
a row fetch, after the FMA start), counted in ``launches_k`` as well.

``sweep_extend_twin`` and ``seed_strategy_merged_twin`` are the kernels'
loops in plain Python on numpy arrays, tests of the kernels' control flow
on the CPU at small sizes; each counts what its kernel counts. The source
is compiled with nvcc into ``build/torch_kernels/libsweep_cuda.so`` at
first use (``ops/nvcc_build.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem_cuda import (_FMI, _SUFFIX, _TwinFmi, _TwinK, _check,
                        _codes_int32, _count, _fmi_args, _form, _kstep_args,
                        _smem_out)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SWEEP = [_vp] * 3 + [_ci] * 7 + [_vp] * 3 + [_ci] * 2 + [_vp] * 3
_MERGED = [_vp] * 10 + [_ci] * 5 + [_vp] * 6
LIB = nvcc_build.Library("sweep.cu", "sweep_cuda", {
    **{f"sweep_extend_launch{_SUFFIX[pd]}": _FMI[pd] + _SWEEP
       for pd in _FMI},
    "sweep_extend_launch_k": _FMI[torch.int32] + [_vp, _ci, _vp] + _SWEEP,
    **{f"seed_strategy_merged_launch{_SUFFIX[pd]}": _MERGED
       for pd in _FMI}})
build = LIB.build            # compile csrc/sweep.cu; returns the library path

# the sweep's outputs: its [3][B][P] int32 ([4] in the k-step form, with
# each lane's row fetches), [9][B][P] position and [4][B][P] byte planes,
# in order
_I_PLANES = ("E", "f3_E", "steps", "rounds")
_P_PLANES = ("k", "l", "s", "fail_k", "fail_l", "fail_ss", "f3_k", "f3_l",
             "f3_ss")
_B_PLANES = ("fail_s", "f3_s", "died_s", "valid")


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


def extend_all_positions_cuda(fmi: DeviceFMIndex, codes, lens, min_intv,
                              check_initial: bool, want_fail: bool,
                              stop_min_len: int = 0, fma=None,
                              p3_max_intv: int = 0, p3_stop: int = 0,
                              n_pos: int = 0, stats: dict = None,
                              stats_key: str = "sweep_ticks") -> dict:
    """Drop-in for ``smem.extend_all_positions`` (equal arrays): one launch
    of sweep_extend_kernel on CUDA tensors, the plain version on CPU ones.
    codes [B, L] and lens [B] int32, min_intv [B] (held as int32, as the
    JAX package holds the reseed's), `fma` a DeviceFmaTable at fmi's
    position dtype on fmi's device, or None."""
    from .smem import extend_all_positions, sweep_keys, sweep_window
    if codes.device.type == "cpu":
        return extend_all_positions(
            fmi, codes, lens, min_intv, check_initial, want_fail,
            stop_min_len, fma, p3_max_intv, p3_stop, n_pos, stats,
            stats_key)
    what = "extend_all_positions_cuda"
    merge_p3, K_eff = sweep_window(fma, stop_min_len, p3_max_intv, p3_stop)
    lad = ()
    if K_eff:
        lad = (fma.ladder_k, fma.ladder_l, fma.ladder_s)
        if any(t.dtype != fmi.pos_dtype or not t.is_contiguous()
               for t in lad):
            raise ValueError(f"{what}: the FMA ladders must be contiguous "
                             f"and of the index's position dtype")
    dev = _check(what, fmi, codes, lens, min_intv, *lad)
    _codes_int32(what, codes, lens)
    B, L = codes.shape
    P = n_pos or L
    if lens.shape != (B,) or min_intv.shape != (B,) or not 0 < P <= L:
        raise ValueError(f"{what}: read counts differ or n_pos {P} is "
                         f"outside [1, {L}]")
    kstep = fmi.kstep > 1
    out_i = torch.empty((4 if kstep else 3, B, P), dtype=torch.int32,
                        device=dev)
    out_p = torch.empty((9, B, P), dtype=fmi.pos_dtype, device=dev)
    out_b = torch.empty((4, B, P), dtype=torch.uint8, device=dev)
    if B:
        c, ln = codes.contiguous(), lens.contiguous()
        mi = min_intv.to(torch.int32).contiguous()
        ptrs = [t.data_ptr() for t in lad] or [None] * 3
        form = (["sweep_extend_launch_k", *_fmi_args(fmi),
                 *_kstep_args(fmi, None)] if kstep else
                [_form("sweep_extend_launch", fmi), *_fmi_args(fmi)])
        LIB.launch(dev, *form, c.data_ptr(), ln.data_ptr(), mi.data_ptr(), B,
                   L, P, int(check_initial), stop_min_len, p3_max_intv,
                   p3_stop, *ptrs, fma.K if K_eff else 0, K_eff,
                   out_i.data_ptr(), out_p.data_ptr(), out_b.data_ptr())
        _count(_EXTEND_FN, fmi, kstep)
    planes = {**dict(zip(_I_PLANES, out_i)), **dict(zip(_P_PLANES, out_p)),
              **{f: v.view(torch.bool) for f, v in zip(_B_PLANES, out_b)}}
    # a row fetch a step at K = 1
    planes.setdefault("rounds", planes["steps"])
    if B:
        _add_stats(stats, stats_key, planes["steps"], planes["rounds"])
    _EXTEND_FN.last_steps = planes["steps"]
    _EXTEND_FN.last_rounds = planes["rounds"]
    return {f: planes[f] for f in sweep_keys(want_fail, merge_p3)}


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, and the int64 form's; the per-lane forward steps of the last call
extend_all_positions_cuda.launches = 0
extend_all_positions_cuda.launches64 = 0
extend_all_positions_cuda.launches_k = 0
extend_all_positions_cuda.last_steps = None      # [B, P] int32
extend_all_positions_cuda.last_rounds = None     # [B, P] int32
# the wrapper itself, for its counts: a caller may swap the module's name
_EXTEND_FN = extend_all_positions_cuda


# the merged stage's running maximum and ticket of each (device, stream):
# zeroed when first made, left zero by every launch
_RUN: dict = {}
_RUN_LOCK = threading.Lock()


def _run_words(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _RUN_LOCK:
        if key not in _RUN:
            _RUN[key] = torch.zeros((2,), dtype=torch.int64, device=dev)
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


def sweep_extend_twin(count, cp_fused, sentinel_index: int, codes, lens,
                      min_intv, check_initial: bool, stop_min_len: int = 0,
                      p3_max_intv: int = 0, p3_stop: int = 0, n_pos: int = 0,
                      ladders=None, K_eff: int = 0, hi_steps=None,
                      kstep=None) -> dict:
    """csrc/sweep.cu's sweep_extend_kernel in plain Python on numpy
    arrays, one lane after another: the FMA start from the lane's ladder
    row (`ladders` = (k, l, s) [4^K, K] with K_eff >= 2, else none), then
    one forward step a column (two a row fetch with `kstep`,
    ``smem_cuda.kstep_tables``' k-gram table) until an N, the read's end
    or a size failure. With `hi_steps` (``smem_cuda.twin_tables``) the
    int64 form. Returns every output plane of the kernel by name, steps
    and rounds (row fetches) included."""
    fm = _TwinFmi(count, cp_fused, sentinel_index, hi_steps)
    kt = None if kstep is None else _TwinK(fm, *kstep)
    C = fm.count
    codes = np.asarray(codes)
    B, L = codes.shape
    P = n_pos or L
    merge = p3_max_intv > 0 and p3_stop > 0
    pd = np.int32 if hi_steps is None else np.int64
    out = {f: np.zeros((B, P), np.int32) for f in _I_PLANES}
    out.update({f: np.zeros((B, P), pd) for f in _P_PLANES})
    out.update({f: np.zeros((B, P), bool) for f in _B_PLANES})
    clip = lambda c: min(max(c, 0), 3)
    if K_eff:
        lk, ll, ls = (np.asarray(a) for a in ladders)
        K = lk.shape[1]
    for b in range(B):
        n_len, mi = int(lens[b]), int(min_intv[b])

        def code(i):
            return min(int(codes[b, i]), 4) if i < L else 4

        for p in range(P):
            c0 = code(p)
            base_ok = p < n_len and c0 < 4
            k = l = s = 0
            died = fs = f3s = False
            fk = fl = fss = f3k = f3l = f3ss = f3E = steps = 0
            if K_eff:                            # the K-mer's ladder row
                cap, lead, km = 0, True, 0
                for i in range(K):
                    c = code(p + i)
                    if i < K_eff:
                        lead = lead and 0 <= c < 4 and p + i < n_len
                        cap += lead
                    km = 4 * km + clip(c)
                jstar = cap
                if check_initial:
                    jstar = 0
                    while jstar < cap and int(ls[km, jstar]) >= mi:
                        jstar += 1
                if jstar:
                    k, l, s = (int(a[km, jstar - 1]) for a in (lk, ll, ls))
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
                         ("rounds", rounds),
                         ("k", k), ("l", l), ("s", s), ("fail_k", fk),
                         ("fail_l", fl), ("fail_ss", fss), ("f3_k", f3k),
                         ("f3_l", f3l), ("f3_ss", f3ss), ("fail_s", fs),
                         ("f3_s", f3s), ("died_s", died),
                         ("valid", base_ok)):
                out[f][b, p] = v
    return out


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
