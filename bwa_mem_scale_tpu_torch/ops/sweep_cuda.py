"""The sweep engine's two per-lane loops through the hand-written CUDA
kernels of csrc/sweep.cu.

Two wrappers, each with the signature of its plain version in
``ops/smem.py`` and each replacing a ``jax.lax.while_loop`` of the JAX
package's ``ops/smem.py``:
- ``extend_all_positions_cuda``: the forward extension from every (read,
  start column) lane, with the FMA ladder table as each lane's start
  (plain ``extend_all_positions``; JAX ``extend_all_positions`` with
  ``ops/fma.py::fast_forward``), one thread a lane;
- ``strategy_chase_cuda``: pass 3's restart chain (plain
  ``strategy_chase``; JAX ``smems_seed_strategy_merged``'s loop), one
  thread a read.
On CUDA tensors each launches its kernel once or raises; on CPU tensors
each runs its plain version. There is no fallback from a kernel to its
plain version. Each kernel has an int32 and an int64 form, picked by the
position dtype (``fmi.pos_dtype``; the records' dtype for the chase), as
in ``ops/smem_cuda.py``, whose index arguments and output layout these
wrappers share. Each keeps a ``launches`` count (both forms), a
``launches64`` count (the int64 form) and the last call's per-lane
``last_steps`` (forward steps for the sweep, chase iterations for the
chase). With ``stats`` they add the longest lane's steps
(``sweep_steps_p1`` / ``sweep_steps_p2`` / ``chase_steps``) and the total
(``sweep_total_p1`` / ``sweep_total_p2`` / ``chase_total``) as device
tensors, and for the sweep the longest lane's row fetches
(``sweep_rounds_p1`` / ``sweep_rounds_p2``, ``last_rounds``). With a
k-gram checkpoint table on the index (``fmi.kstep`` > 1, int32 layout)
the sweep launches its k-step form (``sweep_extend_launch_k``: two bases
a row fetch, after the FMA start), counted in ``launches_k`` as well.

``sweep_extend_twin`` and ``strategy_chase_twin`` are the kernels' loops
in plain Python on numpy arrays, tests of the kernels' control flow on
the CPU at small sizes; each counts what its kernel counts. The source
is compiled with nvcc into ``build/torch_kernels/libsweep_cuda.so`` at
first use (``ops/nvcc_build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .occ import DeviceFMIndex
from .smem_cuda import (_FMI, _SUFFIX, _TwinFmi, _TwinK, _check,
                        _codes_int32, _count, _fmi_args, _form, _kstep_args,
                        _smem_out)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SWEEP = [_vp] * 3 + [_ci] * 7 + [_vp] * 3 + [_ci] * 2 + [_vp] * 3
_CHASE = [_vp] * 7 + [_ci] * 3 + [_vp] * 3
LIB = nvcc_build.Library("sweep.cu", "sweep_cuda", {
    **{f"sweep_extend_launch{_SUFFIX[pd]}": _FMI[pd] + _SWEEP
       for pd in _FMI},
    "sweep_extend_launch_k": _FMI[torch.int32] + [_vp, _ci, _vp] + _SWEEP,
    **{f"strategy_chase_launch{_SUFFIX[pd]}": _CHASE for pd in _FMI}})
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


def strategy_chase_cuda(emit, E3, nxt, f3_k, f3_l, f3_ss, lens,
                        max_out: int, stats: dict = None):
    """Drop-in for ``smem.strategy_chase`` (an equal SmemBuf): one launch
    of strategy_chase_kernel on CUDA tensors, the plain version on CPU
    ones. emit [B, P] bool, E3 and nxt [B, P] int32, the records [B, P]
    int32 or int64 (the form), lens [B] int32."""
    from .smem import SmemBuf, strategy_chase
    if emit.device.type == "cpu":
        return strategy_chase(emit, E3, nxt, f3_k, f3_l, f3_ss, lens,
                              max_out, stats)
    what = "strategy_chase_cuda"
    dev = emit.device
    pd = f3_k.dtype
    ts = (emit, E3, nxt, f3_k, f3_l, f3_ss, lens)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what}: tensors on {dev} and elsewhere")
    B, P = emit.shape
    if (emit.dtype != torch.bool or pd not in _SUFFIX
            or any(t.dtype != torch.int32 for t in (E3, nxt, lens))
            or any(t.dtype != pd for t in (f3_l, f3_ss))
            or any(t.shape != (B, P) for t in ts[1:6])
            or lens.shape != (B,)):
        raise ValueError(f"{what}: shapes or dtypes differ from the plain "
                         f"version's")
    out, fields = _smem_out(B, max_out, pd, dev)
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        args = [t.contiguous() for t in ts]
        LIB.launch(dev, f"strategy_chase_launch{_SUFFIX[pd]}",
                   *(a.data_ptr() for a in args), B, P, max_out,
                   out.data_ptr(), cnt.data_ptr(), steps.data_ptr())
        _CHASE_FN.launches += 1
        _CHASE_FN.launches64 += pd == torch.int64
        _add_stats(stats, "chase_ticks", steps)
    _CHASE_FN.last_steps = steps
    return SmemBuf(*fields, cnt)


strategy_chase_cuda.launches = 0
strategy_chase_cuda.launches64 = 0
strategy_chase_cuda.last_steps = None            # [B] int32
_CHASE_FN = strategy_chase_cuda


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


def strategy_chase_twin(emit, E3, nxt, f3_k, f3_l, f3_ss, lens,
                        max_out: int):
    """csrc/sweep.cu's strategy_chase_kernel in plain Python on numpy
    arrays, one read after another. Returns (m, n, k, l, s, cnt, steps),
    k, l and s of the records' dtype."""
    emit = np.asarray(emit)
    B, P = emit.shape
    M = max_out
    out = np.zeros((5, B, M), np.int64)
    cnt_out = np.zeros(B, np.int32)
    steps_out = np.zeros(B, np.int32)
    for b in range(B):
        pos = cnt = steps = 0
        while pos < int(lens[b]) and pos < P:
            steps += 1
            if emit[b, pos]:
                if cnt < M:
                    out[:, b, cnt] = (pos, E3[b, pos], f3_k[b, pos],
                                      f3_l[b, pos], f3_ss[b, pos])
                cnt += 1
            n = int(nxt[b, pos])
            pos = n if n > pos else pos + 1
        cnt_out[b], steps_out[b] = cnt, steps
    pd = np.asarray(f3_k).dtype
    return (out[0].astype(np.int32), out[1].astype(np.int32),
            *(o.astype(pd) for o in out[2:]), cnt_out, steps_out)
