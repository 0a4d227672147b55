"""The sweep's passes 1 and 2 (csrc/sweep.cu sweep_extend_kernel in its
pass forms: the extension and the emission in one launch) against an
earlier checkout's, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.sweep_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/sweep.cu`` into its own
``build/``. Its passes are what its ``collect_smems_device`` and
``smems_reseed`` run: pass 1 its bare extension's launch, then
``_left_max_mask`` and ``_emit_compact`` as torch operations; pass 2 the
gather of each task's read (``codes[t_read]``), the launch, the mask and
``_emit_compact(rows=t_read)``.

Cases, as chip_smoke.py phases 9 and 13 make them: phase 5's batch
(``tools/batches.py::se_batch``, phase 4's 4.6 Mbp genome) and the
repeat batch (``repeat_batch``), each with an FMA table of K = 11, at the
int32 layout, the forced int64 layout and (phase 5's batch) the K = 2
k-gram table; the two pass calls of ``collect_smems_device``, as made.
Versions: "before" (the earlier passes) and "after" (this checkout's, as
the main path calls them), each first held equal to the plain version
(``smem.sweep_pass_plain``) on every field and record; then "start"
(this launch built from a copy of ``csrc/sweep.cu`` under
``build/torch_kernels/sweep_before_after/`` in which every lane retires
after its FMA start, so the start's share is measured, not inferred;
the tool stops if the line it patches is not found exactly once), "after,
steps kept" (this launch writing each lane's steps too, as the earlier
bare extension did) and the earlier checkout's bare extension alone
("launch before": its ``extend_all_positions_cuda`` on the same lanes, a
pass-2 call's task rows gathered in advance), which parts its walk from
its emission.
Timed in turns (forward, then backward): the device time of a call with
its allocations (``tools/timing.py::device_ms``) and the host wall of one
call followed by ``torch.cuda.synchronize()`` (mean of 50). Each line
carries the card's name and power limit, the outermost aten operations of
one call of each version (``tools/glue_ops.py``), and the longest lane's
steps.
"""

from __future__ import annotations

import argparse
import importlib
import os
import re
import sys

import torch

from ..device import resolve_device
from ..index.kstep import build_cp2
from ..ops import nvcc_build, smem, sweep_cuda
from ..ops.fma import build_fma_table
from ..ops.occ import DeviceFMIndex
from .batches import repeat_batch, se_batch
from .glue_ops import outer_ops
from .probe_before_after import load_before
from .strategy_before_after import synced_ms
from .timing import card_line, device_ms

FMA_K = 11                      # smem-table's default (phase 9)
KW = dict(min_seed_len=19, split_len=28, split_width=10, max_mem_intv=20)


def pass_calls(fmi, c, ln, table) -> list:
    """The (args, kwargs) of collect_smems_device's two sweep_pass_cuda
    calls on the batch, as made (without stats)."""
    calls = []
    real = sweep_cuda.sweep_pass_cuda

    def record(*a, **k):
        calls.append((a, {f: v for f, v in k.items() if f != "stats"}))
        return real(*a, **k)
    sweep_cuda.sweep_pass_cuda = record
    try:
        smem.collect_smems_device(fmi, c, ln, fma=table, **KW)
    finally:
        sweep_cuda.sweep_pass_cuda = real
    return calls


def before_pass(old, old_sweep):
    """The earlier checkout's pass, on a pass call's arguments: (SmemBuf,
    records), as its collect_smems_device and smems_reseed compute them."""
    def run(fmi, codes, lens, msl, M, fma=None, tasks=None, p3_max_intv=0,
            p3_stop=0, n_pos=0, stats_key=None):
        B, L = codes.shape
        P = n_pos or L
        dev = codes.device
        empty = old.SmemBuf.empty(B, M, dev, fmi.pos_dtype)
        if tasks is None:
            ones = torch.ones((B,), dtype=torch.int32, device=dev)
            ext = old_sweep.extend_all_positions_cuda(
                fmi, codes, lens, ones, check_initial=True, want_fail=False,
                fma=fma, p3_max_intv=p3_max_intv, p3_stop=p3_stop, n_pos=P)
            E = ext["E"]
            pcol, mask = old._left_max_mask(E, P, msl)
            out = old._emit_compact(mask, pcol.expand(B, P), E - 1, ext["k"],
                                    ext["l"], ext["s"], empty)
            merged = p3_max_intv > 0 and p3_stop > 0
            return out, ({f: ext[f] for f in smem.MERGED_RECORDS}
                         if merged else {})
        t_read, t_x, t_mi, t_valid = tasks
        T = t_read.shape[0]
        codes_t = torch.where(t_valid[:, None], codes[t_read], 4)
        lens_t = torch.where(t_valid, lens[t_read], 0)
        ext = old_sweep.extend_all_positions_cuda(
            fmi, codes_t.to(torch.int32), lens_t.to(torch.int32),
            t_mi.to(torch.int32), check_initial=True, want_fail=False,
            fma=fma, n_pos=P)
        E = ext["E"]
        pcol, mask = old._left_max_mask(E, P, msl)
        mask = (mask & t_valid[:, None] & (pcol <= t_x[:, None])
                & (E > t_x[:, None]))
        return old._emit_compact(mask, pcol.expand(T, P), E - 1, ext["k"],
                                 ext["l"], ext["s"], empty, rows=t_read), {}
    return run


def bare_args(a, k) -> tuple:
    """A pass call's bare extension, its task rows gathered in advance:
    (args, kwargs) of the earlier checkout's extend_all_positions_cuda."""
    fmi, codes, lens, msl, M = a[:5]
    tasks = k.get("tasks")
    kw = dict(fma=k.get("fma"), n_pos=k["n_pos"])
    if tasks is None:
        ones = torch.ones((codes.shape[0],), dtype=torch.int32,
                          device=codes.device)
        return (fmi, codes, lens, ones, True, False), dict(
            kw, p3_max_intv=k.get("p3_max_intv", 0),
            p3_stop=k.get("p3_stop", 0))
    t_read, _, t_mi, t_valid = tasks
    codes_t = torch.where(t_valid[:, None], codes[t_read], 4)
    lens_t = torch.where(t_valid, lens[t_read], 0)
    return (fmi, codes_t.to(torch.int32).contiguous(),
            lens_t.to(torch.int32).contiguous(),
            t_mi.to(torch.int32).contiguous(), True, False), kw


# the line of csrc/sweep.cu's sweep_lane after the FMA start, before the
# forward steps; the start-only copy retires the lane just before it
_AFTER_START = "  bool f3s = false;\n"


def start_only_library() -> nvcc_build.Library:
    """csrc/sweep.cu with every lane retiring after its FMA start, built
    under its own name in its own directory (its header included from
    csrc/)."""
    with open(sweep_cuda.LIB.source) as f:
        src = f.read()
    out, n = re.subn(re.escape(_AFTER_START), lambda _: (
        "  act = false;                     // the start alone\n"
        + _AFTER_START), src)
    if n != 1:
        raise SystemExit(f"sweep_before_after: {_AFTER_START!r} found {n} "
                         f"times in csrc/sweep.cu")
    csrc = os.path.dirname(sweep_cuda.LIB.source)
    out = out.replace('#include "fmi_step.cuh"',
                      f'#include "{os.path.join(csrc, "fmi_step.cuh")}"')
    out_dir = os.path.join(nvcc_build.BUILD_DIR, "sweep_before_after")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "sweep_start.cu")
    with open(path, "w") as f:
        f.write(out)
    return nvcc_build.Library(path, "sweep_start", sweep_cuda.LIB.argtypes)


def with_library(lib, fn):
    """fn through sweep_cuda with `lib` in place of its library."""
    def call(*a, **k):
        real = sweep_cuda.LIB
        sweep_cuda.LIB = lib
        try:
            return fn(*a, **k)
        finally:
            sweep_cuda.LIB = real
    return call


def steps_kept(*a, **k):
    """This checkout's pass launch writing each lane's steps too."""
    sweep_cuda.sweep_pass_cuda.keep_steps = True
    try:
        return sweep_cuda.sweep_pass_cuda(*a, **k)
    finally:
        sweep_cuda.sweep_pass_cuda.keep_steps = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.sweep_before_after",
        description="Time the sweep's passes 1 and 2 against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.smem")
    old_sweep = importlib.import_module("probe_before.ops.sweep_cuda")
    start_lib = start_only_library()
    for lib in (old_sweep.LIB, sweep_cuda.LIB, start_lib):
        lib.build(force=True)
    start_only = with_library(start_lib, sweep_cuda.sweep_pass_cuda)
    versions = {"before": before_pass(old, old_sweep),
                "after": sweep_cuda.sweep_pass_cuda}
    batches = [("phase 5's batch", *se_batch()),
               ("repeat batch", *repeat_batch())]
    for batch, idx, codes, lens in batches:
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        fma = build_fma_table(DeviceFMIndex.from_host(idx, dev), K=FMA_K)
        forms = [("int32", dict()), ("int64", dict(force_int64=True))]
        if batch == "phase 5's batch":
            forms.append(("K = 2", dict(cp2=build_cp2(idx, 2))))
        for form, fkw in forms:
            fmi = DeviceFMIndex.from_host(idx, dev, **fkw)
            table = fma.to_device(fmi.pos_dtype, dev)
            for n, (a, k) in enumerate(pass_calls(fmi, c, ln, table)):
                label = f"{batch}, {form}, pass {n + 1}"
                want, wrecs = smem.sweep_pass_plain(*a, **k)
                steps = smem.extend_all_positions.last_steps
                ops = {}
                for v, fn in versions.items():
                    got, recs = fn(*a, **k)
                    torch.cuda.synchronize()
                    if not (all(torch.equal(x, y) for x, y in zip(got, want))
                            and set(recs) == set(wrecs)
                            and all(torch.equal(recs[f], wrecs[f])
                                    for f in wrecs)):
                        raise SystemExit(f"{label}: {v} != plain")
                    ops[v] = outer_ops(lambda: fn(*a, **k))
                ba, bk = bare_args(a, k)
                timed = {**{v: (fn, a, k) for v, fn in versions.items()},
                         "start": (start_only, a, k),
                         "after, steps kept": (steps_kept, a, k),
                         "launch before": (old_sweep.extend_all_positions_cuda,
                                           ba, bk)}
                ms = {v: [0.0, 0.0] for v in timed}
                for v in list(timed) + list(timed)[::-1]:
                    fn, xa, xk = timed[v]
                    ms[v][0] += device_ms(lambda: fn(*xa, **xk), 20, dev) / 2
                    ms[v][1] += synced_ms(lambda: fn(*xa, **xk)) / 2
                B, L = a[1].shape
                T = 0 if k.get("tasks") is None else k["tasks"][0].shape[0]
                print(f"[sweep] {label}: B={B}, L={L}, P={k['n_pos']}, "
                      f"M={a[4]}{f', T={T}' if T else ''}; {int(steps.sum())}"
                      f" steps, the longest lane {int(steps.max())}; every "
                      f"version equal to plain; device ms / host wall ms of "
                      f"a synchronised call / outer aten ops: "
                      + "; ".join(f"{v} {ms[v][0]:.5f} / {ms[v][1]:.5f}"
                                  + (f" / {ops[v]}" if v in ops else "")
                                  for v in timed)
                      + f" (means of 2 turns)  [{card}]", flush=True)
            del fmi, table
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
