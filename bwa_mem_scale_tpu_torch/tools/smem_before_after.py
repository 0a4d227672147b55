"""The seeding kernels (SMEM passes 1-2 and pass 3) against an earlier
checkout's, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.smem_before_after build/before
    python -m bwa_mem_scale_tpu_torch.tools.smem_before_after build/before \
        --stage
    python -m bwa_mem_scale_tpu_torch.tools.smem_before_after build/before \
        --mem 3

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/smem.cu`` into its own
``build/``. Its wrappers take the same arguments as this checkout's.

Batches (``tools/batches.py``): chip_smoke.py phase 5's (512 reads of
the 4.6 Mbp cell) and its repeat batch (512 reads on a 2 Mbp genome with
a 1 kbp window in 25 copies and a 150 bp unit in 600). On each, at the
main path's depth 24: pass 1 (a task a read), pass 2 (the reseed tasks
pass 1 gives, budget 2 x 512) and pass 3 (max_intv 20, min_seed_len
20). Every version is first held equal to the plain lockstep version on
every array, then timed in turns (before, after, after, before): the
device time of a wrapper call, its output allocation and zero fill
included (``tools/timing.py::device_ms``). Beside the times: the steps
(the same work in both), this checkout's rounds (dependent occ round
trips) and latency floor (the longest task's rounds x 0.224 us, probe
B's dependent row load), and the pass-3 launch alone at 4, 8, 16 and 32
reads a block. Each line carries the card's name and power limit.

With ``--stage``, instead, the whole ``collect_smems_oh`` of each
checkout in turns: on both batches at the main path's depth 24 (reseed
factor 2), and on phase 5's batch at the retry tiers' (48, reseed factor
8; the read length, 256). This checkout's call runs five launches (pass
1, the task list of csrc/smem_glue.cu, pass 2, pass 3, the merge) with
no torch operation between them but the outputs' allocations; the
earlier one's the glue as torch operations. Both SmemBufs are first held
equal; then the device time of a call and the host wall of one
synchronised call (the glue's cost is host dispatch, which device time
misses), each the mean of 2 turns, the outermost aten operations a call
issues (``tools/glue_ops.py::outer_ops``), and this checkout's two glue
launches as the call makes them, each alone. With ``--mem RUNS``, SE
``mem`` end to end, RUNS runs a checkout in turns, with its ``-v 4``
stage seconds (``kstep_before_after.mem_turns`` without a k-gram table).
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import smem_cuda
from ..ops.occ import DeviceFMIndex
from ..ops.smem import reseed_tasks
from ..ops.smem_oh import one_pos_machine, seed_strategy_machine
from .batches import repeat_batch, se_batch
from .glue_ops import outer_ops
from .probe_before_after import in_turns, load_before
from .timing import card_line, device_ms, wall_ms

DEPTH = 24                       # the main path's stack and emission depth
STEP_US = 0.224                  # probe B's dependent L2 row load
FIELDS = ("m", "n", "k", "l", "s", "cnt")
P3_READS = (4, 8, 16, 32)         # pass-3 reads a block, tried in turn


def passes(fmi, codes, lens, opt):
    """{pass: (kind, args)} of one batch as collect_smems_oh makes them at
    depth 24: kind "one_pos" or "p3", args without stats."""
    B = codes.shape[0]
    dev = codes.device
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    p1 = (fmi, codes, lens, torch.arange(B, dtype=torch.int32, device=dev),
          zi, zi + 1, lens > 0, True, opt.min_seed_len, DEPTH, DEPTH)
    t_read, t_x, t_mi, t_valid, _ = reseed_tasks(
        one_pos_machine(*p1), 2 * B, opt.split_len, opt.split_width)
    p2 = (fmi, codes, lens, t_read, t_x, t_mi, t_valid, False,
          opt.min_seed_len, DEPTH, DEPTH)
    p3 = (fmi, codes, lens, opt.max_mem_intv, opt.min_seed_len + 1, DEPTH)
    return {"pass 1": ("one_pos", p1), "pass 2": ("one_pos", p2),
            "pass 3": ("p3", p3)}


def p3_at(a, R):
    """(a thunk launching this checkout's pass-3 kernel on args `a` at R
    reads a block, its outputs [5, B, M] and counts [B])."""
    fmi, codes, lens, max_intv, min_seed_len, M = a
    B, L = codes.shape
    i32 = dict(dtype=torch.int32, device=codes.device)
    out = torch.empty((5, B, M), **i32)
    cnt, steps = torch.empty((B,), **i32), torch.empty((B,), **i32)
    args = [*smem_cuda._fmi_args(fmi), codes.data_ptr(), lens.data_ptr(), B,
            L, max_intv, min_seed_len, M, R, out.data_ptr(), cnt.data_ptr(),
            steps.data_ptr()]

    def run():
        smem_cuda.LIB.launch(codes.device, "seed_strategy_launch", *args)
    run.steps = steps                  # lives as long as the thunk
    return run, out, cnt


# (depth, reseed factor): the main path's, then the retry tiers'
TIERS = ((DEPTH, 2), (48, 8), (None, 256))


def glue_launches(call) -> dict:
    """{wrapper name: (wrapper, args)} of the task list and merge launches
    that call() makes through this checkout's ops/smem_oh.py."""
    from ..ops import smem_oh
    names = ("reseed_tasks_cuda", "merge_smems_cuda")
    real = {n: getattr(smem_oh, n) for n in names}
    made = {}

    def record(n):
        def run(*a):
            made[n] = (real[n], a)
            return real[n](*a)
        return run
    for n in names:
        setattr(smem_oh, n, record(n))
    try:
        call()
    finally:
        for n in names:
            setattr(smem_oh, n, real[n])
    return made


def stage_turns(old_oh, label, fmi, c, ln, opt, card, dev) -> None:
    """The whole collect_smems_oh of both checkouts in turns at each of
    TIERS (the repeat batch at the main path's alone)."""
    from ..ops import smem_oh
    versions = {"before": old_oh.collect_smems_oh,
                "after": smem_oh.collect_smems_oh}
    for depth, rf in TIERS[:1 if label == "repeat batch" else None]:
        kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                  split_width=opt.split_width,
                  max_mem_intv=opt.max_mem_intv, emit_depth=depth,
                  stack_depth=depth, reseed_factor=rf)
        outs = {v: fn(fmi, c, ln, **kw) for v, fn in versions.items()}
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
            raise SystemExit(f"{label}, depth {depth}: the stages differ")
        ms = {v: {"device": 0.0, "wall": 0.0} for v in versions}
        for v in [*versions, *reversed(versions)]:
            thunk = (lambda fn: lambda: fn(fmi, c, ln, **kw))(versions[v])
            ms[v]["device"] += device_ms(thunk, 20, dev) / 2
            ms[v]["wall"] += wall_ms(thunk) / 2
        ops = {v: outer_ops(lambda fn=fn: fn(fmi, c, ln, **kw))
               for v, fn in versions.items()}
        alone = {n: device_ms(lambda w=w, a=a: w(*a), 20, dev)
                 for n, (w, a) in glue_launches(
                     lambda: smem_oh.collect_smems_oh(fmi, c, ln,
                                                      **kw)).items()}
        out = outs["after"]
        W = out.m.shape[1]
        print(f"[stage] {label}, depth {depth}, reseed factor {rf}: "
              f"B={c.shape[0]}, W={W}, "
              f"{int(out.cnt.clamp(max=W).sum())} SMEMs, "
              f"{int((out.cnt == W).sum())} reads saturated; equal; device "
              f"time before {ms['before']['device']:.5f} ms, after "
              f"{ms['after']['device']:.5f} ms; a synchronised call's host "
              f"wall before {ms['before']['wall']:.5f} ms, after "
              f"{ms['after']['wall']:.5f} ms (means of 2 turns); outer aten "
              f"operations before {ops['before']}, after {ops['after']}; "
              f"the glue launches alone: task list "
              f"{alone['reseed_tasks_cuda']:.5f} ms, merge "
              f"{alone['merge_smems_cuda']:.5f} ms  [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.smem_before_after",
        description="Time the seeding kernels against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    ap.add_argument("--stage", action="store_true",
                    help="instead, the whole collect_smems_oh in turns")
    ap.add_argument("--mem", type=int, default=0, metavar="RUNS",
                    help="instead, SE mem end to end in turns, RUNS runs "
                         "a checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    if args.mem:
        from .kstep_before_after import mem_turns
        mem_turns(args.before, args.mem, card, tables=("none",))
        return 0
    load_before(args.before)                # registers its package
    old_smem = importlib.import_module("probe_before.ops.smem_cuda")
    old_smem.build(force=True)
    smem_cuda.build(force=True)
    opt = MemOptions()
    if args.stage:
        smem_cuda.build_glue(force=True)
        old_oh = importlib.import_module("probe_before.ops.smem_oh")
        for label, make in (("4.6 Mbp batch", se_batch),
                            ("repeat batch", repeat_batch)):
            idx, codes, lens = make()
            stage_turns(old_oh, label, DeviceFMIndex.from_host(idx, dev),
                        torch.as_tensor(codes, device=dev),
                        torch.as_tensor(lens, device=dev), opt, card, dev)
        return 0
    wrappers = {"one_pos": (one_pos_machine, old_smem.one_pos_machine_cuda,
                            smem_cuda.one_pos_machine_cuda),
                "p3": (seed_strategy_machine,
                       old_smem.seed_strategy_machine_cuda,
                       smem_cuda.seed_strategy_machine_cuda)}
    for label, make in (("4.6 Mbp batch", se_batch),
                        ("repeat batch", repeat_batch)):
        idx, codes, lens = make()
        fmi = DeviceFMIndex.from_host(idx, dev)
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        for what, (kind, a) in passes(fmi, c, ln, opt).items():
            plain, before, after = wrappers[kind]
            want = plain(*a)
            plain_steps = plain.last_steps
            for v, fn in (("before", before), ("after", after)):
                got = fn(*a)
                torch.cuda.synchronize()
                if not all(torch.equal(getattr(got, f), getattr(want, f))
                           for f in FIELDS):
                    raise SystemExit(f"{label} {what}: {v} != plain")
                if not torch.equal(fn.last_steps, plain_steps):
                    raise SystemExit(f"{label} {what}: {v}'s steps != "
                                     f"plain's")
            rounds = getattr(after, "last_rounds", None)
            rounds = (plain_steps if kind == "p3" else rounds).long()
            ms = in_turns({"before": before, "after": after},
                          {"call": lambda fn: lambda: fn(*a)}, dev)
            longest = int(rounds.max())
            lanes = a[3].shape[0] if kind == "one_pos" else c.shape[0]
            print(f"[{what}] {label}: T={lanes}, {int(plain_steps.sum())} "
                  f"steps (the "
                  f"longest {int(plain_steps.max())}), {int(rounds.sum())} "
                  f"rounds (the longest {longest}; latency floor "
                  f"{longest * STEP_US * 1e-3:.5f} ms); equal to plain; "
                  f"device time before {ms['before']['call']:.5f} ms, after "
                  f"{ms['after']['call']:.5f} ms (mean of 2 turns)  "
                  f"[{card}]", flush=True)
            if kind != "p3":
                continue
            line = []
            for R in P3_READS:
                run, out, cnt = p3_at(a, R)
                run()
                torch.cuda.synchronize()
                if not (torch.equal(cnt, want.cnt) and all(
                        torch.equal(o, getattr(want, f))
                        for o, f in zip(out, FIELDS))):
                    raise SystemExit(f"{label} pass 3 at R={R} != plain")
                line.append(f"R={R} {device_ms(run, 20, dev):.5f} ms")
            print(f"[pass 3] {label}: the launch alone at R reads a block: "
                  f"{', '.join(line)}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
