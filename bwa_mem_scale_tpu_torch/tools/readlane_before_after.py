"""The readlane seeding kernels (SMEM passes 1-2 and pass 3) against an
earlier checkout's, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.readlane_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/readlane.cu`` into its own
``build/``. Its wrappers take the same arguments as this checkout's.

Batches (``tools/batches.py``): chip_smoke.py phase 5's (512 reads of
the 4.6 Mbp cell) and its repeat batch, each through the 1-step form,
the int64 form (the layout forced) and the k-step forms (K = 2 and 3
tables, ``index/kstep.py``), as ``collect_smems_rl`` makes its passes at
full depth: pass 1 (a task a read), pass 2 (the reseed tasks pass 1
gives, budget 2 x 512) and pass 3 (max_intv 20, min_seed_len 20), each
at one lane a task and at pools of 256 and 64 lanes. Every version is
first held equal to the plain lockstep machine on every array and in
total steps, then timed in turns (before, after, after, before): the
device time of a wrapper call, its output allocation included
(``tools/timing.py::device_ms``). Each line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..index.kstep import build_cp2
from ..ops import smem_rl_cuda
from ..ops.occ import DeviceFMIndex
from ..ops.smem import reseed_tasks
from ..ops.smem_rl import one_pos_machine, seed_strategy_machine
from .batches import repeat_batch, se_batch
from .probe_before_after import in_turns, load_before
from .timing import card_line

FIELDS = ("m", "n", "k", "l", "s", "cnt")
LANES = (None, 256, 64)          # the pools: one lane a task, 256, 64


def passes(fmi, codes, lens, opt):
    """{pass: (kind, args, keyword args)} of one batch as collect_smems_rl
    makes them at full depth, one lane a task."""
    B, L = codes.shape
    dev = codes.device
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    p1 = (fmi, codes, lens, torch.arange(B, dtype=torch.int32, device=dev),
          zi, zi + 1, lens > 0, True, opt.min_seed_len, L)
    t_read, t_x, t_mi, t_valid, _ = reseed_tasks(
        one_pos_machine(*p1), 2 * B, opt.split_len, opt.split_width)
    p2 = (fmi, codes, lens, t_read, t_x, t_mi, t_valid, False,
          opt.min_seed_len, L)
    p3 = (fmi, codes, lens, opt.max_mem_intv, opt.min_seed_len + 1, L)
    return {"pass 1": ("one_pos", p1, {}),
            "pass 2": ("one_pos", p2,
                       {"out_rows": torch.arange(2 * B, device=dev)}),
            "pass 3": ("p3", p3, {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.readlane_before_after",
        description="Time the readlane kernels against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.smem_rl_cuda")
    old.LIB.build(force=True)
    smem_rl_cuda.LIB.build(force=True)
    opt = MemOptions()
    wrappers = {"one_pos": (one_pos_machine, old.readlane_one_pos_cuda,
                            smem_rl_cuda.readlane_one_pos_cuda),
                "p3": (seed_strategy_machine, old.readlane_strategy_cuda,
                       smem_rl_cuda.readlane_strategy_cuda)}
    for label, make in (("phase 5's batch", se_batch),
                        ("repeat batch", repeat_batch)):
        idx, codes, lens = make()
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        for cfg in ("K=1", "int64", "K=2", "K=3"):
            K = int(cfg[2]) if cfg[0] == "K" else 1
            fmi = DeviceFMIndex.from_host(
                idx, dev, force_int64=cfg == "int64",
                cp2=build_cp2(idx, K) if K > 1 else None)
            for what, (kind, a, kw) in passes(fmi, c, ln, opt).items():
                plain, before, after = wrappers[kind]
                want = plain(*a, **kw)
                steps = plain.last_steps
                for lanes in LANES:
                    kl = dict(kw, lanes=lanes)
                    for v, fn in (("before", before), ("after", after)):
                        got = fn(*a, **kl)
                        torch.cuda.synchronize()
                        if not all(torch.equal(getattr(got, f),
                                               getattr(want, f))
                                   for f in FIELDS):
                            raise SystemExit(f"{label} {cfg} {what} lanes "
                                             f"{lanes}: {v} != plain")
                        if int(fn.last_steps.sum()) != int(steps.sum()):
                            raise SystemExit(f"{label} {cfg} {what}: {v}'s "
                                             f"steps != plain's")
                    ms = in_turns({"before": before, "after": after},
                                  {"call": lambda fn: lambda: fn(*a, **kl)},
                                  dev)
                    print(f"[{what}] {label}, {cfg}, lanes "
                          f"{len(after.last_steps)}: "
                          f"{int(steps.sum())} steps (the longest lane "
                          f"{int(after.last_steps.max())}), ticks "
                          f"{int(after.last_ticks.sum())} (the longest lane "
                          f"{int(after.last_ticks.max())}); equal to plain; "
                          f"device time before {ms['before']['call']:.5f} "
                          f"ms, after {ms['after']['call']:.5f} ms (mean of "
                          f"2 turns)  [{card}]", flush=True)
            del fmi
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
