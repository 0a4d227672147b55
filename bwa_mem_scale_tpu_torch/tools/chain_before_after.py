"""The chaining kernels (chain_seeds, chain_filter) against an earlier
checkout's, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.chain_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/chain.cu`` into its own
``build/``. Its wrappers take the same arguments as this checkout's.

Batches (``tools/batches.py``): chip_smoke.py phase 5's (512 reads of
the 4.6 Mbp cell) and its repeat batch (512 reads on a 2 Mbp genome with
a 1 kbp window in 25 copies and a 150 bp unit in 600). Each batch goes
through ``seed_chain_extend`` once, and its chain_seeds and chain_filter
calls are taken as made (the main path's shapes: 512 coordinates, 64
chains of 32 seeds). Every version is first held equal to the plain
lockstep version on every array, its per-read steps equal to the other
version's, then timed in turns (before, after, after, before): the
device time of a wrapper call, its output allocation (and the earlier
design's zero fill and scratch) included (``tools/timing.py::device_ms``).
Beside the times: the steps, this checkout's rounds (its warp's
dependent steps) and latency floor (the longest read's rounds x the
cost of a round measured in the same run, ``tools/round_cost.py``), and
its chain_seeds with no valid coordinate (the launch, the rows and the
seed planes' writes alone) beside torch.zeros of the planes. Each line
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import chain_cuda
from ..ops.chain import (DeviceBns, chain_filter_frac_rep,
                         chain_seeds_device)
from ..ops.occ import DeviceFMIndex
from ..pipeline import align
from .batches import repeat_batch, se_batch
from .probe_before_after import in_turns, load_before
from .round_cost import round_us
from .timing import card_line, device_ms

NAMES = ("chain_seeds_cuda", "chain_filter_cuda")


def chain_calls(idx, codes, lens, dev) -> dict:
    """{wrapper name: (args, kw without stats)} of the batch's two
    chaining calls as ``seed_chain_extend`` makes them."""
    fmi = DeviceFMIndex.from_host(idx, dev)
    dbns = DeviceBns.from_host(idx.bns, dev)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    real = {name: getattr(align, name) for name in NAMES}
    calls = {}

    def recorder(name):
        def record(*args, **kw):
            calls[name] = (args, {k: v for k, v in kw.items()
                                  if k != "stats"})
            return real[name](*args, **kw)
        return record

    cfg = align.PipelineConfig(seed_engine="onehot")     # the main path's
    for name in NAMES:
        setattr(align, name, recorder(name))
    try:
        align.seed_chain_extend(fmi, dbns, c, ln, c.shape[1],
                                opt=MemOptions(), cfg=cfg)
    finally:
        for name, fn in real.items():
            setattr(align, name, fn)
    return calls


def equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.chain_before_after",
        description="Time the chaining kernels against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.chain_cuda")
    old.build(force=True)
    chain_cuda.build(force=True)
    per_round = round_us(dev)
    print(f"[round] one warp's dependent round: {per_round:.5f} us  "
          f"[{card}]", flush=True)
    plain = {"chain_seeds_cuda": chain_seeds_device,
             "chain_filter_cuda": chain_filter_frac_rep}
    for label, make in (("4.6 Mbp batch", se_batch),
                        ("repeat batch", repeat_batch)):
        calls = chain_calls(*make(), dev)
        for name in NAMES:
            a, kw = calls[name]
            before, after = getattr(old, name), getattr(chain_cuda, name)
            want = plain[name](*a, **kw)
            steps = {}
            for v, fn in (("before", before), ("after", after)):
                got = fn(*a, **kw)
                torch.cuda.synchronize()
                if not equal(got, want):
                    raise SystemExit(f"{label} {name}: {v} != plain")
                steps[v] = fn.last_steps.long()
            if not torch.equal(steps["before"], steps["after"]):
                raise SystemExit(f"{label} {name}: the steps differ")
            rounds = after.last_rounds.long()
            ms = in_turns({"before": before, "after": after},
                          {"call": lambda fn: lambda: fn(*a, **kw)}, dev)
            longest = int(rounds.max())
            what = name.replace("_cuda", "")
            print(f"[{what}] {label}: B={want[0].shape[0]}, "
                  f"{int(steps['after'].sum())} steps (the longest read "
                  f"{int(steps['after'].max())}), {int(rounds.sum())} "
                  f"rounds (the longest read {longest}; latency floor "
                  f"{longest * per_round * 1e-3:.5f} ms); equal "
                  f"to plain; device time before {ms['before']['call']:.5f}"
                  f" ms, after {ms['after']['call']:.5f} ms (mean of 2 "
                  f"turns)  [{card}]", flush=True)
        # chain_seeds with no valid coordinate at the same shapes: its
        # launch, rows and plane writes alone
        a, kw = calls[NAMES[0]]
        idle = (*a[:4], torch.zeros_like(a[4]))
        t = device_ms(lambda: chain_cuda.chain_seeds_cuda(*idle, **kw), 20,
                      dev)
        shape = (4, a[2].shape[0], kw["max_chains"],
                 kw["max_seeds_per_chain"])
        fill = device_ms(lambda: torch.zeros(shape, dtype=torch.int32,
                                             device=dev), 20, dev)
        mb = 4 * shape[0] * shape[1] * shape[2] * shape[3] / 1e6
        print(f"[chain_seeds] {label}: after, no valid coordinate (the "
              f"launch, the rows and the {mb:.1f} MB of seed planes "
              f"alone): {t:.5f} ms; torch.zeros of the planes: "
              f"{fill:.5f} ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
