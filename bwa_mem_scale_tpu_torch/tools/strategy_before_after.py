"""Pass 3's merged stage (csrc/sweep.cu seed_strategy_merged_kernel)
against an earlier checkout's stage, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.strategy_before_after \
        build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/sweep.cu`` into its own
``build/``. Its ``smems_seed_strategy_merged`` takes the same arguments
as this checkout's: there, the column glue as torch operations and then
the restart chain's kernel.

Cases, as chip_smoke.py phases 9 and 12 make them, on phase 4's genome
(indexed with the full SA) and phase 5's batch (``tools/batches.py::
se_batch``): the merged-stage call of ``collect_smems_device`` with an
FMA table of K = 11 (the sweep), and of ``collect_smems_ert`` with
`ert-index`'s trie (K = 12, depth 320), each at the int32 and the
forced int64 layout. Versions: "before" (the earlier stage) and "after"
(this one, as the main path calls it). Every version is first
held equal to the plain version on every field and on each read's
steps, then timed in turns (forward, then backward): the device time of
a call with its allocations (``tools/timing.py::device_ms``) and the
host wall of one call followed by ``torch.cuda.synchronize()`` (mean of
50). Each line carries the card's name and power limit, the outermost
aten operations of one call of each version (``tools/glue_ops.py``) and
the longest read's chase steps.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import types

import torch

from ..device import resolve_device
from ..index.ert import build_ert_from_index
from ..ops import ert as ops_ert, smem, sweep_cuda
from ..ops.fma import build_fma_table
from ..ops.occ import DeviceFMIndex
from .batches import se_batch
from .glue_ops import merged_call, outer_ops
from .probe_before_after import load_before
from .timing import card_line, device_ms

ERT_K, ERT_DEPTH = 12, 320      # ert-index's defaults (chip_smoke phase 12)
FMA_K = 11                      # smem-table's default (phase 9)
KW = dict(min_seed_len=19, split_len=28, split_width=10, max_mem_intv=20)


def synced_ms(fn, reps: int = 50) -> float:
    """Host milliseconds of fn() and a synchronise, mean of reps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.strategy_before_after",
        description="Time pass 3's merged stage against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.smem")
    old_sweep = importlib.import_module("probe_before.ops.sweep_cuda")
    old_sweep.LIB.build(force=True)
    sweep_cuda.LIB.build(force=True)
    idx, codes, lens = se_batch(sa_compx=0)
    trie = build_ert_from_index(idx, K=ERT_K, max_depth=ERT_DEPTH)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    fma = build_fma_table(DeviceFMIndex.from_host(idx, dev), K=FMA_K)
    versions = {"before": old.smems_seed_strategy_merged,
                "after": smem.smems_seed_strategy_merged}
    steps_of = {"before": lambda: old_sweep.strategy_chase_cuda.last_steps,
                "after": lambda: sweep_cuda.seed_strategy_merged_cuda
                .last_steps}
    for wide in (False, True):
        fmi = DeviceFMIndex.from_host(idx, dev, force_int64=wide)
        table = fma.to_device(fmi.pos_dtype, dev)
        dert = ops_ert.DeviceErt.from_host(trie, fmi.sa_samples, idx.count,
                                           dev)
        form = "int64" if wide else "int32"
        cases = {
            f"sweep (K={FMA_K} table), {form}": merged_call(
                smem, lambda: smem.collect_smems_device(fmi, c, ln, fma=table,
                                                        **KW)),
            f"ERT (K={ERT_K}, depth {ERT_DEPTH}), {form}": merged_call(
                ops_ert, lambda: ops_ert.collect_smems_ert(
                    dert, fmi.ref, c, ln, pos_dtype=fmi.pos_dtype,
                    seq_len=2 * fmi.l_pac, **KW))}
        for label, (a, k) in cases.items():
            cpu = (types.SimpleNamespace(count=a[0].count.cpu()),
                   *(x.cpu() if isinstance(x, torch.Tensor) else
                     {f: v.cpu() for f, v in x.items()}
                     if isinstance(x, dict) else x for x in a[1:]))
            want = smem.smems_seed_strategy_merged(*cpu, **k)
            want_steps = smem.strategy_chase.last_steps
            ops = {}
            for v, fn in versions.items():
                got = fn(*a, **k)
                torch.cuda.synchronize()
                if not all(torch.equal(x.cpu(), y) for x, y in zip(got,
                                                                   want)):
                    raise SystemExit(f"{label}: {v} != plain")
                if not torch.equal(steps_of[v]().cpu(), want_steps):
                    raise SystemExit(f"{label}: {v}'s steps != plain's")
                ops[v] = outer_ops(lambda: fn(*a, **k))
            ms = {v: [0.0, 0.0] for v in versions}
            for v in list(versions) + list(versions)[::-1]:
                fn = versions[v]
                ms[v][0] += device_ms(lambda: fn(*a, **k), 20, dev) / 2
                ms[v][1] += synced_ms(lambda: fn(*a, **k)) / 2
            B, P = a[3]["E"].shape
            print(f"[merged] {label}: B={B}, L={a[1].shape[1]}, P={P}, "
                  f"max_out={a[6]}; the longest read's chase steps "
                  f"{int(want_steps.max())}, {int(want_steps.sum())} in "
                  f"all; equal to plain, steps too; device ms / host wall "
                  f"ms of a synchronised call / outer aten ops: "
                  + "; ".join(f"{v} {ms[v][0]:.5f} / {ms[v][1]:.5f} / "
                              f"{ops[v]}" for v in versions)
                  + f" (means of 2 turns)  [{card}]", flush=True)
        del dert, fmi, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
