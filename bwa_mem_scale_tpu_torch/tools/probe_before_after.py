"""probe_B's and probe_E's kernels against an earlier checkout's, in
turns, on one card.

    git archive <earlier commit> | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.probe_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one, under the name ``probe_before``, and builds its own
``csrc/probes.cu`` into its own ``build/``. Its wrappers take the same
arguments as this checkout's.

Cases: chip_smoke.py phase 6's shapes (probe_b on the 4.6 Mbp occ table
[287,501, 8] with 4,096 lanes and 32 ticks; probe_e on the chr21-sized
table [2,875,001, 8] with 1,024 rows, 8 ticks and D = 16), probe_b on
the chr21-sized table too, and probe_e at T = 1,024 and 4,096 and D = 4,
16 and 64, and on the TPU probe's [2^20, 128] table (512-byte rows) at
T = 1,024. Every version is first held equal to the plain version, then
timed in turns (before, after, after, before): the device time of a call (``tools/timing.py::device_ms``), and beside it
probe_b's marginal tick (32 against 288 ticks) and probe_e's first tick
alone. Each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

import torch

from ..device import resolve_device
from ..ops import probe_kernels as pk
from .probe_cuda import OCC_W
from .probe_cuda_rates import (B_EXTRA_TICKS, B_TICKS, CHR21_OCC_ROWS,
                               E_TICKS, Run, b_inputs, e_inputs,
                               index_variants, random_table)
from .timing import card_line, device_ms

E_LANES = (1024, 4096)           # phase 6's T first
TPU_E_ROWS = 1 << 20             # the TPU probe_E's [2^20, 128] table


def load_before(root: str):
    """The earlier checkout's ops/probe_kernels module, as
    probe_before.ops.probe_kernels."""
    pkg = os.path.join(os.path.abspath(root), "bwa_mem_scale_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "probe_before", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["probe_before"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("probe_before.ops.probe_kernels")


def in_turns(versions, fns, dev) -> dict[str, dict[str, float]]:
    """{version: {what: device ms, mean of 2 turns}}; `fns` maps what to
    a function of the version's wrapper returning a thunk. Turns run the
    versions forward, then backward."""
    names = list(versions)
    ms = {v: {k: 0.0 for k in fns} for v in names}
    for v in names + names[::-1]:
        for k, make in fns.items():
            ms[v][k] += device_ms(make(versions[v]), 20, dev) / 2
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.probe_before_after",
        description="Time probe B and E against an earlier checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    run = Run(dev, card)
    old = load_before(args.before)
    old.build(force=True)
    pk.build(force=True)
    nt2 = B_TICKS + B_EXTRA_TICKS

    b_cases = [("4.6 Mbp table", *b_inputs(run))]
    chr21 = random_table(run, CHR21_OCC_ROWS, OCC_W, seed=5)
    b_cases.append(("chr21-sized table", chr21, index_variants(
        run, 4096, CHR21_OCC_ROWS, 9973, 131, 1)[0]))
    b_versions = {"before": old.probe_b, "after": pk.probe_b}
    for label, tab, idx in b_cases:
        want = pk.probe_b_plain(tab, idx, B_TICKS)
        for v, fn in b_versions.items():
            got = fn(tab, idx, B_TICKS)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"probe_b {v} != plain on the {label}")
        ms = in_turns(b_versions, {
            "call": lambda fn: lambda: fn(tab, idx, B_TICKS),
            "long": lambda fn: lambda: fn(tab, idx, nt2)}, dev)
        for v, r in ms.items():
            tick_us = (r["long"] - r["call"]) * 1e3 / (nt2 - B_TICKS)
            print(f"[probe_b {v}] {label} {list(tab.shape)}, T="
                  f"{idx.shape[0]}, {B_TICKS} ticks: equal to plain; device "
                  f"time {r['call']:.5f} ms a call, marginal tick "
                  f"{tick_us:.4f} us ({nt2} ticks {r['long']:.5f} ms; mean "
                  f"of 2 turns)  [{card}]", flush=True)

    tab8, idx1024 = e_inputs(run)
    tab128 = random_table(run, TPU_E_ROWS, 128, seed=TPU_E_ROWS + 1)
    e_versions = {"before": old.probe_e, "after": pk.probe_e}
    for tab, T in [(tab8, t) for t in E_LANES] + [(tab128, 1024)]:
        idx = idx1024 if tab is tab8 and T == 1024 else index_variants(
            run, T, tab.shape[0], 999983, 771, 1)[0]
        want = pk.probe_e_plain(idx, tab, E_TICKS)
        for depth in pk.DEPTHS:
            for v, fn in e_versions.items():
                got = fn(idx, tab, E_TICKS, depth)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"probe_e {v} != plain at T={T} "
                                     f"D={depth}")
            ms = in_turns(e_versions, {
                "call": lambda fn: lambda: fn(idx, tab, E_TICKS, depth),
                "first": lambda fn: lambda: fn(idx, tab, 1, depth)}, dev)
            for v, r in ms.items():
                print(f"[probe_e {v}] {list(tab.shape)}, T={T}, {E_TICKS} "
                      f"ticks, D={depth}: equal to plain; device time "
                      f"{r['call']:.5f} ms a call, the first tick alone "
                      f"{r['first']:.5f} ms (mean of 2 turns)  [{card}]",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
