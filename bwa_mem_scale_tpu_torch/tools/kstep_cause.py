"""Where the k-step forms of SMEM passes 1-3 (csrc/smem.cu
one_pos_kernel<.., KS, int>, seed_strategy_kernel<2, int>) of an earlier
checkout lose their time, measured on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \\
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.kstep_cause build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, as ``probe_before``) and builds
its own ``csrc/smem.cu``. Beside it the tool builds patched copies of
that checkout's ``csrc/smem.cu`` and its headers under
``build/torch_kernels/kstep_cause/`` (it stops if a line it patches is
not found exactly once), each run through the earlier wrappers with the
copy's library in place of theirs:
- "forward alone": every task's interval stack emptied after its forward
  walk, so no backward round runs (timing only: no emission);
- "backward on group 0": the backward rounds' 1-step ext reading group
  0 of the k-gram row (the 1-step row inside it) in place of
  ``cp_fused``'s row, so that a k-step launch reads one table (equal
  arrays: held to the plain version);
- "pass 3, one base's loads": pass 3's fetch loading the first base's
  groups only (timing only: the second step's values are zeros, so the
  walks differ; its rounds are printed beside it).

Measured, each line with the card's name and power limit:
- one dependent load (``round_cost.trip_turns``, probe B's chain over a
  table in one cycle; the median of the turns, the turns beside it)
  over 287,501 rows of 32 bytes (9.2 MB, the 4.6 Mbp 1-step table), and
  over the K = 2 and K = 3 k-gram tables' footprints (160 and 672 bytes a
  row of 32 positions: 46.0 and 193.2 MB);
- on chip_smoke.py phase 5's batch and the repeat batch
  (``tools/batches.py``), at the K = 2 and K = 3 tables, passes 1 and 2
  as ``collect_smems_oh`` makes them at depth 24
  (``smem_before_after.passes``): the earlier launch, "forward alone" and
  "backward on group 0" in turns, with the longest task's rounds split
  into forward and backward (the forward-alone copy's rounds), and the
  1-step form on the same inputs;
- pass 3 at the K = 2 table: the earlier launch at 4, 8, 16 and 32 reads
  a warp, and "one base's loads" at 8, with each one's longest rounds.
Device time of a wrapper call (``tools/timing.py::device_ms``), means of
2 turns.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import os
import re
import shutil
import sys

import numpy as np
import torch

from ..config import MemOptions
from ..device import resolve_device
from ..index.kstep import build_cp2
from ..ops import nvcc_build
from ..ops.occ import DeviceFMIndex
from ..ops.smem_oh import one_pos_machine, seed_strategy_machine
from .batches import repeat_batch, se_batch
from .probe_before_after import in_turns, load_before
from .round_cost import trip_turns
from .smem_before_after import FIELDS, passes
from .timing import card_line, device_ms

L2_ROWS = 287_501                 # the 4.6 Mbp checkpoint table's rows
ROW_BYTES = {2: 160, 3: 672}      # a k-gram row of 32 positions
P3_READS = (4, 8, 16, 32)
HEADERS = ("fmi_step.cuh", "one_pos_task.cuh", "sal_walk.cuh")

# (file, the line as it stands, the line in the copy) of each variant
_PUSH = "    if (cs >= mi) push(wA, cA, ck, cl, cs, cn);\n"
_EXT = "          ext(f, e.x, e.y, e.z, a, nk, nl, ns);\n"
_P3 = ("      ext_k<2>(f, g, cl, ck, cs, ch, bk, bl, bs);  // the swapped "
       "interval\n")
PATCHES = {
    "forward alone": ("one_pos_task.cuh", _PUSH,
                      _PUSH + "    cA = 0;                // the forward walk "
                              "alone\n"),
    "backward on group 0": ("one_pos_task.cuh", _EXT, (
        "          if constexpr (KS > 1) {   // group 0 of the k-gram row\n"
        "            int c1[1] = {a}, k1[1], l1[1], s1[1];\n"
        "            ext_k<1>(f, g, e.x, e.y, e.z, c1, k1, l1, s1);\n"
        "            nk = k1[0]; nl = l1[0]; ns = s1[0];\n"
        "          } else {\n  " + _EXT + "          }\n")),
    "one base's loads": ("smem.cu", _P3,
                         _P3.replace("bs);", "bs, 1);")),
}


def variant_library(root: str, label: str, argtypes, host_fns,
                    patches: dict = PATCHES) -> nvcc_build.Library:
    """The csrc/smem.cu of the checkout at `root` with patches[label]
    applied, copied with its headers into a directory of its own."""
    name = "smem_" + re.sub(r"\W+", "_", label)
    out_dir = os.path.join(nvcc_build.BUILD_DIR, "kstep_cause", name)
    os.makedirs(out_dir, exist_ok=True)
    for f in ("smem.cu", *HEADERS):
        shutil.copy(os.path.join(root, "csrc", f), out_dir)
    fname, old, new = patches[label]
    path = os.path.join(out_dir, fname)
    with open(path) as f:
        src = f.read()
    src, n = re.subn(re.escape(old), lambda _: new, src)
    if n != 1:
        raise SystemExit(f"kstep_cause: {old.strip()!r} found {n} times in "
                         f"{root}'s csrc/{fname}")
    with open(path, "w") as f:
        f.write(src)
    return nvcc_build.Library(os.path.join(out_dir, "smem.cu"), name,
                              argtypes, host_fns)


def through(mod, lib, fn):
    """fn with `lib` in place of mod.LIB during the call (its counts and
    per-lane arrays stay on fn, ``__wrapped__``)."""
    def call(*a, **k):
        real = mod.LIB
        mod.LIB = lib
        try:
            return fn(*a, **k)
        finally:
            mod.LIB = real
    call.__wrapped__ = fn
    return call


def p3_launch(old, lib, a, R):
    """A thunk launching the earlier pass-3 k-step kernel of `lib` on args
    `a` at R reads a warp; the thunk's .out, .cnt and .rounds hold its
    outputs and each read's row fetches."""
    fmi, codes, lens, max_intv, min_seed_len, M = a
    B, L = codes.shape
    i32 = dict(dtype=torch.int32, device=codes.device)
    out = torch.empty((5, B, M), **i32)
    cnt, steps, rounds = (torch.empty((B,), **i32) for _ in range(3))
    args = [*old._fmi_args(fmi), *old._kstep_args(fmi, None),
            codes.data_ptr(), lens.data_ptr(), B, L, max_intv, min_seed_len,
            M, R, out.data_ptr(), cnt.data_ptr(), steps.data_ptr(),
            rounds.data_ptr()]

    def run():
        lib.launch(codes.device, "seed_strategy_launch_k", *args)
    run.rounds, run.out, run.cnt = rounds, out, cnt
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.kstep_cause",
        description="Measure where an earlier checkout's k-step seeding "
                    "kernels lose their time.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    before = os.path.abspath(args.before)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(before)                      # registers its package
    old = importlib.import_module("probe_before.ops.smem_cuda")
    libs = {label: variant_library(before, label, old.LIB.argtypes,
                                   old.LIB.host_fns) for label in PATCHES}
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as ex:
        list(ex.map(lambda lib: lib.build(force=True),
                    [old.LIB, *libs.values()]))
    trips = {"9.2 MB (the 1-step table)": L2_ROWS,
             **{f"{L2_ROWS * ROW_BYTES[K] / 1e6:.1f} MB (the K = {K} "
                f"table)": L2_ROWS * ROW_BYTES[K] // 32 for K in (2, 3)}}
    for what, rows in trips.items():
        tt = trip_turns(dev, rows)
        print(f"[trip] one dependent load over {rows} rows of 32 bytes, "
              f"{what}: {float(np.median(tt)):.4f} us (median; turns "
              f"{', '.join(f'{t:.4f}' for t in tt)})  [{card}]", flush=True)
    opt = MemOptions()
    one_pos = {"before": old.one_pos_machine_cuda,
               **{label: through(old, libs[label], old.one_pos_machine_cuda)
                  for label in ("forward alone", "backward on group 0")}}
    for batch, make in (("phase 5's batch", se_batch),
                        ("repeat batch", repeat_batch)):
        idx, codes, lens = make()
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        fmi1 = DeviceFMIndex.from_host(idx, dev)
        for K in (2, 3):
            fmi = DeviceFMIndex.from_host(idx, dev, cp2=build_cp2(idx, K))
            calls = passes(fmi, c, ln, opt)
            for what in ("pass 1", "pass 2"):
                _, a = calls[what]
                want = one_pos_machine(*a)
                rounds = {}
                for v, fn in one_pos.items():
                    got = fn(*a)
                    torch.cuda.synchronize()
                    if v != "forward alone" and not all(
                            torch.equal(getattr(got, f), getattr(want, f))
                            for f in FIELDS):
                        raise SystemExit(f"{batch} K={K} {what}: {v} != "
                                         f"plain")
                    rounds[v] = old.one_pos_machine_cuda.last_rounds.long()
                ms = in_turns(one_pos, {"call": lambda fn: lambda: fn(*a)},
                              dev)
                a1 = (fmi1, *a[1:])
                ms1 = device_ms(lambda: old.one_pos_machine_cuda(*a1), 20,
                                dev)
                r1 = int(old.one_pos_machine_cuda.last_rounds.max())
                top = int(rounds["before"].argmax())
                fw = int(rounds["forward alone"][top])
                tot = int(rounds["before"][top])
                t = {v: ms[v]["call"] for v in ms}
                print(f"[{what}] {batch}, K={K}: the longest task {tot} "
                      f"rounds ({fw} forward, {tot - fw} backward; the "
                      f"1-step form's longest {r1}); device ms: earlier "
                      f"{t['before']:.5f}, forward alone "
                      f"{t['forward alone']:.5f} (so backward "
                      f"{t['before'] - t['forward alone']:.5f}"
                      f"), backward on group 0 "
                      f"{t['backward on group 0']:.5f} (equal to "
                      f"plain); the 1-step form {ms1:.5f} (means of 2 "
                      f"turns)  [{card}]", flush=True)
            del fmi
            torch.cuda.empty_cache()
        fmi = DeviceFMIndex.from_host(idx, dev, cp2=build_cp2(idx, 2))
        _, a = passes(fmi, c, ln, opt)["pass 3"]
        want = seed_strategy_machine(*a)
        runs = {f"R={R}": p3_launch(old, old.LIB, a, R) for R in P3_READS}
        runs["one base's loads, R=8"] = p3_launch(
            old, libs["one base's loads"], a, 8)
        for label, run in runs.items():
            run()
            torch.cuda.synchronize()
            if label.startswith("R=") and not (
                    torch.equal(run.cnt, want.cnt) and all(
                        torch.equal(o, getattr(want, f))
                        for o, f in zip(run.out, FIELDS))):
                raise SystemExit(f"{batch} pass 3 {label} != plain")
        ms = in_turns(runs, {"call": lambda run: run}, dev)
        print(f"[pass 3] {batch}, K=2: device ms (the longest read's "
              f"rounds, us a round) " + ", ".join(
                  f"{label} {ms[label]['call']:.5f} ({int(run.rounds.max())}"
                  f", {ms[label]['call'] * 1e3 / int(run.rounds.max()):.4f})"
                  for label, run in runs.items())
              + f" (means of 2 turns; the last copy's walks differ, timing "
              f"only)  [{card}]", flush=True)
        del fmi
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
