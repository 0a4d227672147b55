"""The k-step forms of the seeding kernels against an earlier checkout's,
in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc native \\
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.kstep_before_after build/before
    python -m bwa_mem_scale_tpu_torch.tools.kstep_before_after build/before \\
        --mem 3

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, as ``probe_before``) and builds
its own ``csrc/smem.cu``, ``csrc/readlane.cu`` and ``csrc/sweep.cu``;
its wrappers take the same arguments as this checkout's.

On chip_smoke.py phase 5's batch and the repeat batch
(``tools/batches.py``), at the K = 2 and K = 3 k-gram tables
(``index/kstep.py``):
- passes 1 and 2 (``one_pos_machine_cuda``) and pass 3
  (``seed_strategy_machine_cuda``) as ``collect_smems_oh`` makes them at
  depth 24 (``smem_before_after.passes``), passes 1-2 also with every
  backward round in its chunked 1-step form (a copy of this checkout's
  ``csrc/`` under ``build/torch_kernels/kstep_cause/``, patched by
  ``kstep_cause.variant_library``; the same arrays);
- the readlane engine's passes (``smem_rl_cuda``) at full depth, at one
  lane a task and pools of 256 and 64 lanes
  (``readlane_before_after.passes``);
- at the K = 2 table, the sweep's two pass launches
  (``sweep_cuda.sweep_pass_cuda``) as ``collect_smems_device`` makes
  them without an FMA table.
ptxas's registers and spills of each checkout's seeding kernels come
first. Every version is first held equal to the plain version on every
array
(and passes 1-3 on each task's steps), then timed in turns (before,
after, after, before): the device time of a wrapper call, its output
allocation included (``tools/timing.py::device_ms``), the two turns
beside their mean (their spread). Beside the times:
the longest task's rounds (row fetches) of each version, and the 1-step
form's device time on the same inputs. Each line carries the card's
name and power limit.

With ``--mem RUNS``, instead, SE ``mem`` end to end in turns: chip_smoke.py
phase 4's genome and 10,000 reads (written under ``build/kstep_mem/``
with the index, the EMF table and both k-gram tables, by this checkout's
CLI), with no k-gram table and with the K = 2 and K = 3 tables, each
checkout's ``mem`` RUNS times a table, the checkouts' order swapped every
run. Each run is a process of its own in that checkout (``MEM_CHILD``):
one ``mem`` that builds and loads the kernels, then the timed ``mem``
(reads/s and index load, as chip_smoke.py phase 13 times it), then
``mem -v 4`` (its synchronised stage seconds). Every run's SAM body must
equal the first's. Prints each run, then each table's and checkout's
mean and range.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import cli
from ..config import MemOptions
from ..device import resolve_device
from ..index.kstep import build_cp2
from ..ops import nvcc_build, smem_cuda, smem_rl, smem_rl_cuda, sweep_cuda
from ..ops.occ import DeviceFMIndex
from ..ops.smem import sweep_pass_plain
from ..ops.smem_oh import one_pos_machine, seed_strategy_machine
from . import readlane_before_after, smem_before_after
from .batches import repeat_batch, se_batch
from .kstep_cause import through, variant_library
from .probe_before_after import load_before
from .sweep_before_after import pass_calls
from .timing import card_line, device_ms

FIELDS = ("m", "n", "k", "l", "s", "cnt")
# this checkout's csrc/smem.cu with every backward round in its chunked
# 1-step form (the same arrays), for the k-step rounds' share
_FUSED = "        if (cA <= WARP && cA <= SD) {\n"
ONE_STEP_BACK = {"after, 1-step backward rounds": (
    "one_pos_task.cuh", _FUSED, _FUSED.replace("if (", "if (false && "))}


def per_lane(fn, attr: str):
    """fn's per-lane `attr` of its last call (its wrapper's, for a call
    through another library)."""
    return getattr(getattr(fn, "__wrapped__", fn), attr)


def held(label, got, want, fn=None, steps=None):
    """Stop unless every field (and with `steps`, fn's steps) equals."""
    torch.cuda.synchronize()
    if not all(torch.equal(getattr(got, f), getattr(want, f))
               for f in FIELDS):
        raise SystemExit(f"{label} != plain")
    if steps is not None and not torch.equal(per_lane(fn, "last_steps"),
                                             steps):
        raise SystemExit(f"{label}: steps != plain's")


def turns(versions, call, dev) -> dict:
    """{version: (first turn, second turn)} device ms of call(fn) over 20
    calls, the versions forward, then backward."""
    names = list(versions)
    t = {v: [] for v in names}
    for v in names + names[::-1]:
        t[v].append(device_ms(lambda: call(versions[v]), 20, dev))
    return t


def shown(t) -> str:
    """A version's mean of its two turns, the turns beside it."""
    return f"{sum(t) / 2:.5f} [{t[0]:.5f}, {t[1]:.5f}]"


# one timed SE `mem` in a checkout (its package first on the path): a mem
# that builds and loads the kernels, the timed mem, then mem -v 4
MEM_CHILD = """
import json, sys, time
import torch
from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
argv = json.loads(sys.argv[1])
cli.mem(argv)
torch.cuda.synchronize()
PROFILER.totals.clear()
t = time.perf_counter()
a = cli.mem(argv)
torch.cuda.synchronize()
wall = time.perf_counter() - t
load = PROFILER.totals["index_load"]
sec = cli.mem(argv + ["-v", "4"]).prof.seconds
print(json.dumps({"wall": wall, "index_load": load,
                  "kstep": int(a.fmi.kstep), "seconds": {
                      k: sec[k] for k in ("seed", "sal", "chain", "bsw")}}))
"""
MEM_READS, MEM_LEN, MEM_BATCH = 10_000, 101, 512


def mem_inputs(root: str,
               tables=("none", "K=2", "K=3")) -> tuple[dict, str]:
    """chip_smoke.py phase 4's genome and reads under `root`, indexed by
    this checkout's CLI: ({table: prefix} for each of `tables` ("none",
    "K=2", "K=3"); the FASTQ)."""
    from ..index.bntseq import decode_bases
    from ..models.aligner import demo_genome, simulate_reads_with_truth
    os.makedirs(root, exist_ok=True)
    g, fq = os.path.join(root, "g"), os.path.join(root, "r.fq")
    bns = demo_genome(4_600_000, seed=7, n_contigs=1)
    seq = decode_bases(bns.seq)
    with open(g + ".fa", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    codes, _, _, _ = simulate_reads_with_truth(bns, MEM_READS, MEM_LEN,
                                               seed=8, err_rate=0.01)
    with open(fq, "w") as f:
        for i in range(MEM_READS):
            f.write(f"@r{i}\n{decode_bases(codes[i])}\n+\n"
                    f"{'I' * MEM_LEN}\n")
    prefixes = {"none": g}
    for argv in (["index", g + ".fa", "-p", g],
                 ["perfect-index", g, "-l", str(MEM_LEN)]):
        if cli.main(argv) != 0:
            raise SystemExit(f"cli {argv[0]} failed")
    for K in (K for K in (2, 3) if f"K={K}" in tables):
        p = prefixes[f"K={K}"] = os.path.join(root, f"k{K}")
        for ext in (".tpuidx.npz", f".emf{MEM_LEN}.npz"):
            if not os.path.exists(p + ext):
                os.symlink(g + ext, p + ext)
        if cli.main(["kstep-table", p, "-k", str(K)]) != 0:
            raise SystemExit(f"kstep-table -k {K} failed")
    return prefixes, fq


def sam_body(path: str) -> str:
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


def mem_turns(before: str, runs: int, card: str,
              tables=("none", "K=2", "K=3")) -> None:
    """SE `mem` with each of `tables`, each checkout RUNS times, in
    turns."""
    root = os.path.join(nvcc_build.REPO, "build", "kstep_mem")
    prefixes, fq = mem_inputs(root, tables)
    homes = {"before": os.path.abspath(before), "after": nvcc_build.REPO}
    got, want = {}, None
    for r in range(runs):
        for table, p in prefixes.items():
            order = list(homes) if r % 2 == 0 else list(homes)[::-1]
            for v in order:
                sam = os.path.join(root, f"{v}_{table[-1]}_{r}.sam")
                argv = [p, fq, "-o", sam, "--device", "cuda",
                        "--batch-reads", str(MEM_BATCH)]
                env = dict(os.environ, PYTHONPATH=homes[v])
                run = subprocess.run(
                    [sys.executable, "-c", MEM_CHILD, json.dumps(argv)],
                    cwd=homes[v], env=env, capture_output=True, text=True)
                if run.returncode:
                    raise SystemExit(f"mem {v}, table {table}, run {r + 1}:"
                                     f" exit {run.returncode}\n"
                                     f"{run.stderr[-4000:]}")
                one = json.loads(run.stdout.strip().splitlines()[-1])
                want = want if want is not None else sam_body(sam)
                if sam_body(sam) != want or one["kstep"] != (
                        1 if table == "none" else int(table[-1])):
                    raise SystemExit(f"mem {v}, table {table}, run {r + 1}:"
                                     f" the SAM body differs from the first "
                                     f"run's, or K {one['kstep']}")
                os.remove(sam)
                one["reads_s"] = MEM_READS / one["wall"]
                got.setdefault((table, v), []).append(one)
                s = one["seconds"]
                print(f"[mem] run {r + 1}, table {table}, {v}: "
                      f"{one['reads_s']:.1f} reads/s ({one['wall']:.3f} s, "
                      f"index load {one['index_load']:.3f} s); -v 4 stage s: "
                      + ", ".join(f"{k} {x:.4f}" for k, x in s.items())
                      + f"  [{card}]", flush=True)
    for (table, v), rs in got.items():
        rate = [x["reads_s"] for x in rs]
        col = lambda f: np.mean([f(x) for x in rs])
        print(f"[mem] table {table}, {v}: {np.mean(rate):.1f} reads/s "
              f"(runs {min(rate):.1f}-{max(rate):.1f}, {len(rs)}), index "
              f"load {col(lambda x: x['index_load']):.3f} s, the rest "
              f"{col(lambda x: x['wall'] - x['index_load']):.3f} s; -v 4 "
              f"seed {col(lambda x: x['seconds']['seed']):.4f} s, sal "
              f"{col(lambda x: x['seconds']['sal']):.4f}, chain "
              f"{col(lambda x: x['seconds']['chain']):.4f}, bsw "
              f"{col(lambda x: x['seconds']['bsw']):.4f} (means)  [{card}]",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.kstep_before_after",
        description="Time the k-step seeding kernels against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    ap.add_argument("--mem", type=int, default=0, metavar="RUNS",
                    help="instead, SE mem end to end in turns, RUNS runs "
                         "of each checkout a table")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    if args.mem:
        mem_turns(args.before, args.mem, card)
        return 0
    load_before(args.before)                # registers its package
    old = {m: importlib.import_module(f"probe_before.ops.{m}")
           for m in ("smem_cuda", "smem_rl_cuda", "sweep_cuda")}
    for lib in (*(m.LIB for m in old.values()), smem_cuda.LIB,
                smem_rl_cuda.LIB, sweep_cuda.LIB):
        lib.build(force=True)
    back1 = variant_library(nvcc_build.REPO, *ONE_STEP_BACK,
                            smem_cuda.LIB.argtypes, smem_cuda.LIB.host_fns,
                            ONE_STEP_BACK)
    back1.build(force=True)
    old_nvcc = importlib.import_module("probe_before.ops.nvcc_build")
    for v, mod in (("before", old_nvcc), ("after", nvcc_build)):
        for lib in ("smem_cuda", "readlane_cuda"):
            for fn, (regs, spill) in mod.ptxas_kernels(
                    mod.REPORTS[lib]).items():
                if "one_pos" in fn or "strategy" in fn:
                    name = re.sub(r"^_ZN12_GLOBAL__N_1", "", fn)
                    print(f"[ptxas] {v}: {name}: {regs} registers, {spill} "
                          f"bytes spilled", flush=True)
    opt = MemOptions()
    for batch, make in (("phase 5's batch", se_batch),
                        ("repeat batch", repeat_batch)):
        idx, codes, lens = make()
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        fmi1 = DeviceFMIndex.from_host(idx, dev)
        for K in (2, 3):
            fmi = DeviceFMIndex.from_host(idx, dev, cp2=build_cp2(idx, K))
            tag = f"{batch}, K={K}"
            # passes 1-3 of the one-hot engine at depth 24
            for what, (kind, a) in smem_before_after.passes(
                    fmi, c, ln, opt).items():
                name = ("one_pos_machine_cuda" if kind == "one_pos" else
                        "seed_strategy_machine_cuda")
                plain = (one_pos_machine if kind == "one_pos"
                         else seed_strategy_machine)
                want = plain(*a)
                steps = plain.last_steps.to(dev).int()
                versions = {"before": getattr(old["smem_cuda"], name),
                            "after": getattr(smem_cuda, name)}
                if kind == "one_pos":
                    versions[next(iter(ONE_STEP_BACK))] = through(
                        smem_cuda, back1, smem_cuda.one_pos_machine_cuda)
                rounds = {}
                for v, fn in versions.items():
                    held(f"{tag} {what} {v}", fn(*a), want, fn, steps)
                    rounds[v] = int(per_lane(fn, "last_rounds").max())
                ms = turns(versions, lambda fn: fn(*a), dev)
                one = getattr(smem_cuda, name)
                a1 = (fmi1, *a[1:])
                held(f"{tag} {what} 1-step", one(*a1), want)
                ms1 = device_ms(lambda: one(*a1), 20, dev)
                r1 = int(one.last_rounds.max())
                print(f"[{what}] {tag}: device ms [its two turns] (the "
                      f"longest task's rounds) " + ", ".join(
                          f"{v} {shown(ms[v])} ({rounds[v]})"
                          for v in versions)
                      + f"; the 1-step form {ms1:.5f} ({r1}); each equal to "
                      f"plain, steps too (means of 2 turns)  [{card}]",
                      flush=True)
            # the readlane engine at full depth
            for what, (kind, a, kw) in readlane_before_after.passes(
                    fmi, c, ln, opt).items():
                name = ("readlane_one_pos_cuda" if kind == "one_pos" else
                        "readlane_strategy_cuda")
                plain = (smem_rl.one_pos_machine if kind == "one_pos" else
                         smem_rl.seed_strategy_machine)
                want = plain(*a, **kw)
                versions = {"before": getattr(old["smem_rl_cuda"], name),
                            "after": getattr(smem_rl_cuda, name)}
                line = []
                for lanes in readlane_before_after.LANES:
                    kl = dict(kw, lanes=lanes)
                    ticks = {}
                    for v, fn in versions.items():
                        held(f"{tag} readlane {what} {v} lanes {lanes}",
                             fn(*a, **kl), want)
                        ticks[v] = int(fn.last_ticks.max())
                    ms = turns(versions, lambda fn: fn(*a, **kl), dev)
                    line.append(f"lanes {lanes}: " + ", ".join(
                        f"{v} {shown(ms[v])} ({ticks[v]})"
                        for v in versions))
                print(f"[readlane {what}] {tag}: device ms (the longest "
                      f"lane's ticks) " + "; ".join(line) + f"; each equal "
                      f"to plain (means of 2 turns)  [{card}]", flush=True)
            if K == 2:                              # the sweep's passes
                for n, (a, k) in enumerate(pass_calls(fmi, c, ln, None)):
                    want, _ = sweep_pass_plain(*a, **k)
                    versions = {"before": old["sweep_cuda"].sweep_pass_cuda,
                                "after": sweep_cuda.sweep_pass_cuda}
                    for v, fn in versions.items():
                        got, _ = fn(*a, **k)
                        held(f"{tag} sweep pass {n + 1} {v}", got, want)
                    ms = turns(versions, lambda fn: fn(*a, **k), dev)
                    print(f"[sweep pass {n + 1}] {tag}: device ms [its two "
                          f"turns] " + ", ".join(f"{v} {shown(ms[v])}"
                                                 for v in versions)
                          + f"; each equal to plain (means of 2 turns)  "
                          f"[{card}]", flush=True)
            del fmi
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
