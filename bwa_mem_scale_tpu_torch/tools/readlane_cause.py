"""What holds a thread-a-worker-lane readlane kernel back, measured once
on one card against a checkout that has that design (csrc/readlane.cu
before the warp-a-lane redesign, e.g. commit b4baf26).

    git archive <commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.readlane_cause build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded as
``probe_before`` (``probe_before_after.load_before``). Its
``csrc/readlane.cu`` is built as it is and in variants written beside it,
each a few lines changed (the tool stops if a line to change is not
found exactly once):
- ``N lanes a warp``: N worker lanes (threads) a block instead of 32, so
  each warp runs N live lanes and a 512-task pass spreads over 512 / N
  SMs;
- ``stacks in shared``: each lane's two interval stacks in its block's
  dynamic shared memory instead of the device scratch, so a backward
  tick's entry load is a shared-memory load, not an L2 trip before the
  occ step.
It prints ptxas's registers and spill bytes of every kernel form of
every build (``-Xptxas -v``), then, on chip_smoke.py phase 5's batch
(``tools/batches.py``: 512 reads of the 4.6 Mbp cell, K = 1, int32), the
device time of passes 1 and 2 at one lane a task and at 64 lanes, and of
pass 3, for each build in turns (``probe_before_after.in_turns``), each
first held equal to the plain machine on every array. Beside them, this
checkout's ``one_pos_kernel`` and ``seed_strategy_kernel``
(``csrc/smem.cu``) on the same tasks at full depth. Each line carries
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import os
import re
import sys

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import nvcc_build, smem_cuda
from ..ops.occ import DeviceFMIndex
from ..ops.smem import reseed_tasks
from ..ops.smem_rl import one_pos_machine, seed_strategy_machine
from .batches import se_batch
from .probe_before_after import in_turns, load_before
from .timing import card_line, device_ms

FIELDS = ("m", "n", "k", "l", "s", "cnt")
# the builds: (label, lanes a warp, stacks in shared memory)
VARIANTS = (("32 lanes a warp (the design)", 32, False),
            ("8 lanes a warp", 8, False),
            ("4 lanes a warp", 4, False),
            ("32 lanes a warp, stacks in shared", 32, True),
            ("8 lanes a warp, stacks in shared", 8, True))
LANES = (None, 64)

_STACK = "  RlEnt<P>* const st = stk + (size_t)lane * 2 * (L + 1);\n"
_STACK_SHARED = (
    "  extern __shared__ int4 rl_smem[];\n"
    "  RlEnt<P>* const st = reinterpret_cast<RlEnt<P>*>(rl_smem)\n"
    "                       + (size_t)threadIdx.x * 2 * (L + 1);\n")
_LAUNCH = re.compile(r"  readlane_one_pos_kernel<KS, P><<<\(T \+ RL_THREADS "
                     r"- 1\) / RL_THREADS,\s+RL_THREADS, 0, ")
_LAUNCH_SHARED = (
    "  const size_t rl_bytes = (size_t)RL_THREADS * 2 * (L + 1)\n"
    "                          * sizeof(RlEnt<P>);\n"
    "  if (rl_bytes > 49152)\n"
    "    cudaFuncSetAttribute(readlane_one_pos_kernel<KS, P>,\n"
    "                         cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
    "                         (int)rl_bytes);\n"
    "  readlane_one_pos_kernel<KS, P><<<(T + RL_THREADS - 1) / RL_THREADS,\n"
    "                                   RL_THREADS, rl_bytes, ")


def _once(src: str, old, new: str) -> str:
    """src with `old` (a string or a compiled pattern) replaced, where it
    occurs exactly once."""
    pat = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
    out, n = pat.subn(lambda _: new, src)
    if n != 1:
        raise SystemExit(f"readlane_cause: {pat.pattern!r} found {n} times "
                         f"in the earlier csrc/readlane.cu")
    return out


def variant_source(src: str, lanes_a_warp: int, shared: bool) -> str:
    """The earlier csrc/readlane.cu with `lanes_a_warp` threads a block
    and, with `shared`, the stacks in dynamic shared memory."""
    src = _once(src, "constexpr int RL_THREADS = 32;",
                f"constexpr int RL_THREADS = {lanes_a_warp};")
    if shared:
        src = _once(src, _STACK, _STACK_SHARED)
        src = _once(src, _LAUNCH, _LAUNCH_SHARED)
    return src


def passes(fmi, codes, lens, opt):
    """{pass: (wrapper kind, args, keyword args)} of one batch as
    collect_smems_rl makes them at full depth."""
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
        prog="python -m bwa_mem_scale_tpu_torch.tools.readlane_cause",
        description="Measure what holds the thread-a-lane readlane "
                    "kernel back.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                 # registers its package
    old = importlib.import_module("probe_before.ops.smem_rl_cuda")
    old_build = importlib.import_module("probe_before.ops.nvcc_build")
    with open(old.LIB.source) as f:
        src = f.read()
    libs = {}
    for label, n, shared in VARIANTS:
        tag = f"w{n}{'s' if shared else ''}"
        path = os.path.join(os.path.dirname(old.LIB.source),
                            f"readlane_{tag}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, n, shared))
        libs[label] = old_build.Library(path, f"readlane_{tag}",
                                        old.LIB.argtypes)
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        list(pool.map(lambda lib: lib.build(force=True),
                      [*libs.values(), smem_cuda.LIB]))
    reports = [(label, old_build.REPORTS[lib.name], ("readlane",))
               for label, lib in libs.items()]
    reports.append(("csrc/smem.cu", nvcc_build.REPORTS[smem_cuda.LIB.name],
                    ("one_pos_kernel", "seed_strategy_kernel")))
    for label, report, names in reports:
        for fn, (regs, spill) in sorted(
                nvcc_build.ptxas_kernels(report).items()):
            if any(n in fn for n in names):
                print(f"[ptxas] {label}: {fn}: {regs} registers, {spill} "
                      f"bytes spilled", flush=True)

    opt = MemOptions()
    idx, codes, lens = se_batch()
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    fmi = DeviceFMIndex.from_host(idx, dev)
    wrappers = {"one_pos": (one_pos_machine, old.readlane_one_pos_cuda),
                "p3": (seed_strategy_machine, old.readlane_strategy_cuda)}

    def call(lib, fn, a, kw):
        old.LIB = lib
        return fn(*a, **kw)

    for what, (kind, a, kw) in passes(fmi, c, ln, opt).items():
        plain, fn = wrappers[kind]
        want = plain(*a, **kw)
        for lanes in LANES:
            kl = dict(kw, lanes=lanes)
            for label, lib in libs.items():
                got = call(lib, fn, a, kl)
                torch.cuda.synchronize()
                if not all(torch.equal(getattr(got, f), getattr(want, f))
                           for f in FIELDS):
                    raise SystemExit(f"{what}, lanes {lanes}, {label}: != "
                                     f"plain")
            ms = in_turns(libs, {"call": lambda lib: lambda: call(
                lib, fn, a, kl)}, dev)
            steps = fn.last_steps
            for label in libs:
                print(f"[{what}] lanes {lanes or len(steps)}, {label}: "
                      f"{ms[label]['call']:.5f} ms (mean of 2 turns; the "
                      f"longest lane {int(steps.max())} steps, "
                      f"{int(steps.sum())} in all)  [{card}]", flush=True)
        if kind == "one_pos":
            ref = lambda: smem_cuda.one_pos_machine_cuda(*a,
                                                         stack_depth=a[9])
        else:
            ref = lambda: smem_cuda.seed_strategy_machine_cuda(*a)
        got = ref()
        if not all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in FIELDS):
            raise SystemExit(f"{what}: csrc/smem.cu's kernel != plain")
        ms = sum(device_ms(ref, 20, dev) for _ in range(2)) / 2
        print(f"[{what}] csrc/smem.cu's kernel on the same tasks at full "
              f"depth: {ms:.5f} ms (mean of 2)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
