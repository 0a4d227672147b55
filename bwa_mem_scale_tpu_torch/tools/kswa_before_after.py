"""The rescue SW kernel (csrc/kswa.cu) against an earlier checkout's, in
turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.kswa_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/kswa.cu`` into its own
``build/``. Its ``launch`` takes the same arguments as this checkout's.

Cases: (a) the rescue calls of the Python PE path (BWA_TPU_NO_NATIVE_PE
and BWA_TPU_NO_NATIVE_KSWA, the rescue SW on the card) on chip_smoke.py
phase 15's 512 pairs with seedless mates (``tools/batches.py::
rescue_pairs``) on phase 4's genome, through ``GpuAligner``'s PE stages
two batches of 256 pairs as ``mem --batch-reads 512`` runs them: each
call; (b) one synthetic job, a 128-column query against 1,024 and 2,048
target rows (the query a prefix of the target, so the reverse scan is
the same at both lengths), whose difference over 1,024 rows is a row
step of the earlier design and a row of this one's wavefront, ROWS rows
a step (chip_smoke.py's ``row_step_us``). Every
version is first held equal to the plain version on every output, then
timed in turns (before, after, after, before): the device time of a
``launch`` call, its allocations included (``tools/timing.py::
device_ms``). Each line carries the card's name and power limit, the
call's jobs and shape and this design's longest job's steps (both
scans).
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np
import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import kswa_cuda
from ..ops.kswa import ksw_align_batch
from ..pipeline.align import GpuAligner, PipelineConfig
from .batches import rescue_pairs, se_batch
from .probe_before_after import in_turns, load_before
from .timing import card_line

SWITCHES = ("BWA_TPU_NO_NATIVE_PE", "BWA_TPU_NO_NATIVE_KSWA")
PAIRS_A_BATCH = 256


def rescue_calls(al, codes):
    """The rescue SW calls (their arguments) of the pairs' PE stages, a
    batch of PAIRS_A_BATCH pairs at a time, under SWITCHES."""
    calls, real = [], kswa_cuda.ksw_align_batch_cuda
    kswa_cuda.ksw_align_batch_cuda = lambda *a: calls.append(a) or real(*a)
    os.environ.update({k: "1" for k in SWITCHES})
    try:
        for i in range(0, codes.shape[0], 2 * PAIRS_A_BATCH):
            c = codes[i:i + 2 * PAIRS_A_BATCH]
            ln = np.full(c.shape[0], c.shape[1], np.int32)
            al.pe_post(al.fetch_pairs(al.dispatch_pairs(c, ln)))
    finally:
        for k in SWITCHES:
            del os.environ[k]
        kswa_cuda.ksw_align_batch_cuda = real
    return calls


def row_step_args(dev, n, opt):
    """chip_smoke.py row_step_us's kswa job of n target rows."""
    s = np.random.RandomState(5).randint(0, 4, 2048)[:n].astype(np.int32)
    return (*(torch.as_tensor(x, device=dev) for x in (
        s[:128][None].copy(), np.array([128], np.int32), s[None],
        np.array([n], np.int32))), opt.mat, opt.o_del, opt.e_del,
        opt.o_ins, opt.e_ins, opt.min_seed_len * opt.a, int(opt.mat.max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.kswa_before_after",
        description="Time the rescue SW kernel against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.kswa_cuda")
    old.LIB.build(force=True)
    kswa_cuda.LIB.build(force=True)
    opt = MemOptions()
    idx, _, _ = se_batch()
    al = GpuAligner(idx, dev, opt, PipelineConfig())
    calls = rescue_calls(al, rescue_pairs(idx.bns))
    cases = {f"(a) rescue call {i + 1} of {len(calls)}": (
        *a[:4], opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.min_seed_len * opt.a, int(opt.mat.max()))
        for i, a in enumerate(calls)}
    for n in (1024, 2048):
        cases[f"(b) row step, {n} rows"] = row_step_args(dev, n, opt)
    versions = {"before": old.launch, "after": kswa_cuda.launch}
    rows = {}
    for label, a in cases.items():
        want = ksw_align_batch(*a)
        for v, fn in versions.items():
            got = fn(*a)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"{label}: {v} != plain")
        steps = kswa_cuda.ksw_align_batch_cuda.last_steps   # after's
        ms = in_turns(versions, {"call": lambda fn: lambda: fn(*a)}, dev)
        rows[label] = {v: ms[v]["call"] for v in versions}
        J, L = a[0].shape
        print(f"[kswa] {label}: {int((a[1] > 0).sum())} jobs (J={J}, L={L}, "
              f"T={a[2].shape[1]}, K={kswa_cuda.k_for(L)}), the longest "
              f"job's steps {int(steps.max())} (both scans; "
              f"{int(torch.clamp(a[3], 0, a[2].shape[1]).max())} target "
              f"rows); equal to plain; device time before "
              f"{rows[label]['before']:.5f} ms, after "
              f"{rows[label]['after']:.5f} ms (mean of 2 turns)  [{card}]",
              flush=True)
    a, b = rows["(b) row step, 1024 rows"], rows["(b) row step, 2048 rows"]
    after = (b['after'] - a['after']) * 1e3 / 1024
    print("[kswa] (b) a row (1,024 more rows' time over 1,024): before "
          f"{(b['before'] - a['before']) * 1e3 / 1024:.4f} us (a row "
          f"step), after {after:.4f} us (a wavefront step of "
          f"{kswa_cuda.ROWS} rows {after * kswa_cuda.ROWS:.4f} us)  "
          f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
