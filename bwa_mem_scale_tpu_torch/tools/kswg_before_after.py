"""The CIGAR DP kernel (csrc/kswg.cu) against an earlier checkout's, in
turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.kswg_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/kswg.cu`` into its own
``build/``. Its wrapper takes the same arguments as this checkout's.

Cases, on chip_smoke.py phase 4's genome (``tools/batches.py::
se_batch``), each a CIGAR DP call that ``GpuAligner._records_from_regs``
makes under BWA_TPU_NO_NATIVE_KSWG: (a) phase 5's batch of 512 reads
(101 bp) and its first 39 jobs at P = 64 (the shape of phase 7's largest
Python-PE call); (b) 16 long reads of 800-2,500 bp, made as phase 15
makes them (seed 33, 1% substitutions), and the largest call of 512 such
reads (phase 10's kind, P in the hundreds); (c) one synthetic pair of
1,024 and of 2,048 rows at w = 15, whose difference over 1,024 rows is a
row step with its traceback step (chip_smoke.py's ``row_step_us``).
Besides the two checkouts' wrappers, "whole block" is this checkout's
kernel planned with a whole block's shared memory whatever P
(``block_budget`` at SMEM_BUDGET), as this design's first form sized it.
Every version is first held equal to the plain version on every output,
then timed in turns (forward, then backward): the device time of a
``launch`` call (w_max taken on the host once, as chip_smoke.py times
the kernel), its output allocation included (``tools/timing.py::
device_ms``). Each line carries the card's name and power limit.
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
from ..ops import kswg_cuda
from ..ops.kswg import ksw_global_batch
from ..pipeline.align import GpuAligner, PipelineConfig
from .batches import se_batch
from .probe_before_after import in_turns, load_before
from .timing import card_line

LONG_JOBS = (16, 800, 2500, 33)  # reads, shortest, longest, seed (phase 15)
MANY_LONG = (512, 800, 2500, 33)  # the same kind, 512 reads


def long_reads(fwd, n, lo, hi, seed):
    """chip_smoke.py's write_long_reads without the file: n reads of lo-hi
    bp from `fwd`, 1% substitutions, every second reverse-complemented."""
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    lens = rng.randint(lo, hi + 1, n)
    pos = np.array([rng.randint(0, len(fwd) - ln) for ln in lens])
    reads = []
    for i in range(n):
        s = fwd[pos[i]: pos[i] + lens[i]].copy()
        m = rng.rand(lens[i]) < 0.01
        s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
        reads.append(comp[s[::-1]] if i % 2 else s)
    return reads


def cigar_calls(al, reads):
    """The CIGAR DP calls (their arguments) of one batch of reads through
    the aligner, the DP on the card (BWA_TPU_NO_NATIVE_KSWG)."""
    L = max(len(r) for r in reads)
    c = np.full((len(reads), L), 4, np.int32)
    for i, r in enumerate(reads):
        c[i, :len(r)] = r
    ln = np.array([len(r) for r in reads], np.int32)
    regs = al.align_batch(c, ln)
    calls, real = [], kswg_cuda.ksw_global_batch_cuda
    kswg_cuda.ksw_global_batch_cuda = lambda *a: calls.append(a) or real(*a)
    os.environ["BWA_TPU_NO_NATIVE_KSWG"] = "1"
    try:
        al._records_from_regs(c, ln, np.ones(len(reads), bool), regs,
                              np.arange(len(reads)))
    finally:
        del os.environ["BWA_TPU_NO_NATIVE_KSWG"]
        kswg_cuda.ksw_global_batch_cuda = real
    return calls


def first_jobs(args, n, P):
    """The call's first n jobs padded to P pairs (length 0, w 1), as the
    finalizer pads a call."""
    out = []
    for x in args[:5]:
        y = torch.zeros((P,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        y[:n] = x[:n]
        out.append(y)
    out[4][n:] = 1
    return (*out, *args[5:])


def row_step_args(dev, n, opt):
    s = np.random.RandomState(5).randint(0, 4, 2048)[:n].astype(np.int32)
    return (*(torch.as_tensor(x, device=dev) for x in (
        s[None], np.array([n], np.int32), s[None], np.array([n], np.int32),
        np.array([15], np.int32))), opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, opt.mat)


def whole_block(*a):
    """kswg_cuda.launch planned with a whole block's shared memory."""
    real = kswg_cuda.block_budget
    kswg_cuda.block_budget = lambda *_: kswg_cuda.SMEM_BUDGET
    try:
        return kswg_cuda.launch(*a)
    finally:
        kswg_cuda.block_budget = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.kswg_before_after",
        description="Time the CIGAR DP kernel against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.kswg_cuda")
    old.LIB.build(force=True)
    kswg_cuda.LIB.build(force=True)
    opt = MemOptions()
    idx, codes, lens = se_batch()
    al = GpuAligner(idx, dev, opt, PipelineConfig(seed_engine="onehot"))
    se = cigar_calls(al, [c[:n] for c, n in zip(codes, lens)])
    fwd = np.asarray(idx.ref_string[: idx.bns.l_pac], np.uint8)
    lng = cigar_calls(al, long_reads(fwd, *LONG_JOBS))
    many = cigar_calls(al, long_reads(fwd, *MANY_LONG))
    big = max(se, key=lambda a: a[0].shape[0])
    cases = {"(a) phase 5's batch": big,
             "(a) its first 39 jobs, P=64": first_jobs(big, 39, 64),
             "(b) 16 long reads": max(lng, key=lambda a: a[0].numel()),
             "(b) 512 long reads, the largest call":
                 max(many, key=lambda a: a[0].numel())}
    for n in (1024, 2048):
        cases[f"(c) row step, {n} rows"] = row_step_args(dev, n, opt)
    # the launches alone, as chip_smoke.py times them: w_max from the
    # host, no synchronisation inside a call
    versions = {"before": old.launch, "after": kswg_cuda.launch,
                "whole block": whole_block}
    rows = {}
    for label, a in cases.items():
        want = ksw_global_batch(*a)
        w_max = int(a[4].max())
        for v, fn in versions.items():
            got = fn(*a, w_max)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"{label}: {v} != plain")
        ms = in_turns(versions,
                      {"call": lambda fn: lambda: fn(*a, w_max)}, dev)
        rows[label] = {v: ms[v]["call"] for v in versions}
        ql, tl, wp = (x.cpu().numpy() for x in (a[1], a[3], a[4]))
        R, S = kswg_cuda.strip(w_max, a[0].shape[1], a[2].shape[1])
        rest, zrb, zsb = kswg_cuda.launch_plan(dev, *a[0].shape,
                                               a[2].shape[1], w_max)
        print(f"[kswg] {label}: P={a[0].shape[0]} "
              f"({int(((ql > 0) & (tl > 0)).sum())} jobs), QL="
              f"{a[0].shape[1]}, TL={a[2].shape[1]}, "
              f"{int(kswg_cuda.band_cells(ql, tl, wp).sum())} band cells, "
              f"the longest pair {int(tl.max())} rows + "
              f"{int(want.n_ops.max())} traceback steps; the widest band's "
              f"strip {R} x {S}, its rows of directions "
              f"{'in tiles' if zrb else 'in shared memory'} ({rest} bytes "
              f"past the codes{', the state in global memory' if zsb else ''}"
              f"; {kswg_cuda.occupancy(dev)} SMs, blocks an SM); equal to "
              f"plain; device time before {rows[label]['before']:.5f} ms, "
              f"after {rows[label]['after']:.5f} ms, whole block "
              f"{rows[label]['whole block']:.5f} ms (mean of 2 turns)  "
              f"[{card}]", flush=True)
    a, b = rows["(c) row step, 1024 rows"], rows["(c) row step, 2048 rows"]
    print("[kswg] (c) a row step with its traceback step: before "
          f"{(b['before'] - a['before']) * 1e3 / 1024:.4f} us, after "
          f"{(b['after'] - a['after']) * 1e3 / 1024:.4f} us  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
