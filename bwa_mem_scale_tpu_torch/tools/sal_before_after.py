"""The SA lookup stage (expand_and_lookup) against an earlier checkout's,
in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.sal_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``) and builds its own ``csrc/smem.cu`` into its own
``build/``: its ``ops/sal.py::expand_and_lookup`` is that checkout's whole
stage (before csrc/sal.cu: tensor glue around one ``sa_walk_kernel``
launch). Both take the same arguments.

Batches (``tools/batches.py``): chip_smoke.py phase 5's (512 reads of the
4.6 Mbp cell) and its repeat batch. Each goes through
``seed_chain_extend`` once on the one-hot engine, and its
``expand_and_lookup`` call is taken as made (512 coordinates a read, the
flat list of 16,384). Then phase 5's call with its SMEM records repeated
to 8,192 and 65,536 reads (a batch that ``-K`` makes; the flat list
grows with it). Both versions are first held equal to this
checkout's plain version (``expand_and_lookup_plain``) on all five
arrays, every slot, with each lane's walk steps equal; then timed in
turns (before, after, after, before): the device time of a call
(``tools/timing.py::device_ms``) and the host wall of one synchronised
call (the glue's cost is host dispatch, which device time misses), each
the mean of 2 turns, and the outermost aten operations a call issues
(``tools/glue_ops.py::outer_ops``). Each line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import sal, sal_cuda
from ..ops.chain import DeviceBns
from ..ops.occ import DeviceFMIndex
from ..ops.smem import SmemBuf
from ..pipeline import align
from .batches import repeat_batch, se_batch
from .glue_ops import outer_ops
from .probe_before_after import load_before
from .timing import card_line, device_ms, wall_ms

NAMES = ("rbeg", "seed_idx", "coord_valid", "total", "overflow")


def stage_call(idx, codes, lens, dev) -> tuple:
    """(args, kw without stats) of the batch's expand_and_lookup call as
    ``seed_chain_extend`` makes it."""
    fmi = DeviceFMIndex.from_host(idx, dev)
    dbns = DeviceBns.from_host(idx.bns, dev)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    real, calls = align.expand_and_lookup, []

    def record(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != "stats"}))
        return real(*args, **kw)

    align.expand_and_lookup = record
    try:
        align.seed_chain_extend(fmi, dbns, c, ln, c.shape[1],
                                opt=MemOptions(),
                                cfg=align.PipelineConfig(seed_engine="onehot"))
    finally:
        align.expand_and_lookup = real
    return calls[0]


def tiled(call, reads: int) -> tuple:
    """The call with its SMEM records repeated to `reads` reads."""
    (fmi, smems, *rest), kw = call
    reps = reads // smems.m.shape[0]
    return (fmi, SmemBuf(*(f.repeat(reps, *[1] * (f.dim() - 1))
                           for f in smems)), *rest), kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.sal_before_after",
        description="Time the SA lookup stage against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old_sal = importlib.import_module("probe_before.ops.sal")
    old_walk = importlib.import_module("probe_before.ops.smem_cuda")
    old_walk.build(force=True)
    sal_cuda.build(force=True)
    versions = {"before": old_sal.expand_and_lookup,
                "after": sal.expand_and_lookup}
    se = stage_call(*se_batch(), dev)
    for label, call in (("4.6 Mbp batch", se),
                        ("repeat batch", stage_call(*repeat_batch(), dev)),
                        ("4.6 Mbp batch x 16", tiled(se, 8192)),
                        ("4.6 Mbp batch x 128", tiled(se, 65536))):
        a, kw = call
        want = sal.expand_and_lookup_plain(*a, **kw)
        for v, fn in versions.items():
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            bad = [n for n, x, y in zip(NAMES, got, want)
                   if not torch.equal(x, y)]
            if bad:
                raise SystemExit(f"{label}: {v} != plain in {bad}")
        steps = sal_cuda.expand_and_lookup_cuda.last_steps
        if not torch.equal(old_walk.sa_walk_cuda.last_steps, steps):
            raise SystemExit(f"{label}: the walks' steps differ")
        ms = {v: {"device": 0.0, "wall": 0.0} for v in versions}
        for v in [*versions, *reversed(versions)]:
            thunk = (lambda fn: lambda: fn(*a, **kw))(versions[v])
            ms[v]["device"] += device_ms(thunk, 20, dev) / 2
            ms[v]["wall"] += wall_ms(thunk) / 2
        ops = {v: outer_ops(lambda fn=fn: fn(*a, **kw))
               for v, fn in versions.items()}
        B, C = want[0].shape
        print(f"[sal] {label}: B={B}, C={C}, {int(want[3].sum())} "
              f"coordinates, {int((steps > 0).sum())} walked of "
              f"{steps.numel()} lanes, {int(steps.sum())} walk steps (the "
              f"longest {int(steps.max())}); equal to plain, the steps "
              f"equal; device time before {ms['before']['device']:.5f} ms, "
              f"after {ms['after']['device']:.5f} ms; a synchronised "
              f"call's host wall before {ms['before']['wall']:.5f} ms, "
              f"after {ms['after']['wall']:.5f} ms (means of 2 turns); "
              f"outer aten operations before {ops['before']}, after "
              f"{ops['after']}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
