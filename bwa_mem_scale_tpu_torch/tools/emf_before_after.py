"""The EMF probe's kernel (csrc/emf.cu emf_lookup_kernel) against an
earlier checkout's, in turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.emf_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/emf.cu`` into its own
``build/``; both launch through their ``ops/emf_cuda.py::launch`` on the
same table and reads.

Cases, like chip_smoke.py phase 11's: (a) 512 reads of 101 bp (seed 8,
1% substitutions, half reverse-complemented) from phase 4's 4.6 Mbp
genome with its EMF table at -l 101, as the API's batch 0 probes them;
(b) the rescue batch (``tools/batches.py::rescue_batch``, -l 51), whose
reads reach the multi-location rescue. Each version is first held equal
to the plain version (``ops/emf.py::emf_lookup``) on all four arrays,
then timed in turns (forward, then backward): the device time of a call
with its allocations (``tools/timing.py::device_ms``) and the host wall
of one call followed by ``torch.cuda.synchronize()`` (mean of 50). Each
line carries the card's name and power limit and the dependent trips of
the longest read by this checkout's twin (``emf_lookup_twin``).
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..device import resolve_device
from ..index.build import build_index
from ..index.perfect import build_perfect_table
from ..models.aligner import demo_genome, simulate_reads
from ..ops import emf_cuda
from ..ops.emf import DeviceEmf, emf_lookup
from ..ops.occ import DeviceFMIndex
from .batches import rescue_batch
from .probe_before_after import load_before
from .strategy_before_after import synced_ms
from .timing import card_line, device_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.emf_before_after",
        description="Time the EMF probe's kernel against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.emf_cuda")
    old.LIB.build(force=True)
    emf_cuda.LIB.build(force=True)
    versions = {"before": old.launch, "after": emf_cuda.launch}
    bns = demo_genome(4_600_000, seed=7, n_contigs=1)
    idx = build_index(bns)
    codes, lens = simulate_reads(idx.bns, 512, 101, seed=8, err_rate=0.01)
    ridx, rcodes, rlens, _ = rescue_batch(51)
    for label, ix, seed_len, cc, ll in (
            ("(a) 4.6 Mbp, 512 reads, -l 101", idx, 101, codes, lens),
            ("(b) the rescue batch, -l 51", ridx, 51, rcodes, rlens)):
        demf = DeviceEmf.from_host(build_perfect_table(ix, seed_len=seed_len),
                                   dev)
        ref = DeviceFMIndex.from_host(ix, dev).ref
        c = torch.as_tensor(cc, device=dev)
        ln = torch.as_tensor(ll, device=dev)
        want = emf_lookup(demf, ref, c, ln)
        for v, fn in versions.items():
            got = fn(demf, ref, c, ln)
            torch.cuda.synchronize()
            if not all(torch.equal(got[k], want[k]) for k in want):
                raise SystemExit(f"{label}: {v} != plain")
        tw = emf_cuda.emf_lookup_twin(demf, ref, c, ln)
        placed = tw["code"] >= 3
        ms = {v: [0.0, 0.0] for v in versions}
        for v in list(versions) + list(versions)[::-1]:
            fn = versions[v]
            ms[v][0] += device_ms(lambda: fn(demf, ref, c, ln), 20, dev) / 2
            ms[v][1] += synced_ms(lambda: fn(demf, ref, c, ln)) / 2
        print(f"[emf] {label}: B={c.shape[0]}, L={c.shape[1]}, max_probe "
              f"{demf.max_probe}; {int(placed.sum())} reads placed; the "
              f"longest read's dependent trips (twin) {int(tw['trips'].max())}"
              f"; every version equal to plain; device ms / host wall ms of "
              f"a synchronised call: "
              + "; ".join(f"{v} {ms[v][0]:.5f} / {ms[v][1]:.5f}"
                          for v in versions)
              + f" (means of 2 turns)  [{card}]", flush=True)
        del demf, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
