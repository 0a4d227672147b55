"""The ERT descent kernel (csrc/ert.cu) against an earlier checkout's, in
turns, on one card.

    git archive <earlier commit> bwa_mem_scale_tpu_torch csrc \
        | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.ert_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one (``probe_before_after.load_before``, under the name
``probe_before``), and builds its own ``csrc/ert.cu`` into its own
``build/``. Its wrapper takes the same arguments as this checkout's.

Cases, as chip_smoke.py phase 12 makes them: the trie of `ert-index`'s
defaults (K = 12, depth 320) on (a) phase 4's genome with phase 5's
batch (``tools/batches.py::se_batch``), (b) the depth-cap batch (512 x
400 bp, ``depth_cap_batch``), (c) (a) at the int64 layout; each batch's
two descent launches (pass 1 merged with pass 3, then the reseed) as
``collect_smems_ert`` makes them. Every version is first held equal to
the plain version on every output and on each lane's node and leaf
steps, then timed in turns (before, after, after, before): the device
time of a wrapper call, its output allocation included
(``tools/timing.py::device_ms``). Each line carries the card's name and
power limit and the launch's steps: the longest lane's node steps and
leaf steps, and its leaf words (16 leaf steps a word).
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from ..device import resolve_device
from ..index.ert import build_ert_from_index
from ..ops import ert as ops_ert, ert_cuda
from ..ops.occ import DeviceFMIndex
from .batches import depth_cap_batch, se_batch
from .probe_before_after import in_turns, load_before
from .timing import card_line

ERT_K, ERT_DEPTH = 12, 320      # ert-index's defaults (chip_smoke phase 12)


def descent_calls(dert, fmi, codes, lens):
    """The two descent calls (arguments, keyword arguments) that
    collect_smems_ert makes on one batch, at chip_smoke.py phase 12's
    options, the kernel launched."""
    kw = dict(min_seed_len=19, split_len=28, split_width=10,
              max_mem_intv=20, pos_dtype=fmi.pos_dtype,
              seq_len=2 * fmi.l_pac)
    name = "ert_extend_all_positions_cuda"
    real, calls = getattr(ert_cuda, name), []

    def record(*args, **k):
        calls.append((args, k))
        return real(*args, **k)

    setattr(ert_cuda, name, record)
    try:
        ops_ert.collect_smems_ert(dert, fmi.ref, codes, lens, **kw)
    finally:
        setattr(ert_cuda, name, real)
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.ert_before_after",
        description="Time the ERT descent kernel against an earlier "
                    "checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    load_before(args.before)                # registers its package
    old = importlib.import_module("probe_before.ops.ert_cuda")
    old.LIB.build(force=True)
    ert_cuda.LIB.build(force=True)
    versions = {"before": old.ert_extend_all_positions_cuda,
                "after": ert_cuda.ert_extend_all_positions_cuda}
    plain = ops_ert.ert_extend_all_positions
    made = {}                       # each batch's index, reads and trie
    for label, make, wide in (("(a) phase 5's batch", se_batch, False),
                              ("(b) depth-cap batch", depth_cap_batch, False),
                              ("(c) phase 5's batch, int64", se_batch, True)):
        if make not in made:
            idx, codes, lens = (make(sa_compx=0) if make is se_batch
                                else make())
            made[make] = (idx, codes, lens, build_ert_from_index(
                idx, K=ERT_K, max_depth=ERT_DEPTH))
        idx, codes, lens, trie = made[make]
        fmi = DeviceFMIndex.from_host(idx, dev, force_int64=wide)
        dert = ops_ert.DeviceErt.from_host(trie, fmi.sa_samples, idx.count,
                                           dev)
        c = torch.as_tensor(codes, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        for n, (a, kw) in enumerate(descent_calls(dert, fmi, c, ln)):
            want = plain(*a, **kw)
            steps = plain.last_steps
            for v, fn in versions.items():
                got = fn(*a, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(got[f], want[f]) for f in want):
                    raise SystemExit(f"{label} pass {n + 1}: {v} != plain")
                if not torch.equal(fn.last_steps, steps):
                    raise SystemExit(f"{label} pass {n + 1}: {v}'s steps "
                                     f"!= plain's")
            ms = in_turns(versions,
                          {"call": lambda fn: lambda: fn(*a, **kw)}, dev)
            st = steps.long()
            words = st[0] + (st[1] + ert_cuda.WORD - 1) // ert_cuda.WORD
            print(f"[ert] {label}, pass {n + 1} (B={a[2].shape[0]}, "
                  f"L={a[2].shape[1]}): {int(st[0].sum())} node + "
                  f"{int(st[1].sum())} leaf steps, the longest lane "
                  f"{int(st.sum(0).max())} ({int(st[0].max())} node "
                  f"steps), the most node steps + leaf words "
                  f"{int(words.max())}; equal to plain; device time before "
                  f"{ms['before']['call']:.5f} ms, after "
                  f"{ms['after']['call']:.5f} ms (mean of 2 turns)  "
                  f"[{card}]", flush=True)
        del dert, fmi
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
