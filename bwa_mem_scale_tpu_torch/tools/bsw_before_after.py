"""The banded-SW kernel's device time against the one-thread-a-pair
kernel it replaced, in turns, on one card.

    git archive <earlier commit> | tar -x -C build/before
    python -m bwa_mem_scale_tpu_torch.tools.bsw_before_after build/before

The earlier checkout's ``bwa_mem_scale_tpu_torch`` is loaded beside this
one, under the name ``bsw_before``, and builds its own ``csrc/bsw.cu``
into its own ``build/``. Its kernel is the port's first one: one thread
a pair, arrays transposed to [row, pair] and sorted by target length, the
DP rows in a device-memory scratch; its launch takes (meta, qs^T, ts^T,
out, eh, P, QL, penalties, scores, block, stream).

On chip_smoke.py phase 3's input (4,096 pairs, query 101, target 309,
band 100 and 200) both kernels are held bit-equal to the plain version,
then timed in turns (before, after, after, before): the device time of
the launch alone (``tools/timing.py::device_ms``; the earlier wrapper's
sort, transposes and scratch are made once beforehand) and the whole
wrapper call back to back (``time_ms``), each line with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

import numpy as np
import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import bsw_cuda
from ..ops.bsw import banded_swa_batch
from .timing import card_line, device_ms, time_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_before(root: str):
    """The earlier checkout's ops/bsw_cuda module, as bsw_before.ops."""
    pkg = os.path.join(os.path.abspath(root), "bwa_mem_scale_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "bsw_before", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bsw_before"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("bsw_before.ops.bsw_cuda")


def before_launch(old, arrs, w, pen):
    """A thunk of the earlier kernel's launch alone; its wrapper's
    preparation done once here."""
    qs, q_lens, ts, t_lens, h0 = arrs
    o_del, e_del, o_ins, e_ins, zdrop, mat = pen
    sc = old.scoring(mat)
    w_p = old.band_per_pair(q_lens, w, o_del, e_del, o_ins, e_ins, sc["mx"])
    eff_t = torch.where((t_lens > 0) & (q_lens > 0), t_lens, 0)
    perm = torch.argsort(eff_t, stable=True)
    qs_t = qs[perm].clamp(0, 4).t().contiguous()
    ts_t = ts[perm].clamp(0, 4).t().contiguous()
    meta = torch.stack([q_lens, t_lens, h0, w_p])[:, perm].contiguous()
    P, QL = qs.shape
    out = torch.empty((6, P), dtype=torch.int32, device=qs.device)
    eh = torch.empty((2, QL + 2, P), dtype=torch.int32, device=qs.device)
    lib = old._load()
    stream = torch.cuda.current_stream(qs.device).cuda_stream

    def call():
        rc = lib.bsw_launch(meta.data_ptr(), qs_t.data_ptr(),
                            ts_t.data_ptr(), out.data_ptr(), eh.data_ptr(),
                            P, QL, o_del, e_del, o_ins, e_ins, zdrop,
                            sc["sc_match"], sc["sc_mis"], sc["sc_n"],
                            old.BLOCK, stream)
        if rc != 0:
            raise RuntimeError(f"earlier bsw_launch failed: CUDA error {rc}")
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.bsw_before_after",
        description="Time the BSW kernel against an earlier checkout's.")
    ap.add_argument("before", help="directory of the earlier checkout")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line(dev)
    sys.path.insert(0, REPO)
    from chip_smoke import P, QL, TL, bsw_pairs
    old = load_before(args.before)
    old.build(force=True)
    bsw_cuda.build(force=True)
    opt = MemOptions()
    pen = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop, opt.mat)
    arrs = [torch.as_tensor(a, device=dev)
            for a in bsw_pairs(np.random.RandomState(11), P, QL, TL)]
    wrappers = {"before": old.banded_swa_batch_cuda,
                "after": bsw_cuda.banded_swa_batch_cuda}
    for w in (opt.w, opt.w << 1):
        want = banded_swa_batch(*arrs, w, *pen)
        qs, q_lens, ts, t_lens, h0 = arrs
        lens = torch.stack([q_lens, t_lens])
        launch = {"before": before_launch(old, arrs, w, pen),
                  "after": lambda: bsw_cuda.bsw_rows(qs, lens, ts, h0, w,
                                                     *pen)}
        times = {v: dict(ms=[], wall_ms=[]) for v in wrappers}
        for v, fn in wrappers.items():
            got = fn(*arrs, w, *pen)
            torch.cuda.synchronize()
            if any(not torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{v} kernel != plain BSW at w={w}")
        for v in ("before", "after", "after", "before"):
            times[v]["ms"].append(device_ms(launch[v], 20, dev))
            times[v]["wall_ms"].append(time_ms(
                lambda: wrappers[v](*arrs, w, *pen), 20, dev))
        for v, r in times.items():
            print(f"[bsw {v}] P={P} QL={QL} TL={TL} w={w}: bit-equal to "
                  f"plain; kernel device time {sum(r['ms']) / 2:.5f} ms, "
                  f"wrapper call back to back {sum(r['wall_ms']) / 2:.5f} "
                  f"ms (mean of 2 turns)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
