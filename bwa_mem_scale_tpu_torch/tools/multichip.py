"""The sharded alignment step and the full pipeline over a device mesh,
against one device: the port's twin of the JAX package's
``__graft_entry__.py::dryrun_multichip``.

    python -m bwa_mem_scale_tpu_torch.tools.multichip [N] [--device cpu]

On a ``Mesh`` of N devices (the first N cards with ``--device cuda``, the
default; N CPU shards with ``--device cpu``): the read-sharded
seed-chain-extend step with the FMA table replicated on each device, on
tiny shapes; then SE (``align_and_finalize``, the device EMF probe
sharded with seeding), PE (``align_pairs_and_finalize``) and the
streaming driver (``SeStream``, three feeds), each with the mesh and
without it, asserting equal records. Prints the JAX dry run's closing
line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import MemOptions
from ..index.build import build_index
from ..index.perfect import build_perfect_table
from ..models.aligner import demo_genome, simulate_reads
from ..ops.chain import DeviceBns
from ..ops.fma import build_fma_table
from ..ops.occ import DeviceFMIndex
from ..parallel.mesh import Mesh, make_mesh, pad_to_multiple, sharded_align_fn
from ..pipeline.align import GpuAligner, PipelineConfig
from ..pipeline.stream import SeStream


def _recs(recs, with_flag=False):
    return [[(r.rid, r.pos, r.mapq) + ((r.flag,) if with_flag else ())
             + (tuple(r.cigar or ()),) for r in rr] for rr in recs]


def dryrun_multichip(mesh: Mesh) -> str:
    """Run the checks on `mesh`; returns the closing line."""
    n = mesh.size
    opt = MemOptions()
    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8)
    idx = build_index(demo_genome(12000, 0))
    L = 64
    B = 2 * n
    codes, lens = simulate_reads(idx.bns, B, L, err_rate=0.02)

    # the index and the FMA ladder table on every device of the mesh
    fmis = {d: DeviceFMIndex.from_host(idx, d) for d in mesh.distinct()}
    dbns = {d: DeviceBns.from_host(idx.bns, d) for d in mesh.distinct()}
    fma = build_fma_table(fmis[mesh[0]], K=4, chunk=256)
    fmas = {d: fma.to_device(fmis[d].pos_dtype, d) for d in mesh.distinct()}
    fn = sharded_align_fn(mesh, opt, cfg, L, with_fma=True)
    codes, lens, _ = pad_to_multiple(codes, lens, n)
    out = fn(fmis, dbns, codes, lens, fmas)
    valid = out["valid"].bool().cpu().numpy()
    reads = out["read"].cpu().numpy()
    assert valid.shape == reads.shape
    if valid.any():
        assert reads[valid].min() >= 0
        assert reads[valid].max() < codes.shape[0]

    # the pipeline under the mesh: every device stage sharded, the host
    # stages on global read ids; records equal to one device's
    emf = build_perfect_table(idx, seed_len=L)

    def aligner(m):
        return GpuAligner(idx, mesh[0], opt, cfg, emf=emf, mesh=m)

    rec_sets = [_recs(aligner(m).align_and_finalize(
        np.asarray(codes, np.int32), np.asarray(lens, np.int32)))
        for m in (None, mesh)]
    assert rec_sets[0] == rec_sets[1], \
        "mesh-mode SAM records diverge from single-device"

    g = np.asarray(idx.bns.seq)
    rng = np.random.RandomState(11)
    pc = np.zeros((2 * n, L), np.int32)
    for p in range(n):
        isize = L + 40
        pos = rng.randint(0, len(g) - isize)
        pc[2 * p] = g[pos: pos + L]
        pc[2 * p + 1] = (3 - g[pos + isize - L: pos + isize][::-1])
    pl = np.full(2 * n, L, np.int32)
    pe_sets = [_recs(aligner(m).align_pairs_and_finalize(pc, pl)[0], True)
               for m in (None, mesh)]
    assert pe_sets[0] == pe_sets[1], \
        "mesh-mode PE records diverge from single-device"

    B2 = 4 * n
    c2, l2 = simulate_reads(idx.bns, 3 * B2, L, seed=5, err_rate=0.02)
    stream_sets = []
    for m in (None, mesh):
        st = SeStream(aligner(m), B2, L)
        got = {}
        for k in range(3):
            st.feed(c2[k * B2: (k + 1) * B2], l2[k * B2: (k + 1) * B2],
                    k * B2)
            got.update(dict(st.ready()))
        st.flush()
        got.update(dict(st.ready()))
        assert len(got) == 3 * B2
        stream_sets.append(_recs([got[i] for i in range(3 * B2)], True))
    assert stream_sets[0] == stream_sets[1], \
        "mesh-mode stream-driver records diverge from single-device"
    return (f"dryrun_multichip({n}): {int(valid.sum())} alignment regions "
            f"over {codes.shape[0]} reads; end-to-end SE + PE + "
            f"stream-driver records match single-device OK")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="multichip")
    p.add_argument("n", type=int, nargs="?", default=None,
                   help="devices (default: every card, or 8 CPU shards)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
        mesh = Mesh(["cpu"] * (a.n or 8))
    else:
        mesh = make_mesh(a.n)
    print(dryrun_multichip(mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
