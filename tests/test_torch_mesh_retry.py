"""The overflow retry tiers under a device mesh, on the CPU.

The port shards the tiers, padding each tier batch with empty reads to a
multiple of the mesh (``parallel/mesh.py::pad_to_multiple``): at 3 and 2
shards, with tiny capacities at the main batch and at tier 1 and tier
batches of 4 and 8 reads, the SE SAM (the stream's retry backlog), the PE
records and ``align_batch``'s regions are byte-equal to the unsharded
port's. (The JAX package runs its tiers unsharded:
``tests/test_torch_mesh_reference.py``.)
"""

import io
from functools import partial

import numpy as np
import pytest
import torch

from conftest import make_genome, sample_reads

from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
from bwa_mem_scale_tpu_torch.index.build import build_index as t_build
from bwa_mem_scale_tpu_torch.parallel.mesh import make_mesh
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg,
                                                    seed_chain_extend)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run

torch.set_num_threads(1)

TINY = dict(max_coords=4, max_chains=2, max_seeds_per_chain=2, max_regs=2,
            max_pairs=6, max_smem_out=2)
L = 48


def _regs(all_regs):
    return [sorted((r.rb, r.re, r.qb, r.qe, r.score) for r in rr)
            for rr in all_regs]


N = 12


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    bns = make_genome(15000, seed=77)
    reads = [r[0] for r in sample_reads(bns, N, L, seed=9, err_rate=0.02)]
    codes = np.full((N, L), 4, np.int32)
    for i, r in enumerate(reads):
        codes[i] = r
    tmp = tmp_path_factory.mktemp("retry")
    fq = str(tmp / "r.fq")
    with open(fq, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * L}\n")
    d = dict(bns=bns, codes=codes, lens=np.full(N, L, np.int32), fq=fq)
    d["one"] = _outputs(d, None)
    return d


def _port(data, mesh):
    """Tiny capacities at the main batch and at tier 1 (so tier 2, in
    batches of 8 reads, runs too); tier-1 batches of 4 reads."""
    cfg = TCfg(seed_engine="onehot", **TINY)
    al = GpuAligner(t_build(data["bns"]), "cpu", TOpt(), cfg, mesh=mesh)
    al.RETRY_BATCH = 4
    al._retry_cfg = cfg
    al._retry_fn = partial(seed_chain_extend, opt=al.opt, cfg=cfg)
    return al


def _outputs(data, mesh):
    al = _port(data, mesh)
    sam = io.StringIO()
    t_run(al, [data["fq"]], sam, batch_reads=N)
    pe, mates = al.align_pairs_and_finalize(data["codes"], data["lens"])
    regs = al.align_batch(data["codes"][:10], data["lens"][:10])
    assert al.overflow_retried > 0 and al.overflow_tier2 > 0
    return (sam.getvalue(),
            [[(r.rid, r.pos, r.flag, tuple(r.cigar or ())) for r in rr]
             for rr in pe], _regs(regs))


@pytest.mark.parametrize("n", [3, 2])
def test_port_retry_tiers_under_mesh_equal_to_unsharded(data, n):
    assert _outputs(data, make_mesh(devices=["cpu"] * n)) == data["one"]
    assert data["one"][0].count("\n") >= N
