"""The JAX package's retry tiers under a device mesh (the reference's
behaviour the port departs from), on its virtual CPU devices.

Under ``make_mesh(3)``, a batch that overflows tiny capacities: the retry
tiers run unsharded (``TpuAligner._retry_jit`` is a plain ``jax.jit``,
not the mesh step), so a 3-device mesh does not raise at its first retry
although the tier batches (64 and 8 reads) do not divide by 3, and the
regions equal the unsharded aligner's. The port shards its tiers and pads
them (``tests/test_torch_mesh_retry.py``).
"""

import numpy as np

from conftest import make_genome, sample_reads

TINY = dict(max_coords=4, max_chains=2, max_seeds_per_chain=2, max_regs=2,
            max_pairs=6, max_smem_out=2)
L = 48


def _regs(all_regs):
    return [sorted((r.rb, r.re, r.qb, r.qe, r.score) for r in rr)
            for rr in all_regs]


def test_jax_mesh_of_three_retries_unsharded():
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.parallel.mesh import make_mesh as j_mesh
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig
    bns = make_genome(15000, seed=77)
    idx = build_index(bns)
    cfg = PipelineConfig(seed_engine="onehot", **TINY)
    codes = np.stack([r[0] for r in sample_reads(bns, 12, L, seed=9,
                                                 err_rate=0.02)])
    codes = codes.astype(np.int32)
    lens = np.full(12, L, np.int32)
    got = []
    for mesh in (j_mesh(3), None):
        al = TpuAligner(idx, MemOptions(), cfg, mesh=mesh)
        got.append(_regs(al.align_batch(codes, lens)))
        assert getattr(al, "overflow_retried", 0) > 0
    assert got[0] == got[1]
