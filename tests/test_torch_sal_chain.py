"""Port vs JAX: SA lookup (both the full-SA gather and the compressed
LF walk, grid and flat-compacted paths) and seed chaining / chain
filtering, on the same SMEM buffers. Exact equality (integer data; the
filter's float comparisons run in float64 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.index.build import build_index
from bwa_mem_scale_tpu.ops import chain as jchain
from bwa_mem_scale_tpu.ops import sal as jsal
from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
from bwa_mem_scale_tpu.ops.smem_oh import collect_smems_oh
from bwa_mem_scale_tpu_torch.ops import chain as tchain
from bwa_mem_scale_tpu_torch.ops import sal as tsal
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf

from conftest import sample_reads

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[3, 0], ids=["compx3", "compx0"])
def setup(request, small_genome, small_index):
    idx = (small_index if request.param == 3
           else build_index(small_genome, sa_compx=0))
    assert idx.sa_compx == request.param
    jf = JFmi.from_host(idx)
    reads = sample_reads(idx.bns, 40, 101, seed=21, err_rate=0.02)
    codes = np.stack([c for c, _, _ in reads]).astype(np.int32)
    # a repeat read: many coordinates per SMEM
    codes[0] = np.tile(idx.bns.seq[500:520].astype(np.int32), 6)[:101]
    lens = np.full(len(codes), 101, np.int32)
    lens[1] = 0
    opt = MemOptions()
    smems = collect_smems_oh(
        jf, jnp.asarray(codes), jnp.asarray(lens),
        min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        emit_depth=24, stack_depth=24)
    t_smems = SmemBuf(*(torch.as_tensor(np.array(a)) for a in smems))
    return dict(idx=idx, jf=jf, tf=TFmi.from_host(idx, "cpu"),
                smems=smems, t_smems=t_smems, lens=lens, opt=opt)


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), what)


def test_sa_lookup(setup):
    rng = np.random.RandomState(3)
    pos = rng.randint(0, setup["idx"].seq_len, size=700).astype(np.int32)
    valid = rng.rand(700) < 0.9
    _eq(jsal.sa_lookup(setup["jf"], jnp.asarray(pos), jnp.asarray(valid)),
        tsal.sa_lookup(setup["tf"], torch.as_tensor(pos),
                       torch.as_tensor(valid)))


@pytest.mark.parametrize("max_coords,flat_k", [
    (64, None),      # B*C <= K: the grid path
    (256, 1024),     # flat compacted path, no read past K
    (256, 128),      # flat path with reads past K (overflow flags)
])
def test_expand_and_lookup(setup, max_coords, flat_k):
    opt = setup["opt"]
    want = jsal.expand_and_lookup(setup["jf"], setup["smems"],
                                  opt.max_occ, max_coords, flat_k=flat_k)
    got = tsal.expand_and_lookup(setup["tf"], setup["t_smems"],
                                 opt.max_occ, max_coords, flat_k=flat_k)
    for name, a, b in zip(("rbeg", "seed_idx", "coord_valid", "total",
                           "overflow"), want, got):
        _eq(a, b, name)
    if flat_k == 128:
        assert got[4].any()


@pytest.mark.parametrize("caps", [(16, 8), (4, 2)],
                         ids=["roomy", "tiny"])
def test_chain_and_filter(setup, caps):
    opt = setup["opt"]
    C, S = caps
    jx = jsal.expand_and_lookup(setup["jf"], setup["smems"], opt.max_occ,
                                64)
    tx = tsal.expand_and_lookup(setup["tf"], setup["t_smems"],
                                opt.max_occ, 64)
    bns = setup["idx"].bns
    jb = jchain.DeviceBns.from_host(bns)
    tb = tchain.DeviceBns.from_host(bns, "cpu")
    kw = dict(w=opt.w, max_chain_gap=opt.max_chain_gap, max_chains=C,
              max_seeds_per_chain=S)
    jch = jchain.chain_seeds_device(jb, setup["smems"], *jx[:3], **kw)
    tch = tchain.chain_seeds_device(tb, setup["t_smems"], *tx[:3], **kw)
    for f in jch._fields:
        _eq(getattr(jch, f), getattr(tch, f), f)
    if C == 4:
        assert tch.overflow.any()
    fkw = dict(min_chain_weight=opt.min_chain_weight,
               mask_level=opt.mask_level, max_chain_gap=opt.max_chain_gap,
               drop_ratio=opt.drop_ratio, min_seed_len=opt.min_seed_len,
               max_chain_extend=opt.max_chain_extend)
    for a, b, name in zip(jchain.chain_filter_device(jch, jb, **fkw),
                          tchain.chain_filter_device(tch, tb, **fkw),
                          ("order", "kept", "w_slot")):
        _eq(a, b, name)
    _eq(jchain.frac_rep_device(setup["smems"], jnp.asarray(setup["lens"]),
                               opt.max_occ),
        tchain.frac_rep_device(setup["t_smems"],
                               torch.as_tensor(setup["lens"]), opt.max_occ))
