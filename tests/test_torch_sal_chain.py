"""Port vs JAX: SA lookup (both the full-SA gather and the compressed
LF walk, grid and flat-compacted paths) and seed chaining / chain
filtering, on the same SMEM buffers. Exact equality (integer data; the
filter's float comparisons run in float64 on both sides).

The SA walk's CUDA kernel: its CPU twin (``smem_cuda.sa_walk_twin``, the
kernel's own loop) and the port's ``sa_lookup`` against the JAX
package's ``sa_lookup`` (plain and staged narrowing), with lanes that
reach the sentinel row and invalid lanes; on a GPU the kernel against
the plain version on a 16,384-lane flat list, and ``expand_and_lookup``
(csrc/sal.cu's kernels, which the main path runs instead of the bare
walk) against its plain version.

The JAX side is imported inside the fixtures and tests that use it, so
the CUDA cases also run on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_sal_chain.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import chain as tchain
from bwa_mem_scale_tpu_torch.ops import sal as tsal
from bwa_mem_scale_tpu_torch.ops import smem_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[3, 0], ids=["compx3", "compx0"])
def setup(request, small_genome, small_index):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu.ops.smem_oh import collect_smems_oh
    from conftest import sample_reads
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
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import sal as jsal
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
    from bwa_mem_scale_tpu.ops import sal as jsal
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
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import sal as jsal
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


@pytest.mark.parametrize("caps", [(16, 8), (4, 2)],
                         ids=["roomy", "tiny"])
def test_chain_twins_on_genome_equal_to_jax(setup, caps):
    """The chaining kernels' CPU twins (``chain_cuda.chain_seeds_twin``
    and ``chain_filter_twin``) on the genome's SMEMs and coordinates
    (the repeat read among them): every Chains field, order, kept,
    w_by_slot and frac_rep equal to the JAX package's, and each read's
    steps the coordinates it walked."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import sal as jsal
    from bwa_mem_scale_tpu_torch.ops import chain_cuda
    opt = setup["opt"]
    C, S = caps
    jx = jsal.expand_and_lookup(setup["jf"], setup["smems"], opt.max_occ,
                                64)
    bns = setup["idx"].bns
    jb = jchain.DeviceBns.from_host(bns)
    kw = dict(w=opt.w, max_chain_gap=opt.max_chain_gap, max_chains=C,
              max_seeds_per_chain=S)
    jch = jchain.chain_seeds_device(jb, setup["smems"], *jx[:3], **kw)
    sm = [np.asarray(a) for a in setup["smems"]]
    total = np.asarray(jx[3])
    twin, steps, _ = chain_cuda.chain_seeds_twin(
        np.asarray(bns.offsets, np.int64), bns.l_pac, sm[0], sm[1],
        np.asarray(jx[0]), np.asarray(jx[1]), np.asarray(jx[2]), **kw)
    for f in jch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jch, f)),
                                      getattr(twin, f), f)
    np.testing.assert_array_equal(steps, total)
    assert total.max() >= 10 and (twin.overflow.any() or C == 16)
    fkw = dict(min_chain_weight=opt.min_chain_weight,
               mask_level=opt.mask_level, max_chain_gap=opt.max_chain_gap,
               drop_ratio=opt.drop_ratio, min_seed_len=opt.min_seed_len,
               max_chain_extend=opt.max_chain_extend)
    want = (*jchain.chain_filter_device(jch, jb, **fkw),
            jchain.frac_rep_device(setup["smems"],
                                   jnp.asarray(setup["lens"]), opt.max_occ))
    got = chain_cuda.chain_filter_twin(
        np.asarray(bns.is_alt, bool), twin, sm[0], sm[1], sm[4], sm[5],
        setup["lens"], max_occ=opt.max_occ, **fkw)
    for name, a, b in zip(("order", "kept", "w_slot", "frac_rep"), want,
                          got):
        _eq(a, torch.as_tensor(b), name)


# ---- the SA walk: the CUDA kernel's twin, the plain walk and JAX -------

@pytest.fixture(scope="module", params=[3, 0], ids=["compx3", "compx0"])
def walk_index(request):
    """A 20 kbp genome whose sentinel row (the row of SA value 0) is not
    sampled at sa_compx 3, so that walks from rows of small SA values end
    on it, indexed at the param's sa_compx; and its full SA."""
    from bwa_mem_scale_tpu.index.build import build_index
    from conftest import make_genome
    genome = make_genome(20000, seed=43)
    full = build_index(genome, sa_compx=0)
    idx = full if request.param == 0 else build_index(genome)
    assert idx.sa_compx == request.param and full.sentinel_index & 7
    return idx, np.asarray(full.sa_samples, np.int64)


def _walk_lanes(sa, n=1000):
    """BWT rows: those of SA values 0-39 (the sentinel row first), then
    random rows; every tenth lane invalid, the last one at the sentinel
    row. Returns (pos, valid, true SA values)."""
    rng = np.random.RandomState(7)
    inv = np.empty_like(sa)
    inv[sa] = np.arange(len(sa))
    pos = np.concatenate([inv[:40], rng.randint(0, len(sa), n - 40)])
    valid = np.arange(n) % 10 != 9
    pos[-1], valid[-1] = inv[0], False
    return pos.astype(np.int32), valid, sa[pos]


def _sentinel_lanes(sa, pos, valid, compx):
    """Valid lanes whose walk ends on the sentinel row: no row from theirs
    back to the sentinel row's (SA values v, v - 1, ..., 0) is sampled."""
    inv = np.empty_like(sa)
    inv[sa] = np.arange(len(sa))
    mask = (1 << compx) - 1
    return [t for t in np.flatnonzero(valid)
            if all(inv[u] & mask for u in range(sa[pos[t]] + 1))]


@pytest.mark.parametrize("stages", ["auto", "512,128,32"],
                         ids=["jax-unstaged", "jax-staged"])
def test_sa_walk_twin_and_lookup_equal_to_jax(walk_index, monkeypatch,
                                              stages):
    """The kernel's twin and the port's sa_lookup equal the JAX package's
    sa_lookup (unstaged, and with staged narrowing forced through
    BWATPU_SAL_STAGES), and the true SA where valid, 0 where not; at
    sa_compx 3 some lanes end on the sentinel row, and the longest walk
    stays within the lockstep's ticks."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import sal as jsal
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    idx, sa = walk_index
    pos, valid, truth = _walk_lanes(sa)
    monkeypatch.setenv("BWATPU_SAL_STAGES", stages)
    want = np.asarray(jsal.sa_lookup(JFmi.from_host(idx), jnp.asarray(pos),
                                     jnp.asarray(valid)))
    tf = TFmi.from_host(idx, "cpu")
    stats = {}
    got = tsal.sa_lookup(tf, torch.as_tensor(pos), torch.as_tensor(valid),
                         stats)
    twin, steps = smem_cuda.sa_walk_twin(
        tf.count.numpy(), tf.cp_fused.numpy(), tf.sentinel_index,
        tf.sa_samples.numpy(), tf.sa_compx, pos, valid)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, twin)
    np.testing.assert_array_equal(want, np.where(valid, truth, 0))
    if idx.sa_compx:
        ends = _sentinel_lanes(sa, pos, valid, idx.sa_compx)
        assert ends and ends[0] == 0
        assert 0 < steps.max() <= stats["sal_ticks"]
    else:
        assert steps.max() == 1 and "sal_ticks" not in stats


def test_sa_lookup_on_cpu_runs_plain(walk_index):
    """On CPU tensors sa_lookup and its wrapper sa_walk_cuda are the
    plain version (no launch), with the lockstep's tick count in stats."""
    idx, sa = walk_index
    pos, valid, _ = _walk_lanes(sa)
    tf = TFmi.from_host(idx, "cpu")
    p, v = torch.as_tensor(pos), torch.as_tensor(valid)
    before = smem_cuda.sa_walk_cuda.launches
    st_a, st_b, st_c = {}, {}, {}
    a = tsal.sa_lookup(tf, p, v, st_a)
    b = tsal.sa_lookup_plain(tf, p, v, st_b)
    c = smem_cuda.sa_walk_cuda(tf, p, v, st_c)
    assert smem_cuda.sa_walk_cuda.launches == before
    assert st_a == st_b == st_c and torch.equal(a, b) and torch.equal(a, c)


# ---- on the card ------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_sal():
    """A 1 Mbp genome indexed by the port (no JAX on the card) at
    sa_compx 3 and 0, and a 512-read batch of 101 bp (1% errors)."""
    _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    return ({3: build_index(bns), 0: build_index(bns, sa_compx=0)},
            simulate_reads(bns, 512, 101, seed=8, err_rate=0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("compx", [3, 0], ids=["compx3", "compx0"])
def test_sa_walk_kernel_equal_to_plain(card_sal, compx):
    """sa_lookup on the card against the plain walk on a 16,384-lane flat
    list (the main path's K), the sentinel row and invalid lanes among
    them (the sentinel row unsampled at sa_compx 3, so that its lanes
    take the kernel's sentinel branch): equal values; one launch with
    per-lane steps equal to the twin's at sa_compx 3, none at sa_compx 0
    (a single gather)."""
    dev = _cuda()
    idx = card_sal[0][compx]
    assert idx.sentinel_index & ((1 << compx) - 1) or not compx
    fmi = TFmi.from_host(idx, dev)
    rng = np.random.RandomState(5)
    pos = rng.randint(0, idx.seq_len, 16384).astype(np.int32)
    valid = rng.rand(16384) < 0.9
    pos[:2], valid[:2] = idx.sentinel_index, True
    p, v = torch.as_tensor(pos, device=dev), torch.as_tensor(valid,
                                                             device=dev)
    before = smem_cuda.sa_walk_cuda.launches
    stats = {}
    got = tsal.sa_lookup(fmi, p, v, stats)
    torch.cuda.synchronize()
    want = tsal.sa_lookup_plain(fmi, p, v)
    assert torch.equal(got, want)
    assert smem_cuda.sa_walk_cuda.launches == before + (compx > 0)
    if compx:
        twin, steps = smem_cuda.sa_walk_twin(
            idx.count, fmi.cp_fused.cpu().numpy(), fmi.sentinel_index,
            fmi.sa_samples.cpu().numpy(), compx, pos, valid)
        np.testing.assert_array_equal(twin, got.cpu().numpy())
        np.testing.assert_array_equal(
            steps, smem_cuda.sa_walk_cuda.last_steps.cpu().numpy())
        assert int(stats["sal_steps"]) == steps.max()


@pytest.mark.cuda
def test_expand_and_lookup_kernel_equal_to_plain(card_sal):
    """expand_and_lookup on the 512-read batch's SMEMs (main-path
    capacities: 512 coordinates a read, the flat list) through the SA
    lookup stage's kernels (csrc/sal.cu) and through its plain version:
    every output equal, one call of the kernel pair, no bare walk."""
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops import sal_cuda
    from bwa_mem_scale_tpu_torch.ops.smem_oh import collect_smems_oh
    dev = _cuda()
    fmi = TFmi.from_host(card_sal[0][3], dev)
    codes, lens = (torch.as_tensor(a, device=dev) for a in card_sal[1])
    opt = MemOptions()
    smems = collect_smems_oh(
        fmi, codes, lens, min_seed_len=opt.min_seed_len,
        split_len=opt.split_len, split_width=opt.split_width,
        max_mem_intv=opt.max_mem_intv, emit_depth=24, stack_depth=24)
    before = sal_cuda.expand_and_lookup_cuda.launches
    walks = smem_cuda.sa_walk_cuda.launches
    got = tsal.expand_and_lookup(fmi, smems, opt.max_occ, 512)
    torch.cuda.synchronize()
    assert sal_cuda.expand_and_lookup_cuda.launches == before + 1
    assert smem_cuda.sa_walk_cuda.launches == walks
    want = tsal.expand_and_lookup_plain(fmi, smems, opt.max_occ, 512)
    for name, a, b in zip(("rbeg", "seed_idx", "coord_valid", "total",
                           "overflow"), got, want):
        assert torch.equal(a, b), name
    assert int(got[3].sum()) > 0
