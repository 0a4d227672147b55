"""Port vs JAX: the SA lookup stage (``expand_and_lookup``) and its fused
CUDA kernels (csrc/sal.cu).

On the CPU, the kernels' numpy twin (``sal_cuda.expand_lookup_twin``: the
warp's scan, the look-back, the binary searches, each thread's walk) and
the plain
version (``sal.expand_and_lookup_plain``, which ``expand_and_lookup`` runs
on CPU tensors) against the JAX package's ``expand_and_lookup`` on all
five arrays, every slot, exact: the grid path, the flat path with and
without reads past K (and with more counting blocks than the look-back's
32-block step), reads whose counts pass C, SMEMs past max_occ (the step
rule), reads with no SMEM, sa_compx 3 and 0, and the int64 layout.
The SMEM records are made from a numpy seed on the 20 kbp test genome:
intervals [k, k + s) of BWT rows, junk past each read's count.

On a GPU (``-m cuda``; the JAX side is imported inside the CPU test, so
the CUDA case also runs on a machine without JAX):
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_sal_fused.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import sal as tsal
from bwa_mem_scale_tpu_torch.ops import sal_cuda, smem_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

NAMES = ("rbeg", "seed_idx", "coord_valid", "total", "overflow")


def smem_records(seq_len: int, B: int, M: int, seed: int) -> tuple:
    """SmemBuf fields (m, n, k, l, s, cnt) as numpy arrays: each read's
    count in [0, M] (every fifth read none, read 1 at M + 1, the stack
    overflow latch), its SMEMs' sizes mostly 1-4 with one in six of
    20-3,000 rows and one in twenty of 0, each interval inside the BWT;
    junk (negative k and s among it) past the count."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(1, M + 1, B).astype(np.int32)
    cnt[::5], cnt[1] = 0, M + 1
    s = rng.randint(1, 5, (B, M))
    wide = rng.rand(B, M) < 1 / 6
    s[wide] = rng.randint(20, 3000, int(wide.sum()))
    s[rng.rand(B, M) < 1 / 20] = 0
    k = (rng.rand(B, M) * (seq_len - s)).astype(np.int64)
    junk = np.arange(M)[None, :] >= cnt[:, None]
    k[junk] = rng.randint(-50, seq_len, int(junk.sum()))
    s[junk] = rng.randint(-5, 5000, int(junk.sum()))
    m = rng.randint(0, 100, (B, M)).astype(np.int32)
    return m, m + 19, k, k * 0 + 3, s.astype(np.int64), cnt


# (id, sa_compx, int64 layout, max_coords, flat_k, max_occ, what the case
# must reach, reads): reads of 12 SMEM slots, 4 a counting block
CASES = [
    ("grid", 3, False, 64, None, 500, "grid", 24),
    ("flat", 3, False, 256, 4096, 500, "flat", 24),
    ("flat-past-k", 3, False, 256, 128, 500, "past_k", 24),
    ("flat-past-k-40-blocks", 3, False, 4, 256, 500, "past_k", 160),
    ("over-c", 3, False, 8, 64, 500, "over_c", 24),
    ("step", 3, False, 64, 1024, 7, "step", 24),
    ("grid-compx0", 0, False, 64, None, 500, "grid", 24),
    ("flat-past-k-compx0", 0, False, 256, 256, 9, "past_k", 24),
    ("int64-flat-past-k", 3, True, 256, 192, 9, "past_k", 24),
    ("int64-grid-compx0", 0, True, 32, None, 500, "over_c", 24),
]


@pytest.fixture(scope="module")
def indexes(small_genome, small_index):
    from bwa_mem_scale_tpu.index.build import build_index
    full = build_index(small_genome, sa_compx=0)
    assert small_index.sa_compx == 3 and full.sa_compx == 0
    return {3: small_index, 0: full}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_twin_and_plain_equal_to_jax(indexes, case):
    """The kernels' twin, the plain version and expand_and_lookup on CPU
    tensors equal the JAX package's expand_and_lookup on every slot of the
    five arrays; the case reaches what it is named for; the twin's longest
    walk stays within the lockstep's ticks (one step, a gather, at
    sa_compx 0); the twin's look-back gives the same arrays whether each
    block sums its predecessors' own sums or finds its predecessor's
    inclusive one; no launch on the CPU."""
    import jax
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import sal as jsal
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JSmemBuf
    _, compx, wide, C, flat_k, max_occ, reach, B = case
    idx = indexes[compx]
    jf = JFmi.from_host(idx, force_int64=wide)
    tf = TFmi.from_host(idx, "cpu", force_int64=wide)
    pd = np.int64 if wide else np.int32
    m, n, k, l, s, cnt = smem_records(idx.seq_len, B, 12, seed=C + compx)
    fields = (m, n, k.astype(pd), l.astype(pd), s.astype(pd), cnt)
    jx = jax.jit(jsal.expand_and_lookup, static_argnums=(2, 3, 4))(
        jf, JSmemBuf(*(jnp.asarray(a) for a in fields)), max_occ, C,
        flat_k)
    want = [np.asarray(a) for a in jx]
    t_smems = SmemBuf(*(torch.as_tensor(a) for a in fields))
    before = sal_cuda.expand_and_lookup_cuda.launches
    stats = {}
    plain = tsal.expand_and_lookup_plain(tf, t_smems, max_occ, C, flat_k,
                                         stats)
    auto = tsal.expand_and_lookup(tf, t_smems, max_occ, C, flat_k)
    assert sal_cuda.expand_and_lookup_cuda.launches == before
    tables = smem_cuda.twin_tables(tf)
    twin, steps = sal_cuda.expand_lookup_twin(
        *tables[:3], tf.sa_samples.numpy(), compx, fields[2], fields[4],
        cnt, max_occ, C, flat_k, hi_steps=tables[3])
    ascending, _ = sal_cuda.expand_lookup_twin(
        *tables[:3], tf.sa_samples.numpy(), compx, fields[2], fields[4],
        cnt, max_occ, C, flat_k, hi_steps=tables[3],
        order=range(1, -(-B // sal_cuda.READS)))
    for name, w, p, a, t, u in zip(NAMES, want, plain, auto, twin,
                                   ascending):
        np.testing.assert_array_equal(w, p.numpy(), f"plain {name}")
        np.testing.assert_array_equal(w, a.numpy(), f"auto {name}")
        np.testing.assert_array_equal(w, t, f"twin {name}")
        np.testing.assert_array_equal(w, u, f"twin, ascending {name}")
    assert plain[0].dtype == tf.pos_dtype
    rbeg, seed_idx, coord_valid, total, overflow = want
    K = sal_cuda.flat_size(B, C, flat_k)
    assert steps.shape == ((B * C,) if B * C <= K else (K,))
    if compx:
        assert 0 < steps.max() <= stats["sal_ticks"]
    else:
        assert steps.max() == 1 and "sal_ticks" not in stats
    assert (cnt == 0).any() and (total[cnt == 0] == 0).all()
    assert coord_valid.sum() == total.sum() and rbeg[~coord_valid].max() == 0
    csum = np.array([sum(sal_cuda._count(int(v), max_occ)
                         for v in s[b, :min(int(cnt[b]), 12)])
                     for b in range(B)])
    reached = {"grid": B * C <= K,
               "flat": B * C > K and total.sum() <= K,
               "past_k": total.sum() > K and (overflow & (csum <= C)).any(),
               "over_c": (csum > C).any() and (total[csum > C] == C).all(),
               "step": (s[:, :12][np.arange(12)[None, :] < cnt[:, None]]
                        > max_occ).any()}
    assert reached[reach], reached
    assert (overflow == ((csum > C) | (np.cumsum(total) > K) & (total > 0)
                         & (B * C > K))).all()


# ---- on the card ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("compx", [3, 0], ids=["compx3", "compx0"])
def test_fused_kernel_equal_to_plain(compx, wide):
    """expand_and_lookup on the card against expand_and_lookup_plain on a
    512-read batch of synthetic SMEM records on a 1 Mbp genome (main-path
    capacities: 512 coordinates a read, the flat list, and a flat list
    short enough that reads pass it; then the grid path at 64; at int32
    and sa_compx 3 also the records repeated to 40,960 reads, a batch
    that -K makes, and 64 reads of 3,072 SMEM slots, whose counting block
    takes 48 KB of starts): every slot of the five arrays equal, one call of the
    kernel pair each, no bare walk, per-lane steps equal to the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import demo_genome
    dev = torch.device("cuda")
    idx = build_index(demo_genome(1_000_000, seed=42, n_contigs=1),
                      sa_compx=compx)
    fmi = TFmi.from_host(idx, dev, force_int64=wide)
    pd = np.int64 if wide else np.int32
    m, n, k, l, s, cnt = smem_records(idx.seq_len, 512, 101, seed=11)
    fields = (m, n, k.astype(pd), l.astype(pd), s.astype(pd), cnt)
    smems = SmemBuf(*(torch.as_tensor(a, device=dev) for a in fields))
    wide_batch = SmemBuf(*(f.repeat(80, *[1] * (f.dim() - 1))
                           for f in smems))
    dm, dn, dk, dl, ds, dcnt = smem_records(idx.seq_len, 64, 3072, seed=12)
    deep = SmemBuf(*(torch.as_tensor(a, device=dev) for a in (
        dm, dn, dk.astype(pd), dl.astype(pd), ds.astype(pd), dcnt)))
    for C, flat_k, sm in ((512, None, smems), (512, 4096, smems),
                          (64, None, smems)) + (
            ((512, None, wide_batch), (512, None, deep))
            if compx == 3 and not wide else ()):
        before = sal_cuda.expand_and_lookup_cuda.launches
        walks = smem_cuda.sa_walk_cuda.launches
        stats = {}
        got = tsal.expand_and_lookup(fmi, sm, 500, C, flat_k, stats)
        torch.cuda.synchronize()
        assert sal_cuda.expand_and_lookup_cuda.launches == before + 1
        assert smem_cuda.sa_walk_cuda.launches == walks
        steps = sal_cuda.expand_and_lookup_cuda.last_steps.cpu().numpy()
        want = tsal.expand_and_lookup_plain(fmi, sm, 500, C, flat_k)
        for name, a, b in zip(NAMES, got, want):
            assert torch.equal(a, b), (C, flat_k, name)
        assert int(stats["sal_steps"]) == steps.max()
        if compx == 3 and not wide and flat_k is None and sm is smems:
            tables = smem_cuda.twin_tables(fmi)
            _, tsteps = sal_cuda.expand_lookup_twin(
                *tables[:3], fmi.sa_samples.cpu().numpy(), compx,
                fields[2], fields[4], cnt, 500, C, flat_k,
                hi_steps=tables[3])
            np.testing.assert_array_equal(tsteps, steps)
