"""Port vs JAX: the three-pass one-hot SMEM collection
(bwa_mem_scale_tpu_torch.ops.smem_oh.collect_smems_oh against
bwa_mem_scale_tpu.ops.smem_oh.collect_smems_oh). Whole arrays are
compared, slots past the count included, so the stable final sort and
the overflow contract (cnt forced to capacity) are both held.

Passes 1 and 2 (``one_pos_machine``): the CUDA kernel's CPU twin
(``smem_cuda.one_pos_twin``, the kernel's own nested loops) against the
port's lockstep ``one_pos_machine`` and the JAX package's
``one_pos_machine_oh``, every field and ``cnt``, at the tiers' depths
(24, 48, the read length), with and without chain restarts, and with the
stack, the emission depth and the reseed budget overflowing; on a GPU
the kernel against the plain version over the same cases and at a
512-read batch.

Pass 3 (``seed_strategy_machine``): the twin ``smem_cuda.
seed_strategy_twin`` against the lockstep and the JAX package's
``seed_strategy_machine_oh`` at emission depths 24, 48 and the read
length and with the depth overflowing; on a GPU the kernel against the
plain version over the same cases and at a 512-read batch, and
``collect_smems_oh`` with all three kernels against the plain machines.

The JAX side is imported inside the tests that use it, so the CUDA cases
also run on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_smem.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem_oh import (
    collect_smems_oh as t_collect, one_pos_machine, reseed_tasks,
    seed_strategy_machine)
from bwa_mem_scale_tpu_torch.ops import smem_cuda
from bwa_mem_scale_tpu_torch.ops.smem import compact_indices

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("m", "n", "k", "l", "s", "cnt")


@pytest.fixture(scope="module")
def both(small_index):
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    return JFmi.from_host(small_index), TFmi.from_host(small_index, "cpu")


def _read_set(small_index):
    from conftest import sample_reads
    reads = sample_reads(small_index.bns, 20, 101, seed=11, err_rate=0.03)
    rows = [c.astype(np.int32) for c, _, _ in reads]
    withn = rows[0].copy()
    withn[[10, 50]] = 4
    rows.append(withn)
    # a tandem repeat: many SMEMs and reseed candidates
    rows.append(np.tile(small_index.bns.seq[100:130].astype(np.int32),
                        4)[:101])
    rows.append(rows[1][:40].copy())
    rows.append(rows[2][:0].copy())                  # empty read
    codes = np.full((len(rows), 101), 4, dtype=np.int32)
    for i, c in enumerate(rows):
        codes[i, : len(c)] = c
    return codes, np.array([len(c) for c in rows], dtype=np.int32)


def _assert_equal(j, t):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), f)


@pytest.mark.parametrize("depth,reseed_factor", [
    (24, 2),        # the main path's "auto" depth on int32 genomes
    (None, 2),      # full depth (the tier-2 retry shape)
    (6, 2),         # shallow: emission and stack overflow fire
    (24, 1),        # reseed lane budget T = B trips on the repeat read
])
def test_collect_smems_oh_equal(small_index, both, depth, reseed_factor):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.ops.smem_oh import collect_smems_oh as j_collect
    jf, tf = both
    codes, lens = _read_set(small_index)
    opt = MemOptions()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              emit_depth=depth, stack_depth=depth,
              reseed_factor=reseed_factor)
    want = j_collect(jf, jnp.asarray(codes), jnp.asarray(lens), **kw)
    stats = {}
    got = t_collect(tf, torch.as_tensor(codes), torch.as_tensor(lens),
                    stats=stats, **kw)
    _assert_equal(want, got)
    assert stats["seed_ticks_p1"] > 0
    if depth == 6:
        assert (got.cnt.numpy() == got.m.shape[1]).any()


def test_reseed_budget_trips(small_index, both):
    """A tiny reseed factor must flag reads whose reseed candidates
    exceed the lane budget (cnt forced to the buffer width)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.ops.smem_oh import collect_smems_oh as j_collect
    jf, tf = both
    codes, lens = _read_set(small_index)
    codes, lens = codes[-4:-1], lens[-4:-1]        # repeat-heavy rows
    opt = MemOptions()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              emit_depth=24, stack_depth=24, reseed_factor=1)
    want = j_collect(jf, jnp.asarray(codes), jnp.asarray(lens), **kw)
    got = t_collect(tf, torch.as_tensor(codes), torch.as_tensor(lens), **kw)
    _assert_equal(want, got)


@pytest.mark.parametrize("T", [1, 5, 64])
def test_compact_indices(T):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import compact_indices as j_compact
    flat = np.random.RandomState(T).rand(40) < 0.3
    jo, jv = j_compact(jnp.asarray(flat), T)
    to, tv = compact_indices(torch.as_tensor(flat), T)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


# ---- passes 1 and 2: the CUDA kernel's twin, the lockstep and JAX ----

# (depth, chain_restarts, max_out, stack_depth, reseed_factor): the
# tiers' depths with and without restarts (pass 2's tasks come from
# pass 1 as collect_smems_oh builds them), then a stack of 2 entries
# (overflows), 2 emission slots (overflow) and the reseed budget T = B
# (trips on the repeat rows, every lane of pass 2 valid)
ONE_POS_CASES = {
    "d24-chain": (24, True, 24, 24, 2),
    "d48-chain": (48, True, 48, 48, 8),
    "dL-chain": (None, True, None, None, 256),
    "d24-reseed": (24, False, 24, 24, 2),
    "d48-reseed": (48, False, 48, 48, 8),
    "dL-reseed": (None, False, None, None, 256),
    "stack-overflow": (2, True, 24, 2, 2),
    "emit-overflow": (2, True, 2, 24, 2),
    "reseed-budget": (24, False, 24, 24, 1),
}


def _tasks(fmi, codes, lens, case, min_seed_len):
    """The case's one_pos_machine arguments: pass 1 (one task a read from
    0) or pass 2 (the reseed tasks collect_smems_oh compacts from pass
    1's output at the case's budget T = reseed_factor * B)."""
    depth, chain, max_out, sd, rf = ONE_POS_CASES[case]
    B, L = codes.shape
    M = max_out or L
    zi = torch.zeros((B,), dtype=torch.int32)
    p1 = (torch.arange(B, dtype=torch.int32), zi, zi + 1, lens > 0)
    if chain:
        return p1, M, sd
    opt = TOpt()
    b1 = one_pos_machine(fmi, codes, lens, *p1, True, min_seed_len, M, sd)
    *tasks, reseed_of = reseed_tasks(b1, rf * B, opt.split_len,
                                     opt.split_width)
    if case == "reseed-budget":
        assert bool(reseed_of.any()) and bool(tasks[3].all())
    return tasks, M, sd


def _planted_genome(BntSeq, Annotation, n=30000):
    """A random genome (either package's BntSeq) with 40-60 bp segments
    copied 1-3 times elsewhere, so that reads over a segment's source
    have reseed (pass 2) hits."""
    rng = np.random.RandomState(5)
    seq = rng.randint(0, 4, n).astype(np.uint8)
    for k in range(6):
        src, ln = 2030 + 2000 * k, 40 + 4 * k
        for c in range(1 + k % 3):
            dst = 16000 + 2000 * k + 600 * c
            seq[dst: dst + ln] = seq[src: src + ln]
    return BntSeq(l_pac=n, anns=[Annotation(name="ctg0", anno="(null)",
                                            offset=0, length=n, n_ambs=0)],
                  ambs=[], seq=seq)


def _one_pos_reads(seq):
    """Reads over the copied segments (exact and with one substitution),
    random reads with 3% errors (half reverse-complemented), N bases, a
    tandem repeat, a 40 bp read and an empty one, 101 columns."""
    rng = np.random.RandomState(11)
    comp = np.array([3, 2, 1, 0], np.int32)
    rows = []
    for k in range(6):
        r = seq[2000 + 2000 * k: 2101 + 2000 * k].astype(np.int32)
        r2 = r.copy()
        r2[5] = (r2[5] + 1) % 4
        rows += [r, r2]
    for i in range(12):
        p = rng.randint(0, len(seq) - 101)
        r = seq[p: p + 101].astype(np.int32)
        e = rng.rand(101) < 0.03
        r[e] = (r[e] + rng.randint(1, 4, e.sum())) % 4
        rows.append(comp[r[::-1]] if i % 2 else r)
    withn = rows[12].copy()
    withn[[10, 50]] = 4
    rows += [withn, np.tile(seq[100:130].astype(np.int32), 4)[:101],
             rows[13][:40].copy(), rows[14][:0].copy()]
    codes = np.full((len(rows), 101), 4, dtype=np.int32)
    for i, c in enumerate(rows):
        codes[i, : len(c)] = c
    return codes, np.array([len(c) for c in rows], dtype=np.int32)


@pytest.fixture(scope="module")
def planted():
    """The planted genome indexed by the JAX package, both packages'
    device indexes on the CPU, and the reads."""
    from bwa_mem_scale_tpu.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    idx = build_index(_planted_genome(BntSeq, Annotation))
    return (JFmi.from_host(idx), TFmi.from_host(idx, "cpu"),
            _one_pos_reads(idx.bns.seq))


def _twin(fmi, codes, lens, tasks, chain, min_seed_len, M, sd):
    out = smem_cuda.one_pos_twin(
        fmi.count.cpu().numpy(), fmi.cp_fused.cpu().numpy(),
        fmi.sentinel_index, codes.cpu().numpy(), lens.cpu().numpy(),
        *(t.cpu().numpy() for t in tasks), chain, min_seed_len, M, sd)
    return out[:6], out[6]


@pytest.mark.parametrize("case", list(ONE_POS_CASES))
def test_one_pos_twin_equal_to_lockstep_and_jax(planted, case):
    """The kernel's twin equals the port's lockstep machine and the JAX
    package's one-hot machine in every field and cnt; its longest lane's
    steps stay within the lockstep's ticks."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_oh import one_pos_machine_oh
    jf, tf, reads = planted
    codes, lens = (torch.as_tensor(a) for a in reads)
    msl = TOpt().min_seed_len
    chain = ONE_POS_CASES[case][1]
    tasks, M, sd = _tasks(tf, codes, lens, case, msl)
    stats = {}
    plain = one_pos_machine(tf, codes, lens, *tasks, chain, msl, M, sd,
                            stats)
    twin, steps = _twin(tf, codes, lens, tasks, chain, msl, M, sd)
    T = tasks[0].shape[0]
    want = one_pos_machine_oh(
        jf, jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()),
        *(jnp.asarray(t.numpy()) for t in tasks), chain, msl, M,
        JBuf.empty(T, M, jf.pos_dtype), stack_depth=sd)
    for f, tw in zip(FIELDS, twin):
        np.testing.assert_array_equal(getattr(plain, f).numpy(), tw, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), tw, f)
    assert 0 < steps.max() <= stats["seed_ticks"]
    cnt = twin[5]
    assert (cnt > 0).any()
    if case == "stack-overflow":
        assert (cnt == M + 1).any()
    elif case == "emit-overflow":
        assert (cnt > M).any()


def test_one_pos_cuda_wrapper_on_cpu_runs_plain(planted):
    """On CPU tensors the wrapper is the plain version (no launch), with
    the lockstep's tick count in stats."""
    _, tf, reads = planted
    codes, lens = (torch.as_tensor(a) for a in reads)
    tasks, M, sd = _tasks(tf, codes, lens, "d24-chain", 19)
    before = smem_cuda.one_pos_machine_cuda.launches
    st_a, st_b = {}, {}
    a = smem_cuda.one_pos_machine_cuda(tf, codes, lens, *tasks, True, 19, M,
                                       sd, st_a, "seed_ticks_p1")
    b = one_pos_machine(tf, codes, lens, *tasks, True, 19, M, sd, st_b,
                        "seed_ticks_p1")
    assert smem_cuda.one_pos_machine_cuda.launches == before
    assert st_a == st_b and st_a["seed_ticks_p1"] > 0
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- pass 3: the CUDA kernel's twin, the lockstep and JAX -------------

# the emission depth max_out of pass 3 (None: the read length); the last
# overflows it on every read with more than two seeds
SEED_STRATEGY_CASES = {"d24": 24, "d48": 48, "dL": None,
                       "emit-overflow": 2}


def _seed_strategy_args(codes, case):
    """(max_intv, min_seed_len, max_out) as collect_smems_oh passes them:
    max_mem_intv, min_seed_len + 1 and the emission depth."""
    opt = TOpt()
    M = SEED_STRATEGY_CASES[case] or codes.shape[1]
    return opt.max_mem_intv, opt.min_seed_len + 1, M


def _seed_twin(fmi, codes, lens, args):
    out = smem_cuda.seed_strategy_twin(
        fmi.count.cpu().numpy(), fmi.cp_fused.cpu().numpy(),
        fmi.sentinel_index, codes.cpu().numpy(), lens.cpu().numpy(), *args)
    return out[:6], out[6]


@pytest.mark.parametrize("case", list(SEED_STRATEGY_CASES))
def test_seed_strategy_twin_equal_to_lockstep_and_jax(planted, case):
    """Pass 3: the kernel's twin equals the port's lockstep machine and
    the JAX package's one-hot machine in every field and cnt (reads with
    N bases, an empty read, a tandem repeat); its longest lane's steps
    stay within the lockstep's ticks."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_oh import seed_strategy_machine_oh
    jf, tf, reads = planted
    codes, lens = (torch.as_tensor(a) for a in reads)
    args = _seed_strategy_args(codes, case)
    stats = {}
    plain = seed_strategy_machine(tf, codes, lens, *args, stats)
    twin, steps = _seed_twin(tf, codes, lens, args)
    want = seed_strategy_machine_oh(jf, jnp.asarray(reads[0]),
                                    jnp.asarray(reads[1]), *args)
    for f, tw in zip(FIELDS, twin):
        np.testing.assert_array_equal(getattr(plain, f).numpy(), tw, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), tw, f)
    assert 0 < steps.max() <= stats["seed_ticks_p3"]
    cnt = twin[5]
    assert (cnt > 0).any() and (codes == 4).any()
    if case == "emit-overflow":
        assert (cnt > args[2]).any()


def test_seed_strategy_cuda_wrapper_on_cpu_runs_plain(planted):
    """On CPU tensors the pass-3 wrapper is the plain version (no launch),
    with the lockstep's tick count in stats."""
    _, tf, reads = planted
    codes, lens = (torch.as_tensor(a) for a in reads)
    args = _seed_strategy_args(codes, "d24")
    before = smem_cuda.seed_strategy_machine_cuda.launches
    st_a, st_b = {}, {}
    a = smem_cuda.seed_strategy_machine_cuda(tf, codes, lens, *args, st_a)
    b = seed_strategy_machine(tf, codes, lens, *args, st_b)
    assert smem_cuda.seed_strategy_machine_cuda.launches == before
    assert st_a == st_b and st_a["seed_ticks_p3"] > 0
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- on the card ------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_genome():
    """The planted genome indexed by the port (no JAX on the card) with
    the twin's reads, and a 512-read batch of 101 bp (1% errors) on a
    1 Mbp genome."""
    _cuda()
    from bwa_mem_scale_tpu_torch.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    idx = build_index(_planted_genome(BntSeq, Annotation))
    big_bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    big = simulate_reads(big_bns, 512, 101, seed=8, err_rate=0.01)
    return idx, _one_pos_reads(idx.bns.seq), build_index(big_bns), big


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ONE_POS_CASES) + ["batch-512"])
def test_one_pos_kernel_equal_to_plain(card_genome, case):
    """The kernel against the plain version on the card, every field and
    cnt, over the twin's cases and at phase 4's batch shape (512 reads
    of 101 bp, pass 1 at depth 24); its per-lane steps equal the twin's
    on the small cases."""
    dev = _cuda()
    idx, small, big_idx, big = card_genome
    if case == "batch-512":
        idx, small = big_idx, big
    fmi = TFmi.from_host(idx, dev)
    codes, lens = (torch.as_tensor(a, device=dev) for a in small)
    msl = TOpt().min_seed_len
    key = "d24-chain" if case == "batch-512" else case
    chain = ONE_POS_CASES[key][1]
    tasks, M, sd = _tasks(TFmi.from_host(idx, "cpu"), codes.cpu(),
                          lens.cpu(), key, msl)
    tasks = [t.to(dev) for t in tasks]
    before = smem_cuda.one_pos_machine_cuda.launches
    got = smem_cuda.one_pos_machine_cuda(fmi, codes, lens, *tasks, chain,
                                         msl, M, sd)
    torch.cuda.synchronize()
    assert smem_cuda.one_pos_machine_cuda.launches == before + 1
    steps = smem_cuda.one_pos_machine_cuda.last_steps.cpu().numpy()
    want = one_pos_machine(fmi, codes, lens, *tasks, chain, msl, M, sd)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.cnt.max()) > 0
    if case != "batch-512":
        _, twin_steps = _twin(fmi, codes, lens, tasks, chain, msl, M, sd)
        np.testing.assert_array_equal(steps, twin_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,reseed_factor", [(24, 2), (48, 8),
                                                 (None, 256)])
def test_collect_smems_kernel_equal_to_plain(card_genome, monkeypatch,
                                             depth, reseed_factor):
    """collect_smems_oh with the kernels for passes 1-2 and pass 3 against
    the same function with the plain machines swapped in, at the three
    tier depths on the 512-read batch: equal SmemBuf, two launches of
    the passes 1-2 kernel and one of the pass-3 kernel."""
    from bwa_mem_scale_tpu_torch.ops import smem_oh
    dev = _cuda()
    _, _, idx, big = card_genome
    fmi = TFmi.from_host(idx, dev)
    codes, lens = (torch.as_tensor(a, device=dev) for a in big)
    opt = TOpt()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              emit_depth=depth, stack_depth=depth,
              reseed_factor=reseed_factor)
    before = smem_cuda.one_pos_machine_cuda.launches
    before3 = smem_cuda.seed_strategy_machine_cuda.launches
    stats = {}
    got = t_collect(fmi, codes, lens, stats=stats, **kw)
    torch.cuda.synchronize()
    assert smem_cuda.one_pos_machine_cuda.launches == before + 2
    assert smem_cuda.seed_strategy_machine_cuda.launches == before3 + 1
    assert int(stats["seed_steps_p1"]) > 0
    assert int(stats["seed_steps_p3"]) > 0
    monkeypatch.setattr(smem_oh, "one_pos_machine_cuda", one_pos_machine)
    monkeypatch.setattr(smem_oh, "seed_strategy_machine_cuda",
                        seed_strategy_machine)
    want = t_collect(fmi, codes, lens, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEED_STRATEGY_CASES)
                         + ["batch-512-d24", "batch-512-d48",
                            "batch-512-dL"])
def test_seed_strategy_kernel_equal_to_plain(card_genome, case):
    """The pass-3 kernel against the plain version on the card, every
    field and cnt, over the twin's cases and on the 512-read batch at the
    three tier depths; its per-lane steps equal the twin's."""
    dev = _cuda()
    idx, small, big_idx, big = card_genome
    key = case
    if case.startswith("batch-512"):
        idx, small, key = big_idx, big, case.split("-")[-1]
    fmi = TFmi.from_host(idx, dev)
    codes, lens = (torch.as_tensor(a, device=dev) for a in small)
    args = _seed_strategy_args(codes, key)
    before = smem_cuda.seed_strategy_machine_cuda.launches
    got = smem_cuda.seed_strategy_machine_cuda(fmi, codes, lens, *args)
    torch.cuda.synchronize()
    assert smem_cuda.seed_strategy_machine_cuda.launches == before + 1
    steps = smem_cuda.seed_strategy_machine_cuda.last_steps.cpu().numpy()
    want = seed_strategy_machine(fmi, codes, lens, *args)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.cnt.max()) > 0
    _, twin_steps = _seed_twin(fmi, codes, lens, args)
    np.testing.assert_array_equal(steps, twin_steps)
