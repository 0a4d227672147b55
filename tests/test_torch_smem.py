"""Port vs JAX: the three-pass one-hot SMEM collection
(bwa_mem_scale_tpu_torch.ops.smem_oh.collect_smems_oh against
bwa_mem_scale_tpu.ops.smem_oh.collect_smems_oh). Whole arrays are
compared, slots past the count included, so the stable final sort and
the overflow contract (cnt forced to capacity) are both held.

Passes 1 and 2 (``one_pos_machine``): the CUDA kernel's CPU twin
(``smem_cuda.one_pos_twin``: the kernel's warp a task, its backward
rounds in chunks of 32 lanes under the ballot-form keep/emit rule)
against the port's lockstep ``one_pos_machine`` and the JAX package's
``one_pos_machine_oh``, every field and ``cnt`` and each task's steps,
at the tiers' depths (24, 48, the read length), with and without chain
restarts, and with the stack, the emission depth and the reseed budget
overflowing; then on a genome with 40 planted copies of a read's
prefixes, where a round takes two chunks (with and without stack
overflow), and pass-2 tasks mid-read. On a GPU the kernel against the
plain version over the same cases and at a 512-read batch, its steps and
rounds equal to the twin's, and with its stacks in a device scratch.

Pass 3 (``seed_strategy_machine``): the twin ``smem_cuda.
seed_strategy_twin`` (the kernel's flat loop) against the lockstep and
the JAX package's
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
    collect_smems_oh as t_collect, one_pos_machine, seed_strategy_machine)
from bwa_mem_scale_tpu_torch.ops import smem_cuda
from bwa_mem_scale_tpu_torch.ops.smem import compact_indices, reseed_tasks

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
    """The twin's (m, n, k, l, s, cnt), steps and rounds."""
    out = smem_cuda.one_pos_twin(
        fmi.count.cpu().numpy(), fmi.cp_fused.cpu().numpy(),
        fmi.sentinel_index, codes.cpu().numpy(), lens.cpu().numpy(),
        *(t.cpu().numpy() for t in tasks), chain, min_seed_len, M, sd)
    return out[:6], out[6], out[7]


@pytest.mark.parametrize("case", list(ONE_POS_CASES))
def test_one_pos_twin_equal_to_lockstep_and_jax(planted, case):
    """The kernel's twin equals the port's lockstep machine and the JAX
    package's one-hot machine in every field and cnt; each task's steps
    equal the lockstep's occ extensions, and its rounds are at most its
    steps."""
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
    plain_steps = one_pos_machine.last_steps.numpy()
    twin, steps, rounds = _twin(tf, codes, lens, tasks, chain, msl, M, sd)
    T = tasks[0].shape[0]
    want = one_pos_machine_oh(
        jf, jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()),
        *(jnp.asarray(t.numpy()) for t in tasks), chain, msl, M,
        JBuf.empty(T, M, jf.pos_dtype), stack_depth=sd)
    for f, tw in zip(FIELDS, twin):
        np.testing.assert_array_equal(getattr(plain, f).numpy(), tw, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), tw, f)
    np.testing.assert_array_equal(steps, plain_steps)
    assert 0 < steps.max() <= stats["seed_ticks"]
    assert (rounds <= steps).all() and (rounds < steps).any()
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


# ---- passes 1 and 2 on rounds of more than 32 entries -----------------

# (stack_depth, chain_restarts, max_out), None the read length: pass 1
# over reads whose stacks pass 32 entries, at full depth and overflowing
# at 24; pass-2 tasks mid-read (with and without a stack overflow)
CHUNK_CASES = {"chunks-dL": (None, True, None), "chunks-d24": (24, True, 24),
               "mid-read-dL": (None, False, None),
               "mid-read-d24": (24, False, 24)}


def _prefix_genome(BntSeq, Annotation, n=40000):
    """A random genome (either package's BntSeq) and a 101 bp read whose
    first 29 bases come from 1,000 and the rest from 4,999 (neither
    extends across the seam), with 40 copies of the read's columns
    [29 - i % 9, 50 + i) planted 750 bp apart from 8,000, each flanked by
    bases the read does not have. Pass 1 from 0 restarts at 29, whose
    forward walk changes interval size at each copy's end: a stack of
    over 32 entries, and backward rounds that keep the copies with
    enough left context, 9 rounds deep. Returns (bns, read)."""
    rng = np.random.RandomState(7)
    seq = rng.randint(0, 4, n).astype(np.uint8)
    s1, s2 = 1000, 5000
    seq[s1 + 29] = (seq[s2 - 1] + 1) % 4
    seq[s2 - 2] = (seq[s1 + 28] + 1) % 4
    read = np.concatenate([seq[s1:s1 + 29],
                           seq[s2 - 1:s2 + 71]]).astype(np.int32)
    for i in range(40):
        d, end = i % 9, 50 + i
        dst = 8000 + 750 * i
        seq[dst: dst + end - 29 + d] = read[29 - d: end]
        seq[dst + end - 29 + d] = (read[end] + 1) % 4
        seq[dst - 1] = (read[28 - d] + 1) % 4
    bns = BntSeq(l_pac=n, anns=[Annotation(name="ctg0", anno="(null)",
                                           offset=0, length=n, n_ambs=0)],
                 ambs=[], seq=seq)
    return bns, read


def _prefix_reads(seq, read):
    """The read, with a substitution at 60, with an N at 75, reverse
    complemented, four genome reads (1% errors) and an empty read."""
    rng = np.random.RandomState(12)
    sub, withn = read.copy(), read.copy()
    sub[60] = (sub[60] + 1) % 4
    withn[75] = 4
    rows = [read, sub, withn, np.array([3, 2, 1, 0], np.int32)[read[::-1]]]
    for _ in range(4):
        p = rng.randint(0, len(seq) - 101)
        r = seq[p: p + 101].astype(np.int32)
        e = rng.rand(101) < 0.01
        r[e] = (r[e] + 1) % 4
        rows.append(r)
    rows.append(read[:0])
    codes = np.full((len(rows), 101), 4, dtype=np.int32)
    for i, c in enumerate(rows):
        codes[i, : len(c)] = c
    return codes, np.array([len(c) for c in rows], dtype=np.int32)


def _chunk_tasks(lens, case):
    """Pass 1 (a task a read from 0, minimum interval 1), or pass-2 tasks
    mid-read: at the seam and inside the planted columns, at the N, at
    each read's last base, past its end, on the empty read, invalid."""
    if CHUNK_CASES[case][1]:
        B = lens.shape[0]
        zi = torch.zeros((B,), dtype=torch.int32)
        return torch.arange(B, dtype=torch.int32), zi, zi + 1, lens > 0
    rd = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 8, 0]
    x = [29, 40, 65, 100, 45, 61, 74, 75, 30, 70, 50, 50, 50, 50, 0, 101]
    mi = [2, 1, 3, 1, 2, 1, 1, 2, 1, 2, 2, 1, 3, 2, 1, 1]
    valid = [True] * 15 + [False]
    as_t = lambda v: torch.tensor(v, dtype=torch.int32)
    return as_t(rd), as_t(x), as_t(mi), torch.tensor(valid)


@pytest.fixture(scope="module")
def prefixes():
    """The planted-prefix genome indexed by the JAX package, both
    packages' device indexes on the CPU, and the reads."""
    from bwa_mem_scale_tpu.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    bns, read = _prefix_genome(BntSeq, Annotation)
    idx = build_index(bns)
    return (JFmi.from_host(idx), TFmi.from_host(idx, "cpu"),
            _prefix_reads(idx.bns.seq, read))


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_one_pos_twin_chunked_rounds(prefixes, case):
    """Rounds of more than 32 entries (two chunks: the ballot's count and
    the size carried across the chunk edge) and pass-2 tasks mid-read:
    the twin equals the lockstep and the JAX machine in every field and
    cnt, and each task's steps equal the lockstep's. The read's stack
    passes 32 entries (it overflows at depth 32), so its rounds fall
    short of its steps; at depth 24 it overflows."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_oh import one_pos_machine_oh
    jf, tf, reads = prefixes
    codes, lens = (torch.as_tensor(a) for a in reads)
    msl = TOpt().min_seed_len
    sd, chain, M = CHUNK_CASES[case]
    M = M or codes.shape[1]
    tasks = _chunk_tasks(lens, case)
    plain = one_pos_machine(tf, codes, lens, *tasks, chain, msl, M, sd)
    plain_steps = one_pos_machine.last_steps.numpy()
    twin, steps, rounds = _twin(tf, codes, lens, tasks, chain, msl, M, sd)
    want = one_pos_machine_oh(
        jf, jnp.asarray(reads[0]), jnp.asarray(reads[1]),
        *(jnp.asarray(t.numpy()) for t in tasks), chain, msl, M,
        JBuf.empty(tasks[0].shape[0], M, jf.pos_dtype), stack_depth=sd)
    for f, tw in zip(FIELDS, twin):
        np.testing.assert_array_equal(getattr(plain, f).numpy(), tw, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), tw, f)
    np.testing.assert_array_equal(steps, plain_steps)
    assert (rounds <= steps).all() and rounds[0] < steps[0]
    cnt = twin[5]
    assert (cnt[:-1] > 0).any()
    if chain:
        deep, _, _ = _twin(tf, codes, lens, tasks, chain, msl, M, 32)
        assert deep[5][0] == M + 1                   # over 32 entries
        assert (cnt[0] == M + 1) == (sd == 24)


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
    N bases, an empty read, a tandem repeat); each read's steps equal the
    lockstep's occ extensions."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_oh import seed_strategy_machine_oh
    jf, tf, reads = planted
    codes, lens = (torch.as_tensor(a) for a in reads)
    args = _seed_strategy_args(codes, case)
    stats = {}
    plain = seed_strategy_machine(tf, codes, lens, *args, stats)
    plain_steps = seed_strategy_machine.last_steps.numpy()
    twin, steps = _seed_twin(tf, codes, lens, args)
    want = seed_strategy_machine_oh(jf, jnp.asarray(reads[0]),
                                    jnp.asarray(reads[1]), *args)
    for f, tw in zip(FIELDS, twin):
        np.testing.assert_array_equal(getattr(plain, f).numpy(), tw, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), tw, f)
    np.testing.assert_array_equal(steps, plain_steps)
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
    the twin's reads, a 512-read batch of 101 bp (1% errors) on a 1 Mbp
    genome, and the planted-prefix genome with its reads."""
    _cuda()
    from bwa_mem_scale_tpu_torch.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    idx = build_index(_planted_genome(BntSeq, Annotation))
    big_bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    big = simulate_reads(big_bns, 512, 101, seed=8, err_rate=0.01)
    pre_bns, read = _prefix_genome(BntSeq, Annotation)
    pre = build_index(pre_bns)
    return (idx, _one_pos_reads(idx.bns.seq), build_index(big_bns), big,
            pre, _prefix_reads(pre.bns.seq, read))


def _card_case(card_genome, case, dev):
    """(fmi on dev, codes, lens, tasks, chain, max_out, stack depth) of a
    twin case, a chunk case or batch-512 (phase 4's shape: 512 reads of
    101 bp, pass 1 at depth 24)."""
    idx, small, big_idx, big, pre_idx, pre = card_genome
    msl = TOpt().min_seed_len
    if case in CHUNK_CASES:
        codes, lens = (torch.as_tensor(a) for a in pre)
        sd, chain, M = CHUNK_CASES[case]
        tasks, M = _chunk_tasks(lens, case), M or codes.shape[1]
        idx = pre_idx
    else:
        if case == "batch-512":
            idx, small, case = big_idx, big, "d24-chain"
        codes, lens = (torch.as_tensor(a) for a in small)
        chain = ONE_POS_CASES[case][1]
        tasks, M, sd = _tasks(TFmi.from_host(idx, "cpu"), codes, lens, case,
                              msl)
    return (TFmi.from_host(idx, dev), codes.to(dev), lens.to(dev),
            [t.to(dev) for t in tasks], chain, M, sd)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ONE_POS_CASES) + list(CHUNK_CASES)
                         + ["batch-512"])
def test_one_pos_kernel_equal_to_plain(card_genome, case):
    """The kernel against the plain version on the card, every field and
    cnt, over the twin's cases, the chunk cases and at phase 4's batch
    shape; its per-task steps equal the lockstep's, and on the small
    cases its steps and rounds equal the twin's."""
    dev = _cuda()
    fmi, codes, lens, tasks, chain, M, sd = _card_case(card_genome, case, dev)
    msl = TOpt().min_seed_len
    before = smem_cuda.one_pos_machine_cuda.launches
    got = smem_cuda.one_pos_machine_cuda(fmi, codes, lens, *tasks, chain,
                                         msl, M, sd)
    torch.cuda.synchronize()
    assert smem_cuda.one_pos_machine_cuda.launches == before + 1
    steps = smem_cuda.one_pos_machine_cuda.last_steps.cpu().numpy()
    rounds = smem_cuda.one_pos_machine_cuda.last_rounds.cpu().numpy()
    want = one_pos_machine(fmi, codes, lens, *tasks, chain, msl, M, sd)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(steps,
                                  one_pos_machine.last_steps.cpu().numpy())
    assert int(got.cnt.max()) > 0 and (rounds <= steps).all()
    if case != "batch-512":
        _, twin_steps, twin_rounds = _twin(fmi, codes, lens, tasks, chain,
                                           msl, M, sd)
        np.testing.assert_array_equal(steps, twin_steps)
        np.testing.assert_array_equal(rounds, twin_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d24-chain", "dL-reseed", "chunks-dL"])
def test_one_pos_kernel_stacks_in_scratch(card_genome, case):
    """At a stack depth past one warp's shared memory (8,000 entries, 256
    KB of stacks) the wrapper gives the kernel a device scratch for its
    stacks: equal to the plain version at that depth, steps and rounds
    equal to the twin's."""
    dev = _cuda()
    fmi, codes, lens, tasks, chain, M, _ = _card_case(card_genome, case, dev)
    sd = 8000
    assert not smem_cuda.LIB.call("one_pos_stacks_in_shared",
                                  codes.shape[1], sd)
    msl = TOpt().min_seed_len
    got = smem_cuda.one_pos_machine_cuda(fmi, codes, lens, *tasks, chain,
                                         msl, M, sd)
    torch.cuda.synchronize()
    want = one_pos_machine(fmi, codes, lens, *tasks, chain, msl, M, sd)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _, twin_steps, twin_rounds = _twin(fmi, codes, lens, tasks, chain, msl,
                                       M, sd)
    np.testing.assert_array_equal(
        smem_cuda.one_pos_machine_cuda.last_steps.cpu().numpy(), twin_steps)
    np.testing.assert_array_equal(
        smem_cuda.one_pos_machine_cuda.last_rounds.cpu().numpy(),
        twin_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,reseed_factor", [(24, 2), (48, 8),
                                                 (None, 256)])
def test_collect_smems_kernel_equal_to_plain(card_genome, monkeypatch,
                                             depth, reseed_factor):
    """collect_smems_oh with the kernels for passes 1-2 and pass 3 and the
    glue's two (the task list, the merge) against the same function with
    the plain machines and the plain glue swapped in, at the three tier
    depths on the 512-read batch: equal SmemBuf, two launches of the
    passes 1-2 kernel, one of the pass-3 kernel and one of each glue
    kernel."""
    from bwa_mem_scale_tpu_torch.ops import smem_oh
    from bwa_mem_scale_tpu_torch.ops.smem import (merge_smems_plain,
                                                  reseed_task_list)
    dev = _cuda()
    _, _, idx, big, _, _ = card_genome
    fmi = TFmi.from_host(idx, dev)
    codes, lens = (torch.as_tensor(a, device=dev) for a in big)
    opt = TOpt()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              emit_depth=depth, stack_depth=depth,
              reseed_factor=reseed_factor)
    before = smem_cuda.one_pos_machine_cuda.launches
    before3 = smem_cuda.seed_strategy_machine_cuda.launches
    glue = (smem_cuda.reseed_tasks_cuda, smem_cuda.merge_smems_cuda)
    before_glue = [w.launches for w in glue]
    stats = {}
    got = t_collect(fmi, codes, lens, stats=stats, **kw)
    torch.cuda.synchronize()
    assert smem_cuda.one_pos_machine_cuda.launches == before + 2
    assert smem_cuda.seed_strategy_machine_cuda.launches == before3 + 1
    assert [w.launches - n for w, n in zip(glue, before_glue)] == [1, 1]
    assert int(stats["seed_steps_p1"]) > 0
    assert 0 < int(stats["seed_rounds_p1"]) <= int(stats["seed_steps_p1"])
    assert int(stats["seed_rounds_p2"]) <= int(stats["seed_steps_p2"])
    assert int(stats["seed_steps_p3"]) > 0
    monkeypatch.setattr(smem_oh, "one_pos_machine_cuda", one_pos_machine)
    monkeypatch.setattr(smem_oh, "seed_strategy_machine_cuda",
                        seed_strategy_machine)
    monkeypatch.setattr(smem_oh, "reseed_tasks_cuda", reseed_task_list)
    monkeypatch.setattr(smem_oh, "merge_smems_cuda", merge_smems_plain)
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
    three tier depths; its per-lane steps equal the twin's and the
    lockstep's."""
    dev = _cuda()
    idx, small, big_idx, big, _, _ = card_genome
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
    np.testing.assert_array_equal(
        steps, seed_strategy_machine.last_steps.cpu().numpy())
    _, twin_steps = _seed_twin(fmi, codes, lens, args)
    np.testing.assert_array_equal(steps, twin_steps)


@pytest.mark.cuda
def test_seed_strategy_kernel_long_reads(card_genome):
    """Reads of 29,100 columns: 8 reads' codes pass 227 KB, so a block
    takes 7 (16 reads: two full blocks and a partial one); equal to the
    plain version, steps equal to the lockstep's."""
    dev = _cuda()
    idx = card_genome[2]                             # the 1 Mbp genome
    rng = np.random.RandomState(21)
    L, B = 29_100, 16
    seq = idx.bns.seq.astype(np.int32)
    codes = np.stack([seq[p: p + L] for p in
                      rng.randint(0, len(seq) - L, B)]).astype(np.int32)
    codes[rng.rand(B, L) < 0.01] = 4
    lens = rng.randint(L - 500, L + 1, B).astype(np.int32)
    fmi = TFmi.from_host(idx, dev)
    c, ln = torch.as_tensor(codes, device=dev), torch.as_tensor(lens,
                                                                device=dev)
    args = _seed_strategy_args(c, "d48")
    got = smem_cuda.seed_strategy_machine_cuda(fmi, c, ln, *args)
    torch.cuda.synchronize()
    want = seed_strategy_machine(fmi, c, ln, *args)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.cnt > 0).all()
    np.testing.assert_array_equal(
        smem_cuda.seed_strategy_machine_cuda.last_steps.cpu().numpy(),
        seed_strategy_machine.last_steps.cpu().numpy())
