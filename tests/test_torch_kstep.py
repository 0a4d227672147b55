"""Port vs JAX: the k-step FM fold (``bwa_mem_scale_tpu_torch.index.kstep``,
the k-gram primitives of ``ops/occ.py`` and the k-step branches of the
seeding machines) against ``bwa_mem_scale_tpu.index.kstep`` and the JAX
package's ``ops/occ.py`` / ``ops/smem_oh.py`` / ``ops/smem.py``, exact
(tolerance 0: integer intervals), on one ~9 kbp genome (the JAX
package's ``tests/test_kstep.py`` shape: 24 reads of 48 bp, 5% errors, 1%
N bases, ragged lengths, plus a tandem repeat).

- ``build_cp2`` at K = 2 and 3 writes the JAX builder's arrays, each
  package loads the other's ``.cp{K}.npz``, and ``extract_bwt`` equals
  the JAX one.
- ``backward_ext2`` / ``backward_ext3``, ``forward_ext2`` /
  ``forward_ext3`` and ``backward_ext_steps_and_1`` equal the JAX
  primitives for every base pair (or triple) on reachable intervals, the
  sentinel-crossing full interval and the 1-base intervals included.
- ``one_pos_machine`` at K = 2 and 3 and ``seed_strategy_machine`` with
  either table equal the JAX ``*_oh`` machines with the same table and
  the port's K = 1 output, each lane's steps equal to K = 1's; the CUDA
  kernels' twins (``smem_cuda.one_pos_twin`` / ``seed_strategy_twin``
  with ``kstep=``) equal the plain versions, steps included, in fewer
  rounds.
- passes 1-2 where the k-step backward rounds meet their edges (the
  planted-prefix genome's rounds past 32 entries at depth 48 and L, the
  edge reads' k-steps ending at the read's start and at an N, intervals
  holding the sentinel row inside a step, stacks overflowed at depth 4):
  the lockstep, the JAX machine and the twin equal, the shapes counted by
  the twin's ``events``; and each k-step twin reads the k-gram table
  alone (no ``cp_fused`` row).
- ``extend_all_positions`` with the table, with and without the FMA
  ladders, merged with pass 3 and not, equals the JAX function; the
  twin ``sweep_cuda.sweep_extend_twin`` equals it, steps included, and
  in its pass forms equals ``sweep_pass_plain`` at K = 2.
On a GPU (``-m cuda``) each k-step kernel against its plain version and
the K = 1 kernel's output on the port's own index, the twin's steps and
rounds on the small batch, the edge reads and the planted-prefix reads
(at the depths above), a 512-read batch on a 1 Mbp genome and (the
sweep's pass 2, which emits only repeats) 512 reads of a genome with
repeats; each launch emits. The
JAX side is imported inside the tests that use it, so the CUDA cases also
run on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_kstep.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.index import kstep as tk
from bwa_mem_scale_tpu_torch.ops import occ as tocc
from bwa_mem_scale_tpu_torch.ops import smem as tsmem
from bwa_mem_scale_tpu_torch.ops import smem_cuda, sweep_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import reseed_tasks
from bwa_mem_scale_tpu_torch.ops.smem_oh import (one_pos_machine,
                                                 seed_strategy_machine)

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("m", "n", "k", "l", "s", "cnt")
MSL = 10                       # min_seed_len of the machine cases


def _reads(seq):
    """24 reads of 48 bp from the genome at 5% errors (half
    reverse-complemented), 1% N bases, every fifth read shorter, and read
    3 a tandem repeat."""
    rng = np.random.RandomState(16)
    comp = np.array([3, 2, 1, 0], np.int32)
    codes = np.empty((24, 48), np.int32)
    for i in range(24):
        p = rng.randint(0, len(seq) - 48)
        r = seq[p:p + 48].astype(np.int32)
        e = rng.rand(48) < 0.05
        r[e] = (r[e] + rng.randint(1, 4, e.sum())) % 4
        codes[i] = comp[r[::-1]] if i % 2 else r
    codes[rng.rand(*codes.shape) < 0.01] = 4
    codes[3] = np.tile(seq[300:307].astype(np.int32), 8)[:48]
    lens = np.full(24, 48, dtype=np.int32)
    lens[::5] = 48 - rng.randint(0, 9, size=5)
    return codes, lens


@pytest.fixture(scope="module")
def side():
    """The genome indexed by the JAX package, both packages' tables at K =
    2 and 3, both packages' device indexes at K = 1, 2, 3 and the reads."""
    from conftest import make_genome
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index import kstep as jk
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    idx = build_index(make_genome(9000, seed=13))
    jt = {K: jk.build_cp2(idx, K) for K in (2, 3)}
    tt = {K: tk.build_cp2(idx, K) for K in (2, 3)}
    return dict(
        idx=idx, jt=jt, tt=tt,
        jf={1: JFmi.from_host(idx),
            **{K: JFmi.from_host(idx, cp2=jt[K]) for K in (2, 3)}},
        tf={1: TFmi.from_host(idx, "cpu"),
            **{K: TFmi.from_host(idx, "cpu", cp2=tt[K]) for K in (2, 3)}},
        reads=_reads(idx.bns.seq))


# ---- the table --------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 3])
def test_build_cp2_equal_to_jax(side, tmp_path, K):
    """The port's builder writes the JAX builder's arrays, and each
    package loads the other's file."""
    from bwa_mem_scale_tpu.index import kstep as jk
    j, t = side["jt"][K], side["tt"][K]
    assert t.K == K and t.fused.shape[1] == (168 if K == 3 else 40)
    for f in ("fused", "c2", "c3"):
        a, b = getattr(j, f), getattr(t, f)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert j.seq_len == t.seq_len and j.nbytes() == t.nbytes()
    from_port = jk.load_cp2(tk.save_cp2(t, str(tmp_path / "t")))
    from_jax = tk.load_cp2(jk.save_cp2(j, str(tmp_path / "j")))
    for got in (from_port, from_jax):
        assert got.K == K and got.seq_len == j.seq_len
        np.testing.assert_array_equal(got.fused, j.fused)
        np.testing.assert_array_equal(got.c2, j.c2)
        if K == 3:
            np.testing.assert_array_equal(got.c3, j.c3)


def test_extract_bwt_equal_to_jax(side):
    from bwa_mem_scale_tpu.index import kstep as jk
    np.testing.assert_array_equal(tk.extract_bwt(side["idx"]),
                                  jk.extract_bwt(side["idx"]))


def test_device_table(side):
    """The device layout holds the file's counts and masks regrouped, the
    int64 layout refuses a table (the JAX error), and nbytes counts it."""
    idx, t2 = side["idx"], side["tt"][2]
    f = side["tf"][2]
    assert f.kstep == 2 and side["tf"][3].kstep == 3
    assert side["tf"][1].kstep == 1
    rows = f.cp_kstep.numpy()
    np.testing.assert_array_equal(rows[:, :8],
                                  side["tf"][1].cp_fused.numpy())
    np.testing.assert_array_equal(
        rows[:, 8:40].reshape(-1, 4, 2, 4)[:, :, 0].reshape(-1, 16),
        t2.fused[:, :16])
    assert f.nbytes() - side["tf"][1].nbytes() == t2.fused.nbytes + 64
    with pytest.raises(ValueError, match="k-step table is int32-path only"):
        TFmi.from_host(idx, "cpu", force_int64=True, cp2=t2)


# ---- the primitives ---------------------------------------------------------

def _intervals(side):
    """Reachable (k, l, s) bi-intervals (random 1-base intervals extended
    backward a few times, the JAX package's test helper), the full
    interval (it holds the sentinel row) and every 1-base interval."""
    from test_kstep import _random_intervals
    idx = side["idx"]
    k, l, s = _random_intervals(idx, side["jf"][1], 128, seed=23)
    count = np.asarray(idx.count, np.int64)
    k = np.concatenate([k, [0], count[:4]]).astype(np.int32)
    l = np.concatenate([l, [0], count[3::-1][:4]]).astype(np.int32)
    s = np.concatenate([s, [idx.seq_len], count[1:5] - count[:4]]
                       ).astype(np.int32)
    return k, l, s


@pytest.mark.parametrize("K", [2, 3])
def test_primitives_equal_to_jax(side, K):
    """Every k-gram primitive at the K-table equals the JAX one, for
    every base combination on each interval (lanes = intervals x combos),
    and its last step equals K chained 1-step extensions where alive."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import occ as jocc
    jf, tf = side["jf"][K], side["tf"][K]
    k, l, s = _intervals(side)
    combos = np.array(np.meshgrid(*[np.arange(4)] * K, indexing="ij")
                      ).reshape(K, -1).T.astype(np.int32)     # [4^K, K]
    n = len(k)
    kk, ll, ss = (np.repeat(v, len(combos)) for v in (k, l, s))
    cs = [np.tile(combos[:, d], n) for d in range(K)]
    J = lambda v: jnp.asarray(v)
    T = lambda v: torch.as_tensor(v)

    def eq(want, got, what):
        assert len(want) == len(got), what
        for i, (wt, gt) in enumerate(zip(want, got)):
            for f, w, g in zip("kls", wt, gt):
                assert g.dtype == torch.int32, (what, i, f)
                np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                              f"{what} step {i} {f}")

    if K == 2:
        pairs = (("backward_ext2", jocc.backward_ext2, tocc.backward_ext2),
                 ("forward_ext2", jocc.forward_ext2, tocc.forward_ext2))
    else:
        pairs = (("backward_ext3", jocc.backward_ext3, tocc.backward_ext3),
                 ("forward_ext3", jocc.forward_ext3, tocc.forward_ext3))
    for name, jfn, tfn in pairs:
        want = jfn(jf, J(kk), J(ll), J(ss), *map(J, cs))
        got = tfn(tf, T(kk), T(ll), T(ss), *map(T, cs))
        eq(want, got, name)
    # the K-step and side steps of one fetch (the lockstep's FWD/BSCAN)
    sides_j = [(J(ll), J(kk), J(ss), J(cs[-1]))] if K == 3 else []
    sides_t = [(T(ll), T(kk), T(ss), T(cs[-1]))] if K == 3 else []
    want = jocc.backward_ext_steps_and_1(
        jf, J(kk), J(ll), J(ss), tuple(map(J, cs)), J(ll), J(kk), J(ss),
        J(cs[0]), sides=sides_j)
    got = tocc.backward_ext_steps_and_1(
        tf, T(kk), T(ll), T(ss), tuple(map(T, cs)), T(ll), T(kk), T(ss),
        T(cs[0]), sides=sides_t)
    eq(want, got, "backward_ext_steps_and_1")
    # the last step equals K chained forward_ext calls where the walk is
    # alive before it
    t1 = side["tf"][1]
    cur = (T(kk), T(ll), T(ss))
    alive = ss > 0
    for d in range(K):
        alive = alive & (cur[2].numpy() > 0)
        cur = tocc.forward_ext(t1, *cur, T(cs[d]))
    last = tocc.forward_ext3(tf, T(kk), T(ll), T(ss), *map(T, cs))[-1] \
        if K == 3 else tocc.forward_ext2(tf, T(kk), T(ll), T(ss),
                                          *map(T, cs))[-1]
    for g, w in zip(last, cur):
        np.testing.assert_array_equal(g.numpy()[alive], w.numpy()[alive])


# ---- the seeding machines ---------------------------------------------------

# (chain_restarts, stack_depth): pass 1 at the read length, pass 1 with a
# stack of 3 entries (overflows), pass-2 tasks at depth 24
ONE_POS_CASES = {"chain": (True, None), "chain-sd3": (True, 3),
                 "reseed": (False, 24)}
ONE_POS_K = [(2, c) for c in ONE_POS_CASES] + [(3, "chain"),
                                               (3, "reseed")]


def _tasks(tf, codes, lens, case):
    chain, sd = ONE_POS_CASES[case]
    B = codes.shape[0]
    zi = torch.zeros((B,), dtype=torch.int32)
    p1 = (torch.arange(B, dtype=torch.int32), zi, zi + 1, lens > 0)
    if chain:
        return p1
    b1 = one_pos_machine(tf, codes, lens, *p1, True, MSL, 48, sd)
    return reseed_tasks(b1, 2 * B, 15, 10)[:4]


@pytest.mark.parametrize("K,case", ONE_POS_K,
                         ids=[f"K{k}-{c}" for k, c in ONE_POS_K])
def test_one_pos_machine_kstep_equal_to_jax(side, K, case):
    """Passes 1-2 with the K-table: the port's lockstep equals the JAX
    one-hot machine with the same table and the port's K = 1 output, its
    steps K = 1's; the kernel's twin equals it, steps included, in fewer
    rounds than K = 1's twin."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_oh import one_pos_machine_oh
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    chain, sd = ONE_POS_CASES[case]
    tf, t1 = side["tf"][K], side["tf"][1]
    tasks = _tasks(t1, codes, lens, case)
    M = 48
    got = one_pos_machine(tf, codes, lens, *tasks, chain, MSL, M, sd)
    steps = one_pos_machine.last_steps
    one = one_pos_machine(t1, codes, lens, *tasks, chain, MSL, M, sd)
    assert torch.equal(steps, one_pos_machine.last_steps)
    T_ = tasks[0].shape[0]
    want = one_pos_machine_oh(
        side["jf"][K], jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()),
        *(jnp.asarray(t.numpy()) for t in tasks), chain, MSL, M,
        JBuf.empty(T_, M, jnp.int32), stack_depth=sd)
    arg = lambda f: (f.count.numpy(), f.cp_fused.numpy(), f.sentinel_index)
    twins = {}
    for kk, f in ((K, tf), (1, t1)):
        twins[kk] = smem_cuda.one_pos_twin(
            *arg(f), codes.numpy(), lens.numpy(),
            *(t.numpy() for t in tasks), chain, MSL, M, sd,
            kstep=smem_cuda.kstep_tables(f))
    for i, f in enumerate(FIELDS):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), f)
        assert torch.equal(getattr(got, f), getattr(one, f)), f
        np.testing.assert_array_equal(twins[K][i], getattr(got, f).numpy(),
                                      f)
    np.testing.assert_array_equal(twins[K][6], steps.numpy())
    assert (twins[K][7] <= twins[1][7]).all()
    assert twins[K][7].sum() < twins[1][7].sum()
    assert int(got.cnt.sum()) > 0
    if case == "chain-sd3":
        assert (got.cnt.numpy() == M + 1).any()


@pytest.mark.parametrize("K", [2, 3])
def test_seed_strategy_kstep_equal_to_jax(side, K):
    """Pass 3 with the K-table (two bases a tick: a trigram table's bigram
    part): the lockstep equals the JAX machine and the K = 1 output, its
    steps K = 1's; the twin equals it in about half the rounds."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_oh import seed_strategy_machine_oh
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    tf, t1 = side["tf"][K], side["tf"][1]
    args = (20, MSL + 1, 48)
    got = seed_strategy_machine(tf, codes, lens, *args)
    steps = seed_strategy_machine.last_steps
    one = seed_strategy_machine(t1, codes, lens, *args)
    assert torch.equal(steps, seed_strategy_machine.last_steps)
    want = seed_strategy_machine_oh(side["jf"][K], jnp.asarray(codes.numpy()),
                                    jnp.asarray(lens.numpy()), *args)
    twin = smem_cuda.seed_strategy_twin(
        tf.count.numpy(), tf.cp_fused.numpy(), tf.sentinel_index,
        codes.numpy(), lens.numpy(), *args,
        kstep=smem_cuda.kstep_tables(tf))
    for i, f in enumerate(FIELDS):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), f)
        assert torch.equal(getattr(got, f), getattr(one, f)), f
        np.testing.assert_array_equal(twin[i], getattr(got, f).numpy(), f)
    np.testing.assert_array_equal(twin[6], steps.numpy())
    assert (2 * twin[7] >= twin[6]).all() and twin[7].sum() < twin[6].sum()
    assert int(got.cnt.sum()) > 0


# ---- the k-step rounds' shapes -------------------------------------------

@pytest.fixture(scope="module")
def prefix_k():
    """test_torch_smem.py's planted-prefix genome (a read whose backward
    rounds pass 32 entries) with both packages' K = 1, 2, 3 indexes and
    its reads."""
    from test_torch_smem import _prefix_genome, _prefix_reads
    from bwa_mem_scale_tpu.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index import kstep as jk
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    bns, read = _prefix_genome(BntSeq, Annotation)
    idx = build_index(bns)
    return dict(
        jf={K: JFmi.from_host(idx, cp2=jk.build_cp2(idx, K)) for K in (2, 3)},
        tf={1: TFmi.from_host(idx, "cpu"),
            **{K: TFmi.from_host(idx, "cpu", cp2=tk.build_cp2(idx, K))
               for K in (2, 3)}},
        reads=_prefix_reads(idx.bns.seq, read))


def _edge_reads(side):
    """The file's reads, then a read whose last 38 bases are the genome's
    first (its backward intervals from column 10 hold the sentinel row),
    a read with N bases at 20 and 33 and an exact genome read; pass-2
    tasks from columns 10-14, 21-26 and 1-4 of those three."""
    codes, lens = side["reads"]
    seq = side["idx"].bns.seq.astype(np.int32)
    rng = np.random.RandomState(41)
    head = np.concatenate([rng.randint(0, 4, 10), seq[:38]])
    withn = seq[500:548].copy()
    withn[[20, 33]] = 4
    codes = np.concatenate([codes, head[None], withn[None],
                            seq[None, 2000:2048]]).astype(np.int32)
    lens = np.concatenate([lens, [48, 48, 48]]).astype(np.int32)
    B = len(lens)
    x = list(range(10, 15)) + list(range(21, 27)) + list(range(1, 5))
    rd = [B - 3] * 5 + [B - 2] * 6 + [B - 1] * 4
    as_t = lambda v: torch.tensor(v, dtype=torch.int32)
    tasks = (as_t(rd), as_t(x), as_t([1] * len(x)),
             torch.ones(len(x), dtype=torch.bool))
    return codes, lens, tasks


# (genome, stack depth): the planted-prefix genome at depth 48 and the
# read length (rounds past 32 entries take the chunked 1-step round on
# the k-gram row's group 0), and the small genome's edge reads at full
# depth (backward k-steps ending at the read's start and at an N, and
# sentinel-holding intervals inside a step) and at depth 4 (overflowed
# stacks take the chunked round)
KSTEP_SHAPES = [("prefix", 48), ("prefix", None), ("edges", None),
                ("edges", 4)]


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("genome,sd", KSTEP_SHAPES,
                         ids=[f"{g}-d{d or 'L'}" for g, d in KSTEP_SHAPES])
def test_one_pos_twin_kstep_shapes(side, prefix_k, K, genome, sd):
    """Passes 1-2 at the K-table where the k-step backward rounds meet
    their edges: the plain lockstep equals the JAX machine with the same
    table and the K = 1 output; the kernel's twin (K backward rounds a
    fetch where a round fits one chunk, the rule applied K times) equals
    it in every field, cnt and steps, asserting the two orders at each
    sub-round, in fewer rounds than K = 1's twin; and the shapes the case
    is for occur."""
    import collections
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_oh import one_pos_machine_oh
    fx = prefix_k if genome == "prefix" else side
    tf, t1, jf = fx["tf"][K], fx["tf"][1], fx["jf"][K]
    if genome == "prefix":
        codes, lens = fx["reads"]
        calls = [(True, None)]
        msl = 19
    else:
        codes, lens, tasks2 = _edge_reads(side)
        calls = [(True, None), (False, tasks2)]
        msl = MSL
    M = 48
    ct, lt = torch.as_tensor(codes), torch.as_tensor(lens)
    events = collections.Counter()
    rounds = {}
    for chain, tasks in calls:
        if tasks is None:
            B = len(lens)
            zi = torch.zeros((B,), dtype=torch.int32)
            tasks = (torch.arange(B, dtype=torch.int32), zi, zi + 1, lt > 0)
        got = one_pos_machine(tf, ct, lt, *tasks, chain, msl, M, sd)
        steps = one_pos_machine.last_steps
        one = one_pos_machine(t1, ct, lt, *tasks, chain, msl, M, sd)
        want = one_pos_machine_oh(
            jf, jnp.asarray(codes), jnp.asarray(lens),
            *(jnp.asarray(t.numpy()) for t in tasks), chain, msl, M,
            JBuf.empty(tasks[0].shape[0], M, jnp.int32), stack_depth=sd)
        tw = {}
        for kk, f in ((K, tf), (1, t1)):
            tw[kk] = smem_cuda.one_pos_twin(
                f.count.numpy(), f.cp_fused.numpy(), f.sentinel_index, codes,
                lens, *(t.numpy() for t in tasks), chain, msl, M, sd,
                kstep=smem_cuda.kstep_tables(f),
                events=events if kk == K else None)
        for i, f in enumerate(FIELDS):
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          getattr(got, f).numpy(), f)
            assert torch.equal(getattr(got, f), getattr(one, f)), f
            np.testing.assert_array_equal(tw[K][i], getattr(got, f).numpy(),
                                          f)
        np.testing.assert_array_equal(tw[K][6], steps.numpy())
        rounds[chain] = (tw[K][7], tw[1][7])
        assert int(got.cnt.sum()) > 0
        if sd == 4:
            assert (got.cnt.numpy() == M + 1).any()
    for r, r1 in rounds.values():
        assert (r <= r1).all() and r.sum() < r1.sum()
    assert events["fused"] > 0
    if genome == "prefix" or sd == 4:
        assert events["chunked"] > 0
    else:
        assert min(events[e] for e in ("start", "N", "sentinel")) > 0


@pytest.mark.parametrize("K", [2, 3])
def test_kstep_twins_read_one_table(side, K):
    """A k-step twin reads the k-gram table alone: passes 1-2 (forward,
    fused and chunked backward rounds) and pass 3 read (row, group)
    k-gram groups and no 1-step (cp_fused) row; the K = 1 twins read
    1-step rows only."""
    codes, lens, _ = _edge_reads(side)
    B = len(lens)
    zi = np.zeros(B, np.int32)
    p1 = (np.arange(B, dtype=np.int32), zi, zi + 1, lens > 0)
    for kk in (K, 1):
        f = side["tf"][kk]
        tabs = (f.count.numpy(), f.cp_fused.numpy(), f.sentinel_index)
        kst = smem_cuda.kstep_tables(f)
        for sd in (None, 4):
            smem_cuda.one_pos_twin(*tabs, codes, lens, *p1, True, MSL, 48,
                                   sd, kstep=kst)
            reads = smem_cuda.one_pos_twin.last_reads
            assert reads and all(isinstance(r, tuple) == (kk > 1)
                                 for r in reads)
        smem_cuda.seed_strategy_twin(*tabs, codes, lens, 20, MSL + 1, 48,
                                     kstep=kst)
        reads = smem_cuda.seed_strategy_twin.last_reads
        assert reads and all(isinstance(r, tuple) == (kk > 1)
                             for r in reads)


# (case, K, FMA): the sweep merged with pass 3 (with and without the
# ladders, and on a trigram table's bigram part), the split pass 3 with its
# stop length, the reseed's per-row minimum intervals
SWEEP_CASES = [("merged", 2, True), ("merged", 2, False), ("merged", 3, True),
               ("split-p3", 2, False), ("reseed", 2, True)]


def _sweep_args(case, B):
    if case == "merged":
        return np.ones(B, np.int32), dict(check_initial=True, want_fail=True,
                                          p3_max_intv=20, p3_stop=MSL + 1)
    if case == "split-p3":
        return np.full(B, 20, np.int32), dict(
            check_initial=False, want_fail=True, stop_min_len=MSL + 1)
    return (np.arange(B, dtype=np.int32) % 3 + 2,
            dict(check_initial=True, want_fail=False))


@pytest.mark.parametrize("case,K,use_fma", SWEEP_CASES,
                         ids=[f"{c}-K{k}-{'fma' if f else 'plain'}"
                              for c, k, f in SWEEP_CASES])
def test_extend_all_positions_kstep_equal_to_jax(side, case, K, use_fma):
    """The sweep's extension with the K-table equals the JAX function with
    the same table and the port's K = 1 output, every record; the kernel's
    twin equals it, steps included, in fewer rounds."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import smem as jsmem
    from bwa_mem_scale_tpu.ops.fma import build_fma_table as jbuild
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    tf, t1 = side["tf"][K], side["tf"][1]
    mi, kw = _sweep_args(case, codes.shape[0])
    jfma = tfma = None
    if use_fma:
        from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
        jfma = jbuild(side["jf"][1], K=5).to_device(jnp.int32)
        tfma = build_fma_table(t1, K=5).to_device(torch.int32, "cpu")
    got = tsmem.extend_all_positions(tf, codes, lens, torch.as_tensor(mi),
                                     fma=tfma, **kw)
    steps = tsmem.extend_all_positions.last_steps
    one = tsmem.extend_all_positions(t1, codes, lens, torch.as_tensor(mi),
                                     fma=tfma, **kw)
    assert torch.equal(steps, tsmem.extend_all_positions.last_steps)
    want = jsmem.extend_all_positions(
        side["jf"][K], jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(mi), fma=jfma, **kw)
    assert set(got) == set(want)
    _, K_eff = tsmem.sweep_window(tfma, kw.get("stop_min_len", 0),
                                  kw.get("p3_max_intv", 0),
                                  kw.get("p3_stop", 0))
    lad = (None if not K_eff else tuple(
        t.numpy() for t in (tfma.ladder_k, tfma.ladder_l, tfma.ladder_s)))
    twin = sweep_cuda.sweep_extend_twin(
        tf.count.numpy(), tf.cp_fused.numpy(), tf.sentinel_index,
        codes.numpy(), lens.numpy(), mi, kw["check_initial"],
        kw.get("stop_min_len", 0), kw.get("p3_max_intv", 0),
        kw.get("p3_stop", 0), ladders=lad, K_eff=K_eff,
        kstep=smem_cuda.kstep_tables(tf))
    for f in want:
        np.testing.assert_array_equal(np.asarray(want[f]), got[f].numpy(), f)
        assert torch.equal(got[f], one[f]), f
        np.testing.assert_array_equal(twin[f], got[f].numpy(), f)
    np.testing.assert_array_equal(twin["steps"], steps.numpy())
    assert twin["rounds"].sum() < twin["steps"].sum()


@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("pass2", [False, True], ids=["pass1", "pass2"])
@pytest.mark.parametrize("M", [48, 1], ids=["wide", "past-M"])
def test_pass_twin_kstep_equal_to_plain(side, use_fma, pass2, M):
    """The sweep's pass forms at K = 2 (two bases a row fetch after the FMA
    start): the twin with the bigram table equal to the plain passes of
    collect_smems_device and smems_reseed, every field, cnt, the merged
    records and each lane's steps, in fewer rounds than steps; each
    lane's start in at most two trips."""
    from test_torch_sweep import pass_twin_case
    from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    tf = side["tf"][2]
    tfma = (build_fma_table(side["tf"][1], K=5).to_device(torch.int32, "cpu")
            if use_fma else None)
    want, twin = pass_twin_case(tf, codes, lens, tfma, MSL, 20, M, pass2,
                                kstep=smem_cuda.kstep_tables(tf))
    assert twin["rounds"].sum() < twin["steps"].sum()
    if M == 1:
        assert (want.cnt > M).any()


def test_wrappers_on_cpu_run_plain(side):
    """On CPU tensors the wrappers run the plain k-step versions: no
    launch counted, equal arrays."""
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    tf = side["tf"][3]
    counts = lambda: [(w.launches, w.launches_k) for w in (
        smem_cuda.one_pos_machine_cuda, smem_cuda.seed_strategy_machine_cuda,
        sweep_cuda.sweep_pass_cuda)]
    before = counts()
    B = codes.shape[0]
    zi = torch.zeros((B,), dtype=torch.int32)
    p1 = (torch.arange(B, dtype=torch.int32), zi, zi + 1, lens > 0)
    a = smem_cuda.one_pos_machine_cuda(tf, codes, lens, *p1, True, MSL, 48)
    b = one_pos_machine(tf, codes, lens, *p1, True, MSL, 48)
    c = smem_cuda.seed_strategy_machine_cuda(tf, codes, lens, 20, 11, 48)
    d = seed_strategy_machine(tf, codes, lens, 20, 11, 48)
    e, _ = sweep_cuda.sweep_pass_cuda(tf, codes, lens, MSL, 48, n_pos=39)
    g, _ = tsmem.sweep_pass_plain(tf, codes, lens, MSL, 48, n_pos=39)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(c, f), getattr(d, f)), f
        assert torch.equal(getattr(e, f), getattr(g, f)), f
    assert counts() == before


# ---- the kernels on the card ------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card():
    """The port's own index of a 9 kbp genome with this file's reads (and
    with its edge reads and their pass-2 tasks, ``_edge_reads``), of a 1
    Mbp genome with 512 reads of 101 bp (1% errors) and of
    test_torch_smem.py's planted-prefix genome with its reads, each with
    its bigram and trigram tables, and of ``tools/batches.py::
    repeat_batch``'s 2 Mbp genome with repeats and its 512 reads, with its
    bigram table; each with a K = 6 FMA table (no JAX on the card)."""
    dev = _cuda()
    from test_torch_smem import _prefix_genome, _prefix_reads
    from bwa_mem_scale_tpu_torch.index.bntseq import BntSeq, Annotation
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    out = {}
    for name in ("small", "batch", "prefix", "edges", "repeat"):
        tasks2 = None
        if name == "repeat":
            idx, codes, lens = repeat_batch()
        elif name == "prefix":
            bns, read = _prefix_genome(BntSeq, Annotation)
            idx = build_index(bns)
            codes, lens = _prefix_reads(idx.bns.seq, read)
        else:
            idx = build_index(demo_genome(
                9000 if name != "batch" else 1_000_000, seed=13,
                n_contigs=1))
            codes, lens = (simulate_reads(idx.bns, 512, 101, seed=8,
                                          err_rate=0.01)
                           if name == "batch" else _reads(idx.bns.seq))
            if name == "edges":
                codes, lens, tasks2 = _edge_reads(
                    dict(idx=idx, reads=(codes, lens)))
        fmis = {1: TFmi.from_host(idx, dev)}
        for K in ((2,) if name == "repeat" else (2, 3)):
            fmis[K] = TFmi.from_host(idx, dev, cp2=tk.build_cp2(idx, K))
        out[name] = dict(fmi=fmis, codes=torch.as_tensor(codes, device=dev),
                         lens=torch.as_tensor(lens, device=dev),
                         tasks2=None if tasks2 is None else [
                             t.to(dev) for t in tasks2],
                         fma=build_fma_table(fmis[1], K=6).to_device(
                             torch.int32, dev))
    return out


def _eq(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# (batch, stack depth): this file's reads, the 512-read batch, the
# planted-prefix reads at depth 48 and the read length (backward rounds
# past 32 entries), the edge reads at the read length (k-steps ending at
# the read's start and at an N, sentinel-holding intervals inside a step)
# and at depth 4 (overflowed stacks)
KERNEL_ONE_POS = [("small", None), ("batch", None), ("prefix", 48),
                  ("prefix", None), ("edges", None), ("edges", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("batch,sd", KERNEL_ONE_POS,
                         ids=[f"{b}-d{d or 'L'}" for b, d in KERNEL_ONE_POS])
@pytest.mark.parametrize("chain", [True, False], ids=["pass1", "pass2"])
def test_one_pos_kstep_kernel_equal_to_plain(card, K, batch, sd, chain):
    """one_pos_kernel's K-step form against the plain version and the K =
    1 kernel: every array and each task's steps; its rounds fewer than K =
    1's; the launch emits; and, except on the 512-read batch, its steps
    and rounds equal the twin's."""
    c = card[batch]
    codes, lens = c["codes"], c["lens"]
    f = c["fmi"][K]
    B = codes.shape[0]
    zi = torch.zeros((B,), dtype=torch.int32, device=codes.device)
    tasks = (torch.arange(B, dtype=torch.int32, device=codes.device), zi,
             zi + 1, lens > 0)
    M, msl = 48, 19 if batch == "prefix" else MSL
    if not chain:
        b1 = one_pos_machine(c["fmi"][1], codes, lens, *tasks, True, msl, M,
                             sd)
        tasks = c["tasks2"] or reseed_tasks(b1, 2 * B, 15, 10)[:4]
    wrap = smem_cuda.one_pos_machine_cuda
    before = (wrap.launches, wrap.launches_k)
    got = wrap(f, codes, lens, *tasks, chain, msl, M, sd)
    torch.cuda.synchronize()
    assert (wrap.launches, wrap.launches_k) == (before[0] + 1, before[1] + 1)
    steps, rounds = wrap.last_steps.cpu(), wrap.last_rounds.cpu()
    one = wrap(c["fmi"][1], codes, lens, *tasks, chain, msl, M, sd)
    rounds1 = wrap.last_rounds.cpu()
    assert torch.equal(steps, wrap.last_steps.cpu())
    _eq(got, one)
    plain = one_pos_machine(f, codes, lens, *tasks, chain, msl, M, sd)
    _eq(got, plain)
    assert torch.equal(steps, one_pos_machine.last_steps.cpu())
    assert (rounds <= rounds1).all() and rounds.sum() < rounds1.sum()
    assert int(got.cnt.sum()) > 0
    if batch != "batch":
        tw = smem_cuda.one_pos_twin(
            *smem_cuda.twin_tables(f)[:3], codes.cpu().numpy(),
            lens.cpu().numpy(), *(t.cpu().numpy() for t in tasks), chain,
            msl, M, sd, kstep=smem_cuda.kstep_tables(f))
        np.testing.assert_array_equal(tw[6], steps.numpy())
        np.testing.assert_array_equal(tw[7], rounds.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("batch", ["small", "batch", "prefix", "edges"])
def test_seed_strategy_kstep_kernel_equal_to_plain(card, K, batch):
    """seed_strategy_kernel's 2-step form against the plain version and
    the K = 1 kernel;
    the launch emits; except on the 512-read batch its steps and rounds
    equal the twin's."""
    c = card[batch]
    codes, lens, f = c["codes"], c["lens"], c["fmi"][K]
    args = (20, MSL + 1, 48)
    wrap = smem_cuda.seed_strategy_machine_cuda
    before = wrap.launches_k
    got = wrap(f, codes, lens, *args)
    torch.cuda.synchronize()
    assert wrap.launches_k == before + 1
    steps, rounds = wrap.last_steps.cpu(), wrap.last_rounds.cpu()
    _eq(got, wrap(c["fmi"][1], codes, lens, *args))
    assert torch.equal(steps, wrap.last_steps.cpu())
    _eq(got, seed_strategy_machine(f, codes, lens, *args))
    assert (2 * rounds >= steps).all() and rounds.sum() < steps.sum()
    assert int(got.cnt.sum()) > 0
    if batch != "batch":
        tw = smem_cuda.seed_strategy_twin(
            *smem_cuda.twin_tables(f)[:3], codes.cpu().numpy(),
            lens.cpu().numpy(), *args, kstep=smem_cuda.kstep_tables(f))
        np.testing.assert_array_equal(tw[6], steps.numpy())
        np.testing.assert_array_equal(tw[7], rounds.numpy())


# pass 2 emits only matches that occur more often than the SMEM they
# reseed: on the 1 Mbp random genome there are none, so its large case
# runs on the repeat batch
KERNEL_SWEEP = [("merged", "small"), ("merged", "batch"),
                ("unmerged", "small"), ("unmerged", "batch"),
                ("reseed", "small"), ("reseed", "repeat"),
                ("merged", "edges"), ("reseed", "prefix")]


@pytest.mark.cuda
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("case,batch", KERNEL_SWEEP,
                         ids=[f"{c}-{b}" for c, b in KERNEL_SWEEP])
def test_sweep_kstep_kernel_equal_to_plain(card, use_fma, case, batch):
    """sweep_extend_kernel's 2-step form (bigram table) in its pass forms
    (pass 1 merged with pass 3 and not, pass 2 over reseed_tasks' list;
    the emission in the launch) against the plain version and the K = 1
    kernel: every SmemBuf field, record and lane's steps, in fewer row
    fetches than steps; every case emits; on the small batch each lane's
    steps and row fetches equal the twin's."""
    from test_torch_sweep import card_pass_case
    c = card[batch]
    codes, lens, f = c["codes"], c["lens"], c["fmi"][2]
    table = c["fma"] if use_fma else None
    msl = 19 if batch in ("repeat", "prefix") else MSL
    wrap = sweep_cuda.sweep_pass_cuda
    before = wrap.launches_k
    got, steps, rounds, kw = card_pass_case(
        f, codes, lens, table, msl, 0 if case == "unmerged" else 20, 48,
        case == "reseed")
    assert wrap.launches_k == before + 1
    one, _ = wrap(c["fmi"][1], codes, lens, msl, 48, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, one))
    assert rounds.sum() < steps.sum() and int(got.cnt.sum()) > 0
    if batch == "small":
        tasks = kw.get("tasks")
        p3 = (kw.get("p3_max_intv", 0), kw.get("p3_stop", 0))
        _, K_eff = tsmem.sweep_window(table, 0, *p3)
        lad = (None if not K_eff else tuple(
            t.cpu().numpy() for t in (table.ladder_k, table.ladder_l,
                                      table.ladder_s)))
        tw = sweep_cuda.sweep_extend_twin(
            *smem_cuda.twin_tables(f)[:3], codes.cpu().numpy(),
            lens.cpu().numpy(), np.ones(len(lens), np.int32), True, 0, *p3,
            kw["n_pos"], ladders=lad, K_eff=K_eff,
            kstep=smem_cuda.kstep_tables(f), emit=(msl, 48),
            tasks=None if tasks is None else tuple(
                t.cpu().numpy() for t in tasks))
        np.testing.assert_array_equal(tw["steps"], steps.numpy())
        np.testing.assert_array_equal(tw["rounds"], rounds.numpy())
        for fd, a, b in zip(got._fields, got, tw["smem"]):
            np.testing.assert_array_equal(a.cpu().numpy(), b, fd)
