"""The one-hot seeding stage's glue: the task list (``smem_cuda.
reseed_tasks_cuda``, csrc/smem_glue.cu reseed_tasks_kernel) and the merge
(``smem_cuda.merge_smems_cuda``, merge_smems_kernel), exact (tolerance 0:
integer arrays).

- Each kernel's CPU twin (``reseed_tasks_twin``, ``merge_smems_twin``:
  the kernel's own loop) against its plain version (``smem.
  reseed_task_list``, ``smem.merge_smems_plain``) on synthetic SmemBufs
  made from a seed: the task budget overflowing, with a read whose tasks
  straddle T; pass-1 and pass-2 rows at M + 1 (a stack overflow) and past
  it (an emission overflow); a read with more than M pass-2 emissions;
  two passes (max_mem_intv 0); int64 positions past 2^32; more than one
  1,024-read chunk; sort keys at, past and wrapping beyond 1 << 30 (m >=
  16,384); a width past the shared-memory plan (and the plan forced small
  at ordinary widths); with and without the pass overflow.
- ``collect_smems_oh`` and ``collect_smems_rl`` with the twins in place
  of the kernels against the JAX functions on conftest's 20 kbp genome,
  at the int32 and the forced int64 layout, with and without pass 3, at
  depths 24, 6 (every overflow) and full, and at a reseed budget of one
  task a read.
- ``merge_plan``: warps a block and shared memory by width, the scratch
  past one warp's share, and the refusal past M = 46,340.
- The wrappers run the plain versions on CPU tensors.
On a GPU (``-m cuda``): each kernel against its plain version over the
synthetic cases, the scratch form included, and ``collect_smems_oh`` /
``collect_smems_rl`` on a 512-read batch launching each kernel once (the
passes 1-2 kernel twice, pass 3 once) and equal to the plain glue. The
JAX side is imported inside the tests that use it, so the CUDA cases also
run without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_smem_glue.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import smem_cuda, smem_oh
from bwa_mem_scale_tpu_torch.ops import smem_rl as trl
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import (SmemBuf, merge_smems_plain,
                                              reseed_task_list)

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("m", "n", "k", "l", "s", "cnt")
SPLIT_LEN, SPLIT_WIDTH = 28, 10

# name: (reads B, slots M, task budget T, pos dtype, pass 3, key span:
# the largest m; cnt kinds)
CASES = {
    "d24": (64, 24, 128, torch.int32, True, 101),
    "straddle": (64, 24, 37, torch.int32, True, 101),
    "two-passes": (64, 24, 128, torch.int32, False, 101),
    "int64": (64, 24, 128, torch.int64, True, 101),
    "chunks": (2500, 6, 4000, torch.int32, True, 101),
    "keys-past-2^30": (48, 24, 96, torch.int32, True, 40000),
    "int64-keys": (48, 12, 96, torch.int64, False, 40000),
    "deep": (16, 101, 32, torch.int32, True, 101),
}


def _buf(rng, R, M, pd, m_max, cnt, big_pos):
    """An SmemBuf [R, M] as the walks leave one: cnt [R] given, the first
    min(cnt, M) slots filled (m <= n, s small enough to make candidates
    often), zeros past them."""
    m = rng.randint(0, m_max, (R, M))
    n = m + rng.randint(0, 60, (R, M))
    hi = (1 << 34) if big_pos else 1 << 20
    k, l = rng.randint(0, hi, (R, M)), rng.randint(0, hi, (R, M))
    s = rng.randint(0, 16, (R, M))
    live = np.arange(M)[None, :] < np.minimum(cnt, M)[:, None]
    f = [np.where(live, a, 0) for a in (m, n, k, l, s)]
    i32 = torch.int32
    return SmemBuf(torch.as_tensor(f[0], dtype=i32),
                   torch.as_tensor(f[1], dtype=i32),
                   *(torch.as_tensor(a, dtype=pd) for a in f[2:]),
                   torch.as_tensor(cnt, dtype=i32))


def _counts(rng, R, M):
    """Counts a row: mostly a few, some at M, M + 1 (the stack overflow's
    latch) and past M (emissions dropped), some 0."""
    c = rng.randint(0, min(M, 6) + 1, R)
    pick = rng.rand(R)
    c[pick < 0.08] = M
    c[(pick >= 0.08) & (pick < 0.14)] = M + 1
    c[(pick >= 0.14) & (pick < 0.18)] = M + rng.randint(2, 9)
    return c


def _case(name, seed=0):
    """(p1, the plain task list, p2t, p3 or None) of a CASES entry; its T
    is the task list's length."""
    B, M, T, pd, has3, m_max = CASES[name]
    rng = np.random.RandomState(seed)
    big = pd == torch.int64
    p1 = _buf(rng, B, M, pd, m_max, _counts(rng, B, M), big)
    if m_max > 1 << 14:                # keys at exactly 1 << 30
        live = np.flatnonzero(p1.cnt.numpy() > 0)[::3]
        p1.m[live, 0], p1.n[live, 0] = 1 << 14, 0
    if name == "straddle":             # T cuts a read's candidates
        every = reseed_task_list(p1, B * M, SPLIT_LEN, SPLIT_WIDTH)
        b = next(b for b in range(10, B) if every[6][b] >= 2)
        T = int(every[5][b]) + 1
    tasks = reseed_task_list(p1, T, SPLIT_LEN, SPLIT_WIDTH)
    cnt2 = _counts(rng, T, M)
    if name == "deep":                 # a read's tasks past M emissions
        cnt2[:] = rng.randint(20, 60, T)
    p2t = _buf(rng, T, M, pd, m_max, cnt2, big)
    p3 = _buf(rng, B, M, pd, m_max, _counts(rng, B, M), big) if has3 else None
    if p3 is not None and m_max > 1 << 14:
        live = np.flatnonzero(p3.cnt.numpy() > 0)[1::3]
        p3.m[live, 0], p3.n[live, 0] = 1 << 14, 0
    return p1, tasks, p2t, p3


def _np(buf):
    return None if buf is None else [f.numpy() for f in buf]


@pytest.mark.parametrize("name", list(CASES))
def test_reseed_tasks_twin_equal_to_plain(name):
    p1, want, _, _ = _case(name)
    B, T = p1.m.shape[0], want[0].shape[0]
    got = smem_cuda.reseed_tasks_twin(p1.m, p1.n, p1.s, p1.cnt, T,
                                      SPLIT_LEN, SPLIT_WIDTH)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(a, b.numpy().astype(a.dtype), str(i))
    t_valid, reseed_of = want[3], want[4]
    first, count = want[5].numpy(), want[6].numpy()
    if name == "straddle":
        # the budget cuts a read's tasks: one kept at T - 1, the read
        # flagged, every slot of the list valid
        cut = [b for b in range(B) if first[b] + count[b] == T
               and reseed_of[b] and count[b] > 0]
        assert cut and bool(t_valid.all())
    if name == "chunks":
        # three chunks of reads, the list's tail invalid
        assert B > 2 * smem_cuda.TASK_THREADS and not bool(t_valid.all())
    assert int(count.sum()) == int(t_valid.sum())


@pytest.mark.parametrize("pass_of", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_merge_smems_twin_equal_to_plain(name, pass_of):
    p1, tasks, p2t, p3 = _case(name)
    t_read, _, _, t_valid, reseed_of, first, count = tasks
    want = merge_smems_plain(p1, p2t, p3, t_read, t_valid, first, count,
                             reseed_of, pass_of)
    got = smem_cuda.merge_smems_twin(_np(p1), _np(p2t), _np(p3), first,
                                     count, reseed_of, pass_of)
    for f, a, b in zip(FIELDS, got, want):
        assert a.dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(a, b.numpy(), f)
    W = want.m.shape[1]
    assert smem_cuda.merge_smems_twin.last_plan == (8, True)
    if name == "deep":                 # more than M pass-2 emissions
        per_read = np.bincount(t_read.numpy()[t_valid.numpy()],
                               np.minimum(p2t.cnt.numpy(), p1.m.shape[1])[
                                   t_valid.numpy()], minlength=len(first))
        assert (per_read > p1.m.shape[1]).any()
    if name.endswith("keys") or name == "keys-past-2^30":
        key = (want.m.numpy().astype(np.int64) << 16) | want.n.numpy()
        assert (key == 1 << 30).any() and (key > 1 << 30).any()
    assert (want.cnt.numpy() < W).any()
    if pass_of:
        assert (want.cnt.numpy() == W).any()


def test_merge_smems_twin_scratch_and_wide_rows():
    """The merge at a width past one warp's shared memory (M = 9,700,
    three passes: 232,800 bytes a warp) takes the device scratch, and at
    ordinary widths a forced small budget gives fewer warps a block or the
    scratch; the arrays do not change."""
    rng = np.random.RandomState(3)
    B, M, T = 3, 9700, 6
    cnt = np.array([40, M + 1, 7])
    p1 = _buf(rng, B, M, torch.int32, 9000, cnt, False)
    tasks = reseed_task_list(p1, T, SPLIT_LEN, SPLIT_WIDTH)
    p2t = _buf(rng, T, M, torch.int32, 9000, np.array([30, 2, M, 5, 0, 9]),
               False)
    p3 = _buf(rng, B, M, torch.int32, 9000, np.array([12, 0, M + 3]), False)
    t_read, _, _, t_valid, reseed_of, first, count = tasks
    assert smem_cuda.merge_plan(M, 3) == (8, False)
    want = merge_smems_plain(p1, p2t, p3, t_read, t_valid, first, count,
                             reseed_of, True)
    got = smem_cuda.merge_smems_twin(_np(p1), _np(p2t), _np(p3), first,
                                     count, reseed_of, True)
    assert smem_cuda.merge_smems_twin.last_plan == (8, False)
    for f, a, b in zip(FIELDS, got, want):
        np.testing.assert_array_equal(a, b.numpy(), f)
    p1, tasks, p2t, p3 = _case("d24")
    t_read, _, _, t_valid, reseed_of, first, count = tasks
    want = merge_smems_plain(p1, p2t, p3, t_read, t_valid, first, count,
                             reseed_of, True)
    for budget, plan in ((3 * 24 * 8 * 3, (3, True)), (100, (8, False))):
        got = smem_cuda.merge_smems_twin(_np(p1), _np(p2t), _np(p3), first,
                                         count, reseed_of, True, budget)
        assert smem_cuda.merge_smems_twin.last_plan == plan
        for f, a, b in zip(FIELDS, got, want):
            np.testing.assert_array_equal(a, b.numpy(), f)


@pytest.mark.parametrize("M,parts,want", [
    (24, 3, (8, True)), (101, 3, (8, True)), (24, 2, (8, True)),
    (1500, 3, (6, True)), (9685, 3, (1, True)), (9686, 3, (8, False)),
    (46340, 2, (8, False))])
def test_merge_plan(M, parts, want):
    assert smem_cuda.merge_plan(M, parts) == want


def test_merge_plan_refuses_past_the_source_index():
    with pytest.raises(ValueError, match="46340"):
        smem_cuda.merge_plan(46341, 2)


def test_glue_wrappers_on_cpu_run_plain():
    p1, want, p2t, p3 = _case("d24")
    got = smem_cuda.reseed_tasks_cuda(p1, want[0].shape[0], SPLIT_LEN,
                                      SPLIT_WIDTH)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    t_read, _, _, t_valid, reseed_of, first, count = want
    before = (smem_cuda.reseed_tasks_cuda.launches,
              smem_cuda.merge_smems_cuda.launches)
    out = smem_cuda.merge_smems_cuda(p1, p2t, p3, t_read, t_valid, first,
                                     count, reseed_of, True)
    ref = merge_smems_plain(p1, p2t, p3, t_read, t_valid, first, count,
                            reseed_of, True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (smem_cuda.reseed_tasks_cuda.launches,
            smem_cuda.merge_smems_cuda.launches) == before


# ---- the stage against the JAX package, with the twins in the kernels'
# places

def _twin_reseed(p1, T, split_len, split_width):
    return tuple(torch.as_tensor(a) for a in smem_cuda.reseed_tasks_twin(
        p1.m, p1.n, p1.s, p1.cnt, T, split_len, split_width))


def _twin_merge(p1, p2t, p3, t_read, t_valid, first, count, reseed_of,
                pass_of):
    out = smem_cuda.merge_smems_twin(_np(p1), _np(p2t), _np(p3), first,
                                     count, reseed_of, pass_of)
    return SmemBuf(*(torch.as_tensor(a) for a in out))


def _reads(idx):
    """20 reads of 101 bp (3% errors), one with two Ns, a tiled 30-mer
    repeat, a 40 bp read and an empty one."""
    from conftest import sample_reads
    rows = [c.astype(np.int32) for c, _, _ in
            sample_reads(idx.bns, 20, 101, seed=11, err_rate=0.03)]
    withn = rows[0].copy()
    withn[[10, 50]] = 4
    rows += [withn, np.tile(idx.bns.seq[100:130].astype(np.int32), 4)[:101],
             rows[1][:40].copy(), rows[2][:0].copy()]
    codes = np.full((len(rows), 101), 4, np.int32)
    for i, c in enumerate(rows):
        codes[i, :len(c)] = c
    return codes, np.array([len(c) for c in rows], np.int32)


@pytest.fixture(scope="module")
def layouts(small_index):
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    return {"int32": (JFmi.from_host(small_index),
                      TFmi.from_host(small_index, "cpu")),
            "int64": (JFmi.from_host(small_index, force_int64=True),
                      TFmi.from_host(small_index, "cpu", force_int64=True))}


@pytest.mark.parametrize("layout,depth,rf,intv", [
    ("int32", 24, 2, 20), ("int32", 6, 2, 20), ("int32", 24, 1, 20),
    ("int32", None, 2, 0), ("int64", None, 2, 20), ("int64", 6, 1, 0)])
def test_collect_smems_oh_with_twins_equal_to_jax(small_index, layouts,
                                                  monkeypatch, layout, depth,
                                                  rf, intv):
    """collect_smems_oh with the glue kernels' twins in their wrappers'
    places against the JAX function: every field, slots past the count
    included (depth 6 overflows the stacks and the emission depth, one
    task a read the budget; intv 0 runs two passes)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_oh import collect_smems_oh as j_collect
    jf, tf = layouts[layout]
    codes, lens = _reads(small_index)
    kw = dict(min_seed_len=19, split_len=SPLIT_LEN, split_width=SPLIT_WIDTH,
              max_mem_intv=intv, emit_depth=depth, stack_depth=depth,
              reseed_factor=rf)
    want = j_collect(jf, jnp.asarray(codes), jnp.asarray(lens), **kw)
    monkeypatch.setattr(smem_oh, "reseed_tasks_cuda", _twin_reseed)
    monkeypatch.setattr(smem_oh, "merge_smems_cuda", _twin_merge)
    got = smem_oh.collect_smems_oh(tf, torch.as_tensor(codes),
                                   torch.as_tensor(lens), **kw)
    for f, a, b in zip(FIELDS, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)
    W = got.m.shape[1]
    if depth == 6 or rf == 1:
        assert (got.cnt.numpy() == W).any()


@pytest.mark.parametrize("layout,intv", [("int32", 20), ("int64", 0)])
def test_collect_smems_rl_with_twins_equal_to_jax(small_index, layouts,
                                                  monkeypatch, layout, intv):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_rl import collect_smems_rl as j_collect
    jf, tf = layouts[layout]
    codes, lens = _reads(small_index)
    kw = dict(min_seed_len=19, split_len=SPLIT_LEN, split_width=SPLIT_WIDTH,
              max_mem_intv=intv)
    want = j_collect(jf, jnp.asarray(codes), jnp.asarray(lens), **kw)
    monkeypatch.setattr(trl, "reseed_tasks_cuda", _twin_reseed)
    monkeypatch.setattr(trl, "merge_smems_cuda", _twin_merge)
    got = trl.collect_smems_rl(tf, torch.as_tensor(codes),
                               torch.as_tensor(lens), lanes=7, **kw)
    for f, a, b in zip(FIELDS, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)


# ---- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _to(buf, dev):
    return None if buf is None else SmemBuf(*(f.to(dev) for f in buf))


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 100])
@pytest.mark.parametrize("name", list(CASES))
def test_glue_kernels_equal_to_plain(name, budget, monkeypatch):
    """Each kernel against its plain version on the card over the twins'
    cases (budget 100: the merge's device scratch); one launch each."""
    dev = _cuda()
    if budget is not None:
        monkeypatch.setattr(smem_cuda, "MERGE_SMEM_BUDGET", budget)
    p1, want, p2t, p3 = _case(name)
    p1, p2t, p3 = _to(p1, dev), _to(p2t, dev), _to(p3, dev)
    before = (smem_cuda.reseed_tasks_cuda.launches,
              smem_cuda.merge_smems_cuda.launches,
              smem_cuda.merge_smems_cuda.launches64)
    got = smem_cuda.reseed_tasks_cuda(p1, want[0].shape[0], SPLIT_LEN,
                                      SPLIT_WIDTH)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.cpu().to(b.dtype), b), i
    t_read, _, _, t_valid, reseed_of, first, count = got
    for pass_of in (True, False):
        out = smem_cuda.merge_smems_cuda(p1, p2t, p3, t_read, t_valid,
                                         first, count, reseed_of, pass_of)
        ref = merge_smems_plain(p1, p2t, p3, t_read, t_valid, first,
                                count, reseed_of, pass_of)
        torch.cuda.synchronize()
        for f, a, b in zip(FIELDS, out, ref):
            assert torch.equal(a, b), f
    is64 = int(p1.k.dtype == torch.int64)
    assert (smem_cuda.reseed_tasks_cuda.launches,
            smem_cuda.merge_smems_cuda.launches,
            smem_cuda.merge_smems_cuda.launches64) == (
        before[0] + 1, before[1] + 2, before[2] + 2 * is64)


@pytest.mark.cuda
def test_merge_kernel_wide_rows_in_scratch():
    """Rows of 9,700 slots a pass (three passes pass 227 KB a warp): the
    kernel's device scratch, equal to the plain version."""
    dev = _cuda()
    rng = np.random.RandomState(3)
    B, M, T = 3, 9700, 6
    p1 = _buf(rng, B, M, torch.int32, 9000, np.array([40, M + 1, 7]), False)
    tasks = reseed_task_list(p1, T, SPLIT_LEN, SPLIT_WIDTH)
    p2t = _buf(rng, T, M, torch.int32, 9000, np.array([30, 2, M, 5, 0, 9]),
               False)
    p3 = _buf(rng, B, M, torch.int32, 9000, np.array([12, 0, M + 3]), False)
    want = merge_smems_plain(p1, p2t, p3, tasks[0], tasks[3], tasks[5],
                             tasks[6], tasks[4], True)
    got = smem_cuda.merge_smems_cuda(
        _to(p1, dev), _to(p2t, dev), _to(p3, dev),
        *(t.to(dev) for t in (tasks[0], tasks[3], tasks[5], tasks[6],
                              tasks[4])), True)
    torch.cuda.synchronize()
    for f, a, b in zip(FIELDS, got, want):
        assert torch.equal(a.cpu(), b), f


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["onehot", "readlane"])
def test_collect_launches_each_kernel(engine, monkeypatch):
    """collect_smems_oh (depth 24) and collect_smems_rl on a 512-read batch
    of a 1 Mbp genome: the task list and the merge once each, passes 1-2
    twice, pass 3 once; equal to the same call with the plain glue."""
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    from bwa_mem_scale_tpu_torch.ops import smem_rl_cuda
    dev = _cuda()
    bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    codes, lens = simulate_reads(bns, 512, 101, seed=8, err_rate=0.01)
    fmi = TFmi.from_host(build_index(bns), dev)
    c, ln = torch.as_tensor(codes, device=dev), torch.as_tensor(lens,
                                                                device=dev)
    kw = dict(min_seed_len=19, split_len=SPLIT_LEN, split_width=SPLIT_WIDTH,
              max_mem_intv=20)
    if engine == "onehot":
        mod, run = smem_oh, lambda: smem_oh.collect_smems_oh(
            fmi, c, ln, emit_depth=24, stack_depth=24, **kw)
        walks = (smem_cuda.one_pos_machine_cuda,
                 smem_cuda.seed_strategy_machine_cuda)
    else:
        mod, run = trl, lambda: trl.collect_smems_rl(fmi, c, ln, lanes=64,
                                                     **kw)
        walks = (smem_rl_cuda.readlane_one_pos_cuda,
                 smem_rl_cuda.readlane_strategy_cuda)
    counters = (smem_cuda.reseed_tasks_cuda, smem_cuda.merge_smems_cuda,
                *walks)
    before = [w.launches for w in counters]
    got = run()
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(counters, before)] == [1, 1, 2, 1]
    monkeypatch.setattr(mod, "reseed_tasks_cuda", reseed_task_list)
    monkeypatch.setattr(mod, "merge_smems_cuda", merge_smems_plain)
    want = run()
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
