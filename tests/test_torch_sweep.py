"""Port vs JAX: the position-parallel sweep seeding engine with the FMA
ladder table (``bwa_mem_scale_tpu_torch.ops.smem`` / ``ops.fma`` against
``bwa_mem_scale_tpu.ops.smem`` / ``ops.fma``), exact, integers throughout.

- The FMA ladders at K = 5 equal the JAX package's on both layouts, and a
  table saved by either package loads in the other.
- The plain ``extend_all_positions`` equals the JAX one in every output,
  with and without the table, merged with pass 3 and not (the split pass
  3 with its stop length, and the reseed's per-row minimum intervals), at
  (min_seed_len, max_mem_intv) in [(10, 20), (3, 4)], at the int32 and the
  forced int64 layouts.
- ``collect_smems_device`` equals the JAX one in all fields, also where
  a small batch's reseed budget (2B tasks) saturates ``cnt`` and where
  the buffer width cuts the records.
- The plain merged stage (``smems_seed_strategy_merged``) equals the
  JAX one.
- The kernels' CPU twins (``sweep_cuda.sweep_extend_twin``,
  ``seed_strategy_merged_twin``) equal the plain versions, steps
  included; the sweep twin in its pass forms (passes 1 and 2 with their
  emission, int32 and int64, with and without the table, reads past the
  slot width) equals ``sweep_pass_plain``, each lane's start in at most
  two dependent trips.
- The CLIs: ``smem-table`` writes the JAX CLI's arrays; ``mem
  --seed-engine sweep`` SE and PE write the JAX CLI's SAM bodies with the
  same table; ``mem`` with a table and no engine named writes the JAX
  CLI's SAM body and note.
On a GPU (``-m cuda``) each kernel against its plain version and its twin
on the same cases, on a 512-read batch and (pass 2, which emits only
repeats) on 512 reads of a genome with repeats, at both layouts. The JAX side
is imported inside the tests that use it, so the CUDA cases also run on a
machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_sweep.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import fma as tfma, smem as tsmem
from bwa_mem_scale_tpu_torch.ops import smem_cuda, sweep_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

K = 5                          # the tests' ladder length
L = 60
PARAMS = [(10, 20), (3, 4)]    # (min_seed_len, max_mem_intv)
I64 = torch.int64


def _reads(seq, seed=3):
    """20 reads of 60 bp at 3% errors from the genome, one with two N
    bases, one of 5 bp, one random (many short SMEMs: the reseed budget),
    one empty, one over the padding."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(20):
        p = rng.randint(0, len(seq) - L)
        r = seq[p:p + L].astype(np.int32).copy()
        m = rng.rand(L) < 0.03
        r[m] = (r[m] + rng.randint(1, 4, m.sum())) % 4
        rows.append(r)
    rows[3][[10, 40]] = 4
    rows += [rows[1][:5].copy(), rng.randint(0, 4, L).astype(np.int32),
             rows[2][:0].copy(), rows[4][:L - 7].copy()]
    codes = np.full((len(rows), L), 4, np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    return codes, np.array([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def side(small_index):
    """Both packages' indexes at both layouts, their K = 5 tables, and
    the reads."""
    from bwa_mem_scale_tpu.ops import fma as jfma
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    j32 = JFmi.from_host(small_index)
    return dict(
        jfmi={False: j32, True: JFmi.from_host(small_index,
                                               force_int64=True)},
        tfmi={w: TFmi.from_host(small_index, "cpu", force_int64=w)
              for w in (False, True)},
        jtable=jfma.build_fma_table(j32, K=K),
        ttable=tfma.build_fma_table(TFmi.from_host(small_index, "cpu"), K=K),
        reads=_reads(small_index.bns.seq))


def _tables(side, wide, use_fma):
    """(JAX DeviceFmaTable, port DeviceFmaTable) at the layout, or Nones."""
    import jax.numpy as jnp
    if not use_fma:
        return None, None
    return (side["jtable"].to_device(jnp.int64 if wide else jnp.int32),
            side["ttable"].to_device(I64 if wide else torch.int32))


def _assert_dicts(j, t):
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        w = np.asarray(j[k])
        assert t[k].numpy().dtype == w.dtype, (k, t[k].dtype, w.dtype)
        np.testing.assert_array_equal(w, t[k].numpy(), k)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_fma_ladders_equal_to_jax(side, wide):
    """build_fma_table on the port's layout (int32 or forced int64) gives
    the JAX package's ladders, int64 on the host."""
    got = tfma.build_fma_table(side["tfmi"][wide], K=K, chunk=100)
    want = side["jtable"]
    assert got.K == want.K == K
    for f in ("ladder_k", "ladder_l", "ladder_s"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype == np.int64 and a.shape == (4 ** K, K)
        np.testing.assert_array_equal(a, b, f)


def test_fma_files_load_across_packages(side, tmp_path):
    """A table saved by either package loads in the other, equal."""
    from bwa_mem_scale_tpu.ops import fma as jfma
    jpath = jfma.save_fma(side["jtable"], str(tmp_path / "j"))
    tpath = tfma.save_fma(side["ttable"], str(tmp_path / "t"))
    assert jpath.endswith(f"j.fma{K}.npz") and tpath.endswith(f"t.fma{K}.npz")
    for got, want in ((tfma.load_fma(jpath), side["jtable"]),
                      (jfma.load_fma(tpath), side["ttable"])):
        assert got.K == K
        for f in ("ladder_k", "ladder_l", "ladder_s"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          getattr(want, f), f)
    dev = tfma.load_fma(jpath).to_device(I64)
    assert dev.ladder_s.dtype == I64 and dev.nbytes() == 3 * 8 * 4 ** K * K


def _sweep_args(case, params, n_reads):
    """(min_intv [B], keyword arguments) of a sweep case: pass 1 merged
    with pass 3, the split pass 3 (no initial check, fail records, a stop
    length), or the reseed's per-row minimum intervals."""
    msl, mmi = params
    if case == "merged":
        return np.ones(n_reads, np.int32), dict(
            check_initial=True, want_fail=False, p3_max_intv=mmi,
            p3_stop=msl + 1)
    if case == "split-p3":
        return np.full(n_reads, mmi, np.int32), dict(
            check_initial=False, want_fail=True, stop_min_len=msl)
    return ((np.arange(n_reads) % 5) + 1).astype(np.int32), dict(
        check_initial=True, want_fail=True)


SWEEP_CASES = ([(c, p) for c in ("merged", "split-p3") for p in PARAMS]
               + [("reseed", PARAMS[0])])


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("case,params", SWEEP_CASES,
                         ids=[f"{c}-{p[0]}-{p[1]}" for c, p in SWEEP_CASES])
def test_extend_all_positions_equal_to_jax(side, wide, use_fma, case,
                                           params):
    """Every output of the plain sweep equal to the JAX sweep's, dtypes
    included, over the start columns a collector takes (L - msl + 1)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import smem as jsmem
    codes, lens = side["reads"]
    mi, kw = _sweep_args(case, params, len(lens))
    jt, tt = _tables(side, wide, use_fma)
    P = L - params[0] + 1
    want = jsmem.extend_all_positions(
        side["jfmi"][wide], jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(mi), fma=jt, n_pos=P, **kw)
    stats = {}
    got = tsmem.extend_all_positions(
        side["tfmi"][wide], torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(mi), fma=tt, n_pos=P, stats=stats, **kw)
    _assert_dicts(want, got)
    assert stats["sweep_ticks"] > 0
    # the table's window resolves a lane's first K_eff - 1 steps
    _, K_eff = tsmem.sweep_window(tt, kw.get("stop_min_len", 0),
                                  kw.get("p3_max_intv", 0),
                                  kw.get("p3_stop", 0))
    assert K_eff == (0 if not use_fma else
                     min(K, params[0] - (case == "split-p3")))
    steps = tsmem.extend_all_positions.last_steps
    assert 0 < int(steps.max()) <= L - max(K_eff, 1)


COLLECT_CASES = [(p, None) for p in PARAMS] + [(PARAMS[1], 8)]


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("params,max_out", COLLECT_CASES,
                         ids=["10-20", "3-4", "3-4-out8"])
def test_collect_smems_device_equal_to_jax(side, wide, use_fma, params,
                                           max_out):
    """collect_smems_device equal to the JAX package's in every field and
    slot; at (3, 4) the random read's reseed candidates pass the budget
    of 2B tasks and saturate its count; at max_out 8 the width cuts."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import smem as jsmem
    codes, lens = side["reads"]
    jt, tt = _tables(side, wide, use_fma)
    msl, mmi = params
    kw = dict(min_seed_len=msl, split_len=int(msl * 1.5 + .499),
              split_width=10, max_mem_intv=mmi, max_out=max_out)
    want = jsmem.collect_smems_device(side["jfmi"][wide], jnp.asarray(codes),
                                      jnp.asarray(lens), fma=jt, **kw)
    stats = {}
    got = tsmem.collect_smems_device(side["tfmi"][wide],
                                     torch.as_tensor(codes),
                                     torch.as_tensor(lens), fma=tt,
                                     stats=stats, **kw)
    for f in got._fields:
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(w, getattr(got, f).numpy(), f)
    width = got.m.shape[1]
    if msl == 3:
        assert (got.cnt == width).any()         # saturated reads
    assert (got.cnt > 0).any() and stats["chase_ticks"] > 0


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("case", ["merged", "split-p3", "reseed"])
def test_sweep_twin_equal_to_plain(side, wide, use_fma, case):
    """sweep_extend_twin (the kernel's per-lane loop) equal to the
    lockstep in every output and each lane's steps."""
    codes, lens = side["reads"]
    mi, kw = _sweep_args(case, PARAMS[0], len(lens))
    _, tt = _tables(side, wide, use_fma)
    fmi = side["tfmi"][wide]
    P = L - PARAMS[0][0] + 1
    want = tsmem.extend_all_positions(fmi, torch.as_tensor(codes),
                                      torch.as_tensor(lens),
                                      torch.as_tensor(mi), fma=tt, n_pos=P,
                                      **kw)
    steps = tsmem.extend_all_positions.last_steps.numpy()
    _, K_eff = tsmem.sweep_window(tt, kw.get("stop_min_len", 0),
                                  kw.get("p3_max_intv", 0),
                                  kw.get("p3_stop", 0))
    tabs = smem_cuda.twin_tables(fmi)
    lad = (None if not K_eff else
           tuple(t.numpy() for t in (tt.ladder_k, tt.ladder_l, tt.ladder_s)))
    twin = sweep_cuda.sweep_extend_twin(
        *tabs[:3], codes, lens, mi, kw["check_initial"],
        kw.get("stop_min_len", 0), kw.get("p3_max_intv", 0),
        kw.get("p3_stop", 0), P, ladders=lad, K_eff=K_eff,
        hi_steps=tabs[3])
    for k, v in want.items():
        assert twin[k].dtype == v.numpy().dtype, k
        np.testing.assert_array_equal(twin[k], v.numpy(), k)
    np.testing.assert_array_equal(twin["steps"], steps)
    assert steps.sum() > 0


def pass_twin_case(fmi, codes, lens, table, msl, mmi, M, pass2,
                   kstep=None):
    """sweep_pass_plain (the plain pass 1 of collect_smems_device, merged
    with pass 3, or smems_reseed's pass 2 over its tasks) and the kernel's
    twin on the same inputs: every SmemBuf field, cnt, the merged records
    and each lane's steps equal, each lane's start in at most two
    dependent trips. Returns (the plain SmemBuf, the twin's dict)."""
    P = codes.shape[1] - msl + 1
    kw = dict(p3_max_intv=mmi, p3_stop=msl + 1)
    want, recs = tsmem.sweep_pass_plain(fmi, codes, lens, msl, M, fma=table,
                                        n_pos=P, **kw)
    tasks = None
    if pass2:                # the tasks of pass 1's SMEMs at full width
        p1, _ = tsmem.sweep_pass_plain(fmi, codes, lens, msl, P, fma=table,
                                       n_pos=P, **kw)
        tasks = tsmem.reseed_tasks(p1, 2 * codes.shape[0],
                                   int(msl * 1.5 + .499), 10)[:4]
        want, recs = tsmem.sweep_pass_plain(fmi, codes, lens, msl, M,
                                            fma=table, tasks=tasks, n_pos=P)
        kw = {}
    steps = sweep_cuda.walked_steps(tsmem.extend_all_positions.last_steps,
                                    tasks).numpy()
    _, K_eff = tsmem.sweep_window(table, 0, kw.get("p3_max_intv", 0),
                                  kw.get("p3_stop", 0))
    tabs = smem_cuda.twin_tables(fmi)
    lad = (None if not K_eff else tuple(
        t.numpy() for t in (table.ladder_k, table.ladder_l, table.ladder_s)))
    twin = sweep_cuda.sweep_extend_twin(
        *tabs[:3], codes.numpy(), lens.numpy(),
        np.ones(codes.shape[0], np.int32), True, 0,
        kw.get("p3_max_intv", 0), kw.get("p3_stop", 0), P, ladders=lad,
        K_eff=K_eff, hi_steps=tabs[3], kstep=kstep, emit=(msl, M),
        tasks=None if tasks is None else tuple(t.numpy() for t in tasks))
    for f, a, b in zip(want._fields, want, twin["smem"]):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, f)
    assert set(recs) == (set() if pass2 else set(tsmem.MERGED_RECORDS))
    for f, v in recs.items():
        assert twin[f].dtype == v.numpy().dtype, f
        np.testing.assert_array_equal(twin[f], v.numpy(), f)
    np.testing.assert_array_equal(twin["steps"], steps)
    assert twin["start_trips"].max() <= 2
    if K_eff:
        assert twin["start_trips"].max() == 2 and twin["ladder_sectors"] > 0
    assert twin["rows"] > 0 and int(want.cnt.sum()) > 0
    return want, twin


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("pass2", [False, True], ids=["pass1", "pass2"])
@pytest.mark.parametrize("M", [60, 1], ids=["wide", "past-M"])
def test_pass_twin_equal_to_plain(side, wide, use_fma, pass2, M):
    """sweep_extend_twin in its pass forms (the FMA start in at most two
    trips, then the emission into each read's slots) equal to the plain
    passes of collect_smems_device and smems_reseed, every field, cnt,
    the merged records and each lane's steps; at M = 1 reads emit past
    their slots, which drop while cnt counts them."""
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    _, tt = _tables(side, wide, use_fma)
    want, _ = pass_twin_case(side["tfmi"][wide], codes, lens, tt,
                             *PARAMS[0], M, pass2)
    if M == 1:
        assert (want.cnt > M).any()


def _merged_inputs(side, wide, use_fma, params=PARAMS[0]):
    """smems_seed_strategy_merged's inputs on the pass-1 sweep's merged
    records: (index, codes, lens, ext, P)."""
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    _, tt = _tables(side, wide, use_fma)
    fmi = side["tfmi"][wide]
    msl, mmi = params
    P = L - msl + 1
    ext = tsmem.extend_all_positions(fmi, codes, lens,
                                     torch.ones(len(lens), dtype=torch.int32),
                                     True, False, fma=tt, p3_max_intv=mmi,
                                     p3_stop=msl + 1, n_pos=P)
    return fmi, codes, lens, ext, P


def assert_merged_twin(fmi, codes, lens, ext, P, msl, mmi, M):
    """seed_strategy_merged_twin equal to the plain merged stage, every
    field and each read's steps (the lockstep chase's); returns the plain
    SmemBuf."""
    want = tsmem.smems_seed_strategy_merged(fmi, codes, lens, ext, mmi,
                                            msl + 1, M, n_pos=P)
    twin = sweep_cuda.seed_strategy_merged_twin(
        fmi.count.numpy(), codes.numpy(), lens.numpy(),
        {k: v.numpy() for k, v in ext.items()}, msl + 1, M, P)
    for f, a, b in zip(want._fields, want, twin):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, f)
    np.testing.assert_array_equal(tsmem.strategy_chase.last_steps.numpy(),
                                  twin[6])
    return want


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
def test_chase_twin_equal_to_plain(side, wide, use_fma):
    """The merged stage's twin (seed_strategy_merged_twin: the glue at the
    visited columns and the chase) equal to the plain
    smems_seed_strategy_merged, each read's steps too, at the width 12
    and at a width (4) some reads pass."""
    fmi, codes, lens, ext, P = _merged_inputs(side, wide, use_fma)
    for M in (12, 4):
        want = assert_merged_twin(fmi, codes, lens, ext, P, *PARAMS[0], M)
        assert (want.cnt > 0).any()
    assert (want.cnt > 4).any()


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("params", PARAMS, ids=["10-20", "3-4"])
def test_merged_plain_equal_to_jax(side, wide, params):
    """The plain smems_seed_strategy_merged equal to the JAX function on
    the same seeded reads and the same merged records (the JAX sweep's),
    every field and dtype, at a width (12) some reads pass."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import smem as jsmem
    codes, lens = side["reads"]
    msl, mmi = params
    P = L - msl + 1
    kw = dict(p3_max_intv=mmi, p3_stop=msl + 1, n_pos=P)
    jfmi = side["jfmi"][wide]
    jext = jsmem.extend_all_positions(
        jfmi, jnp.asarray(codes), jnp.asarray(lens),
        jnp.ones(len(lens), jnp.int32), True, False, **kw)
    want = jsmem.smems_seed_strategy_merged(
        jfmi, jnp.asarray(codes), jnp.asarray(lens), jext, mmi, msl + 1, 12,
        n_pos=P)
    ext = {k: torch.as_tensor(np.asarray(v)) for k, v in jext.items()}
    got = tsmem.smems_seed_strategy_merged(
        side["tfmi"][wide], torch.as_tensor(codes), torch.as_tensor(lens),
        ext, mmi, msl + 1, 12, n_pos=P)
    for f in got._fields:
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(w, getattr(got, f).numpy(), f)
    assert int(got.cnt.sum()) > 0


def test_wrappers_on_cpu_run_plain(side):
    """On CPU tensors each wrapper runs its plain version: equal outputs
    (pass 1, pass 2 over its tasks, the merged stage), no launch counted,
    the lockstep's ticks in stats."""
    before = (sweep_cuda.sweep_pass_cuda.launches,
              sweep_cuda.seed_strategy_merged_cuda.launches)
    st = {}
    fmi, codes, lens, ext, P = _merged_inputs(side, False, True)
    args = (fmi, codes, lens, ext, 20, 11, 12, P)
    a = sweep_cuda.seed_strategy_merged_cuda(*args, stats=st)
    b = tsmem.smems_seed_strategy_merged(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, tt = _tables(side, False, True)
    a, ra = sweep_cuda.sweep_pass_cuda(fmi, codes, lens, 10, 12, fma=tt,
                                       p3_max_intv=20, p3_stop=11, n_pos=P,
                                       stats=st)
    b, rb = tsmem.sweep_pass_plain(fmi, codes, lens, 10, 12, fma=tt,
                                   p3_max_intv=20, p3_stop=11, n_pos=P)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(ra) == set(rb) and all(torch.equal(ra[k], rb[k]) for k in rb)
    tasks = tsmem.reseed_tasks(a, 2 * len(lens), 15, 10)[:4]
    a, ra = sweep_cuda.sweep_pass_cuda(fmi, codes, lens, 10, 12, fma=tt,
                                       tasks=tasks, n_pos=P, stats=st,
                                       stats_key="sweep_ticks_p2")
    b, rb = tsmem.sweep_pass_plain(fmi, codes, lens, 10, 12, fma=tt,
                                   tasks=tasks, n_pos=P)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and ra == rb == {}
    assert int(a.cnt.sum()) > 0
    assert (sweep_cuda.sweep_pass_cuda.launches,
            sweep_cuda.seed_strategy_merged_cuda.launches) == before
    assert st["chase_ticks"] > 0
    assert st["sweep_ticks_p1"] > 0 and st["sweep_ticks_p2"] > 0


def test_seed_chain_extend_sweep_runs_default_config(side, small_index):
    """PipelineConfig() is the sweep, as in the JAX package: the dict of
    seed_chain_extend equal to the one-hot engine's on the same batch
    (the engines give identical output), with and without the table; the
    readlane engine gives it too, on one lane a task and on 5 lanes."""
    import dataclasses
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops.chain import DeviceBns
    from bwa_mem_scale_tpu_torch.pipeline.align import (PipelineConfig,
                                                        seed_chain_extend)
    codes, lens = (torch.as_tensor(a) for a in side["reads"])
    fmi = side["tfmi"][False]
    cfg = PipelineConfig(max_coords=64, max_chains=8, max_seeds_per_chain=8,
                         max_regs=8, max_pairs=256)
    assert cfg.seed_engine == "sweep"
    dbns = DeviceBns.from_host(small_index.bns, "cpu")
    opt = MemOptions()
    onehot = seed_chain_extend(fmi, dbns, codes, lens, L, opt=opt,
                               cfg=dataclasses.replace(cfg,
                                                       seed_engine="onehot"))
    _, tt = _tables(side, False, True)
    for table in (None, tt):
        st = {}
        got = seed_chain_extend(fmi, dbns, codes, lens, L, opt=opt, cfg=cfg,
                                fma=table, stats=st)
        assert st["sweep_ticks_p1"] > 0
        for k in ("packed", "meta", "smem_cnt"):
            assert torch.equal(got[k], onehot[k]), k
    for lanes in (None, 5):
        st = {}
        got = seed_chain_extend(fmi, dbns, codes, lens, L, opt=opt,
                                cfg=dataclasses.replace(
                                    cfg, seed_engine="readlane",
                                    seed_lanes=lanes), stats=st)
        assert st["rl_ticks_p1"] > 0 and st["rl_ticks_p3"] > 0
        for k in ("packed", "meta", "smem_cnt"):
            assert torch.equal(got[k], onehot[k]), (k, lanes)


# ---- the CLIs against the JAX CLI ------------------------------------------

@pytest.fixture(scope="module")
def cli_side(tmp_path_factory):
    """12 kbp in 2 contigs indexed by the JAX CLI, its `smem-table -k 6`,
    40 SE reads and 24 FR pairs of 60 bp."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu.index.bntseq import decode_bases
    from conftest import make_genome, sample_reads
    from test_torch_nojax import _write_pairs
    tmp = tmp_path_factory.mktemp("sweepcli")
    bns = make_genome(12000, seed=9, n_contigs=2)
    with open(tmp / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    with open(tmp / "r.fq", "w") as f:
        for i, (c, _, _) in enumerate(sample_reads(bns, 40, L, seed=2,
                                                   err_rate=0.02)):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    _write_pairs(bns, tmp, 24)
    prefix = str(tmp / "g")
    assert jcli.main(["index", str(tmp / "g.fa"), "-p", prefix]) == 0
    assert jcli.main(["smem-table", prefix, "-k", "6"]) == 0
    return tmp, prefix


def _body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@PG"))


def test_smem_table_cli_equal_to_jax(cli_side, tmp_path):
    """The port's `smem-table -k 6 --device cpu` writes the JAX CLI's
    file: the same names, int64 ladders, equal arrays."""
    import os
    from bwa_mem_scale_tpu_torch import cli
    tmp, prefix = cli_side
    mine = str(tmp_path / "g")
    for ext in (".tpuidx.npz",):
        os.symlink(prefix + ext, mine + ext)
    assert cli.main(["smem-table", mine, "-k", "6", "--device", "cpu"]) == 0
    j, t = np.load(prefix + ".fma6.npz"), np.load(mine + ".fma6.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], k)


def _stderr_of(fn, *args):
    """(fn(*args), what it printed to sys.stderr)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        out = fn(*args)
    return out, buf.getvalue()


FASTQS = {"se": ["r.fq"], "pe": ["r1.fq", "r2.fq"]}


@pytest.fixture(scope="module")
def jax_sweep(cli_side):
    """The JAX CLI's `mem --seed-engine sweep` SAM files, SE and PE (two
    files), with the table next to the index."""
    from bwa_mem_scale_tpu import cli as jcli
    tmp, prefix = cli_side
    out = {}
    for mode, fqs in FASTQS.items():
        out[mode] = tmp / f"jax_{mode}.sam"
        assert jcli.main(["mem", prefix, *(str(tmp / f) for f in fqs),
                          "--batch-reads", "16", "--seed-engine", "sweep",
                          "-o", str(out[mode])]) == 0
    return out


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_mem_sweep_cli_equal_to_jax(cli_side, jax_sweep, tmp_path, mode):
    """`mem --seed-engine sweep` with the FMA table next to the index: the
    port's SAM body equal to the JAX CLI's, SE and PE (two files); the
    table is loaded and reaches the sweep."""
    from bwa_mem_scale_tpu_torch import cli
    tmp, prefix = cli_side
    tout = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [prefix, *(str(tmp / f) for f in
                                             FASTQS[mode]),
                                   "--batch-reads", "16", "--seed-engine",
                                   "sweep", "-o", str(tout), "--device",
                                   "cpu"])
    assert "* FMA ladder table loaded (K=6)" in err
    assert al.cfg.seed_engine == "sweep" and al.dfma.K == 6
    assert al.stats["sweep_ticks_p1"] > 0
    body = _body(jax_sweep[mode])
    assert body.count("\n") >= 40
    assert _body(tout) == body


TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4, max_regs=4,
            max_pairs=16)


@pytest.mark.parametrize("mode,wide", [("se", False), ("pe", False),
                                       ("se", True)],
                         ids=["se-int32", "pe-int32", "se-int64"])
def test_sweep_retry_ladder_equal_to_jax(cli_side, jax_sweep, mode, wide):
    """The sweep with the table at tiny capacities: reads overflow and go
    through the retry tiers (each with the table), and the SAM body
    equals the JAX CLI's; also at the forced int64 layout."""
    import io
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                        PipelineConfig)
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    tmp, prefix = cli_side
    table = tfma.load_fma(prefix + ".fma6.npz")
    al = GpuAligner(load_index(prefix), "cpu", MemOptions(),
                    PipelineConfig(seed_engine="sweep", **TINY), fma=table)
    if wide:
        al.fmi = TFmi.from_host(al.idx, "cpu", force_int64=True)
        al.dfma = table.to_device(I64)
    sam = io.StringIO()
    run_alignment(al, [str(tmp / f) for f in FASTQS[mode]], sam,
                  batch_reads=16, paired=mode == "pe")
    assert al.overflow_retried > 0
    assert al.fmi.pos_dtype == al.dfma.ladder_s.dtype
    with open(jax_sweep[mode]) as f:
        want = "".join(ln for ln in f if not ln.startswith("@"))
    assert sam.getvalue() == want


def test_mem_cli_with_table_default_engine_equal_to_jax(cli_side, tmp_path):
    """A table next to the index no longer makes `mem` refuse: with no
    engine named the port seeds with the one-hot machine, prints the JAX
    CLI's note, and writes its SAM body."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu_torch import cli
    tmp, prefix = cli_side
    args = [prefix, str(tmp / "r.fq"), "--batch-reads", "16"]
    jout, tout = tmp_path / "jax.sam", tmp_path / "port.sam"
    rc, jerr = _stderr_of(jcli.main, ["mem", *args, "-o", str(jout)])
    assert rc == 0
    al, terr = _stderr_of(cli.mem, args + ["-o", str(tout), "--device",
                                           "cpu"])
    note = "* note: onehot seeding ignores the FMA table"
    assert note in jerr and note in terr
    assert al.cfg.seed_engine == "onehot" and al.dfma is None
    assert _body(tout) == _body(jout)


def test_mem_cli_still_refuses_readlane(cli_side, tmp_path):
    """`mem --seed-engine readlane` runs (the port refused it before the
    engine was ported): SE and PE (two files) with the FMA table next to
    the index, the SAM body equal to the JAX CLI's `mem --seed-engine
    readlane`, and the JAX CLI's note that the engine ignores the table."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu_torch import cli
    tmp, prefix = cli_side
    note = "* note: readlane seeding ignores the FMA table"
    for mode, fqs in FASTQS.items():
        args = [prefix, *(str(tmp / f) for f in fqs), "--batch-reads", "16",
                "--seed-engine", "readlane"]
        jout, tout = tmp_path / f"jax_{mode}.sam", tmp_path / f"{mode}.sam"
        rc, jerr = _stderr_of(jcli.main, ["mem", *args, "-o", str(jout)])
        assert rc == 0
        al, terr = _stderr_of(cli.mem, args + ["-o", str(tout), "--device",
                                               "cpu"])
        assert note in jerr and note in terr
        assert al.cfg.seed_engine == "readlane" and al.dfma is None
        assert al.stats["rl_ticks_p1"] > 0
        body = _body(jout)
        assert body.count("\n") >= 40
        assert _body(tout) == body, mode


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card():
    """The port's own index of a 20 kbp genome with this file's reads, of
    a 1 Mbp genome with 512 reads of 101 bp (1% errors) and of
    ``tools/batches.py::repeat_batch``'s 2 Mbp genome with repeats and its
    512 reads, the K = 6 tables of each, at both layouts (no JAX on the
    card)."""
    dev = _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    out = {}
    for name in ("small", "batch", "repeat"):
        if name == "repeat":
            idx, codes, lens = repeat_batch()
        else:
            idx = build_index(demo_genome(
                20000 if name == "small" else 1_000_000, seed=42,
                n_contigs=1))
            codes, lens = (_reads(idx.bns.seq) if name == "small" else
                           simulate_reads(idx.bns, 512, 101, seed=8,
                                          err_rate=0.01))
        table = tfma.build_fma_table(TFmi.from_host(idx, dev), K=6)
        for wide in (False, True):
            fmi = TFmi.from_host(idx, dev, force_int64=wide)
            out[name, wide] = dict(
                fmi=fmi, table=table.to_device(fmi.pos_dtype, dev),
                codes=torch.as_tensor(codes, device=dev),
                lens=torch.as_tensor(lens, device=dev))
    return out


# pass 2 emits only matches that occur more often than the SMEM they
# reseed: on the 1 Mbp random genome there are none, so its large case
# runs on the repeat batch
CARD_CASES = [("small", "merged"), ("small", "unmerged"),
              ("small", "reseed"), ("batch", "merged"),
              ("batch", "unmerged"), ("repeat", "reseed")]


def card_pass_case(fmi, codes, lens, table, msl, mmi, M, pass2):
    """One pass launch (sweep_pass_cuda, each lane's steps kept) against
    sweep_pass_plain on the same CUDA tensors: every SmemBuf field, the
    merged records and each lane's steps (and row fetches) equal. Returns
    (the launch's SmemBuf, its steps, its rounds, the pass's arguments)."""
    P = codes.shape[1] - msl + 1
    kw = dict(fma=table, n_pos=P, p3_max_intv=mmi, p3_stop=msl + 1)
    if pass2:
        p1, _ = tsmem.sweep_pass_plain(fmi, codes, lens, msl, P, **kw)
        kw = dict(fma=table, n_pos=P, tasks=tsmem.reseed_tasks(
            p1, 2 * codes.shape[0], int(msl * 1.5 + .499), 10)[:4])
    wrap = sweep_cuda.sweep_pass_cuda
    before = (wrap.launches, wrap.launches64)
    wrap.keep_steps = True
    try:
        got, recs = wrap(fmi, codes, lens, msl, M, **kw)
    finally:
        wrap.keep_steps = False
    torch.cuda.synchronize()
    wide = fmi.pos_dtype == I64
    assert (wrap.launches, wrap.launches64) == (before[0] + 1,
                                                before[1] + wide)
    steps, rounds = wrap.last_steps.cpu(), wrap.last_rounds.cpu()
    want, wrecs = tsmem.sweep_pass_plain(fmi, codes, lens, msl, M, **kw)
    for f, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert set(recs) == set(wrecs)
    for f in wrecs:
        assert recs[f].dtype == wrecs[f].dtype, f
        assert torch.equal(recs[f], wrecs[f]), f
    assert torch.equal(steps, sweep_cuda.walked_steps(
        tsmem.extend_all_positions.last_steps, kw.get("tasks")).cpu())
    return got, steps, rounds, kw


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("batch,case", CARD_CASES,
                         ids=[f"{n}-{c}" for n, c in CARD_CASES])
def test_sweep_kernel_equal_to_plain(card, wide, use_fma, batch, case):
    """sweep_extend_kernel's pass forms against the plain version on the
    card: pass 1 merged with pass 3 and not (max_mem_intv 0), and pass 2
    (the reseed) over reseed_tasks' list, the emission in the launch at a
    width some reads pass; every output and each lane's steps; every case
    emits; on the small batch also against the twin."""
    c = card[batch, wide]
    codes, lens = c["codes"], c["lens"]
    msl = 10 if batch == "small" else 19
    tt = c["table"] if use_fma else None
    got, steps, _, kw = card_pass_case(c["fmi"], codes, lens, tt, msl,
                                       0 if case == "unmerged" else 20, 8,
                                       case == "reseed")
    assert int(steps.sum()) > 0 and int(got.cnt.sum()) > 0
    if batch == "small":
        tasks = kw.get("tasks")
        p3 = (kw.get("p3_max_intv", 0), kw.get("p3_stop", 0))
        _, K_eff = tsmem.sweep_window(tt, 0, *p3)
        lad = (None if not K_eff else tuple(
            t.cpu().numpy() for t in (tt.ladder_k, tt.ladder_l, tt.ladder_s)))
        tabs = smem_cuda.twin_tables(c["fmi"])
        twin = sweep_cuda.sweep_extend_twin(
            *tabs[:3], codes.cpu().numpy(), lens.cpu().numpy(),
            np.ones(len(lens), np.int32), True, 0, *p3, kw["n_pos"],
            ladders=lad, K_eff=K_eff, hi_steps=tabs[3], emit=(msl, 8),
            tasks=None if tasks is None else tuple(
                t.cpu().numpy() for t in tasks))
        np.testing.assert_array_equal(twin["steps"], steps.numpy())
        for f, a, b in zip(got._fields, got, twin["smem"]):
            np.testing.assert_array_equal(a.cpu().numpy(), b, f)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("use_fma", [False, True], ids=["plain", "fma"])
@pytest.mark.parametrize("batch", ["small", "batch"])
def test_collect_and_chase_kernels_equal_to_plain(card, wide, use_fma,
                                                  batch):
    """collect_smems_device with both kernels on the card equal to the
    plain path on the CPU, every field; its merged-stage launch as made
    against the plain stage on the CPU and (the small batch) the twin,
    each read's steps too; its stats counters and its torch operations
    (the outputs' allocations only)."""
    from bwa_mem_scale_tpu_torch.tools.glue_ops import outer_ops
    c = card[batch, wide]
    msl = 10 if batch == "small" else 19
    kw = dict(min_seed_len=msl, split_len=int(msl * 1.5 + .499),
              split_width=10, max_mem_intv=20)
    tt = c["table"] if use_fma else None
    calls = []
    real = sweep_cuda.seed_strategy_merged_cuda

    def record(*a, **k):
        calls.append(a)
        return real(*a, **k)
    before = (sweep_cuda.sweep_pass_cuda.launches, real.launches)
    sweep_cuda.seed_strategy_merged_cuda = record
    try:
        got = tsmem.collect_smems_device(c["fmi"], c["codes"], c["lens"],
                                         fma=tt, **kw)
    finally:
        sweep_cuda.seed_strategy_merged_cuda = real
    torch.cuda.synchronize()
    assert (sweep_cuda.sweep_pass_cuda.launches,
            real.launches) == (before[0] + 2, before[1] + 1)
    want = _plain_collect(c, tt, kw)
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    fmi, codes, lens, ext, mmi, stop, M, P = calls[0][:8]
    cpu_ext = {k: v.cpu() for k, v in ext.items()}
    p = tsmem.smems_seed_strategy_merged(
        _CpuCount(fmi.count.cpu()), codes.cpu(), lens.cpu(), cpu_ext, mmi,
        stop, M, P)
    p_steps = tsmem.strategy_chase.last_steps
    st = {}
    k = real(*calls[0][:8], stats=st)
    steps = real.last_steps.cpu()
    for f, a, b in zip(p._fields, k, p):
        assert torch.equal(a.cpu(), b), f
    assert torch.equal(steps, p_steps)
    real(*calls[0][:8], stats=st)
    assert int(st["chase_steps"]) == 2 * int(steps.max())
    assert int(st["chase_total"]) == 2 * int(steps.sum())
    names = set()
    outer_ops(lambda: real(*calls[0][:8], stats=st), names)
    assert names <= {"aten::empty", "aten::unbind", "aten::select",
                     "aten::slice", "aten::view"}, names
    if batch == "small":
        twin = sweep_cuda.seed_strategy_merged_twin(
            fmi.count.cpu().numpy(), codes.cpu().numpy(),
            lens.cpu().numpy(), {k: v.numpy() for k, v in cpu_ext.items()},
            stop, M, P)
        np.testing.assert_array_equal(twin[6], p_steps.numpy())


class _CpuCount:
    """What the merged stage reads of an index: its C array."""

    def __init__(self, count):
        self.count = count


def _plain_collect(c, tt, kw):
    """collect_smems_device on the CPU (the plain versions) on the card
    case's index and reads."""
    import dataclasses
    fmi = c["fmi"]
    cpu = dataclasses.replace(
        fmi, count=fmi.count.cpu(), cp_fused=fmi.cp_fused.cpu(),
        cp_hi_steps=(None if fmi.cp_hi_steps is None
                     else fmi.cp_hi_steps.cpu()),
        sa_samples=fmi.sa_samples.cpu(), ref=fmi.ref.cpu())
    table = None if tt is None else dataclasses.replace(
        tt, ladder_k=tt.ladder_k.cpu(), ladder_l=tt.ladder_l.cpu(),
        ladder_s=tt.ladder_s.cpu())
    return tsmem.collect_smems_device(cpu, c["codes"].cpu(), c["lens"].cpu(),
                                      fma=table, **kw)
