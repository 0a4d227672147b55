"""Port vs JAX: the readlane seeding engine (``ops/smem_rl.py``, its
kernels' wrappers and twins in ``ops/smem_rl_cuda.py``) against the JAX
package's ``ops/smem_rl.py``, exact (tolerance 0: integer arrays and tick
counts), on conftest's 20 kbp genome: 16 reads of 101 bp at 3% errors,
one with two N bases, a tiled 30-mer repeat, a 40 bp read and a
zero-length read mid-backlog (B = 20, L = 101), at the int32 and the
forced int64 layout and with the bigram and trigram tables.

- ``collect_smems_rl`` equals the JAX function (one JAX run a layout or
  table, one lane a task) at lanes None and 19 (19 on the int64 layout
  and the k-gram tables), and the port's one-hot engine at full depth
  (K = 1 and int64).
- ``one_pos_machine`` (pass 1 at lanes None, 3, 7 and 19, and 19 on the
  int64 layout and the k-gram tables; pass 2 on the reseed tasks with
  ``out_rows``) and ``seed_strategy_machine`` equal the JAX machines
  array for array and in ``with_ticks``' tick, done_at and phase_ticks:
  the same lockstep machine, refill order included.
- The kernels' twins (``readlane_twin``, ``readlane_strategy_twin``) equal
  the plain machines under their own pull order and two seeded random
  ones (one on the int64 layout and the k-gram tables), their total
  steps equal the plain machines', and each lane's ticks are the sum of
  its tasks' rounds as csrc/smem.cu's twins count them (pass 3: row
  fetches). Pass 3's lanes a warp follow the shared memory a block has.
- The wrappers run the plain machines on CPU tensors and refuse a tensor
  of any other non-CUDA device rather than fall back.
- ``mem --seed-engine readlane -v 4`` prints the JAX CLI's device stage
  table (its header with B and L, its four rows) beside the port's stage
  seconds.
On a GPU (``-m cuda``) each kernel form at lanes None, 64 and 7 (pass 3
also at 1 and 32 lanes a warp) against its plain version (run on one
lane a task), K = 1, 2, 3 and int64, with total steps equal and K = 1's
total ticks equal to the twins', on the small batch and on 512 reads of
a 1 Mbp genome. The
JAX side is imported inside the fixtures that use it, so the CUDA cases
also run without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_smem_rl.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.index import kstep as tk
from bwa_mem_scale_tpu_torch.ops import smem_cuda, smem_rl_cuda
from bwa_mem_scale_tpu_torch.ops import smem_rl as trl
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.smem import reseed_tasks
from bwa_mem_scale_tpu_torch.ops.smem_oh import collect_smems_oh

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("m", "n", "k", "l", "s", "cnt")
MSL, SPLIT_LEN, SPLIT_WIDTH, MAX_INTV = 19, 28, 10, 20
KW = dict(min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_WIDTH,
          max_mem_intv=MAX_INTV)
CFGS = ("k1", "int64", "k2", "k3")


def _reads(idx):
    """The batch: codes [20, 101] int32 (4 past a read's end), lens."""
    from conftest import sample_reads
    reads = [c.astype(np.int32) for c, _, _ in
             sample_reads(idx.bns, 16, 101, seed=5, err_rate=0.03)]
    withn = reads[0].copy()
    withn[10] = withn[50] = 4
    reads += [withn,
              np.tile(idx.bns.seq[100:130].astype(np.int32), 4)[:101],
              reads[1][:40].copy()]
    reads.insert(8, np.zeros(0, np.int32))       # zero length, mid-backlog
    codes = np.full((len(reads), 101), 4, np.int32)
    for i, c in enumerate(reads):
        codes[i, :len(c)] = c
    return codes, np.array([len(c) for c in reads], np.int32)


@pytest.fixture(scope="module")
def side(small_index):
    """Both packages' device indexes in each configuration, and the
    batch."""
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    idx = small_index
    jf = {"k1": JFmi.from_host(idx),
          "int64": JFmi.from_host(idx, force_int64=True)}
    tf = {"k1": TFmi.from_host(idx, "cpu"),
          "int64": TFmi.from_host(idx, "cpu", force_int64=True)}
    for K in (2, 3):
        # one table for both (the builders' arrays are equal:
        # tests/test_torch_kstep.py)
        cp2 = tk.build_cp2(idx, K)
        jf[f"k{K}"] = JFmi.from_host(idx, cp2=cp2)
        tf[f"k{K}"] = TFmi.from_host(idx, "cpu", cp2=cp2)
    codes, lens = _reads(idx)
    return dict(jf=jf, tf=tf, codes=codes, lens=lens, tasks={})


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(want, got, what):
    """A JAX SmemBuf (or numpy tuple) against a port SmemBuf, every field
    and its dtype."""
    for f, a, b in zip(FIELDS, want, got):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(a, b, f"{what}: {f}")


def _pass1_args(side):
    B = side["codes"].shape[0]
    b, z = np.arange(B, dtype=np.int32), np.zeros(B, np.int32)
    return b, z, z + 1, side["lens"] > 0


def _pass2_tasks(side, cfg):
    """The reseed tasks of the port's pass 1 (equal to the JAX pass 1's)
    as numpy arrays (t_read, t_x, t_mi, t_valid), made once a
    configuration."""
    if cfg not in side["tasks"]:
        side["tasks"][cfg] = _reseed(side, cfg)
    return side["tasks"][cfg]


def _reseed(side, cfg):
    tf = side["tf"][cfg]
    codes, lens = _t(side["codes"]), _t(side["lens"])
    p1 = trl.one_pos_machine(tf, codes, lens,
                             *(_t(a) for a in _pass1_args(side)), True, MSL,
                             codes.shape[1])
    tasks = reseed_tasks(p1, 2 * codes.shape[0], SPLIT_LEN, SPLIT_WIDTH)[:4]
    return [t.numpy().astype(np.int32) if t.dtype != torch.bool
            else t.numpy() for t in tasks]


@pytest.fixture(scope="module")
def jax_collect(side):
    """The JAX collect_smems_rl of each configuration, one lane a read."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem_rl import collect_smems_rl
    return {cfg: [np.asarray(a) for a in collect_smems_rl(
        side["jf"][cfg], jnp.asarray(side["codes"]),
        jnp.asarray(side["lens"]), **KW)] for cfg in CFGS}


@pytest.mark.parametrize("cfg", CFGS)
def test_collect_smems_rl_equal_to_jax(side, jax_collect, cfg):
    tf = side["tf"][cfg]
    codes, lens = _t(side["codes"]), _t(side["lens"])
    assert tf.kstep == {"k2": 2, "k3": 3}.get(cfg, 1)
    for lanes in ((None, 19) if cfg == "k1" else (19,)):
        st = {}
        got = trl.collect_smems_rl(tf, codes, lens, lanes=lanes, stats=st,
                                   **KW)
        _eq(jax_collect[cfg], got, f"{cfg}, lanes {lanes}")
        assert st["rl_ticks_p1"] > 0 and st["rl_ticks_p2"] > 0
    assert int(got.cnt.sum()) > 0
    if cfg in ("k2", "k3"):     # the k-step one-hot: test_torch_kstep.py
        return
    oh = collect_smems_oh(tf, codes, lens, **KW)
    for f in FIELDS:
        assert torch.equal(getattr(oh, f), getattr(got, f)), f


def _jax_ticks(ticks):
    return [np.asarray(t) for t in ticks]


def _eq_ticks(want, got, what):
    tick, done_at, phase = _jax_ticks(want)
    assert int(tick) == int(got[0]), what
    np.testing.assert_array_equal(done_at, got[1].numpy(), what)
    np.testing.assert_array_equal(phase, got[2].numpy(), what)


@pytest.mark.parametrize("cfg,lanes", [
    ("k1", None), ("k1", 3), ("k1", 7), ("k1", 19), ("int64", 19),
    ("k2", 19), ("k3", 19)])
def test_pass1_equal_to_jax_with_ticks(side, cfg, lanes):
    """Pass 1 (restarts at next_x) of one_pos_machine: every array and
    the lockstep's ticks equal the JAX machine's."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_rl import one_pos_machine
    jf, tf = side["jf"][cfg], side["tf"][cfg]
    codes, lens = side["codes"], side["lens"]
    B, L = codes.shape
    args = _pass1_args(side)
    jb, jt = one_pos_machine(
        jf, jnp.asarray(codes), jnp.asarray(lens),
        *(jnp.asarray(a) for a in args), True, MSL, L,
        JBuf.empty(B, L, jf.pos_dtype), with_ticks=True, lanes=lanes)
    tb, tt = trl.one_pos_machine(tf, _t(codes), _t(lens),
                                 *(_t(a) for a in args), True, MSL, L,
                                 with_ticks=True, lanes=lanes)
    _eq(jb, tb, f"pass 1, {cfg}, lanes {lanes}")
    _eq_ticks(jt, tt, f"pass 1 ticks, {cfg}, lanes {lanes}")
    assert tt[1].shape == (lanes or B,)


@pytest.mark.parametrize("cfg,lanes", [
    ("k1", None), ("k1", 7), ("int64", 19), ("k2", 19), ("k3", 19)])
def test_pass2_and_pass3_equal_to_jax_with_ticks(side, cfg, lanes):
    """Pass 2 (one position a task, each task its own row through
    out_rows) and pass 3 (seed_strategy_machine): every array and the
    ticks equal the JAX machines'."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops import smem_rl as jrl
    jf, tf = side["jf"][cfg], side["tf"][cfg]
    codes, lens = side["codes"], side["lens"]
    B, L = codes.shape
    tasks = _pass2_tasks(side, cfg)
    N = len(tasks[0])
    assert 0 < int(tasks[3].sum()) < N
    jb, jt = jrl.one_pos_machine(
        jf, jnp.asarray(codes), jnp.asarray(lens),
        *(jnp.asarray(a) for a in tasks), False, MSL, L,
        JBuf.empty(N, L, jf.pos_dtype), with_ticks=True, lanes=lanes,
        out_rows=jnp.arange(N, dtype=jnp.int32))
    tb, tt = trl.one_pos_machine(
        tf, _t(codes), _t(lens), *(_t(a) for a in tasks), False, MSL, L,
        with_ticks=True, lanes=lanes, out_rows=torch.arange(N))
    _eq(jb, tb, f"pass 2, {cfg}, lanes {lanes}")
    _eq_ticks(jt, tt, f"pass 2 ticks, {cfg}, lanes {lanes}")
    jb3, jt3 = jrl.seed_strategy_machine(
        jf, jnp.asarray(codes), jnp.asarray(lens), MAX_INTV, MSL + 1, L,
        with_ticks=True, lanes=lanes)
    tb3, tt3 = trl.seed_strategy_machine(tf, _t(codes), _t(lens), MAX_INTV,
                                         MSL + 1, L, with_ticks=True,
                                         lanes=lanes)
    _eq(jb3, tb3, f"pass 3, {cfg}, lanes {lanes}")
    assert int(np.asarray(jt3)) == int(tt3)
    assert int(tb3.cnt.sum()) > 0


@pytest.mark.parametrize("cfg", CFGS)
def test_readlane_twins_equal_to_plain(side, cfg):
    """The kernels' loops (the twins) under their own pull order and two
    seeded random ones: every array equal to the plain machine's, total
    steps equal, and each lane's ticks the sum of its tasks' rounds as
    csrc/smem.cu's warp-a-task kernel counts them (``one_pos_twin`` at
    full depth; pass 3: ``seed_strategy_twin``'s row fetches a read)."""
    tf = side["tf"][cfg]
    tables = smem_cuda.twin_tables(tf)
    kw = dict(hi_steps=tables[3], kstep=smem_cuda.kstep_tables(tf))
    codes, lens = side["codes"], side["lens"]
    B, L = codes.shape
    rng = np.random.RandomState(17)
    lanes = 7
    for chain, tasks, rows in ((True, _pass1_args(side), None),
                               (False, _pass2_tasks(side, cfg), "own")):
        N = len(tasks[0])
        out_rows = None if rows is None else np.arange(N)
        want = trl.one_pos_machine(
            tf, _t(codes), _t(lens), *(_t(a) for a in tasks), chain, MSL, L,
            lanes=lanes, out_rows=None if out_rows is None else _t(out_rows))
        steps = int(trl.one_pos_machine.last_steps.sum())
        rounds = smem_cuda.one_pos_twin(*tables[:3], codes, lens, *tasks,
                                        chain, MSL, L, **kw)[7]
        pulls = (rng.randint(0, lanes, N), rng.randint(0, 2, N))
        if cfg != "k1":                 # K = 1 takes every order
            pulls = pulls[:1]
        for pull in ((None,) + pulls if chain else pulls[:1]):
            got = smem_rl_cuda.readlane_twin(
                *tables[:3], codes, lens, *tasks, chain, MSL, L,
                lanes=lanes, out_rows=out_rows, pull=pull, **kw)
            _eq(got[:6], want, f"twin, pass {1 if chain else 2}, {cfg}")
            assert int(got[6].sum()) == steps
            assert int(got[7].sum()) == int(rounds.sum())
            if pull is not None:
                np.testing.assert_array_equal(
                    got[7], np.bincount(pull, rounds, lanes).astype(int))
    want = trl.seed_strategy_machine(tf, _t(codes), _t(lens), MAX_INTV,
                                     MSL + 1, L, lanes=lanes)
    steps = int(trl.seed_strategy_machine.last_steps.sum())
    fetches = smem_cuda.seed_strategy_twin(*tables[:3], codes, lens,
                                           MAX_INTV, MSL + 1, L, **kw)[7]
    for pull in ((None, rng.randint(0, lanes, B)) if cfg == "k1"
                 else (rng.randint(0, lanes, B),)):
        got = smem_rl_cuda.readlane_strategy_twin(
            *tables[:3], codes, lens, MAX_INTV, MSL + 1, L, lanes=lanes,
            pull=pull, **kw)
        _eq(got[:6], want, f"strategy twin, {cfg}")
        assert int(got[6].sum()) == steps
        assert int(got[7].sum()) == int(fetches.sum())
        if pull is not None:
            np.testing.assert_array_equal(
                got[7], np.bincount(pull, fetches, lanes).astype(int))


@pytest.mark.parametrize("L,lanes,want", [
    (101, 512, 8), (101, 64, 8), (101, 7, 7), (40, 3, 3), (151, 256, 8),
    (30000, 512, 7), (116224, 64, 2), (116225, 64, 1), (232448, 64, 1),
    (232449, 64, 0)])
def test_strategy_lanes_a_warp(side, L, lanes, want):
    """Pass 3's worker lanes a one-warp block: P3_LANES (8) while that
    many slots of L codes (each rounded up to 16 bytes) fit 227 KB of
    shared memory, fewer for long reads or a smaller pool, none where one
    slot does not fit (the wrapper then raises on the card). On the CPU
    the pool's geometry does not show: pass 3 at `lanes` equals the plain
    machine at one lane a read."""
    assert smem_rl_cuda.P3_LANES == 8
    rw = smem_rl_cuda.strategy_lanes_a_warp(L, lanes)
    assert rw == want
    assert rw * ((L + 15) // 16 * 16) <= smem_rl_cuda.SMEM_MAX
    tf = side["tf"]["k1"]
    codes, lens = _t(side["codes"]), _t(side["lens"])
    B = codes.shape[0]
    got = smem_rl_cuda.readlane_strategy_cuda(
        tf, codes, lens, MAX_INTV, MSL + 1, codes.shape[1],
        lanes=min(lanes, B))
    want_buf = trl.seed_strategy_machine(tf, codes, lens, MAX_INTV, MSL + 1,
                                         codes.shape[1])
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want_buf, f)), f


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices(side):
    """On CPU tensors each wrapper is its plain machine (no launch
    counted); a tensor on another device than the CPU or CUDA raises, so
    nothing falls back to the plain machine off the CPU."""
    tf = side["tf"]["k1"]
    codes, lens = _t(side["codes"]), _t(side["lens"])
    args = [_t(a) for a in _pass1_args(side)]
    L = codes.shape[1]
    n1 = smem_rl_cuda.readlane_one_pos_cuda.launches
    n3 = smem_rl_cuda.readlane_strategy_cuda.launches
    st = {}
    got = smem_rl_cuda.readlane_one_pos_cuda(tf, codes, lens, *args, True,
                                             MSL, L, lanes=5, stats=st)
    want = trl.one_pos_machine(tf, codes, lens, *args, True, MSL, L)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    got = smem_rl_cuda.readlane_strategy_cuda(tf, codes, lens, MAX_INTV,
                                              MSL + 1, L, stats=st)
    want = trl.seed_strategy_machine(tf, codes, lens, MAX_INTV, MSL + 1, L)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (smem_rl_cuda.readlane_one_pos_cuda.launches,
            smem_rl_cuda.readlane_strategy_cuda.launches) == (n1, n3)
    assert st["rl_ticks"] > 0 and st["rl_ticks_p3"] > 0
    meta = codes.to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        smem_rl_cuda.readlane_one_pos_cuda(tf, meta, lens.to("meta"),
                                           *(a.to("meta") for a in args),
                                           True, MSL, L)
    with pytest.raises(ValueError, match="unsupported device meta"):
        smem_rl_cuda.readlane_strategy_cuda(tf, meta, lens.to("meta"),
                                            MAX_INTV, MSL + 1, L)


def test_mem_v4_prints_the_stage_table(tmp_path):
    """`mem --seed-engine readlane -v 4 --device cpu`: the JAX CLI's
    device stage table of the first batch (its header with the batch's B
    and L, then seed, +sa_lookup, +chain/filter and +extend(full)), and
    the port's synchronised stage seconds kept; the table is printed
    once."""
    import contextlib
    import io
    import re
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    from conftest import make_genome, sample_reads
    bns = make_genome(12000, seed=9, n_contigs=2)
    with open(tmp_path / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    with open(tmp_path / "r.fq", "w") as f:
        for i, (c, _, _) in enumerate(sample_reads(bns, 24, 60, seed=2,
                                                   err_rate=0.02)):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    g = str(tmp_path / "g")
    assert cli.main(["index", str(tmp_path / "g.fa"), "-p", g]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        al = cli.mem([g, str(tmp_path / "r.fq"), "-o",
                      str(tmp_path / "o.sam"), "--device", "cpu",
                      "--batch-reads", "16", "--seed-engine", "readlane",
                      "-v", "4"])
    err = buf.getvalue()
    assert err.count("Device stage profile") == 1
    lines = err.split("Device stage profile")[1].splitlines()
    assert lines[0] == " (B=16, L=60, warm; incremental prefixes):"
    rows = [re.match(r"  (\S+) +([0-9.]+)s  \(stage +([0-9.]+)s, +\d+ "
                     r"reads/s cumulative\)$", ln) for ln in lines[1:5]]
    assert [r.group(1) for r in rows] == ["seed", "+sa_lookup",
                                          "+chain/filter", "+extend(full)"]
    assert not al.stage_profile_pending and al.batches == 2
    assert al.prof is not None and al.prof.seconds["seed"] > 0


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card():
    """The port's own index of a 20 kbp genome with 20 reads and of a 1
    Mbp genome with 512 reads of 101 bp (1% errors), each at K = 1, 2, 3
    and the forced int64 layout (no JAX on the card)."""
    dev = _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    out = {}
    for name, n, reads in (("small", 20000, 20), ("batch", 1_000_000, 512)):
        idx = build_index(demo_genome(n, seed=13, n_contigs=1))
        codes, lens = simulate_reads(idx.bns, reads, 101, seed=8,
                                     err_rate=0.01)
        lens[reads // 2] = 0
        fmis = {"k1": TFmi.from_host(idx, dev),
                "int64": TFmi.from_host(idx, dev, force_int64=True)}
        for K in (2, 3):
            fmis[f"k{K}"] = TFmi.from_host(idx, dev,
                                          cp2=tk.build_cp2(idx, K))
        out[name] = dict(fmi=fmis, codes=torch.as_tensor(codes, device=dev),
                         lens=torch.as_tensor(lens, device=dev))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("batch", ["small", "batch"])
def test_readlane_kernels_equal_to_plain(card, cfg, batch):
    """Passes 1, 2 and 3 through each kernel form at lanes None, 64 and 7
    (pass 3 at 64 lanes also at 1 and 32 lanes a warp): every array equal
    to the plain machine's on the card (run once, on one lane a task: its
    arrays do not depend on the pool), total steps equal, at K = 1 the
    total ticks equal to the twins' (a task's rounds do not depend on the
    lane that runs it, so the total is the same for every pull order);
    each launch counted in its form; collect_smems_rl equal to the
    one-hot engine at full depth."""
    b = card[batch]
    fmi, codes, lens = b["fmi"][cfg], b["codes"], b["lens"]
    dev = codes.device
    B, L = codes.shape
    one, three = (smem_rl_cuda.readlane_one_pos_cuda,
                  smem_rl_cuda.readlane_strategy_cuda)
    bidx = torch.arange(B, dtype=torch.int32, device=dev)
    z = torch.zeros_like(bidx)
    p1 = (bidx, z, z + 1, lens > 0)
    want1 = trl.one_pos_machine(fmi, codes, lens, *p1, True, MSL, L)
    s1 = int(trl.one_pos_machine.last_steps.sum())
    tasks = reseed_tasks(want1, 2 * B, SPLIT_LEN, SPLIT_WIDTH)[:4]
    rows = torch.arange(tasks[0].shape[0], device=dev)
    want2 = trl.one_pos_machine(fmi, codes, lens, *tasks, False, MSL, L,
                                out_rows=rows)
    s2 = int(trl.one_pos_machine.last_steps.sum())
    want3 = trl.seed_strategy_machine(fmi, codes, lens, MAX_INTV, MSL + 1, L)
    s3 = int(trl.seed_strategy_machine.last_steps.sum())
    t1 = t2 = t3 = None
    if fmi.kstep == 1:
        tb = smem_cuda.twin_tables(fmi)
        c, ln = codes.cpu().numpy(), lens.cpu().numpy()

        def ticks(*args):
            return int(smem_rl_cuda.readlane_twin(
                *tb[:3], c, ln, *(a.cpu().numpy() for a in args[:4]),
                *args[4:], hi_steps=tb[3])[7].sum())
        t1 = ticks(*p1, True, MSL, L)
        t2 = ticks(*tasks, False, MSL, L)
        t3 = int(smem_rl_cuda.readlane_strategy_twin(
            *tb[:3], c, ln, MAX_INTV, MSL + 1, L, hi_steps=tb[3])[7].sum())
    for lanes in (None, 64, 7):
        for chain, args, out_rows, want, s, t in (
                (True, p1, None, want1, s1, t1),
                (False, tasks, rows, want2, s2, t2)):
            before = (one.launches, one.launches64, one.launches_k)
            got = one(fmi, codes, lens, *args, chain, MSL, L, lanes=lanes,
                      out_rows=out_rows)
            for f in FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert int(one.last_steps.sum()) == s
            if t is not None:
                assert int(one.last_ticks.sum()) == t
            assert (one.launches - before[0], one.launches64 - before[1],
                    one.launches_k - before[2]) == (
                1, int(cfg == "int64"), int(cfg in ("k2", "k3")))
        per_warp = smem_rl_cuda.P3_LANES
        for rw in ((per_warp, 1, 32) if lanes == 64 else (per_warp,)):
            smem_rl_cuda.P3_LANES = rw
            try:
                got = three(fmi, codes, lens, MAX_INTV, MSL + 1, L,
                            lanes=lanes)
            finally:
                smem_rl_cuda.P3_LANES = per_warp
            for f in FIELDS:
                assert torch.equal(getattr(got, f), getattr(want3, f)), f
            assert int(three.last_steps.sum()) == s3
            if t3 is not None:
                assert int(three.last_ticks.sum()) == t3
    full = trl.collect_smems_rl(fmi, codes, lens, lanes=64, **KW)
    oh = collect_smems_oh(fmi, codes, lens, **KW)
    for f in FIELDS:
        assert torch.equal(getattr(full, f), getattr(oh, f)), f
