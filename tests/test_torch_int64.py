"""The int64-position layout of ``ops/occ.py`` through the port, exact.

On the CPU, against the JAX package's int64 path
(``DeviceFMIndex.from_host(force_int64=True)``) on small genomes:
- the layout's choice (forced, or an index whose ``seq_len`` alone passes
  2^31) and the retry tiers that go with it;
- the occ primitives at the forced layout equal to the JAX package's and
  to the port's int32 ones; the high-count decode on tables whose counts
  pass 2^32 equal to the JAX package's ``_row_at`` / ``occ_b_and_base``;
- the plain seeding machines on a "lifted" table (every count plus 2^32:
  no longer an FM index, intervals past 2^32) equal to the JAX machines;
  pass 3's twin equal to its plain version there (passes 1-2's twin is
  not: the warp form's keep rule rests on two orders along a backward
  round that only a real FM index keeps, and the twin reports the break);
- the SA lookup on samples lifted by 2^33, and chaining on a synthetic
  3.1 Gbp genome (coordinates past 2^31 and 2^32, a read over the strands'
  junction), the plain versions and the kernels' twins equal to the JAX
  functions;
- the twins of all five kernel forms equal to their plain versions;
- ``seed_chain_extend``'s dict equal to the JAX program's, key by key and
  dtype by dtype; ``mem`` (SE, at two capacities, the tiny one through the
  retry ladder) byte-equal to the JAX package's int32 SAM; the CLI on an
  index whose ``seq_len`` passes 2^31; PE byte-equal to the port's int32
  PE.
Every comparison is exact (integers; no tolerance).

On a GPU (``-m cuda``) each int64 kernel form against its plain version,
with its steps (and rounds) equal to its twin's, on a 512-read batch, on
the lifted table (pass 3), with a non-empty step table, on the lifted SA
samples, and chaining past 2^31 (also past 48 KB of shared memory and on
the repeat batch):
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_int64.py
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.ops import chain as tchain
from bwa_mem_scale_tpu_torch.ops import chain_cuda, smem_cuda
from bwa_mem_scale_tpu_torch.ops import occ as tocc
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.ops.sal import sa_lookup_plain
from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf, reseed_tasks
from bwa_mem_scale_tpu_torch.ops.smem_oh import (one_pos_machine,
                                                 seed_strategy_machine)

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

B, L = 32, 101
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)
FIELDS = ("m", "n", "k", "l", "s", "cnt")
I32, I64 = torch.int32, torch.int64
LIFT = 1 << 32
# the synthetic chaining genomes of 3.1 Gbp: test_torch_chain's 20 kbp
# layout behind a first contig of D0 bases and before a last one of D1, so
# forward positions move up by D0 and reverse ones by D0 + 2 x D1. "fw":
# both strands at ~3.1e9, past 2^31, seeds over the strands' junction;
# "rc": reverse positions at ~5.2e9, past 2^32
MOVES = {"fw": (3_100_000_000 - 20_000, 0),
         "rc": (1_000_000_000, 2_100_000_000 - 20_000)}


def _lift(idx, how):
    """idx with its checkpoint counts' high words raised: "plus-2^32" every
    count + 2^32; "steps" each base's high word stepping 1-3 times at
    blocks of its own; "plus-2^35" every count + 8 x 2^32 (the step
    table's 8 entries a base, all at block 0)."""
    cnt = np.asarray(idx.cp_count, np.int64)
    nb = cnt.shape[0]
    if how == "plus-2^32":
        hi = np.ones_like(cnt)
    elif how == "plus-2^35":
        hi = np.full_like(cnt, 8)
    else:
        blk = np.arange(nb)[:, None]
        hi = sum((blk >= np.array([(c + j) * nb // 7 for c in range(4)]))
                 for j in range(1, 4))
        hi[:, 0] = (blk[:, 0] >= nb // 2)
    return dataclasses.replace(idx, cp_count=cnt + (hi << 32))


def _reads(seq, n, seed):
    """101 bp reads: 2% substitutions, half reverse-complemented, a
    chimera in 7, a random read in 11, N bases in 13, an exact reverse
    copy in 5."""
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0], np.int32)
    codes = np.zeros((n, L), np.int32)
    for i in range(n):
        p = rng.randint(0, len(seq) - L)
        s = seq[p: p + L].astype(np.int32).copy()
        e = rng.rand(L) < 0.02
        s[e] = (s[e] + rng.randint(1, 4, e.sum())) % 4
        if i % 7 == 0:
            p2 = rng.randint(0, len(seq) - L)
            s[L // 2:] = seq[p2 + L // 2: p2 + L]
        if i % 11 == 0:
            s[:] = rng.randint(0, 4, L)
        if i % 13 == 5:
            s[rng.randint(0, L, 2)] = 4
        if i % 2:
            s = comp[np.minimum(s, 3)][::-1].copy()
        if i % 5 == 2:
            s = comp[seq[p: p + L].astype(np.int32)][::-1].copy()
        codes[i] = s
    return codes


def _write_fastq(path, codes):
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    with open(path, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@q{i}\n{decode_bases(c)}\n+\n"
                    f"{chr(33 + i % 40) * len(c)}\n")
    return str(path)


def _pass1(codes, lens):
    n = codes.shape[0]
    zi = torch.zeros((n,), dtype=I32)
    return (torch.arange(n, dtype=I32), zi, zi + 1, lens > 0)


def _eq_buf(got, want, what=""):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        a = a if isinstance(a, np.ndarray) else a.cpu().numpy()
        b = b if isinstance(b, np.ndarray) else np.asarray(b)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, f"{what} {f}")


# ---- the layout -----------------------------------------------------------

def test_from_host_picks_the_int64_layout(small_index):
    """int32 by default; int64 when forced, or when seq_len alone passes
    2^31 (then GpuAligner also takes the JAX package's wide retry
    tiers): the C array and SA samples int64, the row's low words equal
    to the counts, an empty step table (no count reaches 2^32)."""
    from bwa_mem_scale_tpu_torch.pipeline.align import GpuAligner
    f32 = TFmi.from_host(small_index, "cpu")
    f64 = TFmi.from_host(small_index, "cpu", force_int64=True)
    assert (f32.pos_dtype, f64.pos_dtype) == (I32, I64)
    assert f32.cp_hi_steps is None and f64.hi_counts == [0, 0, 0, 0]
    assert f64.sa_samples.dtype == f64.count.dtype == I64
    assert torch.equal(f32.cp_fused, f64.cp_fused)
    assert torch.equal(f32.sa_samples.long(), f64.sa_samples)
    assert f64.nbytes() - f32.nbytes() == (
        4 * f32.sa_samples.numel() + 4 * 5 + 8 * 4 * tocc.HI_STEPS)
    big = dataclasses.replace(small_index, seq_len=1 << 31)
    assert not big.pos_fits_int32
    assert TFmi.from_host(big, "cpu").pos_dtype == I64
    al = GpuAligner(big, "cpu", TOpt())
    assert al.fmi.pos_dtype == I64
    assert (al.RETRY_BATCH, al.RETRY2_BATCH) == (512, 16)
    assert (GpuAligner.RETRY_BATCH, GpuAligner.RETRY2_BATCH) == (64, 8)


@pytest.mark.parametrize("how", ["plus-2^32", "steps", "plus-2^35"])
def test_hi_steps(small_index, how):
    """The step table: each base's high word is its steps at or before the
    block; more than HI_STEPS steps, or high words that fall along the
    BWT, are refused."""
    lifted = _lift(small_index, how)
    steps = tocc.hi_steps(lifted.cp_count)
    hi = np.asarray(lifted.cp_count) >> 32
    blk = np.arange(hi.shape[0])[:, None]
    for c in range(4):
        np.testing.assert_array_equal(
            (blk >= steps[c][None, :]).sum(1), hi[:, c])
    with pytest.raises(ValueError, match="steps"):
        tocc.hi_steps(np.asarray(lifted.cp_count) + (1 << 35))
    falls = np.array(lifted.cp_count)
    falls[0, 2] += 3 << 32                  # above every later row's
    with pytest.raises(ValueError, match="fall"):
        tocc.hi_steps(falls)


# ---- the primitives -------------------------------------------------------

def _positions(n_pos, seed=7, n=512):
    rng = np.random.RandomState(seed)
    return rng.randint(0, n_pos, size=n).astype(np.int64)


def test_primitives_equal_to_jax_and_int32(small_index):
    """occ_all4, backward_ext_all4, occ_b_and_base, bwt_base_at and
    sa_sample_at at the forced layout: equal to the JAX package's forced
    layout (values and int64 dtype) and, as values, to the port's int32
    layout."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import occ as jocc
    jf = jocc.DeviceFMIndex.from_host(small_index, force_int64=True)
    t64 = TFmi.from_host(small_index, "cpu", force_int64=True)
    t32 = TFmi.from_host(small_index, "cpu")
    n = small_index.seq_len
    pp = _positions(n)
    k = _positions(n - 60, seed=8)
    s = np.minimum(_positions(50, seed=9) + 1, n - k)
    l_ = _positions(n, seed=10)
    ns = int(small_index.sa_samples.shape[0])
    si = _positions(ns, seed=11)
    t = lambda a, dt: torch.as_tensor(a).to(dt)

    def both(fn, jfn, *args):
        want = jfn(jf, *(jnp.asarray(a) for a in args))
        got = fn(t64, *(t(a, I64) for a in args))
        ref = fn(t32, *(t(a, I32) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for w, g, r in zip(want, got, ref):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, (fn.__name__, g.dtype)
            np.testing.assert_array_equal(g.numpy(), w, fn.__name__)
            np.testing.assert_array_equal(g.numpy(), r.numpy().astype(
                w.dtype), fn.__name__)

    both(tocc.occ_all4, jocc.occ_all4, pp)
    both(tocc.backward_ext_all4, jocc.backward_ext_all4, k, l_, s)
    both(tocc.occ_b_and_base, jocc.occ_b_and_base, pp)
    both(tocc.bwt_base_at, jocc.bwt_base_at, pp)
    both(tocc.sa_sample_at, jocc.sa_sample_at, si)


@pytest.mark.parametrize("how", ["plus-2^32", "steps", "plus-2^35"])
def test_high_count_decode_equal_to_jax(small_index, how):
    """Counts past 2^32: the port's row decode (low words and the step
    table) against the JAX package's (low words and the cp_hi byte), for
    _row_at, occ_all4 and occ_b_and_base, and the kernels' twin row."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import occ as jocc
    lifted = _lift(small_index, how)
    jf = jocc.DeviceFMIndex.from_host(lifted, force_int64=True)
    tf = TFmi.from_host(lifted, "cpu", force_int64=True)
    pp = _positions(small_index.seq_len, seed=12)
    pp[:4] = [0, 31, small_index.seq_len - 1, 32 * 100 + 5]
    blk = pp >> 5
    counts, masks, _ = tocc._row_at(tf, torch.as_tensor(pp))
    j_counts, j_masks = jocc._row_at(jf, jnp.asarray(blk.astype(np.int32)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(masks.numpy(),
                                  np.asarray(j_masks).astype(np.int64))
    assert int(counts.max()) >= LIFT
    for fn in ("occ_all4", "occ_b_and_base"):
        got = getattr(tocc, fn)(tf, torch.as_tensor(pp))
        want = getattr(jocc, fn)(jf, jnp.asarray(pp))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), fn)
    twin = smem_cuda._TwinFmi(*smem_cuda.twin_tables(tf))
    for p, want in zip(pp[:64], counts.numpy()[:64]):
        assert twin.row(int(p))[0] == [int(v) for v in want]


# ---- the plain machines past 2^32 -----------------------------------------

@pytest.fixture(scope="module")
def lifted(small_index):
    """The lifted table ("plus-2^32") on both packages' int64 layouts, and
    24 reads."""
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    up = _lift(small_index, "plus-2^32")
    codes = _reads(small_index.bns.seq, 24, seed=3)
    return (JFmi.from_host(up, force_int64=True),
            TFmi.from_host(up, "cpu", force_int64=True),
            torch.as_tensor(codes), torch.full((24,), L, dtype=I32))


def test_plain_seeding_on_lifted_table_equal_to_jax(lifted):
    """Passes 1 and 2 (the lockstep one_pos_machine) and pass 3
    (seed_strategy_machine) on the lifted table, where intervals pass
    2^32 and the next rows are read at clamped indices: equal to the JAX
    machines, dtypes included; pass 3's twin equal to its plain version
    there, with intervals past 2^32 among its outputs. Passes 1-2's twin
    reports the broken order its warp form rests on."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.smem import SmemBuf as JBuf
    from bwa_mem_scale_tpu.ops.smem_oh import (one_pos_machine_oh,
                                               seed_strategy_machine_oh)
    jf, tf, codes, lens = lifted
    jc, jl = jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy())
    tasks = _pass1(codes, lens)
    opt = TOpt()
    n = codes.shape[0]
    p1 = one_pos_machine(tf, codes, lens, *tasks, True, 19, L, 24)
    want = one_pos_machine_oh(jf, jc, jl, *(jnp.asarray(t.numpy())
                                            for t in tasks), True, 19, L,
                              JBuf.empty(n, L, jf.pos_dtype),
                              stack_depth=24)
    _eq_buf(p1, want, "pass 1")
    # pass 2 from made-up tasks: every read's midpoint at mi 2
    t2 = (torch.arange(n, dtype=I32), torch.full((n,), 50, dtype=I32),
          torch.full((n,), 2, dtype=I32), lens > 0)
    for msl in (19, 1):
        p2 = one_pos_machine(tf, codes, lens, *t2, False, msl, L, 24)
        want = one_pos_machine_oh(jf, jc, jl, *(jnp.asarray(t.numpy())
                                                for t in t2), False, msl, L,
                                  JBuf.empty(n, L, jf.pos_dtype),
                                  stack_depth=24)
        _eq_buf(p2, want, f"pass 2 msl {msl}")
    assert int(p2.cnt.sum()) > 0 and int(p2.k.max()) >= LIFT
    with pytest.raises(AssertionError, match="out of order"):
        tt = smem_cuda.twin_tables(tf)
        smem_cuda.one_pos_twin(*tt[:3], codes.numpy(), lens.numpy(),
                               *(t.numpy() for t in t2), False, 1, L, 24,
                               hi_steps=tt[3])
    tt = smem_cuda.twin_tables(tf)
    for max_intv, msl in ((opt.max_mem_intv, opt.min_seed_len + 1),
                          ((1 << 31) - 1, 2)):
        p3 = seed_strategy_machine(tf, codes, lens, max_intv, msl, L)
        want = seed_strategy_machine_oh(jf, jc, jl, max_intv, msl, L)
        _eq_buf(p3, want, "pass 3")
        twin = smem_cuda.seed_strategy_twin(
            *tt[:3], codes.numpy(), lens.numpy(), max_intv, msl, L,
            hi_steps=tt[3])
        _eq_buf(SmemBuf(*twin[:6]), p3, "pass 3 twin")
        np.testing.assert_array_equal(twin[6],
                                      seed_strategy_machine.last_steps)
    assert int(p3.cnt.sum()) > 0 and int(p3.l.max()) >= LIFT


def test_sa_lookup_past_2_31_equal_to_jax(small_index):
    """SA samples lifted by 2^33: the port's plain SA walk and the kernel's
    twin equal to the JAX package's sa_lookup on the same samples; a walk
    that ends on a sample gives the int32 walk's value + 2^33, one that
    ends on the sentinel row its offset."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu.ops.sal import sa_lookup as j_sal
    up = dataclasses.replace(
        small_index, sa_samples=np.asarray(small_index.sa_samples,
                                           np.int64) + (1 << 33))
    jf = JFmi.from_host(up, force_int64=True)
    tf = TFmi.from_host(up, "cpu", force_int64=True)
    t32 = TFmi.from_host(small_index, "cpu")
    pos = _positions(small_index.seq_len, seed=13, n=600)
    pos[:2] = small_index.sentinel_index, small_index.sentinel_index + 1
    valid = np.arange(600) % 9 != 4
    got = sa_lookup_plain(tf, torch.as_tensor(pos), torch.as_tensor(valid))
    want = np.asarray(j_sal(jf, jnp.asarray(pos), jnp.asarray(valid)))
    assert got.dtype == I64
    np.testing.assert_array_equal(got.numpy(), want)
    tt = smem_cuda.twin_tables(tf)
    twin, steps = smem_cuda.sa_walk_twin(*tt[:3], tf.sa_samples.numpy(),
                                         tf.sa_compx, pos, valid,
                                         hi_steps=tt[3])
    np.testing.assert_array_equal(twin, got.numpy())
    base = sa_lookup_plain(t32, torch.as_tensor(pos, dtype=I32),
                           torch.as_tensor(valid)).numpy().astype(np.int64)
    lifted_lanes = got.numpy() >= (1 << 33)
    assert lifted_lanes.sum() > 500
    np.testing.assert_array_equal(got.numpy()[lifted_lanes] - (1 << 33),
                                  base[lifted_lanes])
    np.testing.assert_array_equal(got.numpy()[~lifted_lanes],
                                  base[~lifted_lanes])
    assert steps.max() > 1


# ---- chaining past 2^31 ---------------------------------------------------

def _move(pos, move):
    """A position of the 20 kbp layout on the 3.1 Gbp genome `move`."""
    from test_torch_chain import L_PAC
    d0, d1 = MOVES[move]
    pos = np.asarray(pos, np.int64)
    return pos + np.where(pos < L_PAC, d0, d0 + 2 * d1)


def shifted_batch(move, seed=5):
    """test_torch_chain's synthetic batch (reverse-strand, alt, bridging
    and junction seeds, equal weights, overflow at small capacities) on
    the 3.1 Gbp genome `move` (MOVES): (m, n, s int64, cnt, lens, rbeg
    int64, seed_idx, total, offsets, is_alt, l_pac)."""
    from test_torch_chain import IS_ALT, L_PAC, OFFSETS, synthetic_batch
    m, n, s, cnt, lens, rbeg, seed_idx, total = synthetic_batch(seed)
    d0, d1 = MOVES[move]
    offsets = [0, *(OFFSETS + d0)] + ([L_PAC + d0] if d1 else [])
    is_alt = [False, *IS_ALT] + ([False] if d1 else [])
    return (m, n, s.astype(np.int64), cnt, lens, _move(rbeg, move),
            seed_idx, total, np.asarray(offsets, np.int64),
            np.asarray(is_alt, bool), L_PAC + d0 + d1)


def _smems64(m, n, s, cnt, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)
    z = np.zeros(m.shape, np.int64)
    return SmemBuf(t(m), t(n), t(z), t(z), t(s), t(cnt))


@pytest.mark.parametrize("caps", [(16, 8), (4, 2)], ids=["roomy", "tiny"])
@pytest.mark.parametrize("move", list(MOVES))
def test_chain_past_2_31_equal_to_jax(move, caps):
    """The batch on a 3.1 Gbp genome chained and filtered by the port's
    lockstep, the kernels' twins and the JAX package at int64: every
    field and dtype equal; the chains are the 20 kbp batch's at int32,
    moved (keys and seeds' rbeg) and one contig on (rid)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import smem as jsmem
    from test_torch_chain import FLT, GAP, L_PAC, MAX_OCC, W
    (m, n, s, cnt, lens, rbeg, seed_idx, total, offsets, is_alt,
     l_pac) = shifted_batch(move)
    coords = rbeg[np.arange(rbeg.shape[1])[None, :] < total[:, None]]
    assert coords.min() > 1 << 31 if move == "fw" else coords.max() > 1 << 32
    C, S = caps
    valid = np.arange(rbeg.shape[1])[None, :] < total[:, None]
    kw = dict(w=W, max_chain_gap=GAP, max_chains=C, max_seeds_per_chain=S)
    j = jnp.asarray
    jsm = jsmem.SmemBuf(j(m), j(n), j(np.zeros_like(s)), j(np.zeros_like(s)),
                        j(s), j(cnt))
    jb = jchain.DeviceBns(offsets=j(offsets), is_alt=j(is_alt), l_pac=l_pac)
    jch = jchain.chain_seeds_device(jb, jsm, j(rbeg), j(seed_idx), j(valid),
                                    **kw)
    tb = tchain.DeviceBns(offsets=torch.as_tensor(offsets),
                          is_alt=torch.as_tensor(is_alt), l_pac=l_pac)
    sm = _smems64(m, n, s, cnt)
    tch = tchain.chain_seeds_device(tb, sm, torch.as_tensor(rbeg),
                                    torch.as_tensor(seed_idx),
                                    torch.as_tensor(valid), **kw)
    twin, _, _ = chain_cuda.chain_seeds_twin(offsets, l_pac, m, n, rbeg,
                                             seed_idx, valid, **kw)
    for f in tchain.Chains._fields:
        got = getattr(tch, f).numpy()
        assert got.dtype == np.asarray(getattr(jch, f)).dtype, f
        np.testing.assert_array_equal(np.asarray(getattr(jch, f)), got, f)
        assert getattr(twin, f).dtype == got.dtype, f
        np.testing.assert_array_equal(getattr(twin, f), got, f)
    assert tch.key.dtype == tch.seed_rbeg.dtype == I64
    # the 20 kbp batch's chains at int32, moved, on the reads whose
    # coordinates lie in the genome (the move maps [0, 2 x 20 kbp) only)
    from test_torch_chain import IS_ALT, OFFSETS, synthetic_batch
    r32 = synthetic_batch(5)[5]
    ch32 = tchain.chain_seeds_device(
        tchain.DeviceBns(offsets=torch.as_tensor(OFFSETS),
                         is_alt=torch.as_tensor(IS_ALT), l_pac=L_PAC),
        SmemBuf(*(torch.as_tensor(a) for a in (m, n, np.zeros_like(m),
                                               np.zeros_like(m),
                                               s.astype(np.int32), cnt))),
        torch.as_tensor(r32), torch.as_tensor(seed_idx),
        torch.as_tensor(valid), **kw)
    inside = torch.as_tensor(~(valid & (r32 >= 2 * L_PAC)).any(1))
    assert int(inside.sum()) > 40
    tch, ch32 = (tchain.Chains(*(f[inside] for f in c)) for c in (tch, ch32))
    live = torch.arange(C)[None, :] < tch.n[:, None]
    assert torch.equal(tch.n, ch32.n)
    assert np.array_equal(tch.key[live].numpy(),
                          _move(ch32.key[live].numpy(), move))
    assert torch.equal(tch.rid[live], ch32.rid[live] + 1)
    seeded = tch.seed_len > 0
    assert np.array_equal(tch.seed_rbeg[seeded].numpy(),
                          _move(ch32.seed_rbeg[seeded].numpy(), move))
    assert (tch.seed_rbeg[seeded] >= l_pac).any()
    tch = tchain.chain_seeds_device(tb, sm, torch.as_tensor(rbeg),
                                    torch.as_tensor(seed_idx),
                                    torch.as_tensor(valid), **kw)
    for flt in FLT.values():
        want = (*jchain.chain_filter_device(jch, jb, **flt),
                jchain.frac_rep_device(jsm, j(lens), MAX_OCC))
        got = tchain.chain_filter_frac_rep(tch, tb, sm,
                                           torch.as_tensor(lens),
                                           max_occ=MAX_OCC, **flt)
        ftwin = chain_cuda.chain_filter_twin(
            is_alt, tchain.Chains(*(a.numpy() for a in tch)), m, n, s, cnt,
            lens, max_occ=MAX_OCC, **flt)
        for name, a, b, c in zip(("order", "kept", "w_by_slot", "frac_rep"),
                                 want, got, ftwin):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
            np.testing.assert_array_equal(c, b.numpy(), name)


# ---- the twins at int64 ---------------------------------------------------

def test_seeding_twins_int64_equal_to_plain(small_index):
    """On the forced layout (a real FM index): passes 1, 2 and 3 of the
    twins equal to the plain machines (k, l and s int64), each task's
    steps equal to the lockstep's, and steps and rounds equal to the
    int32 twins' (the same walk)."""
    t64 = TFmi.from_host(small_index, "cpu", force_int64=True)
    t32 = TFmi.from_host(small_index, "cpu")
    codes = torch.as_tensor(_reads(small_index.bns.seq, 24, seed=14))
    lens = torch.full((24,), L, dtype=I32)
    lens[3] = 60
    opt = TOpt()
    p1 = one_pos_machine(t64, codes, lens, *_pass1(codes, lens), True, 19,
                         L, None)
    t_read, t_x, t_mi, t_valid, _ = reseed_tasks(p1, 48, opt.split_len,
                                                 opt.split_width)
    assert int(t_valid.sum()) > 0
    runs = {"pass 1": (_pass1(codes, lens), True),
            "pass 2": ((t_read, t_x, t_mi, t_valid), False)}
    for what, (tasks, chain) in runs.items():
        out = {}
        for key, fmi in (("i64", t64), ("i32", t32)):
            tt = smem_cuda.twin_tables(fmi)
            twin = smem_cuda.one_pos_twin(
                *tt[:3], codes.numpy(), lens.numpy(),
                *(t.numpy() for t in tasks), chain, 19, 24, 24,
                hi_steps=tt[3])
            plain = one_pos_machine(fmi, codes, lens, *tasks, chain, 19, 24,
                                    24)
            _eq_buf(SmemBuf(*twin[:6]), plain, f"{what} {key}")
            np.testing.assert_array_equal(twin[6],
                                          one_pos_machine.last_steps)
            out[key] = twin
        assert out["i64"][2].dtype == np.int64
        for a, b in zip(out["i64"], out["i32"]):
            np.testing.assert_array_equal(a, b)
    for key, fmi in (("i64", t64), ("i32", t32)):
        tt = smem_cuda.twin_tables(fmi)
        args = (opt.max_mem_intv, opt.min_seed_len + 1, 24)
        twin = smem_cuda.seed_strategy_twin(*tt[:3], codes.numpy(),
                                            lens.numpy(), *args,
                                            hi_steps=tt[3])
        plain = seed_strategy_machine(fmi, codes, lens, *args)
        _eq_buf(SmemBuf(*twin[:6]), plain, f"pass 3 {key}")
        np.testing.assert_array_equal(twin[6],
                                      seed_strategy_machine.last_steps)


# ---- the whole slice ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(small_index, tmp_path_factory):
    """One JAX aligner (int32, one compile at [B, L]) and its SAM of 80
    reads with an EMF table; its program run once more with the JAX
    package's forced int64 layout; the index and table saved for the
    port."""
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
    from bwa_mem_scale_tpu_torch.index.perfect import (
        build_perfect_table as t_build_perfect)
    tmp = tmp_path_factory.mktemp("int64")
    codes = _reads(small_index.bns.seq, 80, seed=5)
    fq = _write_fastq(tmp / "r.fq", codes)
    emf = build_perfect_table(small_index, seed_len=L)
    prefix = str(tmp / "g")
    save_index(small_index, prefix)
    save_perfect_table(emf, prefix)
    jal = TpuAligner(small_index, MemOptions(),
                     JCfg(seed_engine="onehot", **CAPS), emf=emf)
    sam = io.StringIO()
    j_run(jal, [fq], sam, batch_reads=B)
    tidx = t_load(prefix)
    return dict(jal=jal, codes=codes, fq=fq, prefix=prefix, tidx=tidx,
                temf=t_build_perfect(tidx, seed_len=L), sam=sam.getvalue(),
                tmp=tmp)


def _forced(tidx, caps, emf=None):
    from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                        PipelineConfig)
    al = GpuAligner(tidx, "cpu", TOpt(),
                    PipelineConfig(seed_engine="onehot", **caps), emf=emf)
    al.fmi = TFmi.from_host(tidx, "cpu", force_int64=True)
    return al


def test_seed_chain_extend_int64_equal_to_jax(small_index, jax_side):
    """seed_chain_extend at the forced layout: every array of the dict
    equal to the JAX program's with its fmi forced, dtype by dtype (the
    seeding depths at "auto" the read length for both)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu_torch.pipeline.align import seed_chain_extend
    codes = jax_side["codes"][:B]
    lens = np.full(B, L, np.int32)
    lens[3] = 0
    jal = jax_side["jal"]
    jf = JFmi.from_host(small_index, force_int64=True)
    want = jal._jit_extend(jf, jal.dbns, jnp.asarray(codes),
                           jnp.asarray(lens), L=L)
    tal = _forced(jax_side["tidx"], CAPS)
    got = seed_chain_extend(tal.fmi, tal.dbns, torch.as_tensor(codes),
                            torch.as_tensor(lens), L, opt=tal.opt,
                            cfg=tal.cfg)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, (k, got[k].dtype, w.dtype)
        np.testing.assert_array_equal(w, got[k].numpy(), k)
    assert got["valid"].any() and got["rb"].dtype == I64


@pytest.mark.parametrize("caps", ["same", "tiny"])
def test_mem_sam_int64_equal_to_jax(jax_side, caps):
    """mem at the forced layout, the EMF table on: the SAM body byte-equal
    to the JAX package's int32 SAM; at tiny capacities through the
    overflow retry ladder (tiers at the forced layout too)."""
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    tal = _forced(jax_side["tidx"], CAPS if caps == "same" else TINY,
                  jax_side["temf"])
    sam = io.StringIO()
    n = run_alignment(tal, [jax_side["fq"]], sam, batch_reads=B)
    assert n == len(jax_side["codes"]) and tal.fmi.pos_dtype == I64
    assert sam.getvalue() == jax_side["sam"]
    assert tal.emf_hits > 0
    assert (tal.overflow_retried > 0) == (caps == "tiny")


def test_mem_cli_on_an_index_past_2_31(jax_side, tmp_path):
    """The CLI on the saved index with only its seq_len set to 2^31: no
    refusal, the int64 layout and the wide retry tiers, and the JAX
    package's int32 SAM body."""
    from bwa_mem_scale_tpu_torch import cli
    z = np.load(jax_side["prefix"] + ".tpuidx.npz")
    arrs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrs["meta"]).decode())
    meta["seq_len"] = 1 << 31
    arrs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    prefix = str(tmp_path / "big")
    np.savez(prefix + ".tpuidx.npz", **arrs)
    os.symlink(jax_side["prefix"] + f".emf{L}.npz", prefix + f".emf{L}.npz")
    out = tmp_path / "out.sam"
    al = cli.mem([prefix, jax_side["fq"], "-o", str(out), "--device", "cpu",
                  "--batch-reads", str(B)])
    assert al.fmi.pos_dtype == I64 and al.RETRY_BATCH == 512
    with open(out) as f:
        body = "".join(ln for ln in f if not ln.startswith("@"))
    assert body == jax_side["sam"]


def _pairs(bns, n_pairs, seed):
    """FR pairs (insert 300 +- 30, read 2 reverse-complemented, 1%
    substitutions), a random mate in 7."""
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0], np.uint8)
    codes = np.zeros((2 * n_pairs, L), np.int32)
    for p in range(n_pairs):
        frag = int(np.clip(rng.normal(300, 30), L + 10, 600))
        pos = rng.randint(0, bns.l_pac - frag)
        r1 = bns.seq[pos: pos + L].copy()
        r2 = comp[bns.seq[pos + frag - L: pos + frag][::-1]].copy()
        for r in (r1, r2):
            e = rng.rand(L) < 0.01
            r[e] = (r[e] + rng.randint(1, 4, e.sum())) % 4
        if p % 7 == 5:
            r2 = rng.randint(0, 4, L).astype(np.uint8)
        codes[2 * p], codes[2 * p + 1] = r1, r2
    return codes


def test_pe_int64_equal_to_int32(small_index, tmp_path):
    """Paired-end at the forced layout: the SAM body byte-equal to the
    port's int32 PE run (two batches of 16 pairs, at the tiny capacities
    too, through the retry ladder)."""
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                        PipelineConfig)
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    codes = _pairs(small_index.bns, 32, seed=6)
    fqs = []
    for mate in (0, 1):
        path = tmp_path / f"r{mate + 1}.fq"
        with open(path, "w") as f:
            for i in range(mate, len(codes), 2):
                f.write(f"@p{i // 2}\n{decode_bases(codes[i])}\n+\n"
                        f"{'I' * L}\n")
        fqs.append(str(path))
    for caps in (CAPS, TINY):
        sams = []
        for force in (False, True):
            al = GpuAligner(small_index, "cpu", TOpt(),
                            PipelineConfig(seed_engine="onehot", **caps))
            if force:
                al.fmi = TFmi.from_host(small_index, "cpu", force_int64=True)
            sam = io.StringIO()
            run_alignment(al, fqs, sam, batch_reads=B, paired=True)
            sams.append(sam.getvalue())
        assert sams[0] == sams[1] and sams[0].count("\n") >= 64


# ---- on the card ------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card():
    """A 1 Mbp genome indexed by the port (no JAX on the card), its int32
    and forced int64 layouts on the card and 512 reads of 101 bp (1%
    errors); the same for chip_smoke.py's repeat batch (tools/batches.py:
    reads with reseed hits and deep interval stacks) under "rep_"."""
    dev = _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    out = dict(dev=dev)
    for pre, (idx, codes, lens) in (
            ("", (build_index(bns), *simulate_reads(bns, 512, L, seed=8,
                                                    err_rate=0.01))),
            ("rep_", repeat_batch(512, L))):
        out.update({pre + "idx": idx, pre + "f32": TFmi.from_host(idx, dev),
                    pre + "f64": TFmi.from_host(idx, dev, force_int64=True),
                    pre + "codes": torch.as_tensor(codes, device=dev),
                    pre + "lens": torch.as_tensor(lens, device=dev)})
    return out


def _with_steps(fmi):
    """fmi with a step table whose every base steps once past the last
    row: the int64 forms' decode loop runs (a load a step), the counts
    stay true."""
    steps = torch.full_like(fmi.cp_hi_steps, tocc.NO_STEP)
    steps[:, 0] = fmi.cp_fused.shape[0] + 5
    return dataclasses.replace(fmi, cp_hi_steps=steps, hi_counts=[1] * 4)


def _one_pos_case(card, case):
    """(batch prefix, tasks, chain, stack depth) of a case: pass 1 at
    depths 24 and L and with its stacks in a device scratch (depth
    8,000), pass 1 and pass 2 (its reseed tasks) on the repeat batch."""
    pre = "rep_" if case.startswith("repeat") else ""
    codes, lens = card[pre + "codes"], card[pre + "lens"]
    dev = card["dev"]
    n = codes.shape[0]
    zi = torch.zeros((n,), dtype=I32, device=dev)
    p1 = (torch.arange(n, dtype=I32, device=dev), zi, zi + 1, lens > 0)
    if case == "repeat-pass2":
        opt = TOpt()
        first = one_pos_machine(card["rep_f32"], codes, lens, *p1, True, 19,
                                24, 24)
        t2 = reseed_tasks(first, 2 * n, opt.split_len, opt.split_width)[:4]
        return pre, t2, False, 24
    sd = {"pass1-dL": None, "pass1-scratch": 8000}.get(case, 24)
    return pre, p1, True, sd


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pass1-d24", "pass1-dL", "pass1-scratch",
                                  "steps", "repeat-pass1", "repeat-pass2"])
def test_one_pos_int64_kernel_equal_to_plain(card, case):
    """The passes 1-2 kernel's int64 form against the plain machine at the
    forced layout, every field (k, l, s int64) and cnt; its steps equal
    the lockstep's, its steps and rounds equal to the int32 form's (the
    same walk) and, on the first 48 tasks, to the twin's; "steps" runs
    with a non-empty step table. One launch, counted as int64."""
    pre, tasks, chain, sd = _one_pos_case(
        card, "pass1-d24" if case == "steps" else case)
    f64 = card[pre + "f64"]
    f64 = _with_steps(f64) if case == "steps" else f64
    codes, lens = card[pre + "codes"], card[pre + "lens"]
    M = 24 if sd == 24 else L
    before = (smem_cuda.one_pos_machine_cuda.launches,
              smem_cuda.one_pos_machine_cuda.launches64)
    got = smem_cuda.one_pos_machine_cuda(f64, codes, lens, *tasks, chain, 19,
                                         M, sd)
    torch.cuda.synchronize()
    assert (smem_cuda.one_pos_machine_cuda.launches,
            smem_cuda.one_pos_machine_cuda.launches64) == (before[0] + 1,
                                                           before[1] + 1)
    steps = smem_cuda.one_pos_machine_cuda.last_steps.cpu().numpy()
    rounds = smem_cuda.one_pos_machine_cuda.last_rounds.cpu().numpy()
    want = one_pos_machine(f64, codes, lens, *tasks, chain, 19, M, sd)
    assert got.k.dtype == I64
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(steps,
                                  one_pos_machine.last_steps.cpu().numpy())
    g32 = smem_cuda.one_pos_machine_cuda(card[pre + "f32"], codes, lens,
                                         *tasks, chain, 19, M, sd)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        steps, smem_cuda.one_pos_machine_cuda.last_steps.cpu().numpy())
    np.testing.assert_array_equal(
        rounds, smem_cuda.one_pos_machine_cuda.last_rounds.cpu().numpy())
    assert torch.equal(g32.k.long(), got.k) and int(got.cnt.max()) > 0
    tt = smem_cuda.twin_tables(f64)
    cpu = [t[:48].cpu().numpy() for t in tasks]
    twin = smem_cuda.one_pos_twin(*tt[:3], codes.cpu().numpy(),
                                  lens.cpu().numpy(), *cpu, chain, 19, M, sd,
                                  hi_steps=tt[3])
    np.testing.assert_array_equal(twin[6], steps[:48])
    np.testing.assert_array_equal(twin[7], rounds[:48])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["batch-d24", "batch-dL", "steps",
                                  "lifted"])
def test_seed_strategy_int64_kernel_equal_to_plain(card, case):
    """Pass 3's int64 form against the plain machine: on the 512-read batch
    at depths 24 and L, with a non-empty step table, and on the lifted
    table (every count + 2^32, intervals past 2^32, rows read at clamped
    indices); every field equal, steps equal to the lockstep's and the
    twin's (first 64 reads)."""
    dev = card["dev"]
    codes, lens = card["codes"], card["lens"]
    fmi = card["f64"]
    args = (20, 20, 24 if case == "batch-d24" else L)
    if case == "steps":
        fmi = _with_steps(fmi)
    elif case == "lifted":
        fmi = TFmi.from_host(_lift(card["idx"], "plus-2^32"), dev,
                             force_int64=True)
        args = ((1 << 31) - 1, 2, L)
    got = smem_cuda.seed_strategy_machine_cuda(fmi, codes, lens, *args)
    torch.cuda.synchronize()
    want = seed_strategy_machine(fmi, codes, lens, *args)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    steps = smem_cuda.seed_strategy_machine_cuda.last_steps.cpu().numpy()
    np.testing.assert_array_equal(
        steps, seed_strategy_machine.last_steps.cpu().numpy())
    tt = smem_cuda.twin_tables(fmi)
    twin = smem_cuda.seed_strategy_twin(*tt[:3], codes[:64].cpu().numpy(),
                                        lens[:64].cpu().numpy(), *args,
                                        hi_steps=tt[3])
    np.testing.assert_array_equal(twin[6], steps[:64])
    assert int(got.cnt.sum()) > 0
    if case == "lifted":
        assert int(got.l.max()) >= LIFT


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["forced", "steps", "lifted-samples"])
def test_sa_walk_int64_kernel_equal_to_plain(card, case):
    """The SA walk's int64 form against the plain walk over 16,384 lanes:
    at the forced layout, with a non-empty step table, and on samples
    lifted by 2^33 (values past 2^33, the int32 walk's + 2^33 where the
    walk ends on a sample); steps equal to the twin's (first 2,000
    lanes)."""
    from bwa_mem_scale_tpu_torch.ops.sal import sa_lookup
    dev = card["dev"]
    fmi, idx = card["f64"], card["idx"]
    if case == "steps":
        fmi = _with_steps(fmi)
    elif case == "lifted-samples":
        fmi = dataclasses.replace(fmi, sa_samples=fmi.sa_samples + (1 << 33))
    rng = np.random.RandomState(15)
    pos = torch.as_tensor(rng.randint(0, idx.seq_len, 16384), device=dev)
    valid = torch.as_tensor(rng.rand(16384) < 0.9, device=dev)
    before = smem_cuda.sa_walk_cuda.launches64
    got = sa_lookup(fmi, pos, valid)
    torch.cuda.synchronize()
    assert smem_cuda.sa_walk_cuda.launches64 == before + 1
    want = sa_lookup_plain(fmi, pos, valid)
    assert got.dtype == I64 and torch.equal(got, want)
    base = sa_lookup(card["f32"], pos.int(), valid).long()
    if case == "lifted-samples":
        up = got >= (1 << 33)
        assert int(up.sum()) > 14000
        assert torch.equal(got[up] - (1 << 33), base[up])
        assert torch.equal(got[~up], base[~up])
    else:
        assert torch.equal(got, base)
    tt = smem_cuda.twin_tables(fmi)
    _, tsteps = smem_cuda.sa_walk_twin(
        *tt[:3], fmi.sa_samples.cpu().numpy(), fmi.sa_compx,
        pos[:2000].cpu().numpy(), valid[:2000].cpu().numpy(),
        hi_steps=tt[3])
    np.testing.assert_array_equal(
        smem_cuda.sa_walk_cuda.last_steps[:2000].cpu().numpy(), tsteps)


@pytest.mark.cuda
@pytest.mark.parametrize("flt", ["default", "float64"])
@pytest.mark.parametrize("caps", [(16, 8), (4, 2)], ids=["roomy", "tiny"])
@pytest.mark.parametrize("move", list(MOVES))
def test_chain_int64_kernels_past_2_31(move, caps, flt):
    """The batch on the 3.1 Gbp genomes (rbeg past 2^31, or reverse ones
    past 2^32; seeds over contigs and over the strands' junction) on the
    card: both int64 kernel forms equal to their plain versions and twins,
    steps and rounds included."""
    from test_torch_chain import FLT, _kernels_vs_plain
    dev = _cuda()
    (m, n, s, cnt, lens, rbeg, seed_idx, total, offsets, is_alt,
     l_pac) = shifted_batch(move)
    t = lambda a: torch.as_tensor(a, device=dev)
    before = (chain_cuda.chain_seeds_cuda.launches64,
              chain_cuda.chain_filter_cuda.launches64)
    ch = _kernels_vs_plain(dev, (offsets, is_alt, l_pac),
                           _smems64(m, n, s, cnt, dev), t(rbeg), t(seed_idx),
                           t(total), t(lens), *caps, FLT[flt])
    assert ch.key.dtype == ch.seed_rbeg.dtype == I64
    assert (chain_cuda.chain_seeds_cuda.launches64,
            chain_cuda.chain_filter_cuda.launches64) == (before[0] + 1,
                                                         before[1] + 1)


@pytest.mark.cuda
def test_chain_int64_kernels_large_shared_memory():
    """test_torch_chain's wide read (1,071 chains) at C = 1,800 moved past
    2^32: chain_seeds' int64 state (9 words a chain, 64.8 KB) and the
    filter's past 48 KB; equal to the plain versions and twins."""
    from test_torch_chain import FLT, WIDE, _kernels_vs_plain, wide_read
    dev = _cuda()
    C = 1800
    assert 4 * 9 * C > 49152
    assert chain_cuda.LIB.call("chain_max_chains", 2) >= C
    m, n, s, cnt, lens, rbeg, seed_idx, total = wide_read()
    t = lambda a: torch.as_tensor(a, device=dev)
    up = 1 << 32
    ch = _kernels_vs_plain(
        dev, (np.concatenate([[0], WIDE["offsets"] + up]).astype(np.int64),
              np.concatenate([[False], WIDE["is_alt"]]),
              WIDE["l_pac"] + up),
        _smems64(m, n, s.astype(np.int64), cnt, dev),
        t(rbeg.astype(np.int64) + up), t(seed_idx), t(total), t(lens), C,
        WIDE["S"], FLT["default"])
    assert int(ch.n[0]) == 1071


@pytest.mark.cuda
def test_chain_int64_kernels_repeat_batch():
    """chip_smoke.py's repeat batch seeded on the card at the forced
    layout (depth L, the int64 "auto") and chained at the main path's
    shapes: both int64 forms equal to their plain versions and twins."""
    from bwa_mem_scale_tpu_torch.ops.sal import expand_and_lookup
    from bwa_mem_scale_tpu_torch.ops.smem_oh import collect_smems_oh
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    from test_torch_chain import FLT, _kernels_vs_plain
    dev = _cuda()
    idx, codes, lens = repeat_batch(512, L)
    fmi = TFmi.from_host(idx, dev, force_int64=True)
    c, ln = (torch.as_tensor(a, device=dev) for a in (codes, lens))
    opt = TOpt()
    smems = collect_smems_oh(
        fmi, c, ln, min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv)
    rbeg, seed_idx, _, total, _ = expand_and_lookup(fmi, smems, opt.max_occ,
                                                    512)
    assert rbeg.dtype == smems.s.dtype == I64
    bns = idx.bns
    ch = _kernels_vs_plain(dev, (np.asarray(bns.offsets, np.int64),
                                 np.asarray(bns.is_alt, bool),
                                 int(bns.l_pac)), smems, rbeg, seed_idx,
                           total, ln, 64, 32, FLT["default"])
    assert int(ch.n.max()) >= 25 and bool(ch.overflow.any())


@pytest.mark.cuda
def test_seed_chain_extend_int64_on_card_equal_to_int32(card):
    """seed_chain_extend on the card at the forced layout against the int32
    layout on the 512-read batch at the CLI's capacities: packed and meta
    equal; every int64 form launched, none of the int32 forms; each call
    launches the extension's select, pairs and stage kernels once and its
    fused BSW round four times (each counted as BSW's too)."""
    from bwa_mem_scale_tpu_torch.ops import extend_cuda
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                        seed_chain_extend)
    al = GpuAligner(card["idx"], card["dev"], TOpt())
    from bwa_mem_scale_tpu_torch.ops.sal_cuda import expand_and_lookup_cuda
    wrappers = (smem_cuda.one_pos_machine_cuda,
                smem_cuda.seed_strategy_machine_cuda, expand_and_lookup_cuda,
                chain_cuda.chain_seeds_cuda, chain_cuda.chain_filter_cuda,
                extend_cuda.ext_select_cuda, extend_cuda.ext_stage_cuda,
                extend_cuda.ext_bsw_band_cuda)
    ext = (extend_cuda.ext_select_cuda, extend_cuda.ext_pairs_cuda,
           extend_cuda.ext_stage_cuda, extend_cuda.ext_bsw_band_cuda,
           banded_swa_batch_cuda)
    outs = []
    for fmi in (card["f32"], card["f64"]):
        before = [(w.launches, w.launches64) for w in wrappers]
        ext_before = [w.launches for w in ext]
        outs.append(seed_chain_extend(fmi, al.dbns, card["codes"],
                                      card["lens"], L, opt=al.opt,
                                      cfg=al.cfg))
        torch.cuda.synchronize()
        grew = [(w.launches - a, w.launches64 - b)
                for w, (a, b) in zip(wrappers, before)]
        wide = fmi.pos_dtype == I64
        assert all(n > 0 and n64 == (n if wide else 0) for n, n64 in grew)
        assert [w.launches - n for w, n in zip(ext, ext_before)] == [
            1, 1, 1, 4, 4]
    for key in ("packed", "meta"):
        assert torch.equal(outs[0][key], outs[1][key]), key
