"""Port vs JAX: ERT seeding (``bwa_mem_scale_tpu_torch.index.ert`` /
``ops.ert`` against ``bwa_mem_scale_tpu.index.ert`` / ``ops.ert``), exact,
integers throughout, on a 20 kbp genome indexed with the full SA
(sa_compx 0), one 100 bp window of it copied elsewhere, at K = 6 and trie
depths 80 and 30.

- The trie: the port's ``build_ert`` arrays equal the JAX package's; a
  ``.ert6.npz`` written by either package loads in the other, equal;
  ``DeviceErt.rec`` equals the JAX ``child_rec`` after re-layout.
- The seeding: the plain ``ert_extend_all_positions`` equals the JAX one
  in every output (pass 1 merged with pass 3, the reseed's per-row
  minimum intervals, pass 3 unchecked) at (min_seed_len, max_mem_intv)
  in [(10, 20), (3, 4)], at the int32 and the forced int64 position
  dtypes; ``collect_smems_ert`` equals the JAX one in every field. The
  reads hold N bases, a 5 bp read, an empty read, random reads that
  saturate the 2B reseed budget, the copied window (its node walk stops at
  the depth cap), a read across the fw/rc boundary and one past the
  reverse strand's end (the leaf walk's bound).
- The kernel's CPU twin (``ert_cuda.ert_extend_twin``) equals the plain
  version, node and leaf steps included, and on exact reads whose leaf
  walks cross 16-byte words, meet N bases mid-word, reach seq_len and
  take pass 3's record inside a word, at minimum intervals 0 to 3.
- The merged stage's twin (``sweep_cuda.seed_strategy_merged_twin``) on
  the ERT's records equals the plain ``smems_seed_strategy_merged``.
On a GPU (``-m cuda``) the kernel against its plain version and its twin,
at both position dtypes. The JAX side is imported inside the tests that
use it, so the CUDA cases also run on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_ert.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.index import ert as tert
from bwa_mem_scale_tpu_torch.ops import ert as tops, ert_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

K = 6                          # the tests' k-mer table length
DEPTHS = [80, 30]              # trie depth caps
L = 100
PARAMS = [(10, 20), (3, 4)]    # (min_seed_len, max_mem_intv)
REPEAT = (1000, 5000)          # a 100 bp window and where it is copied
ARRAYS = ("kmer_lo", "kmer_cnt", "kmer_ptr", "node_lo", "node_cnt",
          "child_ptr", "root_children")


def _genome():
    """20 kbp, one contig, the window at REPEAT[0] copied to REPEAT[1]."""
    from bwa_mem_scale_tpu_torch.models.aligner import demo_genome
    bns = demo_genome(20000, seed=42, n_contigs=1)
    a, b = REPEAT
    bns.seq[b:b + 100] = bns.seq[a:a + 100]
    return bns


def _reads(text, l_pac):
    """30 reads in a [30, 100] batch: 20 of 60-100 bp at 3% errors, one
    with two N bases, one of 5 bp, one empty, four random, the copied
    window, a read across the fw/rc boundary and the reverse strand's last
    40 bases followed by A (code 0) bases."""
    rng = np.random.RandomState(3)
    rows = []
    for i in range(20):
        n = L - 10 * (i % 5)
        p = rng.randint(0, l_pac - n)
        r = text[p:p + n].astype(np.int32).copy()
        m = rng.rand(n) < 0.03
        r[m] = (r[m] + rng.randint(1, 4, m.sum())) % 4
        rows.append(r)
    rows[3][[10, 40]] = 4
    rows += [rows[1][:5].copy(), rows[2][:0].copy()]
    rows += [rng.randint(0, 4, L).astype(np.int32) for _ in range(4)]
    rows.append(text[REPEAT[0]:REPEAT[0] + L].astype(np.int32))
    rows.append(text[l_pac - 50:l_pac + 50].astype(np.int32))
    rows.append(np.concatenate([text[2 * l_pac - 40:],
                                np.zeros(60, np.uint8)]).astype(np.int32))
    codes = np.full((len(rows), L), 4, np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    return codes, np.array([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def side():
    """The full-SA index, both packages' tries at both depths, their
    device forms, both packages' indexes at both position dtypes, and the
    reads."""
    from bwa_mem_scale_tpu.index import ert as jert
    from bwa_mem_scale_tpu.ops import ert as jops
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu_torch.index.build import build_index
    idx = build_index(_genome(), sa_compx=0)
    sa = idx.sa_samples
    out = dict(idx=idx, reads=_reads(idx.ref_string, idx.bns.l_pac),
               jfmi=JFmi.from_host(idx),
               tfmi={w: TFmi.from_host(idx, "cpu", force_int64=w)
                     for w in (False, True)})
    for d in DEPTHS:
        je = jert.build_ert(idx.ref_string, sa, K=K, max_depth=d)
        out["jert", d] = je
        out["tert", d] = tert.build_ert(idx.ref_string, sa, K=K, max_depth=d)
        out["jdev", d] = jops.DeviceErt.from_host(je, sa, idx.count)
        out["tdev", d] = tops.DeviceErt.from_host(out["tert", d], sa,
                                                  idx.count, "cpu")
    return out


@pytest.mark.parametrize("depth", DEPTHS)
def test_build_ert_equal_to_jax(side, depth):
    """build_ert gives the JAX package's arrays, dtypes included; the
    depth cap leaves nodes with four empty children."""
    j, t = side["jert", depth], side["tert", depth]
    assert (t.K, t.max_depth, t.n_nodes) == (j.K, j.max_depth, j.n_nodes)
    for f in ARRAYS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, f)
    assert ((t.child_ptr == -1).all(1) & (t.node_cnt >= 2)).any()


def test_ert_files_load_across_packages(side, tmp_path):
    """A .ert6.npz saved by either package loads in the other, equal;
    build_ert_from_index on a sampled index recomputes the SA."""
    from bwa_mem_scale_tpu.index import ert as jert
    from bwa_mem_scale_tpu_torch.index.build import build_index
    j, t = side["jert", DEPTHS[0]], side["tert", DEPTHS[0]]
    jpath = jert.save_ert(j, str(tmp_path / "j"))
    tpath = tert.save_ert(t, str(tmp_path / "t"))
    assert jpath.endswith(f"j.ert{K}.npz") and tpath.endswith(f"t.ert{K}.npz")
    for got, want in ((tert.load_ert(jpath), j), (jert.load_ert(tpath), t)):
        assert (got.K, got.max_depth) == (K, DEPTHS[0])
        for f in ARRAYS:
            a = np.asarray(getattr(got, f))
            assert a.dtype == getattr(want, f).dtype, f
            np.testing.assert_array_equal(a, getattr(want, f), f)
    sampled = build_index(_genome(), sa_compx=3)
    again = tert.build_ert_from_index(sampled, K=K, max_depth=DEPTHS[0])
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(again, f), getattr(t, f), f)


@pytest.mark.parametrize("depth", DEPTHS)
def test_device_ert_equal_to_jax_child_rec(side, depth):
    """DeviceErt.rec [N + 1, 4, 2] is the JAX child_rec [N + 1, 8] with
    the encodings and payloads paired; the same root, C array and cap."""
    j, t = side["jdev", depth], side["tdev", depth]
    rec = np.asarray(j.child_rec)
    assert t.rec.dtype == torch.int64 and t.rec.shape == (rec.shape[0], 4, 2)
    np.testing.assert_array_equal(t.rec[:, :, 0].numpy(), rec[:, :4])
    np.testing.assert_array_equal(t.rec[:, :, 1].numpy(), rec[:, 4:])
    assert (t.root, t.max_depth) == (j.root, j.max_depth)
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    # the same from the SA already on the device (GpuAligner's call)
    again = tops.DeviceErt.from_host(side["tert", depth],
                                     side["tfmi"][False].sa_samples,
                                     side["idx"].count, "cpu")
    assert torch.equal(again.rec, t.rec)


def _word_reads(text, l_pac, codes, lens):
    """The batch with 8 exact 100 bp windows of the genome appended (their
    lanes reach a single occurrence and walk it across 16-byte words):
    two with N bases at columns 37 and 70 (mid-word), one whose window
    starts 60 bases before the reverse strand's end (its leaf walks reach
    seq_len)."""
    rng = np.random.RandomState(23)
    rows = [text[p:p + L].astype(np.int32)
            for p in rng.randint(0, l_pac - L, 7)]
    rows[1][[37, 70]] = 4
    rows[2][[37]] = 4
    rows.append(np.concatenate([text[2 * l_pac - 60:],
                                text[:40]]).astype(np.int32))
    return (np.concatenate([codes, np.stack(rows)]),
            np.concatenate([lens, np.full(len(rows), L, np.int32)]))


def _ext_args(case, params, n_reads):
    """(min_intv [B], keyword arguments) of a descent case: pass 1 merged
    with pass 3, the reseed's per-row minimum intervals (s + 1 of a
    task), pass 3's records with no initial check, or (words) pass 1
    merged with rows' minimum intervals of 0 to 3 (a leaf walk that goes
    on past a mismatch, stops at one, or ends at its first step)."""
    msl, mmi = params
    if case == "words":
        return (np.arange(n_reads) % 4).astype(np.int32), dict(
            check_initial=True, p3_max_intv=mmi, p3_stop=msl + 1)
    if case == "merged":
        return np.ones(n_reads, np.int32), dict(
            check_initial=True, p3_max_intv=mmi, p3_stop=msl + 1)
    if case == "reseed":
        rng = np.random.RandomState(msl)
        return rng.randint(1, 5, n_reads).astype(np.int32), dict(
            check_initial=True)
    return np.full(n_reads, 2, np.int32), dict(
        check_initial=False, p3_max_intv=mmi, p3_stop=msl + 1)


def _assert_dicts(j, t):
    assert list(j) == list(t), (list(j), list(t))
    for k in j:
        w = np.asarray(j[k])
        assert t[k].numpy().dtype == w.dtype, (k, t[k].dtype, w.dtype)
        np.testing.assert_array_equal(w, t[k].numpy(), k)


EXT_CASES = [(c, p) for c in ("merged", "reseed", "unchecked")
             for p in PARAMS]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case,params", EXT_CASES,
                         ids=[f"{c}-{p[0]}-{p[1]}" for c, p in EXT_CASES])
def test_ert_extend_equal_to_jax(side, depth, wide, case, params):
    """The plain descent gives the JAX package's dict, key order and
    dtypes included; on the copied window the node steps reach the depth
    cap wherever the minimum interval lets a 2-hit walk go on."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import ert as jops
    codes, lens = side["reads"]
    mi, kw = _ext_args(case, params, len(lens))
    tf = side["tfmi"][wide]
    want = jops.ert_extend_all_positions(
        side["jdev", depth], side["jfmi"].ref, jnp.asarray(codes),
        jnp.asarray(lens), jnp.asarray(mi),
        pos_dtype=jnp.int64 if wide else jnp.int32,
        seq_len=2 * side["jfmi"].l_pac, **kw)
    stats = {}
    got = tops.ert_extend_all_positions(
        side["tdev", depth], tf.ref, torch.as_tensor(codes),
        torch.as_tensor(lens), torch.as_tensor(mi), pos_dtype=tf.pos_dtype,
        seq_len=2 * tf.l_pac, stats=stats, stats_key="ert_ticks_p1", **kw)
    _assert_dicts(want, got)
    steps = tops.ert_extend_all_positions.last_steps
    assert steps.shape == (2, len(lens), L) and stats["ert_ticks_p1"] > 0
    if mi[-3] <= 2:
        # the copied window (two occurrences): lane 0 walks on nodes to
        # the cap, where a node has four empty children
        assert int(steps[0, -3, 0]) == depth


COLLECT_CASES = [(d, p) for d in DEPTHS for p in PARAMS]


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("depth,params", COLLECT_CASES,
                         ids=[f"d{d}-{p[0]}-{p[1]}" for d, p in COLLECT_CASES])
def test_collect_smems_ert_equal_to_jax(side, wide, depth, params):
    """collect_smems_ert gives the JAX SmemBuf in every field and dtype
    (l zero), with saturated counts where the 2B reseed budget overflows
    (at min_seed_len 3)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import ert as jops
    codes, lens = side["reads"]
    msl, mmi = params
    kw = dict(min_seed_len=msl, split_len=int(msl * 1.5), split_width=10,
              max_mem_intv=mmi, max_out=L)
    tf = side["tfmi"][wide]
    want = jops.collect_smems_ert(
        side["jdev", depth], side["jfmi"].ref, jnp.asarray(codes),
        jnp.asarray(lens), pos_dtype=jnp.int64 if wide else jnp.int32,
        seq_len=2 * side["jfmi"].l_pac, **kw)
    stats = {}
    got = tops.collect_smems_ert(
        side["tdev", depth], tf.ref, torch.as_tensor(codes),
        torch.as_tensor(lens), pos_dtype=tf.pos_dtype, seq_len=2 * tf.l_pac,
        stats=stats, **kw)
    for f in got._fields:
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(w, getattr(got, f).numpy(), f)
    assert int(got.cnt.sum()) > 0 and not got.l.any()
    assert stats["ert_ticks_p1"] > 0 and stats["ert_ticks_p2"] >= 0
    if msl == 3:
        assert (got.cnt == got.m.shape[1]).any()
        assert "chase_ticks" in stats


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", ["merged", "reseed", "unchecked", "words"])
def test_ert_twin_equal_to_plain(side, depth, wide, case):
    """The kernel's loop in plain Python (the leaf walk 16 reference bytes
    a word) gives the lockstep's outputs and each lane's node and leaf
    steps; in the words case leaf walks start unaligned, cross words, meet
    an N mid-word, reach seq_len, die at mi > 1, go on past a mismatch at
    mi = 0 and take pass 3's record inside a word."""
    codes, lens = side["reads"]
    if case == "words":
        codes, lens = _word_reads(side["idx"].ref_string,
                                  side["idx"].bns.l_pac, codes, lens)
    mi, kw = _ext_args(case, PARAMS[0] if case == "words" else PARAMS[1],
                       len(lens))
    tf = side["tfmi"][wide]
    dev = side["tdev", depth]
    got = tops.ert_extend_all_positions(
        dev, tf.ref, torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(mi), pos_dtype=tf.pos_dtype, seq_len=2 * tf.l_pac,
        **kw)
    steps = tops.ert_extend_all_positions.last_steps.numpy()
    twin = ert_cuda.ert_extend_twin(dev.rec.numpy(), dev.root, tf.ref.numpy(),
                                    2 * tf.l_pac, codes, lens, mi,
                                    wide=wide, **kw)
    for k in got:
        assert twin[k].dtype == got[k].numpy().dtype, k
        np.testing.assert_array_equal(twin[k], got[k].numpy(), k)
    np.testing.assert_array_equal(twin["node_steps"], steps[0])
    np.testing.assert_array_equal(twin["leaf_steps"], steps[1])
    assert steps[1].sum() > 0 or case == "unchecked"
    if case == "words":                  # the plain version is JAX's too
        import jax.numpy as jnp
        from bwa_mem_scale_tpu.ops import ert as jops
        _assert_dicts(jops.ert_extend_all_positions(
            side["jdev", depth], side["jfmi"].ref, jnp.asarray(codes),
            jnp.asarray(lens), jnp.asarray(mi),
            pos_dtype=jnp.int64 if wide else jnp.int32,
            seq_len=2 * side["jfmi"].l_pac, **kw), got)
        leaf = twin["leaf_steps"]
        assert twin["leaf_words"].max() >= 5 and (leaf > 16).any()
        # a record inside a run of matches, and a walk on past a mismatch
        on_leaf = (leaf > 0) & twin["f3_s"]
        assert (twin["f3_ss"][on_leaf] == 1).any()
        past = (mi[:, None] == 0) & (leaf > 0) & (twin["s"] == 0)
        assert past.any()


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_merged_twin_equal_to_plain_on_ert_records(side, depth, wide):
    """csrc/sweep.cu's merged-stage twin on the ERT's pass-1 records (l
    zero, the C array from the trie) equal to the plain
    smems_seed_strategy_merged as collect_smems_ert calls it, every field
    and each read's steps, at the width L and at a width (4) some reads
    pass."""
    from bwa_mem_scale_tpu_torch.ops import smem as tsmem, sweep_cuda
    codes, lens = side["reads"]
    msl, mmi = PARAMS[1]
    tf = side["tfmi"][wide]
    dev = side["tdev", depth]
    mi, kw = _ext_args("merged", PARAMS[1], len(lens))
    ext = tops.ert_extend_all_positions(
        dev, tf.ref, torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(mi), pos_dtype=tf.pos_dtype, seq_len=2 * tf.l_pac,
        **kw)
    fmi = tops._ErtAsFmi(dev, tf.pos_dtype)
    for M in (L, 4):
        want = tsmem.smems_seed_strategy_merged(
            fmi, torch.as_tensor(codes), torch.as_tensor(lens), ext, mmi,
            msl + 1, M)
        twin = sweep_cuda.seed_strategy_merged_twin(
            fmi.count.numpy(), codes, lens,
            {k: v.numpy() for k, v in ext.items()}, msl + 1, M)
        for f, a, b in zip(want._fields, want, twin):
            assert a.numpy().dtype == b.dtype, f
            np.testing.assert_array_equal(a.numpy(), b, f)
        np.testing.assert_array_equal(
            tsmem.strategy_chase.last_steps.numpy(), twin[6])
    assert (want.cnt > 4).any() and not want.l.any()


def test_wrapper_on_cpu_runs_plain(side):
    """On CPU tensors the wrapper is the plain version: no launch, the
    same dict."""
    codes, lens = side["reads"]
    mi, kw = _ext_args("merged", PARAMS[0], len(lens))
    tf, dev = side["tfmi"][False], side["tdev", DEPTHS[0]]
    args = (dev, tf.ref, torch.as_tensor(codes), torch.as_tensor(lens),
            torch.as_tensor(mi))
    before = ert_cuda.ert_extend_all_positions_cuda.launches
    got = ert_cuda.ert_extend_all_positions_cuda(
        *args, pos_dtype=torch.int32, seq_len=2 * tf.l_pac, **kw)
    assert ert_cuda.ert_extend_all_positions_cuda.launches == before
    want = tops.ert_extend_all_positions(*args, pos_dtype=torch.int32,
                                         seq_len=2 * tf.l_pac, **kw)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_seed_chain_extend_with_ert_equal_to_sweep(side):
    """seed_chain_extend with the ERT gives the sweep's packed and meta on
    a batch the depth cap does not reach (the copied window left out)."""
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops.chain import DeviceBns
    from bwa_mem_scale_tpu_torch.pipeline.align import (PipelineConfig,
                                                        seed_chain_extend)
    codes, lens = side["reads"]
    keep = np.arange(len(lens)) != len(lens) - 3
    c, ln = torch.as_tensor(codes[keep]), torch.as_tensor(lens[keep])
    tf = side["tfmi"][False]
    dbns = DeviceBns.from_host(side["idx"].bns, "cpu")
    opt, cfg = MemOptions(min_seed_len=10), PipelineConfig()
    stats = {}
    got = seed_chain_extend(tf, dbns, c, ln, L, opt=opt, cfg=cfg,
                            ert=side["tdev", DEPTHS[0]], stats=stats)
    want = seed_chain_extend(tf, dbns, c, ln, L, opt=opt, cfg=cfg)
    assert "ert_ticks_p1" in stats
    for k in ("packed", "meta"):
        assert torch.equal(got[k], want[k]), k


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card():
    """The port's own trie (depths 80 and 30) of this file's genome on the
    card, its reads and its reference (no JAX on the card)."""
    dev = _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    idx = build_index(_genome(), sa_compx=0)
    codes, lens = _reads(idx.ref_string, idx.bns.l_pac)
    out = dict(codes=torch.as_tensor(codes, device=dev),
               lens=torch.as_tensor(lens, device=dev),
               ref=torch.as_tensor(idx.ref_string, device=dev),
               text=idx.ref_string,
               seq_len=2 * idx.bns.l_pac)
    for d in DEPTHS:
        e = tert.build_ert(idx.ref_string, idx.sa_samples, K=K, max_depth=d)
        out[d] = tops.DeviceErt.from_host(e, idx.sa_samples, idx.count, dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", ["merged", "reseed", "unchecked", "words"])
def test_ert_kernel_equal_to_plain(card, depth, wide, case):
    """ert_extend_kernel against the lockstep on the card and against the
    twin, every output and each lane's node and leaf steps."""
    codes, lens = card["codes"], card["lens"]
    if case == "words":
        c, ln = _word_reads(card["text"], card["seq_len"] // 2,
                            codes.cpu().numpy(), lens.cpu().numpy())
        codes = torch.as_tensor(c, device=codes.device)
        lens = torch.as_tensor(ln, device=codes.device)
    mi, kw = _ext_args(case, PARAMS[0] if case == "words" else PARAMS[1],
                       len(lens))
    mi = torch.as_tensor(mi, device=codes.device)
    pd = torch.int64 if wide else torch.int32
    fn = ert_cuda.ert_extend_all_positions_cuda
    before = (fn.launches, fn.launches64)
    got = fn(card[depth], card["ref"], codes, lens, mi, pos_dtype=pd,
             seq_len=card["seq_len"], **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches64) == (before[0] + 1, before[1] + wide)
    steps = fn.last_steps.cpu()
    want = tops.ert_extend_all_positions(card[depth], card["ref"], codes,
                                         lens, mi, pos_dtype=pd,
                                         seq_len=card["seq_len"], **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(steps, tops.ert_extend_all_positions.last_steps.cpu())
    twin = ert_cuda.ert_extend_twin(
        card[depth].rec.cpu().numpy(), card[depth].root,
        card["ref"].cpu().numpy(), card["seq_len"], codes.cpu().numpy(),
        lens.cpu().numpy(), mi.cpu().numpy(), wide=wide, **kw)
    np.testing.assert_array_equal(twin["node_steps"], steps[0].numpy())
    np.testing.assert_array_equal(twin["leaf_steps"], steps[1].numpy())
