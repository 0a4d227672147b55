"""Port vs JAX for the device EMF probe and the in-process single-end API
on the CPU:

- ``ops/emf.py``: ``fmix64`` and the seed hash against the host table's
  numpy hash on random keys; ``emf_lookup`` against the JAX
  ``emf_lookup`` under ``jax.jit``, all four arrays of every read
  exactly, on the setups of ``tests/test_emf.py`` (outcome codes, N,
  errors, too-short reads, reads longer than the seed, multi-location
  entries, the multi-location rescue on both strands) and a mixed batch
  with empty, too-short and random reads, at both of the port's
  reference layouts (``force_int64``);
- ``ops/emf_cuda.py``: the wrapper on CPU tensors is the plain version
  (no launch counted), and it raises on a device it has no kernel for;
  the kernel's twin (``emf_lookup_twin``) equals the plain version on
  every setup, in at most three dependent trips a read that takes no
  rescue;
- ``GpuAligner``'s ``emf_filter``, ``align_batch`` (regions),
  ``align_and_finalize`` (records) and ``align_reads_to_sam`` (lines)
  against ``TpuAligner``'s, with and without an EMF table, at capacities
  small enough that the overflow-retry ladder runs, on a genome with
  planted repeats (multi-location hits, rescues);
- ``align_and_finalize`` with the device probe against the port's
  ``SeStream`` with the host probe;
- ``EMF_DEVICE_BYTES=0``: the table stays on the host and
  ``dispatch_batch`` runs without a probe;
- the kernel against the plain version on the card (``cuda``), with a
  table whose probes run past 32 slots and reads of 400 columns.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bwa_mem_scale_tpu.config import MemOptions as JOpt
from bwa_mem_scale_tpu.index.artifacts import save_index
from bwa_mem_scale_tpu.index.bntseq import BntSeq, Annotation
from bwa_mem_scale_tpu.index.build import build_index
from bwa_mem_scale_tpu.index.perfect import build_perfect_table
from bwa_mem_scale_tpu.io.fastq import Read as JRead, ReadBatch as JBatch
from bwa_mem_scale_tpu.ops import emf as jemf
from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                              PipelineConfig as JCfg)
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index import perfect as tperfect
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.io.fastq import (Read as TRead,
                                              ReadBatch as TBatch)
from bwa_mem_scale_tpu_torch.ops import emf as temf, emf_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg)
from bwa_mem_scale_tpu_torch.pipeline.stream import SeStream

from conftest import make_genome, sample_reads

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

S = 48
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)


def _port_table(pt):
    """The port's PerfectTable holding the JAX table's arrays."""
    return tperfect.PerfectTable(**{f.name: getattr(pt, f.name)
                                    for f in dataclasses.fields(pt)})


def _one_contig(seq):
    n = len(seq)
    return BntSeq(l_pac=n, anns=[Annotation(name="c", anno="", offset=0,
                                            length=n, n_ambs=0)],
                  ambs=[], seq=seq)


def _jax_lookup(idx, pt, codes, lens):
    out = jax.jit(jemf.emf_lookup)(jemf.DeviceEmf.from_host(pt),
                                   JFmi.from_host(idx).ref,
                                   jnp.asarray(codes, jnp.int32),
                                   jnp.asarray(lens, jnp.int32))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_lookup(tidx, pt, codes, lens, force_int64=False, fn=None):
    fmi = TFmi.from_host(tidx, "cpu", force_int64=force_int64)
    demf = temf.DeviceEmf.from_host(_port_table(pt), "cpu")
    out = (fn or temf.emf_lookup)(demf, fmi.ref,
                                  torch.as_tensor(codes, dtype=torch.int32),
                                  torch.as_tensor(lens, dtype=torch.int32))
    return {k: v.numpy() for k, v in out.items()}


def _assert_equal(want, got):
    assert set(want) == set(got) == {"code", "slot", "loc", "n_loc"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


# ---- the setups -------------------------------------------------------

def _planted(seed, unit_len, places, rc_places=()):
    """8 kbp with `unit` copied at `places` and its reverse complement at
    `rc_places`; returns (bns, unit)."""
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 4, size=8000).astype(np.uint8)
    unit = rng.randint(0, 4, size=unit_len).astype(np.uint8)
    for p in places:
        seq[p: p + unit_len] = unit
    for p in rc_places:
        seq[p: p + unit_len] = COMP[unit[::-1]]
    return _one_contig(seq), unit


def _batch(reads, L):
    codes = np.full((len(reads), L), 4, np.int32)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
        lens[i] = len(r)
    return codes, lens


def _setup(name):
    """(JAX index, JAX table, codes, lens) of one setup."""
    if name in ("codes", "longer", "host", "mixed"):
        bns = make_genome(30000, seed=5)
        idx = build_index(bns)
        pt = build_perfect_table(idx, seed_len=S)
        if name == "codes":
            reads = sample_reads(bns, 40, S, seed=9)
            codes = np.stack([r[0] for r in reads]).astype(np.int32)
            codes[0, 10] = 4
            codes[1, 20] = (codes[1, 20] + 2) % 4
            return idx, pt, codes, np.full(40, S, np.int32)
        if name == "longer":
            reads = sample_reads(bns, 20, 72, seed=10)
            codes = np.stack([r[0] for r in reads]).astype(np.int32)
            lens = np.full(20, 72, np.int32)
            lens[0] = S - 5                    # too short, padded by bases
            return idx, pt, codes, lens
        if name == "host":
            reads = sample_reads(bns, 30, 64, seed=15, err_rate=0.02)
            codes = np.stack([r[0] for r in reads]).astype(np.int32)
            codes[1, 8] = 4
            lens = np.full(30, 64, np.int32)
            lens[3] = 40
            return idx, pt, codes, lens
        # mixed: exact reads of 0-90 bp on both strands, N inside and past
        # the length, random reads, a read of only Ns
        rng = np.random.RandomState(21)
        reads = [r[0] for r in sample_reads(bns, 48, 90, seed=22)]
        codes, lens = _batch(reads, 90)
        lens[:] = rng.randint(0, 91, 48)
        lens[:4] = (0, S - 1, S, S + 1)
        codes[4:8] = rng.randint(0, 4, (4, 90))
        codes[8, 5] = 4                         # an N inside
        codes[9, 89] = 4
        lens[9] = 60                            # an N past the length
        codes[10] = 4
        codes[11, S + 3] = 4
        lens[11] = S + 10                       # an N past the seed
        return idx, pt, codes, lens
    if name == "multi":
        # unit at 1000 and 5000, its reverse complement at 6500
        bns, unit = _planted(3, S + 10, (1000, 5000), (6500,))
        idx = build_index(bns)
        pt = build_perfect_table(idx, seed_len=S)
        seq = bns.seq
        reads = [unit[:S], unit, COMP[unit[::-1]], seq[990:990 + S + 20],
                 COMP[seq[6500:6500 + S + 10][::-1]], unit[5:]]
        codes, lens = _batch(reads, S + 20)
        return idx, pt, codes, lens
    # rescue: an S-bp unit at 1000 and 5000 in different contexts; reads
    # 12 bp longer than the seed from either copy, on either strand
    bns, unit = _planted(9, S, (1000, 5000))
    idx = build_index(bns)
    pt = build_perfect_table(idx, seed_len=S)
    seq = bns.seq
    reads = [seq[p: p + S + 12] for p in (1000, 5000)]
    reads += [COMP[seq[p - 12: p + S][::-1]] for p in (1000, 5000)]
    reads += [seq[p - 7: p + S + 5] for p in (1000, 5000)]
    reads.append(np.concatenate([unit, [0] * 12]).astype(np.uint8))
    codes, lens = _batch(reads, S + 12)
    return idx, pt, codes, lens


SETUPS = ("codes", "longer", "host", "mixed", "multi", "rescue")


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """Each setup with the port's index loaded from the JAX package's
    saved file, and the JAX function's outputs."""
    out = {}
    for name in SETUPS:
        idx, pt, codes, lens = _setup(name)
        prefix = str(tmp_path_factory.mktemp(name) / "g")
        save_index(idx, prefix)
        out[name] = dict(idx=idx, pt=pt, codes=codes, lens=lens,
                         tidx=t_load(prefix),
                         want=_jax_lookup(idx, pt, codes, lens))
    return out


def test_fmix64_and_seed_hash_match_the_table():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 2 ** 63, 4096, dtype=np.int64).astype(np.uint64)
    keys[:8] = (0, 1, 2 ** 63, 2 ** 64 - 1, 2 ** 32, 2 ** 32 - 1,
                0x9E3779B97F4A7C15, 2 ** 63 - 1)
    keys[8:2048] |= np.uint64(1 << 63)        # the high bit set
    got = temf.fmix64(torch.as_tensor(keys.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64),
                                  tperfect.fmix64(keys))
    for s in (19, 32, 48, 101, 151):
        seeds = rng.randint(0, 4, (256, s)).astype(np.uint8)
        want = tperfect.hash_words(tperfect.pack_words(seeds), s)
        got = temf.seed_hash(torch.as_tensor(seeds.astype(np.int32)), s)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("layout", ["int32", "int64"])
@pytest.mark.parametrize("name", SETUPS)
def test_emf_lookup_equal_to_jax(setups, name, layout):
    s = setups[name]
    got = _port_lookup(s["tidx"], s["pt"], s["codes"], s["lens"],
                       force_int64=layout == "int64")
    _assert_equal(s["want"], got)
    code = got["code"]
    if name == "codes":
        assert code[0] == temf.WITH_N and (code[2:] >= 3).all()
    if name == "longer":
        assert code[0] == temf.NO_TABLE and (code[1:] >= 3).all()
        assert got["loc"][0] >= 0          # matched from the padding
    if name == "mixed":
        assert {0, 1, 2, 3, 4} <= set(code.tolist())
    if name == "multi":
        assert got["n_loc"][0] == 3 and (code[:5] >= 3).all()
    if name == "rescue":
        # each read's own copy, found through the list where the entry's
        # location fails the extension
        assert code[:4].tolist() == [3, 3, 4, 4]
        assert got["loc"][:4].tolist() == [1000, 5000, 1000, 5000]


@pytest.mark.parametrize("layout", ["int32", "int64"])
@pytest.mark.parametrize("name", SETUPS)
def test_emf_twin_equal_to_plain(setups, name, layout):
    """emf_lookup_twin (the kernel's rounds: the read, the probe, both
    windows in one trip, the rescue two trips a group of entries) equal
    to the plain emf_lookup in all four arrays; a read that takes no
    rescue makes at most three dependent trips, one through the list
    more."""
    s = setups[name]
    fmi = TFmi.from_host(s["tidx"], "cpu", force_int64=layout == "int64")
    demf = temf.DeviceEmf.from_host(_port_table(s["pt"]), "cpu")
    c = torch.as_tensor(s["codes"], dtype=torch.int32)
    n = torch.as_tensor(s["lens"], dtype=torch.int32)
    st = {}
    want = temf.emf_lookup(demf, fmi.ref, c, n, stats=st)
    twin = emf_cuda.emf_lookup_twin(demf, fmi.ref, c, n)
    for k in want:
        assert twin[k].dtype == want[k].numpy().dtype, k
        np.testing.assert_array_equal(twin[k], want[k].numpy(), k)
    rescued = st["cands"].numpy() > 0
    assert (twin["trips"][~rescued] <= 3).all()
    assert (twin["trips"][rescued] >= 5).all()
    if name == "rescue":
        assert rescued.any()


def test_emf_lookup_stats_count_the_rescue(setups):
    s = setups["rescue"]
    st = {}
    _port_lookup(s["tidx"], s["pt"], s["codes"], s["lens"],
                 fn=lambda *a: temf.emf_lookup(*a, stats=st))
    assert st["cands"].sum() > 0
    assert (st["trips"] >= 2).all() and (st["slots"] >= 1).all()
    assert (st["ref_bytes"] <= 2 * (S + 12) * (1 + st["cands"])).all()


def test_cpu_wrapper_is_the_plain_version(setups):
    s = setups["mixed"]
    before = emf_cuda.emf_lookup_cuda.launches
    got = _port_lookup(s["tidx"], s["pt"], s["codes"], s["lens"],
                       fn=emf_cuda.emf_lookup_cuda)
    _assert_equal(s["want"], got)
    assert emf_cuda.emf_lookup_cuda.launches == before
    demf = temf.DeviceEmf.from_host(_port_table(s["pt"]), "cpu")
    meta = torch.zeros((2, 90), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        emf_cuda.emf_lookup_cuda(demf, meta, meta, meta[:, 0])


# ---- the in-process single-end API -------------------------------------

L = 64


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    """A 30 kbp genome with a 58 bp unit in three copies (one reverse
    complemented) and a 48 bp unit in two contexts; a batch of exact
    reads on both strands, reads with errors and Ns, too-short reads,
    multi-location hits and rescues; both packages' aligners at tiny
    capacities, with the EMF table, and the JAX package's results."""
    rng = np.random.RandomState(5)
    seq = rng.randint(0, 4, 30000).astype(np.uint8)
    u1 = rng.randint(0, 4, S + 10).astype(np.uint8)
    u2 = rng.randint(0, 4, S).astype(np.uint8)
    for p in (3000, 12000):
        seq[p: p + S + 10] = u1
    seq[20000: 20000 + S + 10] = COMP[u1[::-1]]
    for p in (8000, 25000):
        seq[p: p + S] = u2
    bns = _one_contig(seq)
    idx = build_index(bns)
    pt = build_perfect_table(idx, seed_len=S)
    reads = [r[0] for r in sample_reads(bns, 24, L, seed=12)]
    reads += [r[0] for r in sample_reads(bns, 12, L, seed=13,
                                         err_rate=0.04)]
    reads += [u1[:S], u1, COMP[u1[::-1]], seq[8000:8000 + S + 12],
              seq[25000:25000 + S + 12], COMP[seq[24990:25000 + S][::-1]],
              seq[500:500 + 40], seq[700:700 + S]]
    codes, lens = _batch(reads, L)
    codes[30, 7] = 4
    prefix = str(tmp_path_factory.mktemp("api") / "g")
    save_index(idx, prefix)
    tidx = t_load(prefix)
    jal = TpuAligner(idx, JOpt(), JCfg(seed_engine="onehot", **TINY),
                     emf=pt)
    tal = GpuAligner(tidx, "cpu", TOpt(), TCfg(seed_engine="onehot", **TINY),
                     emf=_port_table(pt))
    names = [f"q{i}" for i in range(len(reads))]
    quals = ["".join(chr(33 + (i + j) % 40) for j in range(len(r)))
             for i, r in enumerate(reads)]
    jbatch = JBatch([JRead(n, np.asarray(r, np.uint8), q)
                     for n, r, q in zip(names, reads, quals)])
    want = dict(emf=jal.emf_filter(codes, lens),
                regs=jal.align_batch(codes, lens),
                recs=jal.align_and_finalize(codes, lens, id_offset=7),
                sam=jal.align_reads_to_sam(jbatch, id_offset=7))
    jal.demf = None        # the aligner as its gate leaves a table past it
    want["recs_no_emf"] = jal.align_and_finalize(codes, lens, id_offset=7)
    tbatch = TBatch([TRead(n, np.asarray(r, np.uint8), q)
                     for n, r, q in zip(names, reads, quals)])
    return dict(codes=codes, lens=lens, tidx=tidx, pt=pt, tal=tal,
                tbatch=tbatch, want=want, n_reads=len(reads),
                overflow_jax=jal.overflow_retried)


def _reg_key(r):
    return (r.rb, r.re, r.qb, r.qe, r.rid, r.score, r.truesc, r.w,
            r.seedcov, r.seedlen0, r.frac_rep, r.is_alt)


def _rec_key(r):
    return (r.rid, r.pos, r.flag, r.is_rev, r.mapq, r.NM,
            tuple(r.cigar or []), r.score, r.sub, r.MD, r.XA)


def test_emf_filter_equal_to_jax(api):
    got = api["tal"].emf_filter(api["codes"], api["lens"])
    _assert_equal(api["want"]["emf"], got)
    code = got["code"]
    assert (code >= 3).sum() >= 24 and temf.NO_TABLE in code
    assert api["tal"].emf_filter(api["codes"][:, : S - 1],
                                 np.minimum(api["lens"], S - 1)) is None


def test_align_batch_equal_to_jax(api):
    tal = api["tal"]
    before = tal.overflow_retried
    got = tal.align_batch(api["codes"], api["lens"])
    want = api["want"]["regs"]
    assert len(got) == len(want) == api["n_reads"]
    for i, (a, b) in enumerate(zip(want, got)):
        assert [_reg_key(r) for r in a] == [_reg_key(r) for r in b], i
    assert tal.overflow_retried > before
    assert api["overflow_jax"] > 0


@pytest.mark.parametrize("emf", ["device", "none"])
def test_align_and_finalize_equal_to_jax(api, emf):
    tal = api["tal"]
    if emf == "none":
        tal = GpuAligner(api["tidx"], "cpu", TOpt(),
                         TCfg(seed_engine="onehot", **TINY))
    hits = tal.emf_hits
    got = tal.align_and_finalize(api["codes"], api["lens"], id_offset=7)
    want = api["want"]["recs" if emf == "device" else "recs_no_emf"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert [_rec_key(r) for r in a] == [_rec_key(r) for r in b], i
    if emf == "device":
        assert tal.emf_hits - hits >= 24
        assert tal.demf is not None and tal.demf.device.type == "cpu"


def test_align_reads_to_sam_equal_to_jax(api):
    got = api["tal"].align_reads_to_sam(api["tbatch"], id_offset=7)
    assert got == api["want"]["sam"]
    assert len(got) >= api["n_reads"]


def test_device_probe_equal_to_the_stream(api):
    """align_and_finalize (device probe, hits zeroed on the device)
    against SeStream (host probe, hits compacted out of the batches)."""
    tal = api["tal"]
    want = tal.align_and_finalize(api["codes"], api["lens"])
    al = GpuAligner(api["tidx"], "cpu", TOpt(),
                    TCfg(seed_engine="onehot", **TINY),
                    emf=_port_table(api["pt"]))
    stream = SeStream(al, batch_reads=16, max_len=L)
    got, off = {}, 0
    for chunk in (7, 13, 21, 3):
        stream.feed(api["codes"][off: off + chunk],
                    api["lens"][off: off + chunk], off)
        off += chunk
        got.update(stream.ready())
    stream.flush()
    got.update(stream.ready())
    assert sorted(got) == list(range(api["n_reads"]))
    assert al.emf_hits > 0 and al.demf is None    # probed on the host
    for i in range(api["n_reads"]):
        assert [_rec_key(r) for r in want[i]] == \
            [_rec_key(r) for r in got[i]], i


def test_emf_device_bytes_gate(api, monkeypatch, capsys):
    monkeypatch.setenv("EMF_DEVICE_BYTES", "0")
    al = GpuAligner(api["tidx"], "cpu", TOpt(),
                    TCfg(seed_engine="onehot", **TINY),
                    emf=_port_table(api["pt"]))
    assert "stays host-resident" in capsys.readouterr().err
    assert not al.emf_resident and al.emf_filter(api["codes"],
                                                 api["lens"]) is None
    handle = al.dispatch_batch(api["codes"], api["lens"])
    assert handle[2] is None and al.demf is None
    recs = al.finalize_batch(handle, id_offset=7)
    want = api["want"]["recs_no_emf"]
    for i, (a, b) in enumerate(zip(want, recs)):
        assert [_rec_key(r) for r in a] == [_rec_key(r) for r in b], i
    assert al.emf_checked == 0
    monkeypatch.setenv("EMF_DEVICE_BYTES", str(1 << 40))
    assert GpuAligner(api["tidx"], "cpu", TOpt(), emf=_port_table(
        api["pt"])).emf_resident


# ---- the kernel on the card ----------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the EMF kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_equals_plain(setups):
    dev = _cuda()
    cases = [(s["tidx"], s["pt"], s["codes"], s["lens"])
             for s in setups.values()]
    # a crowded table (probes past 32 slots) and reads of 400 columns
    s = setups["codes"]                 # make_genome(30000, seed=5)
    crowded = build_perfect_table(s["idx"], seed_len=S, slack=1.05)
    assert crowded.max_probe > 64
    reads = sample_reads(s["idx"].bns, 300, 400, seed=31, err_rate=0.001)
    codes = np.stack([r[0] for r in reads]).astype(np.int32)
    lens = np.random.RandomState(32).randint(0, 401, 300).astype(np.int32)
    cases.append((s["tidx"], crowded, codes, lens))
    for tidx, pt, codes, lens in cases:
        for wide in (False, True):
            fmi = TFmi.from_host(tidx, dev, force_int64=wide)
            demf = temf.DeviceEmf.from_host(_port_table(pt), dev)
            c = torch.as_tensor(codes, device=dev)
            n = torch.as_tensor(lens, device=dev)
            before = emf_cuda.emf_lookup_cuda.launches
            got = emf_cuda.emf_lookup_cuda(demf, fmi.ref, c, n)
            torch.cuda.synchronize()
            assert emf_cuda.emf_lookup_cuda.launches == before + 1
            want = temf.emf_lookup(demf, fmi.ref, c, n)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        emf_cuda.emf_lookup_cuda(demf, fmi.ref, c[:, : S - 1], n)
