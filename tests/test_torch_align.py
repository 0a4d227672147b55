"""Port vs JAX for the whole single-end slice on the CPU:

- ``seed_chain_extend``: every array of the output dict equal to the JAX
  package's (one compiled JAX program at a small shape, shared with the
  ``mem`` run below through the same aligner);
- ``run_alignment`` on the same FASTQ with an EMF table: SAM bodies
  byte-equal, with EMF hits; and again with tiny capacities in the port,
  which routes reads through the deferred overflow-retry ladder;
- the port with tiny capacities equal to the port with roomy ones on a
  repeat-dense genome (the retry ladder as tests/test_overflow.py drives
  it in the JAX package);
- the CLIs: an unreadable EMF table is skipped with the JAX package's
  warning; `perfect-index --chunked` and `-g` save the JAX CLI's table;
  `mem` under five option sets writes the JAX CLI's SAM body.

Each side gets its inputs from its own package: the port loads the index
the JAX package saved with its own ``load_index``, builds its own EMF
table and takes its own ``MemOptions``.
"""

import io
import os

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.index.artifacts import save_index
from bwa_mem_scale_tpu.index.bntseq import decode_bases
from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                             save_perfect_table)
from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                              PipelineConfig as JCfg)
from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
from bwa_mem_scale_tpu_torch.pipeline.align import (
    GpuAligner, PipelineConfig as TCfg, seed_chain_extend)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.index.bntseq import BntSeq, Annotation
from bwa_mem_scale_tpu_torch.index.build import build_index as t_build
from bwa_mem_scale_tpu_torch.index.perfect import (
    build_perfect_table as t_build_perfect)

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

B, L = 32, 101
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)
ROOMY = dict(max_coords=2048, max_chains=128, max_seeds_per_chain=64,
             max_regs=256, max_pairs=16 * 256)


def _reads(genome, n, seed):
    """Errors, chimeras, unmappable reads, N bases and exact
    reverse-strand copies (EMF hits)."""
    rng = np.random.RandomState(seed)
    codes = np.zeros((n, L), np.int32)
    for i in range(n):
        p = rng.randint(0, len(genome) - L)
        s = genome[p: p + L].astype(np.int32).copy()
        if i % 3 == 1:
            s[rng.rand(L) < 0.04] = rng.randint(0, 4)
        if i % 7 == 0:
            p2 = rng.randint(0, len(genome) - L)
            s[L // 2:] = genome[p2 + L // 2: p2 + L]
        if i % 11 == 0:
            s[:] = rng.randint(0, 4, L)
        if i % 13 == 5:
            s[rng.randint(0, L, 2)] = 4
        if i % 5 == 2:
            s = (3 - genome[p: p + L].astype(np.int32))[::-1].copy()
        codes[i] = s
    return codes


def _write_fastq(path, codes):
    with open(path, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@q{i}\n{decode_bases(c)}\n+\n"
                    f"{chr(33 + i % 40) * len(c)}\n")
    return str(path)


@pytest.fixture(scope="module")
def jax_side(small_index, tmp_path_factory):
    """One JAX aligner (one compile at [B, L]) serving the dict test and
    the reference SAM; the index and EMF table saved for the port, and
    the port's own index (loaded from those files) and EMF table."""
    tmp = tmp_path_factory.mktemp("fq")
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
                temf=t_build_perfect(tidx, seed_len=L), sam=sam.getvalue())


def test_seed_chain_extend_equal(small_index, jax_side):
    import jax.numpy as jnp
    codes = jax_side["codes"][:B]
    lens = np.full(B, L, np.int32)
    lens[3] = 0                                  # a dead lane
    jal = jax_side["jal"]
    want = jal._jit_extend(jal.fmi, jal.dbns, jnp.asarray(codes),
                           jnp.asarray(lens), L=L)
    tal = GpuAligner(jax_side["tidx"], "cpu", TOpt(),
                     TCfg(seed_engine="onehot", **CAPS))
    stats = {}
    got = seed_chain_extend(tal.fmi, tal.dbns, torch.as_tensor(codes),
                            torch.as_tensor(lens), L, opt=tal.opt,
                            cfg=tal.cfg, stats=stats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      got[k].numpy(), k)
    assert got["valid"].any() and stats["seed_ticks_p1"] > 0


@pytest.mark.parametrize("caps", ["same", "tiny"])
def test_mem_sam_equal_to_jax(small_index, jax_side, caps):
    tal = GpuAligner(jax_side["tidx"], "cpu", TOpt(),
                     TCfg(seed_engine="onehot",
                          **(CAPS if caps == "same" else TINY)),
                     emf=jax_side["temf"])
    sam = io.StringIO()
    n = t_run(tal, [jax_side["fq"]], sam, batch_reads=B)
    assert n == len(jax_side["codes"])
    assert sam.getvalue() == jax_side["sam"]
    assert tal.emf_hits > 0
    names = [ln.split("\t", 1)[0] for ln in sam.getvalue().splitlines()]
    primaries = [nm for nm, ln in zip(names, sam.getvalue().splitlines())
                 if not int(ln.split("\t")[1]) & 0x900]
    assert primaries == [f"q{i}" for i in range(n)]
    if caps == "tiny":
        assert tal.overflow_retried > 0
    else:
        assert tal.overflow_retried == 0


def test_mem_cli_sam_equal_to_jax(jax_side, tmp_path):
    """The port's CLI `mem --device cpu`, at its default capacities, on
    the index and EMF table the JAX package saved, writes the JAX
    package's SAM body byte for byte. `-t 4` still parses and, having no
    effect, gives the default run's SAM bytes."""
    from bwa_mem_scale_tpu_torch import cli
    argv = [jax_side["prefix"], jax_side["fq"], "--device", "cpu",
            "--batch-reads", str(B)]
    out, out_t4 = tmp_path / "out.sam", tmp_path / "t4.sam"
    al = cli.mem(argv + ["-o", str(out)])
    with open(out) as f:
        body = "".join(ln for ln in f if not ln.startswith("@"))
    assert body == jax_side["sam"]
    assert al.emf_hits > 0 and al.batches > 0
    cli.mem(argv + ["-o", str(out_t4), "-t", "4"])
    assert out_t4.read_bytes() == out.read_bytes()


def test_demo_data_equal_to_jax():
    """models/aligner.py: the same genome and reads as the JAX package's
    helpers for a seed; the truth it adds locates every error-free read."""
    from bwa_mem_scale_tpu.models import aligner as jm
    from bwa_mem_scale_tpu_torch.models import aligner as tm
    jb = jm.demo_genome(30000, seed=4, n_contigs=3)
    tb = tm.demo_genome(30000, seed=4, n_contigs=3)
    np.testing.assert_array_equal(jb.seq, tb.seq)
    assert ([(a.name, a.offset, a.length) for a in jb.anns]
            == [(a.name, a.offset, a.length) for a in tb.anns])
    for err in (0.0, 0.03):
        for a, b in zip(jm.simulate_reads(jb, 40, 101, seed=5, err_rate=err),
                        tm.simulate_reads(tb, 40, 101, seed=5, err_rate=err)):
            np.testing.assert_array_equal(a, b)
    codes, _, pos, is_rev = tm.simulate_reads_with_truth(tb, 40, 101, seed=5,
                                                         err_rate=0.0)
    comp = np.array([3, 2, 1, 0], np.int32)
    for c, p, r in zip(codes, pos, is_rev):
        src = tb.seq[p: p + 101].astype(np.int32)
        np.testing.assert_array_equal(c, comp[src[::-1]] if r else src)
    assert 0 < is_rev.sum() < len(is_rev)


@pytest.fixture(scope="module")
def repeat_index():
    """A 200 bp unit recurring 40 times (tests/test_overflow.py), indexed
    by the port."""
    rng = np.random.RandomState(7)
    unit = rng.randint(0, 4, size=200).astype(np.uint8)
    parts = []
    for _ in range(40):
        parts += [unit, rng.randint(0, 4, size=150).astype(np.uint8)]
    seq = np.concatenate(parts)
    bns = BntSeq(l_pac=len(seq),
                 anns=[Annotation(name="rep", anno="(null)", offset=0,
                                  length=len(seq), n_ambs=0)],
                 ambs=[], seq=seq)
    return t_build(bns)


def test_overflow_retry_ladder_lossless(repeat_index, tmp_path):
    rng = np.random.RandomState(3)
    comp = np.array([3, 2, 1, 0], dtype=np.int32)
    codes = []
    for _ in range(16):
        pos = rng.randint(0, 38) * 350 + rng.randint(0, 120)
        frag = repeat_index.bns.seq[pos: pos + 120].astype(np.int32)
        codes.append(comp[frag[::-1]] if rng.randint(2) else frag)
    fq = _write_fastq(tmp_path / "rep.fq", np.stack(codes))

    def run(caps):
        al = GpuAligner(repeat_index, "cpu", TOpt(),
                        TCfg(seed_engine="onehot", **caps))
        al.RETRY_BATCH = 8
        sam = io.StringIO()
        t_run(al, [fq], sam, batch_reads=8)
        return sam.getvalue(), al

    got, tiny = run(TINY)
    want, roomy = run(ROOMY)
    assert tiny.overflow_retried > 0
    assert roomy.overflow_retried == 0
    assert got == want


def _body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


def test_mem_cli_skips_unreadable_emf(jax_side, tmp_path, capsys):
    """A truncated EMF table is skipped with the JAX CLI's warning, and
    `mem` writes the SAM body of a run with no table."""
    import shutil
    from bwa_mem_scale_tpu_torch import cli
    src = jax_side["prefix"]
    for sub in ("none", "bad"):
        (tmp_path / sub).mkdir()
        shutil.copy(src + ".tpuidx.npz", tmp_path / sub / "g.tpuidx.npz")
    emf = f"{src}.emf{L}.npz"
    with open(emf, "rb") as f:
        head = f.read(os.path.getsize(emf) // 2)
    bad = tmp_path / "bad" / f"g.emf{L}.npz"
    bad.write_bytes(head)
    out = {}
    for sub in ("none", "bad"):
        out[sub] = tmp_path / f"{sub}.sam"
        cli.mem([str(tmp_path / sub / "g"), jax_side["fq"], "-o",
                 str(out[sub]), "--device", "cpu", "--batch-reads", str(B)])
    err = capsys.readouterr().err
    assert f"* WARNING: ignoring unreadable EMF table {bad}: " in err
    assert _body(out["bad"]) == _body(out["none"])


@pytest.mark.parametrize("flags", [["--chunked"], ["-g", "0.00001"]])
def test_perfect_index_cli_equal_to_jax(jax_side, tmp_path, flags):
    """`perfect-index --chunked` and `-g GB` (the streaming builder, a
    budget that drops entries) save the JAX CLI's arrays."""
    import shutil
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu_torch import cli
    tables = {}
    for side, main in (("jax", jcli.cmd_perfect_index),
                       ("port", lambda a: cli.main(["perfect-index", *a]))):
        (tmp_path / side).mkdir()
        prefix = str(tmp_path / side / "g")
        shutil.copy(jax_side["prefix"] + ".tpuidx.npz", prefix + ".tpuidx.npz")
        assert main([prefix, "-l", "60", *flags]) == 0
        tables[side] = np.load(f"{prefix}.emf60.npz")
    j, t = tables["jax"], tables["port"]
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(j[k], t[k], k)
    full = t_build_perfect(jax_side["tidx"], seed_len=60)
    n_full = int((full.loc >= 0).sum())
    if flags[0] == "-g":
        assert int((t["loc"] >= 0).sum()) < n_full
    else:
        assert int((t["loc"] >= 0).sum()) == n_full


@pytest.fixture(scope="module")
def cli_genome(tmp_path_factory):
    """30 kbp in 3 contigs, indexed and with an EMF table (seed 100) by
    the JAX package, and 96 reads of 60-149 bp: substitutions, a few
    indels and N bases, half reverse-complemented, some exact (EMF
    hits), names with FASTQ comments."""
    from bwa_mem_scale_tpu.index.build import build_index
    from conftest import make_genome
    tmp = tmp_path_factory.mktemp("cli")
    bns = make_genome(30000, seed=31, n_contigs=3)
    idx = build_index(bns)
    prefix = str(tmp / "g")
    save_index(idx, prefix)
    save_perfect_table(build_perfect_table(idx, seed_len=100), prefix)
    rng = np.random.RandomState(12)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    with open(tmp / "r.fq", "w") as f:
        for i in range(96):
            n = rng.randint(60, 150)
            a = bns.anns[i % 3]
            p = a.offset + rng.randint(0, a.length - n - 5)
            s = bns.seq[p: p + n].copy()
            if i % 4:
                m = rng.rand(n) < 0.02
                s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
            if i % 9 == 2:
                s = np.delete(s, rng.randint(10, n - 10))
            if i % 9 == 5:
                s = np.insert(s, rng.randint(10, n - 10), rng.randint(4))
            if i % 13 == 3:
                s[rng.randint(0, len(s), 2)] = 4
            if i % 2:
                s = comp[s[::-1]]
            f.write(f"@c{i} BC:Z:{'ACGT'[i % 4] * 4}\n{decode_bases(s)}\n"
                    f"+\n{chr(35 + i % 40) * len(s)}\n")
    return prefix, str(tmp / "r.fq")


@pytest.mark.parametrize("opts", [
    ["-C", "-R", "@RG\\tID:g1\\tSM:s1"],
    ["-M", "-a", "-5", "-q"],
    ["-K", "3000"],
    ["-x", "pacbio"],
    ["-A", "2"],
], ids=["C-R", "M-a-5-q", "K3000", "x-pacbio", "A2"])
def test_mem_cli_options_equal_to_jax(cli_genome, tmp_path, opts):
    """The port's CLI against the JAX CLI, SAM bodies byte-equal, under
    option sets that change the output path (FASTQ comments and read
    groups, secondary and supplementary marking, chunked batching, a
    preset, another scoring matrix)."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu_torch import cli
    prefix, fq = cli_genome
    args = [prefix, fq, "--batch-reads", "32", *opts]
    jout, tout = tmp_path / "jax.sam", tmp_path / "port.sam"
    assert jcli.cmd_mem(args + ["-o", str(jout)]) == 0
    cli.mem(args + ["-o", str(tout), "--device", "cpu"])
    body = _body(jout)
    assert body.count("\n") >= 96
    assert _body(tout) == body
