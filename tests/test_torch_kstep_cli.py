"""Port CLI vs JAX CLI with the k-step checkpoint table, single-end, on the
CPU: a 12 kbp genome in two contigs indexed by the JAX CLI with its FMA
table (`smem-table -k 6`), 40 reads of 60 bp, and the JAX CLI's
`kstep-table -k 2` and `-k 3` under two prefixes linked to the index.

- ``kstep-table`` through the port's CLI writes the JAX CLI's file at K =
  2 and 3 (names, dtypes, arrays).
- ``mem`` with ``.cp2.npz``, then ``.cp3.npz``, next to the index, on the
  one-hot engine and on ``--seed-engine sweep``: the table's note and the
  SAM body equal the JAX CLI's with the same file, and the body equals the
  no-table body (exact: SAM bytes).
- The retry ladder at tiny capacities with the trigram table: every tier
  seeds with it, and the body equals the JAX CLI's.
- An unreadable ``.cp3.npz`` is skipped with the JAX CLI's warning and the
  bigram table loads; the int64 layout refuses a table with the JAX
  package's error.
Paired-end runs are in ``tests/test_torch_kstep_pe.py``.
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch import cli

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

L = 60
FASTQS = {"se": ["r.fq"], "pe": ["r1.fq", "r2.fq"]}
ENGINES = {"onehot": [], "sweep": ["--seed-engine", "sweep"]}
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4, max_regs=4,
            max_pairs=16)


def _stderr_of(fn, *args):
    """(fn(*args), what it printed to sys.stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        out = fn(*args)
    return out, buf.getvalue()


def body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@PG"))


def notes(err):
    """The table's note and any warning, as the CLIs print them."""
    return [ln for ln in err.splitlines()
            if "checkpoint table" in ln or ln.startswith("* WARNING")]


def link(src_prefix, dst_prefix, exts):
    for ext in exts:
        os.symlink(src_prefix + ext, dst_prefix + ext)


def setup_side(tmp_path_factory, mode):
    """The genome, reads and pairs; the JAX CLI's index, FMA table and
    k-step tables (prefix g2 with `.cp2.npz`, g3 with `.cp3.npz`, both
    linked to g's index and FMA table); the JAX CLI's `mem` SAM bodies and
    stderr for `mode` ("se" or "pe"): without a table (one-hot) and with
    each table on each engine."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu.index.bntseq import decode_bases
    from conftest import make_genome, sample_reads
    from test_torch_nojax import _write_pairs
    tmp = tmp_path_factory.mktemp(f"kstep{mode}")
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
    g = str(tmp / "g")
    assert jcli.main(["index", str(tmp / "g.fa"), "-p", g]) == 0
    assert jcli.main(["smem-table", g, "-k", "6"]) == 0
    prefix = {1: g}
    for K in (2, 3):
        prefix[K] = str(tmp / f"g{K}")
        link(g, prefix[K], [".tpuidx.npz", ".fma6.npz"])
        assert jcli.main(["kstep-table", prefix[K], "-k", str(K)]) == 0
    fqs = [str(tmp / f) for f in FASTQS[mode]]
    sam, err = {}, {}
    runs = [(1, "onehot")] + [(K, e) for K in (2, 3) for e in ENGINES]
    for K, engine in runs:
        out = tmp / f"jax_{mode}_{K}_{engine}.sam"
        rc, err[K, engine] = _stderr_of(jcli.main, [
            "mem", prefix[K], *fqs, "--batch-reads", "16", "-o", str(out),
            *ENGINES[engine]])
        assert rc == 0
        sam[K, engine] = body(out)
    return dict(tmp=tmp, prefix=prefix, fqs=fqs, sam=sam, err=err)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    return setup_side(tmp_path_factory, "se")


def check_mem(side, tmp_path, K, engine):
    """The port's `mem` with the K table on `engine`: the note and the SAM
    body equal the JAX CLI's with the same file, and the no-table body."""
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [side["prefix"][K], *side["fqs"],
                                   "--batch-reads", "16", "-o", str(out),
                                   "--device", "cpu", *ENGINES[engine]])
    want = notes(side["err"][K, engine])
    assert notes(err) == want == [
        f"* {K}-step ({'tri' if K == 3 else 'bi'}gram) checkpoint table "
        f"loaded"]
    assert al.fmi.kstep == K and al.cfg.seed_engine == engine
    got = body(out)
    assert got.count("\n") >= 40
    assert got == side["sam"][K, engine]
    assert got == side["sam"][1, "onehot"]


@pytest.mark.parametrize("K", [2, 3])
def test_kstep_table_cli_equal_to_jax(side, tmp_path, K):
    """The port's `kstep-table -k K` writes the JAX CLI's file."""
    mine = str(tmp_path / "t")
    link(side["prefix"][1], mine, [".tpuidx.npz"])
    rc, err = _stderr_of(cli.main, ["kstep-table", mine, "-k", str(K)])
    assert rc == 0 and f"* wrote {mine}.cp{K}.npz (" in err
    j = np.load(f"{side['prefix'][K]}.cp{K}.npz")
    t = np.load(f"{mine}.cp{K}.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], k)


@pytest.mark.parametrize("K,engine", [(K, e) for K in (2, 3)
                                      for e in ENGINES],
                         ids=[f"K{K}-{e}" for K in (2, 3) for e in ENGINES])
def test_mem_kstep_cli_equal_to_jax(side, tmp_path, K, engine):
    check_mem(side, tmp_path, K, engine)


def test_kstep_retry_ladder_equal_to_jax(side):
    """The trigram table at tiny capacities: reads overflow and go through
    the retry tiers, each seeding with the table (three bases a FWD tick),
    and the SAM body equals the JAX CLI's."""
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.kstep import load_cp2
    from bwa_mem_scale_tpu_torch.ops import smem_oh
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    p = side["prefix"][3]
    al = align.GpuAligner(load_index(p), "cpu", MemOptions(),
                          align.PipelineConfig(seed_engine="onehot", **TINY),
                          cp2=load_cp2(p + ".cp3.npz"))
    seeded = []
    real = smem_oh.one_pos_machine_cuda

    def record(fmi, *a, **k):
        seeded.append(fmi.kstep)
        return real(fmi, *a, **k)
    smem_oh.one_pos_machine_cuda = record
    try:
        sam = io.StringIO()
        run_alignment(al, side["fqs"], sam, batch_reads=16)
    finally:
        smem_oh.one_pos_machine_cuda = real
    assert al.overflow_retried > 0
    assert len(seeded) > 2 * al.batches and set(seeded) == {3}
    want = "".join(ln for ln in side["sam"][3, "onehot"].splitlines(True)
                   if not ln.startswith("@"))
    assert sam.getvalue() == want


def test_mem_skips_unreadable_kstep_table(side, tmp_path):
    """An unreadable `.cp3.npz` is skipped with the JAX CLI's warning, and
    the `.cp2.npz` beside it loads; the body stays the JAX CLI's."""
    from bwa_mem_scale_tpu import cli as jcli
    mine = str(tmp_path / "g")
    link(side["prefix"][2], mine, [".tpuidx.npz", ".fma6.npz", ".cp2.npz"])
    with open(mine + ".cp3.npz", "wb") as f:
        f.write(b"not an npz")
    _, jerr = _stderr_of(jcli.find_cp2, mine)
    want = notes(jerr)
    assert len(want) == 1 and want[0].startswith(
        f"* WARNING: ignoring unreadable k-step table {mine}.cp3.npz")
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [mine, *side["fqs"], "--batch-reads",
                                   "16", "-o", str(out), "--device", "cpu"])
    assert notes(err) == want + ["* 2-step (bigram) checkpoint table loaded"]
    assert al.fmi.kstep == 2
    assert body(out) == side["sam"][2, "onehot"]


def test_kstep_int64_refused_as_jax(side):
    """A genome of 2^31 positions (the int64 layout): the builder and the
    aligner refuse a k-step table with the JAX package's errors."""
    from bwa_mem_scale_tpu.index import kstep as jk
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.kstep import build_cp2, load_cp2
    from bwa_mem_scale_tpu_torch.pipeline.align import GpuAligner
    idx = load_index(side["prefix"][1])
    big = dataclasses.replace(idx, seq_len=1 << 31)
    table = load_cp2(side["prefix"][2] + ".cp2.npz")
    errs = []
    for fn in (lambda: jk.build_cp2(big), lambda: build_cp2(big),
               lambda: JFmi.from_host(big, cp2=table),
               lambda: GpuAligner(big, "cpu", MemOptions(), cp2=table)):
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "int32-position genomes only" in errs[0]
    assert errs[2] == errs[3] == "k-step table is int32-path only"
