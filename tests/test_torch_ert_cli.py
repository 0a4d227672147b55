"""Port CLI vs JAX CLI with an ERT index, on the CPU: a 12 kbp genome in
two contigs indexed with the full SA (``index -s 0``) by the JAX CLI, its
``ert-index -k 6``, 40 single-end reads and 24 FR pairs of 60 bp.

- ``ert-index`` writes the JAX CLI's arrays, at the default depth and at
  ``--max-depth 40``.
- ``mem`` with the ERT next to the index, SE and PE (two files): the
  port's SAM body and its "ERT index loaded" note equal the JAX CLI's; the
  trie seeds every batch (the sweep engine reported, as in JAX).
- The retry ladder at tiny capacities (every tier seeding with the ERT),
  SE and PE and SE at the forced int64 layout, gives the JAX CLI's body.
- An ERT file next to a sampled index and an unreadable ERT file each
  drop the trie with the JAX CLI's warning, and the body stays the JAX
  CLI's (every engine gives the same SMEMs); a named sweep engine keeps
  the trie.
- A named readlane engine drops the auto-loaded trie with the JAX CLI's
  note, and its body is the JAX CLI's `mem --seed-engine readlane`.
- An unreadable k-step table (`.cp2.npz`) is skipped with the JAX CLI's
  warning, and the trie's body stays (the test keeps its name from when
  the port refused the table).
"""

import contextlib
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
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4, max_regs=4,
            max_pairs=16)


def _stderr_of(fn, *args):
    """(fn(*args), what it printed to sys.stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@PG"))


def _link(src_prefix, dst_prefix, exts):
    for ext in exts:
        os.symlink(src_prefix + ext, dst_prefix + ext)


@pytest.fixture(scope="module")
def cli_side(tmp_path_factory):
    """The genome, reads and pairs; the JAX CLI's full-SA index and its
    ERT (K = 6), and its SE and PE `mem` SAM files and stderr with the
    ERT next to the index."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu.index.bntseq import decode_bases
    from conftest import make_genome, sample_reads
    from test_torch_nojax import _write_pairs
    tmp = tmp_path_factory.mktemp("ertcli")
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
    assert jcli.main(["index", str(tmp / "g.fa"), "-p", prefix, "-s",
                      "0"]) == 0
    assert jcli.main(["ert-index", prefix, "-k", "6"]) == 0
    sam, err = {}, {}
    for mode, fqs in FASTQS.items():
        sam[mode] = tmp / f"jax_{mode}.sam"
        rc, err[mode] = _stderr_of(jcli.main, [
            "mem", prefix, *(str(tmp / f) for f in fqs), "--batch-reads",
            "16", "-o", str(sam[mode])])
        assert rc == 0
    return dict(tmp=tmp, prefix=prefix, sam=sam, err=err)


def _notes(err):
    return [ln for ln in err.splitlines() if ln.startswith(("* ERT",
                                                            "* note",
                                                            "* WARNING"))]


@pytest.mark.parametrize("flags", [[], ["--max-depth", "40"]],
                         ids=["default", "depth40"])
def test_ert_index_cli_equal_to_jax(cli_side, tmp_path, flags):
    """The port's `ert-index -k 6` writes the JAX CLI's file: the same
    names, dtypes and arrays."""
    from bwa_mem_scale_tpu import cli as jcli
    prefix = cli_side["prefix"]
    want, mine = str(tmp_path / "j"), str(tmp_path / "t")
    _link(prefix, want, [".tpuidx.npz"])
    _link(prefix, mine, [".tpuidx.npz"])
    assert jcli.main(["ert-index", want, "-k", "6", *flags]) == 0
    assert cli.main(["ert-index", mine, "-k", "6", *flags]) == 0
    j, t = np.load(want + ".ert6.npz"), np.load(mine + ".ert6.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], k)
    assert int(t["max_depth"]) == (40 if flags else 320)


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_mem_ert_cli_equal_to_jax(cli_side, tmp_path, mode):
    """`mem` with the ERT next to the index: the JAX CLI's SAM body and
    notes; the trie seeds every batch and the sweep engine is reported."""
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [prefix, *(str(tmp / f) for f in
                                             FASTQS[mode]),
                                   "--batch-reads", "16", "-o", str(out),
                                   "--device", "cpu"])
    assert _notes(err) == _notes(cli_side["err"][mode])
    assert _notes(err)[0].startswith("* ERT index loaded (K=6, ")
    assert al.dert is not None and al.cfg.seed_engine == "sweep"
    assert al.stats["ert_ticks_p1"] > 0 and "sweep_ticks_p1" not in al.stats
    body = _body(cli_side["sam"][mode])
    assert body.count("\n") >= 40
    assert _body(out) == body


@pytest.mark.parametrize("mode,wide", [("se", False), ("pe", False),
                                       ("se", True)],
                         ids=["se-int32", "pe-int32", "se-int64"])
def test_ert_retry_ladder_equal_to_jax(cli_side, mode, wide):
    """The ERT at tiny capacities: reads overflow and go through the retry
    tiers, each seeding with the trie, and the SAM body equals the JAX
    CLI's; also at the forced int64 layout."""
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.ert import load_ert
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    al = align.GpuAligner(load_index(prefix), "cpu", MemOptions(),
                          align.PipelineConfig(**TINY),
                          ert=load_ert(prefix + ".ert6.npz"))
    if wide:
        al.fmi = DeviceFMIndex.from_host(al.idx, "cpu", force_int64=True)
    seeded = []
    real = align.collect_smems_ert

    def record(*a, **k):
        seeded.append(a[3].shape[0])
        return real(*a, **k)
    align.collect_smems_ert = record
    try:
        sam = io.StringIO()
        run_alignment(al, [str(tmp / f) for f in FASTQS[mode]], sam,
                      batch_reads=16, paired=mode == "pe")
    finally:
        align.collect_smems_ert = real
    assert al.overflow_retried > 0
    assert len(seeded) > al.batches          # the tiers seeded with it too
    with open(cli_side["sam"][mode]) as f:
        want = "".join(ln for ln in f if not ln.startswith("@"))
    assert sam.getvalue() == want


@pytest.mark.parametrize("case", ["sampled", "unreadable"])
def test_mem_drops_ert_as_jax(cli_side, tmp_path, case):
    """The trie is dropped with the JAX CLI's warning next to a sampled
    index and when its file is unreadable; the one-hot engine then seeds,
    and the body stays the JAX CLI's ERT body."""
    from bwa_mem_scale_tpu import cli as jcli
    from bwa_mem_scale_tpu.index.artifacts import load_index
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    mine = str(tmp_path / "g")
    if case == "sampled":
        assert cli.main(["index", str(tmp / "g.fa"), "-p", mine]) == 0
        _link(prefix, mine, [".ert6.npz"])
    else:
        _link(prefix, mine, [".tpuidx.npz"])
        with open(mine + ".ert6.npz", "wb") as f:
            f.write(b"not an npz")
    # the JAX CLI's own lookup prints its warning
    _, jerr = _stderr_of(jcli.find_ert, mine, load_index(mine))
    want = _notes(jerr)
    assert len(want) == 1 and want[0].startswith("* WARNING")
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [mine, str(tmp / "r.fq"), "--batch-reads",
                                   "16", "-o", str(out), "--device", "cpu"])
    assert _notes(err) == want
    assert al.dert is None and al.cfg.seed_engine == "onehot"
    assert _body(out) == _body(cli_side["sam"]["se"])


def test_mem_named_sweep_keeps_ert(cli_side, tmp_path):
    """`--seed-engine sweep` named keeps the auto-loaded trie (the JAX
    CLI's rule): the ERT seeds, the body is the JAX CLI's."""
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [prefix, str(tmp / "r.fq"),
                                   "--batch-reads", "16", "-o", str(out),
                                   "--device", "cpu", "--seed-engine",
                                   "sweep"])
    assert _notes(err) == _notes(cli_side["err"]["se"])
    assert al.dert is not None and al.stats["ert_ticks_p1"] > 0
    assert _body(out) == _body(cli_side["sam"]["se"])


def test_mem_cli_still_refuses_kstep(cli_side, tmp_path):
    """An empty `.cp2.npz` next to the ERT index: the port's `mem` no longer
    refuses the k-step table; as the JAX CLI, it skips the unreadable file
    with its warning, and the SAM body equals the trie run's."""
    from bwa_mem_scale_tpu import cli as jcli
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    mine = str(tmp_path / "g")
    _link(prefix, mine, [".tpuidx.npz", ".ert6.npz"])
    open(mine + ".cp2.npz", "wb").close()
    _, jerr = _stderr_of(jcli.find_cp2, mine)
    want = _notes(jerr)
    assert len(want) == 1 and want[0].startswith(
        f"* WARNING: ignoring unreadable k-step table {mine}.cp2.npz")
    out = tmp_path / "port.sam"
    al, err = _stderr_of(cli.mem, [mine, str(tmp / "r.fq"), "--batch-reads",
                                   "16", "-o", str(out), "--device", "cpu"])
    assert [n for n in _notes(err) if n.startswith("* WARNING")] == want
    assert al.fmi.kstep == 1 and al.dert is not None
    assert _body(out) == _body(cli_side["sam"]["se"])


def test_mem_readlane_drops_ert_with_jax_note(cli_side, tmp_path):
    """`mem --seed-engine readlane` with the ERT next to the index: the
    JAX CLI's notes (the trie loaded, then dropped for the named engine),
    no trie on the aligner, the readlane engine seeding every batch, and
    the JAX CLI's SAM body (equal to the trie's: every engine gives the
    same SMEMs)."""
    from bwa_mem_scale_tpu import cli as jcli
    tmp, prefix = cli_side["tmp"], cli_side["prefix"]
    args = [prefix, str(tmp / "r.fq"), "--batch-reads", "16",
            "--seed-engine", "readlane"]
    jout, tout = tmp_path / "jax.sam", tmp_path / "port.sam"
    rc, jerr = _stderr_of(jcli.main, ["mem", *args, "-o", str(jout)])
    assert rc == 0
    al, terr = _stderr_of(cli.mem, args + ["-o", str(tout), "--device",
                                           "cpu"])
    note = "* note: readlane seeding selected; ignoring auto-loaded ERT index"
    assert note in _notes(jerr) and _notes(terr) == _notes(jerr)
    assert al.dert is None and al.cfg.seed_engine == "readlane"
    assert al.stats["rl_ticks_p1"] > 0
    assert _body(tout) == _body(jout) == _body(cli_side["sam"]["se"])
