"""Paired-end `mem`, port vs JAX on the CPU, exact (arrays and SAM bytes):

- one PE batch through ``dispatch_pairs`` + ``fetch_pairs``: packed,
  meta and the EMF regions (``pm_regs``) equal to the JAX package's;
- ``run_alignment(paired=True)`` on two FASTQ files of 48 pairs (three
  batches) with an EMF table: the SAM body byte-equal to the JAX
  package's, with EMF hits on mates, mates without seeds (rescued),
  random mates, mates on different contigs and N bases;
- the port's CLI with two files, with ``-p`` on one interleaved file and
  with ``-I 300,30``, each byte-equal to the JAX ``run_alignment``;
- the port at tiny capacities byte-equal to the port at roomy ones, with
  overflow retries (PE under overflow, held without the JAX PE path);
- with the native PE stage declining every batch on both sides, the
  Python PE path's SAM body byte-equal to the JAX package's, with the
  native SAM text (``sam_ctx``) and without it (``-C``).

One JAX aligner, compiled once at [B, L], serves every JAX run. The port
loads the index and EMF table the JAX package saved with its own loaders
and takes its own ``MemOptions``. On a GPU, PE `mem --device cuda`
(through the BSW and SMEM kernels) writes the CPU run's SAM bytes.

The JAX side is imported inside the fixture and tests that use it, so the
CUDA case also runs on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_pe.py
"""

import io

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.index.perfect import (
    load_perfect_table as t_load_perfect)
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

B, L = 32, 101                 # 16 pairs a batch
N_PAIRS = 48
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)
ROOMY = dict(max_coords=2048, max_chains=128, max_seeds_per_chain=64,
             max_regs=256, max_pairs=16 * 256)
COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def _pairs(bns, n_pairs, seed):
    """FR pairs, insert 300 +- 30, read 2 reverse-complemented, 1%
    substitutions; some pairs exact (EMF hits), some with a mate that
    has no 19-mer seed (every 10th base changed: rescue), a random
    mate, a mate from another contig, or N bases."""
    rng = np.random.RandomState(seed)
    n_ctg = len(bns.anns)
    codes = np.zeros((2 * n_pairs, L), np.int32)
    for p in range(n_pairs):
        a = bns.anns[p % n_ctg]
        frag = int(np.clip(rng.normal(300, 30), L + 10, a.length - 1))
        pos = a.offset + rng.randint(0, a.length - frag)
        r1 = bns.seq[pos: pos + L].copy()
        end = bns.seq[pos + frag - L: pos + frag]
        if p % 9 == 4:                       # mate on the next contig
            b = bns.anns[(p + 1) % n_ctg]
            q = b.offset + rng.randint(0, b.length - L)
            end = bns.seq[q: q + L]
        r2 = COMP[end[::-1]].copy()
        if p % 6 != 1:                       # p % 6 == 1: exact pair
            for r in (r1, r2):
                m = rng.rand(L) < 0.01
                r[m] = (r[m] + rng.randint(1, 4, m.sum())) % 4
        if p % 8 == 3:                       # no seed: found by rescue
            r2[5::10] = (r2[5::10] + 1) % 4
        if p % 7 == 5:                       # random mate
            r2 = rng.randint(0, 4, L).astype(np.uint8)
        if p % 11 == 7:
            r1[rng.randint(0, L, 2)] = 4
        codes[2 * p], codes[2 * p + 1] = r1, r2
    return codes


def _write_fastq(path, codes, ids):
    """Read i (of the interleaved order) is named p{i // 2}, with a
    quality of its own."""
    with open(path, "w") as f:
        for i in ids:
            f.write(f"@p{i // 2}\n{decode_bases(codes[i])}\n+\n"
                    f"{chr(35 + i % 38) * L}\n")
    return str(path)


def _pes_300_30():
    """-I 300,30 as the JAX CLI builds it."""
    from bwa_mem_scale_tpu.pipeline.pe import PeStat
    pes = [PeStat() for _ in range(4)]
    pes[1] = PeStat(low=180, high=420, avg=300.0, std=30.0, failed=False)
    return pes


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    """Genome, index, EMF table, FASTQ files, and the JAX aligner's SAM
    bodies (without and with -I)."""
    from conftest import make_genome
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    tmp = tmp_path_factory.mktemp("pe")
    idx = build_index(make_genome(30000, seed=23, n_contigs=3))
    emf = build_perfect_table(idx, seed_len=L)
    codes = _pairs(idx.bns, N_PAIRS, seed=6)
    ids = range(2 * N_PAIRS)
    fq1 = _write_fastq(tmp / "r1.fq", codes, ids[0::2])
    fq2 = _write_fastq(tmp / "r2.fq", codes, ids[1::2])
    fqi = _write_fastq(tmp / "ri.fq", codes, ids)
    prefix = str(tmp / "g")
    save_index(idx, prefix)
    save_perfect_table(emf, prefix)
    jal = TpuAligner(idx, MemOptions(), JCfg(seed_engine="onehot", **CAPS),
                     emf=emf)
    sams = {}
    for key, pes in (("auto", None), ("fixed", _pes_300_30())):
        jal.pes = pes
        out = io.StringIO()
        j_run(jal, [fq1, fq2], out, batch_reads=B, paired=True)
        sams[key] = out.getvalue()
    jal.pes = None
    return dict(tidx=t_load(prefix),
                temf=t_load_perfect(f"{prefix}.emf{L}.npz"), codes=codes,
                fq1=fq1, fq2=fq2, fqi=fqi, prefix=prefix, jal=jal,
                sam=sams["auto"], sam_fixed=sams["fixed"], tmp=tmp)


def _port(pe, caps):
    return GpuAligner(pe["tidx"], "cpu", TOpt(),
                      TCfg(seed_engine="onehot", **caps), emf=pe["temf"])


def test_pe_batch_equal_to_jax(pe):
    codes = pe["codes"][:B]
    lens = np.full(B, L, np.int32)
    want = pe["jal"].fetch_pairs(pe["jal"].dispatch_pairs(codes, lens))
    tal = _port(pe, CAPS)
    got = tal.fetch_pairs(tal.dispatch_pairs(codes, lens))
    assert got[0] == want[0] == "raw"
    np.testing.assert_array_equal(got[1], want[1])     # codes
    np.testing.assert_array_equal(got[2], want[2])     # lens
    assert got[3] and got[3].keys() == want[3].keys()  # pm_regs
    for i in want[3]:    # AlnReg of two module copies: compare fields
        assert [vars(r) for r in got[3][i]] == [vars(r) for r in want[3][i]]
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))  # packed
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))  # meta
    assert got[6] == want[6] == {}                     # ov_regs
    assert tal.emf_hits == len(want[3])


def _primary_flags(sam):
    out = []
    for ln in sam.splitlines():
        t = ln.split("\t")
        if not int(t[1]) & 0x900:
            out.append((t[0], int(t[1]), t[6]))
    return out


def test_pe_run_alignment_sam_equal_to_jax(pe):
    tal = _port(pe, CAPS)
    sam = io.StringIO()
    n = t_run(tal, [pe["fq1"], pe["fq2"]], sam, batch_reads=B, paired=True)
    assert n == 2 * N_PAIRS
    assert sam.getvalue() == pe["sam"]
    assert tal.batches == 3 and tal.emf_hits > 0
    assert tal.overflow_retried == 0
    prim = _primary_flags(sam.getvalue())
    assert [nm for nm, _, _ in prim] == [f"p{i // 2}"
                                        for i in range(2 * N_PAIRS)]
    assert all(f & (0x40 if i % 2 == 0 else 0x80)
               for i, (_, f, _) in enumerate(prim))
    # mates without a seed (pairs 3, 11, ...) are placed by rescue
    assert any(not prim[2 * p + 1][1] & 0x4 for p in range(3, N_PAIRS, 8))
    # mates on another contig name it in RNEXT
    assert any(rn not in ("=", "*") for _, _, rn in prim)


@pytest.mark.parametrize("mode", ["two_files", "interleaved", "fixed_insert"])
def test_pe_cli_sam_equal_to_jax(pe, mode, tmp_path):
    """The port's CLI `mem --device cpu` at its default capacities."""
    out = tmp_path / "out.sam"
    fqs = [pe["fqi"], "-p"] if mode == "interleaved" else [pe["fq1"],
                                                          pe["fq2"]]
    extra = ["-I", "300,30"] if mode == "fixed_insert" else []
    al = cli.mem([pe["prefix"], *fqs, "-o", str(out), "--device", "cpu",
                  "--batch-reads", str(B), *extra])
    with open(out) as f:
        body = "".join(ln for ln in f if not ln.startswith("@"))
    assert body == (pe["sam_fixed"] if mode == "fixed_insert" else pe["sam"])
    assert al.emf_hits > 0 and al.batches == 3
    if mode == "fixed_insert":
        assert [vars(s) for s in al.pes] == [vars(s) for s in _pes_300_30()]


def test_pe_overflow_retry_lossless(pe):
    """Tiny capacities truncate reads; the retry ladder restores them and
    the SAM equals the roomy run's byte for byte."""
    def run(caps):
        al = _port(pe, caps)
        al.RETRY_BATCH = 8
        sam = io.StringIO()
        t_run(al, [pe["fq1"], pe["fq2"]], sam, batch_reads=B, paired=True)
        return sam.getvalue(), al

    got, tiny = run(TINY)
    want, roomy = run(ROOMY)
    assert tiny.overflow_retried > 0
    assert roomy.overflow_retried == 0
    assert got == want


@pytest.mark.parametrize("sam_ctx", [True, False], ids=["sam_ctx", "records"])
def test_pe_python_path_equal_to_jax(pe, monkeypatch, sam_ctx):
    """The native PE stage declines every batch on both sides
    (``finalize_pe_rows`` returns None): the port takes the Python PE
    path as the JAX package does, with the same SAM bytes. Without
    ``sam_ctx`` (``-C``) the records go through the Python SAM writer."""
    from bwa_mem_scale_tpu.pipeline import native_finalize as j_nf
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    from bwa_mem_scale_tpu_torch.pipeline import native_finalize as t_nf
    from bwa_mem_scale_tpu_torch.pipeline import pe as t_pe
    declined = []

    def decline(*a, **k):
        declined.append(1)
        return None

    monkeypatch.setattr(j_nf, "finalize_pe_rows", decline)
    monkeypatch.setattr(t_nf, "finalize_pe_rows", decline)
    rescued = []
    run_rescue = t_pe.run_rescue_jobs
    monkeypatch.setattr(t_pe, "run_rescue_jobs",
                        lambda opt, jobs, device: rescued.append(len(jobs))
                        or run_rescue(opt, jobs, device))
    jal = pe["jal"]
    monkeypatch.setattr(jal.opt, "copy_comment", not sam_ctx)
    want = io.StringIO()
    j_run(jal, [pe["fq1"], pe["fq2"]], want, batch_reads=B, paired=True)
    n_jax = len(declined)
    tal = _port(pe, CAPS)
    tal.opt.copy_comment = not sam_ctx
    got = io.StringIO()
    n = t_run(tal, [pe["fq1"], pe["fq2"]], got, batch_reads=B, paired=True)
    assert n == 2 * N_PAIRS
    assert n_jax == 3 and len(declined) == 6
    assert sum(rescued) > 0
    assert got.getvalue() == want.getvalue()
    assert got.getvalue() == pe["sam"]


@pytest.mark.cuda
def test_pe_mem_on_card_equals_cpu(tmp_path):
    """PE `mem --device cuda` (the BSW and SMEM kernels; EMF hits keep
    their rows at length 0) writes the `--device cpu` run's SAM bytes,
    on a genome, index and EMF table the port builds itself."""
    from bwa_mem_scale_tpu_torch.models.aligner import demo_genome
    from bwa_mem_scale_tpu_torch.ops.smem_cuda import one_pos_machine_cuda
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    bns = demo_genome(30000, seed=23, n_contigs=3)
    with open(tmp_path / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    codes = _pairs(bns, N_PAIRS, seed=6)
    ids = range(2 * N_PAIRS)
    fqs = [_write_fastq(tmp_path / f"r{m + 1}.fq", codes, ids[m::2])
           for m in (0, 1)]
    g = str(tmp_path / "g")
    assert cli.main(["index", g + ".fa", "-p", g]) == 0
    assert cli.main(["perfect-index", g, "-l", str(L)]) == 0
    body = {}
    for device in ("cpu", "cuda"):
        before = one_pos_machine_cuda.launches
        al = cli.mem([g, *fqs, "-o", str(tmp_path / f"{device}.sam"),
                      "--device", device, "--batch-reads", str(B)])
        assert (one_pos_machine_cuda.launches > before) == (device == "cuda")
        assert al.emf_hits > 0
        body[device] = [ln for ln in open(tmp_path / f"{device}.sam")
                        if not ln.startswith("@PG")]
    assert body["cuda"] == body["cpu"]
    assert sum(1 for ln in body["cpu"] if not ln.startswith("@")) \
        == 2 * N_PAIRS
