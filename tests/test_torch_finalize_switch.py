"""The Python finalize path under ``BWA_TPU_NO_NATIVE_FINALIZE``, port vs
JAX on the CPU, exact (SAM bytes and records):

- SE ``mem`` with an EMF table: the port's CLI at its default capacities,
  and the port at tiny capacities (the retry ladder inline, before the
  next dispatch), each byte-equal to the JAX package's SAM body under the
  same switch; again with ``BWA_TPU_NO_NATIVE_KSWG`` also set (the CIGAR
  DP on the device, here its plain version);
- PE ``mem`` with rescued mates: the same four runs against the JAX
  package's PE SAM under the same switches;
- ``GpuAligner.align_and_finalize`` under the switch (the device EMF
  probe, here the CPU) equal to ``TpuAligner.align_and_finalize`` under
  the switch on every field ``tests/test_native_finalize.py`` compares;
- without the switch, a native finalizer that cannot load raises
  ``RuntimeError`` before any read is aligned.

Under the switch the port never loads the native finalizer: each run
here replaces its loader by one that raises. Each test sets the switch
for the JAX side and the port alike, and restores it after.
"""

import io

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.index.perfect import (
    load_perfect_table as t_load_perfect)
from bwa_mem_scale_tpu_torch.ops import kswg_cuda
from bwa_mem_scale_tpu_torch.pipeline import native_finalize as t_nf
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run

import torch_pe_switch as pe_data
from test_native_finalize import _key
from test_torch_int64 import _reads, _write_fastq

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

B, L = 32, 101
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)
FIN, KSWG = "BWA_TPU_NO_NATIVE_FINALIZE", "BWA_TPU_NO_NATIVE_KSWG"
ENVS = {"finalize": {FIN: "1"}, "finalize_kswg": {FIN: "1", KSWG: "1"}}


def _jax_sams(jal, fqs, paired):
    """The JAX package's SAM under each of ENVS, from one aligner."""
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    sams = {}
    for name, env in ENVS.items():
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            j_run(jal, fqs, out, batch_reads=B, paired=paired)
        sams[name] = out.getvalue()
    return sams


@pytest.fixture(scope="module")
def se(small_index, tmp_path_factory):
    """80 reads (errors, chimeras, random reads, N bases, exact reverse
    copies: EMF hits) on the small genome, its index and EMF table saved
    by the JAX package, and the JAX SAM under each switch set."""
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    tmp = tmp_path_factory.mktemp("se")
    codes = _reads(small_index.bns.seq, 80, seed=5)
    fq = _write_fastq(tmp / "r.fq", codes)
    emf = build_perfect_table(small_index, seed_len=L)
    prefix = str(tmp / "g")
    save_index(small_index, prefix)
    save_perfect_table(emf, prefix)
    jal = TpuAligner(small_index, MemOptions(),
                     JCfg(seed_engine="onehot", **CAPS), emf=emf)
    return dict(jal=jal, codes=codes, fq=fq, prefix=prefix,
                sam=_jax_sams(jal, [fq], paired=False))


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    """tests/torch_pe_switch.py's 48 pairs (rescued mates, random mates,
    mates on another contig, N bases) on its three-contig genome, and the
    JAX PE SAM under each switch set."""
    from conftest import make_genome
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    tmp = tmp_path_factory.mktemp("pe")
    idx = build_index(make_genome(30000, seed=23, n_contigs=3))
    emf = build_perfect_table(idx, seed_len=L)
    codes = pe_data.pairs(idx.bns, pe_data.N_PAIRS, seed=6)
    ids = range(2 * pe_data.N_PAIRS)
    fq1 = pe_data.write_fastq(tmp / "r1.fq", codes, ids[0::2])
    fq2 = pe_data.write_fastq(tmp / "r2.fq", codes, ids[1::2])
    prefix = str(tmp / "g")
    save_index(idx, prefix)
    save_perfect_table(emf, prefix)
    jal = TpuAligner(idx, MemOptions(), JCfg(seed_engine="onehot", **CAPS),
                     emf=emf)
    return dict(fq1=fq1, fq2=fq2, prefix=prefix,
                sam=_jax_sams(jal, [fq1, fq2], paired=True))


def _unloadable():
    raise OSError("native/libfinalize.so: cannot open shared object file")


def _switch(monkeypatch, env):
    """Set `env` for the port, make the native finalizer unloadable, and
    count the device CIGAR DP's calls."""
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(t_nf, "_load", _unloadable)
    calls = []
    fn = kswg_cuda.ksw_global_batch_cuda
    monkeypatch.setattr(kswg_cuda, "ksw_global_batch_cuda",
                        lambda *a: calls.append(a[0].shape) or fn(*a))
    return calls


def _body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


def _port_run(prefix, fqs, caps, tmp_path, paired):
    """The port's SAM body: the CLI at its default capacities, or
    run_alignment at tiny ones (the retry ladder)."""
    if caps == "default":
        out = tmp_path / "out.sam"
        al = cli.mem([prefix, *fqs, "-o", str(out), "--device", "cpu",
                      "--batch-reads", str(B)])
        return _body(out), al
    al = GpuAligner(t_load(prefix), "cpu", TOpt(),
                    TCfg(seed_engine="onehot", **TINY),
                    emf=t_load_perfect(f"{prefix}.emf{L}.npz"))
    al.RETRY_BATCH = 8
    sam = io.StringIO()
    t_run(al, fqs, sam, batch_reads=B, paired=paired)
    return sam.getvalue(), al


@pytest.mark.parametrize("caps", ["default", "tiny"])
@pytest.mark.parametrize("env", list(ENVS))
def test_se_mem_under_switch_equal_to_jax(se, env, caps, monkeypatch,
                                          tmp_path):
    """SE: the Aln-mode stream (inline retries at tiny capacities), the
    Python record path and aln_to_sam_line, byte-equal to the JAX SAM;
    the CIGARs through the device DP exactly when _KSWG is set."""
    calls = _switch(monkeypatch, env)
    body, al = _port_run(se["prefix"], [se["fq"]], caps, tmp_path, False)
    assert body == se["sam"][env]
    assert al.emf_hits > 0
    assert (al.overflow_retried > 0) == (caps == "tiny")
    assert bool(calls) == (KSWG in ENVS[env])


@pytest.mark.parametrize("caps", ["default", "tiny"])
@pytest.mark.parametrize("env", list(ENVS))
def test_pe_mem_under_switch_equal_to_jax(pe, env, caps, monkeypatch,
                                          tmp_path):
    """PE: every batch down the Python PE path, records through
    aln_to_sam_line, byte-equal to the JAX PE SAM under the switches."""
    calls = _switch(monkeypatch, env)
    rescued = []
    from bwa_mem_scale_tpu_torch.pipeline import pe as t_pe
    run_rescue = t_pe.run_rescue_jobs
    monkeypatch.setattr(t_pe, "run_rescue_jobs",
                        lambda opt, jobs, device: rescued.append(len(jobs))
                        or run_rescue(opt, jobs, device))
    body, al = _port_run(pe["prefix"], [pe["fq1"], pe["fq2"]], caps,
                         tmp_path, True)
    assert body == pe["sam"][env]
    assert sum(rescued) > 0
    assert (al.overflow_retried > 0) == (caps == "tiny")
    assert bool(calls) == (KSWG in ENVS[env])


@pytest.mark.parametrize("caps", ["same", "tiny"])
def test_align_and_finalize_under_switch_equal_to_jax(se, caps,
                                                      monkeypatch):
    """The in-process SE API (device EMF probe, then the two-stage Python
    route) under the switch: the JAX aligner's records under the switch,
    field for field."""
    codes = se["codes"][:B].copy()
    lens = np.full(B, L, np.int32)
    lens[3] = 0                                  # a dead lane
    monkeypatch.setenv(FIN, "1")
    want = se["jal"].align_and_finalize(codes, lens, id_offset=77)
    _switch(monkeypatch, "finalize")
    tal = GpuAligner(t_load(se["prefix"]), "cpu", TOpt(),
                     TCfg(seed_engine="onehot",
                          **(CAPS if caps == "same" else TINY)),
                     emf=t_load_perfect(f"{se['prefix']}.emf{L}.npz"))
    got = tal.align_and_finalize(codes, lens, id_offset=77)
    assert _key(got) == _key(want)
    assert tal.emf_hits > 0 and tal.demf is not None
    assert (tal.overflow_retried > 0) == (caps == "tiny")


def test_unloadable_library_without_switch_raises(se, monkeypatch,
                                                  tmp_path):
    """Without the switch a native finalizer that fails to load or build
    stops the run: RuntimeError from the aligner and from `mem`, before
    the output is opened."""
    monkeypatch.delenv(FIN, raising=False)
    monkeypatch.setattr(t_nf, "_load", _unloadable)
    with pytest.raises(RuntimeError, match="libfinalize"):
        GpuAligner(t_load(se["prefix"]), "cpu")
    out = tmp_path / "out.sam"
    with pytest.raises(RuntimeError, match="libfinalize"):
        cli.mem([se["prefix"], se["fq"], "-o", str(out), "--device", "cpu",
                 "--batch-reads", str(B)])
    assert not out.exists()
