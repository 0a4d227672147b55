"""Several hosts, port vs JAX on the CPU, exact (SAM bytes):

- ``run_alignment(host_shard=(3, i))``, SE and PE: each host's part
  byte-equal to the JAX package's part, the union of the parts equal to
  the single-host run line for line, each host holding only its batches
  (batch k on host k mod 3), global read ids kept;
- the guards (chunk_bp batching, a checkpoint, a host id out of range);
- ``mem --num-hosts 2 --host-id i`` through the CLI as two subprocesses,
  without and with ``--coordinator localhost:<port>`` (a torch.distributed
  gloo group, a barrier at the end): the two parts' union equal to the
  single-host body; the CLI's refusals;
- ``tools/multiproc_dp.py``: two gloo processes, each its half of a
  global batch on a local 2-shard mesh, against one process;
- ``tools/multichip.py`` on a 4-shard CPU mesh.
"""

import io
import os
import socket
import subprocess
import sys

import pytest
import torch

from conftest import make_genome, sample_reads

from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "ACGTN"
L = 48
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8, max_regs=8)


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, codes in enumerate(reads):
            s = "".join(BASES[c] for c in codes)
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return str(path)


@pytest.fixture(scope="module")
def mh(tmp_path_factory):
    """tests/test_multihost.py's data (a 15 kbp genome, 46 SE and 48
    interleaved PE reads of 48 bp at 2% errors) and the JAX package's
    single-host runs and 3-host parts."""
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment
    d = tmp_path_factory.mktemp("mh")
    idx = build_index(make_genome(15000, seed=77))
    prefix = str(d / "g")
    save_index(idx, prefix)
    jal = TpuAligner(idx, MemOptions(), PipelineConfig(**CAPS))
    out = dict(prefix=prefix, tidx=t_load(prefix), d=d)
    for paired in (False, True):
        n = 48 if paired else 46   # not a multiple of the batch for SE
        reads = [r[0] for r in sample_reads(idx.bns, n, L, seed=9,
                                            err_rate=0.02)]
        fq = _write_fastq(d / f"mh_{paired}.fq", reads)
        runs = {}
        for shard in (None, (3, 0), (3, 1), (3, 2)):
            buf = io.StringIO()
            run_alignment(jal, [fq], buf, batch_reads=8, paired=paired,
                          host_shard=shard)
            runs[shard] = buf.getvalue()
        out[paired] = dict(fq=fq, runs=runs)
    return out


def _port_run(mh, paired, shard):
    al = GpuAligner(mh["tidx"], "cpu", TOpt(), TCfg(**CAPS))
    buf = io.StringIO()
    t_run(al, [mh[paired]["fq"]], buf, batch_reads=8, paired=paired,
          host_shard=shard)
    return buf.getvalue()


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_host_shard_parts_equal_to_jax(mh, paired):
    full = _port_run(mh, paired, None)
    assert full == mh[paired]["runs"][None]
    parts = [_port_run(mh, paired, (3, i)) for i in range(3)]
    for i, part in enumerate(parts):
        assert part == mh[paired]["runs"][(3, i)]
        names = {int(ln.split("\t")[0][1:]) for ln in part.splitlines()}
        assert names and all((rid // 8) % 3 == i for rid in names)
    # the union, in the single-host run's order
    by_name = {}
    for part in parts:
        for ln in part.splitlines():
            by_name.setdefault(ln.split("\t")[0], []).append(ln)
    merged = [by_name[ln.split("\t")[0]].pop(0)
              for ln in full.splitlines()]
    assert merged == full.splitlines()
    assert not any(by_name.values())


def test_host_shard_guards(mh):
    al = GpuAligner(mh["tidx"], "cpu", TOpt(), TCfg(**CAPS))
    with pytest.raises(ValueError, match="chunk_bp"):
        t_run(al, ["x.fq"], io.StringIO(), chunk_bp=1000, host_shard=(2, 0))
    with pytest.raises(ValueError, match="checkpoint"):
        t_run(al, ["x.fq"], io.StringIO(), checkpoint_path="c.json",
              host_shard=(2, 0))
    with pytest.raises(ValueError, match="out of range"):
        t_run(al, ["x.fq"], io.StringIO(), host_shard=(2, 2))


def test_cli_refusals(mh, tmp_path):
    base = [mh["prefix"], mh[False]["fq"], "-o", str(tmp_path / "x.sam"),
            "--device", "cpu", "--num-hosts", "2"]
    with pytest.raises(SystemExit, match=r"--host-id must be in \[0, "):
        cli.mem(base + ["--host-id", "2"])
    with pytest.raises(SystemExit, match="--checkpoint is per-host-stream"):
        cli.mem(base + ["--checkpoint", str(tmp_path / "c.json")])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _body(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.mark.parametrize("coordinator", [False, True],
                         ids=["plain", "coordinator"])
def test_cli_two_hosts(mh, tmp_path, coordinator):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    extra = (["--coordinator", f"localhost:{_free_port()}"] if coordinator
             else [])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwa_mem_scale_tpu_torch.cli", "mem",
         mh["prefix"], mh[True]["fq"], "-p", "-o", str(tmp_path / f"{i}.sam"),
         "--device", "cpu", "--batch-reads", "8", "--num-hosts", "2",
         "--host-id", str(i), *extra], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    for i, (_, err) in enumerate(outs):
        assert f"* multi-host shard: batches {i} mod 2" in err
        assert ((f"* torch.distributed: host {i}/2 via localhost:" in err)
                == coordinator)
    full = mh[True]["runs"][None].splitlines(keepends=True)
    parts = [_body(tmp_path / f"{i}.sam") for i in range(2)]
    assert sorted(parts[0] + parts[1]) == sorted(full)
    assert all(parts)


def test_multiproc_dp_tool():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "bwa_mem_scale_tpu_torch.tools.multiproc_dp"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "proc 0: MATCH (16 reads" in r.stdout
    assert r.stdout.rstrip().endswith("MULTIPROCESS DP TEST PASSED")


def test_multichip_tool_on_cpu_mesh():
    from bwa_mem_scale_tpu_torch.parallel.mesh import Mesh
    from bwa_mem_scale_tpu_torch.tools.multichip import dryrun_multichip
    line = dryrun_multichip(Mesh(["cpu"] * 4))
    assert line.startswith("dryrun_multichip(4): ")
    assert line.endswith("records match single-device OK")
