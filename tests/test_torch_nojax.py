"""The port runs without JAX: `index`, `perfect-index` and
`mem --device cpu`, and the import of the probe entry points, in a fresh
interpreter in which importing `jax`, `jaxlib` or the JAX package
`bwa_mem_scale_tpu` raises."""

import os
import subprocess
import sys
import textwrap

from bwa_mem_scale_tpu.index.bntseq import decode_bases

from conftest import make_genome, sample_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        BLOCKED = ("jax", "jaxlib", "bwa_mem_scale_tpu")

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    from bwa_mem_scale_tpu_torch.cli import main
    for argv in (["index", "g.fa", "-p", "g"],
                 ["perfect-index", "g", "-l", "60"],
                 ["mem", "g", "r.fq", "-o", "out.sam", "--device", "cpu",
                  "--batch-reads", "16"]):
        assert main(argv) == 0, argv
    import bwa_mem_scale_tpu_torch.tools.probe_cuda
    import bwa_mem_scale_tpu_torch.tools.probe_cuda_rates
    leaked = [m for m in sys.modules
              if m.split(".")[0] in Block.BLOCKED]
    assert not leaked, leaked
    print("NOJAX-OK")
""")


def test_port_cli_runs_with_jax_blocked(tmp_path):
    bns = make_genome(12000, seed=9, n_contigs=2)
    with open(tmp_path / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    reads = sample_reads(bns, 40, 60, seed=2, err_rate=0.02)
    with open(tmp_path / "r.fq", "w") as f:
        for i, (c, _, _) in enumerate(reads):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX-OK" in proc.stdout
    body = [ln for ln in open(tmp_path / "out.sam") if not ln.startswith("@")]
    names = [ln.split("\t", 1)[0] for ln in body
             if not int(ln.split("\t")[1]) & 0x900]
    assert names == [f"r{i}" for i in range(40)]
    mapped = sum(1 for ln in body if not int(ln.split("\t")[1]) & 0x4)
    assert mapped >= 36
