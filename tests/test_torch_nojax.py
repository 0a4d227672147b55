"""The port runs without JAX: `index`, `perfect-index`, single-end and
paired-end `mem --device cpu` (pairs with `-I`, through the native PE
stage and through the Python PE path, with equal SAM), single-end and
paired-end `mem -W 10` on 250-300 bp reads (the long-read seed-SW
filter, ops/seedsw.py), `smem-table` and
SE and PE `mem --seed-engine sweep` with its table and SE and PE `mem
--seed-engine readlane` (SAM equal to the one-hot engine's), `ert-index` on a full-SA index and SE and PE `mem`
seeding with the ERT (SAM equal to the one-hot engine's), `kstep-table -k 3`
and SE and PE `mem` with the trigram table (SAM equal to the run without
it), the in-process SE API (`align_reads_to_sam`, the EMF
table probed on the device, here the CPU), SE and PE `mem --devices`
on a CPU mesh and SE `mem --num-hosts 2` (SAM and parts equal to the
one-device, one-host run), PE `mem` under `BWA_TPU_NO_NATIVE_PE`,
`BWA_TPU_NO_NATIVE_KSWG` and `BWA_TPU_NO_NATIVE_KSWA` (the device DP
loops' plain versions; records placed as without them), SE and PE `mem`
under `BWA_TPU_NO_NATIVE_FINALIZE` (the Python record path and SAM
writer; records placed as without it), `load-shm`, a
`mem` that
attaches to the staged store (SAM equal to `mem` from the files) and
`remove-shm`, the import of the
probe entry points and `chip_smoke.py`'s input helpers, in a fresh
interpreter in which importing `jax`, `jaxlib` or the JAX package
`bwa_mem_scale_tpu` raises. No module loaded there comes from a file
of the JAX package's directory, whatever name it was imported under."""

import os
import subprocess
import sys
import textwrap

import numpy as np

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
    import os
    REPO = sys.argv[1]
    sys.path.insert(0, REPO)
    from bwa_mem_scale_tpu_torch.cli import main
    for argv in (["index", "g.fa", "-p", "g"],
                 ["perfect-index", "g", "-l", "60"],
                 ["mem", "g", "r.fq", "-o", "out.sam", "--device", "cpu",
                  "--batch-reads", "16"],
                 ["mem", "g", "r1.fq", "r2.fq", "-o", "pe.sam", "--device",
                  "cpu", "--batch-reads", "16", "-I", "200,20"],
                 ["smem-table", "g", "-k", "5", "--device", "cpu"],
                 ["mem", "g", "r.fq", "-o", "sweep.sam", "--device", "cpu",
                  "--batch-reads", "16", "--seed-engine", "sweep"],
                 ["mem", "g", "r1.fq", "r2.fq", "-o", "pe_sweep.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I", "200,20",
                  "--seed-engine", "sweep"],
                 ["mem", "g", "r.fq", "-o", "readlane.sam", "--device",
                  "cpu", "--batch-reads", "16", "--seed-engine", "readlane"],
                 ["mem", "g", "r1.fq", "r2.fq", "-o", "pe_readlane.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I", "200,20",
                  "--seed-engine", "readlane"],
                 ["mem", "g", "rl.fq", "-o", "long.sam", "--device", "cpu",
                  "--batch-reads", "8", "-W", "10"],
                 ["mem", "g", "rl_1.fq", "rl_2.fq", "-o", "long_pe.sam",
                  "--device", "cpu", "--batch-reads", "8", "-W", "10"],
                 # the ERT on a full-SA index of the same genome
                 ["index", "g.fa", "-p", "e", "-s", "0"],
                 ["perfect-index", "e", "-l", "60"],
                 ["ert-index", "e", "-k", "6"],
                 ["mem", "e", "r.fq", "-o", "ert.sam", "--device", "cpu",
                  "--batch-reads", "16"],
                 ["mem", "e", "r1.fq", "r2.fq", "-o", "pe_ert.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I",
                  "200,20"],
                 # the k-step table under a prefix linked to g's index
                 ["kstep-table", "k", "-k", "3"],
                 ["mem", "k", "r.fq", "-o", "kstep.sam", "--device", "cpu",
                  "--batch-reads", "16"],
                 ["mem", "k", "r1.fq", "r2.fq", "-o", "pe_kstep.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I",
                  "200,20"]):
        if argv[:2] == ["kstep-table", "k"]:
            os.symlink("g.tpuidx.npz", "k.tpuidx.npz")
        assert main(argv) == 0, argv
    # several devices (a CPU mesh) and several hosts (two parts)
    for argv in (["mem", "g", "r.fq", "-o", "mesh.sam", "--device", "cpu",
                  "--batch-reads", "16", "--devices", "4"],
                 ["mem", "g", "r1.fq", "r2.fq", "-o", "pe_mesh.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I", "200,20",
                  "--devices", "2"],
                 ["mem", "g", "r.fq", "-o", "host0.sam", "--device", "cpu",
                  "--batch-reads", "16", "--num-hosts", "2", "--host-id",
                  "0"],
                 ["mem", "g", "r.fq", "-o", "host1.sam", "--device", "cpu",
                  "--batch-reads", "16", "--num-hosts", "2", "--host-id",
                  "1"]):
        assert main(argv) == 0, argv
    # the JAX package's switches: the Python PE path, the device CIGAR DP
    # and the device rescue SW
    SW = ("BWA_TPU_NO_NATIVE_PE", "BWA_TPU_NO_NATIVE_KSWG",
          "BWA_TPU_NO_NATIVE_KSWA")
    os.environ.update({k: "1" for k in SW})
    assert main(["mem", "g", "r1.fq", "r2.fq", "-o", "pe_sw.sam",
                 "--device", "cpu", "--batch-reads", "16", "-I",
                 "200,20"]) == 0
    for k in SW:
        del os.environ[k]
    # the Python finalize path: records and SAM text without the native
    # finalizer, SE and PE
    os.environ["BWA_TPU_NO_NATIVE_FINALIZE"] = "1"
    for argv in (["mem", "g", "r.fq", "-o", "fin.sam", "--device", "cpu",
                  "--batch-reads", "16"],
                 ["mem", "g", "r1.fq", "r2.fq", "-o", "pe_fin.sam",
                  "--device", "cpu", "--batch-reads", "16", "-I",
                  "200,20"]):
        assert main(argv) == 0, argv
    del os.environ["BWA_TPU_NO_NATIVE_FINALIZE"]
    # the Python PE path, as taken when the native PE stage declines
    from bwa_mem_scale_tpu_torch.pipeline import native_finalize
    native_finalize.finalize_pe_rows = lambda *a, **k: None
    assert main(["mem", "g", "r1.fq", "r2.fq", "-o", "pe_py.sam",
                 "--device", "cpu", "--batch-reads", "16", "-I",
                 "200,20"]) == 0
    # the in-process SE API with the device EMF probe
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.perfect import load_perfect_table
    from bwa_mem_scale_tpu_torch.io.fastq import read_fastq
    from bwa_mem_scale_tpu_torch.pipeline.align import GpuAligner
    al = GpuAligner(load_index("g"), "cpu",
                    emf=load_perfect_table("g.emf60.npz"))
    lines = al.align_reads_to_sam(next(read_fastq("r.fq")))
    assert al.emf_hits > 0 and al.demf is not None, al.emf_hits
    with open("api.sam", "w") as f:
        f.writelines(lines)
    # the in-memory index store, in a directory of the test's own
    from bwa_mem_scale_tpu_torch import store
    store.DEFAULT_STORE_DIR = os.path.abspath("shm")
    for argv in (["load-shm", "g"],
                 ["mem", "g", "r.fq", "-o", "shm.sam", "--device", "cpu",
                  "--batch-reads", "16"],
                 ["remove-shm", "g"]):
        assert main(argv) == 0, argv
    assert not os.listdir("shm")
    import bwa_mem_scale_tpu_torch.ops.emf_cuda
    import bwa_mem_scale_tpu_torch.ops.ert_cuda
    import bwa_mem_scale_tpu_torch.ops.kswa_cuda
    import bwa_mem_scale_tpu_torch.ops.kswg_cuda
    import bwa_mem_scale_tpu_torch.tools.multichip
    import bwa_mem_scale_tpu_torch.ops.seedsw_cuda
    import bwa_mem_scale_tpu_torch.ops.smem_cuda
    import bwa_mem_scale_tpu_torch.ops.smem_rl_cuda
    import bwa_mem_scale_tpu_torch.ops.sweep_cuda
    import bwa_mem_scale_tpu_torch.tools.probe_cuda
    import bwa_mem_scale_tpu_torch.tools.probe_cuda_rates
    import numpy as np
    import chip_smoke
    chip_smoke.GENOME_BP, chip_smoke.N_READS = 20000, 8
    os.mkdir("smoke")
    assert len(chip_smoke.write_inputs("smoke")[0]) == 8
    assert chip_smoke.bsw_pairs(np.random.RandomState(0), 16, 20, 40)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in Block.BLOCKED]
    assert not leaked, leaked
    jax_pkg = os.path.join(os.path.realpath(REPO), "bwa_mem_scale_tpu") \
        + os.sep
    foreign = [m for m, mod in list(sys.modules.items())
               if os.path.realpath(getattr(mod, "__file__", None) or "")
               .startswith(jax_pkg)]
    assert not foreign, foreign
    print("NOJAX-OK")
""")


def _write_pairs(bns, tmp_path, n_pairs, L=60, insert=200, name="r"):
    """FR pairs, insert `insert` +- 20, read 2 reverse-complemented, 1%
    substitutions: <name>1.fq and <name>2.fq, mates named p<i>."""
    rng = np.random.RandomState(4)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    with open(tmp_path / f"{name}1.fq", "w") as f1, \
            open(tmp_path / f"{name}2.fq", "w") as f2:
        for p in range(n_pairs):
            a = bns.anns[p % len(bns.anns)]
            frag = int(rng.normal(insert, 20))
            pos = a.offset + rng.randint(0, a.length - frag)
            r1 = bns.seq[pos: pos + L].copy()
            r2 = comp[bns.seq[pos + frag - L: pos + frag][::-1]]
            for f, r in ((f1, r1), (f2, r2)):
                m = rng.rand(L) < 0.01
                r[m] = (r[m] + 1) % 4
                f.write(f"@p{p}\n{decode_bases(r)}\n+\n{'I' * L}\n")


def _primaries(path):
    return [ln.split("\t") for ln in open(path)
            if not ln.startswith("@") and not int(ln.split("\t")[1]) & 0x900]


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
    _write_pairs(bns, tmp_path, 24)
    # the long-read regime at -W 10 (reads of 220 bp and more)
    with open(tmp_path / "rl.fq", "w") as f:
        for i, (c, _, _) in enumerate(sample_reads(bns, 8, 280, seed=3,
                                                   err_rate=0.02)):
            f.write(f"@l{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    _write_pairs(bns, tmp_path, 4, L=250, insert=700, name="rl_")
    # one intra-op thread: the suite runs several test workers at once
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", RUNNER, REPO],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX-OK" in proc.stdout
    prim = _primaries(tmp_path / "out.sam")
    assert [t[0] for t in prim] == [f"r{i}" for i in range(40)]
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 36
    # paired-end: mates in input order, read 1 then read 2, mostly mapped
    prim = _primaries(tmp_path / "pe.sam")
    assert [t[0] for t in prim] == [f"p{i // 2}" for i in range(48)]
    assert all(int(t[1]) & (0x40 if i % 2 == 0 else 0x80)
               for i, t in enumerate(prim))
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 44
    body = {f: [ln for ln in open(tmp_path / f) if not ln.startswith("@PG")]
            for f in ("out.sam", "sweep.sam", "pe.sam", "pe_py.sam",
                      "pe_sweep.sam", "shm.sam", "ert.sam", "pe_ert.sam",
                      "kstep.sam", "pe_kstep.sam", "readlane.sam",
                      "pe_readlane.sam", "mesh.sam", "pe_mesh.sam",
                      "pe_sw.sam", "host0.sam", "host1.sam", "fin.sam",
                      "pe_fin.sam")}
    assert (body["pe.sam"] == body["pe_py.sam"] == body["pe_sweep.sam"]
            == body["pe_ert.sam"] == body["pe_kstep.sam"]
            == body["pe_readlane.sam"] == body["pe_mesh.sam"])
    assert (body["out.sam"] == body["sweep.sam"] == body["shm.sam"]
            == body["ert.sam"] == body["kstep.sam"] == body["readlane.sam"]
            == body["mesh.sam"])
    # the two hosts' parts: batch 0 (r0-r15) and batch 2 on host 0
    parts = [[ln for ln in body[f"host{i}.sam"] if not ln.startswith("@")]
             for i in (0, 1)]
    assert sorted(parts[0] + parts[1]) == sorted(
        ln for ln in body["out.sam"] if not ln.startswith("@"))
    assert all(int(ln.split("\t")[0][1:]) // 16 % 2 == i
               for i in (0, 1) for ln in parts[i])
    # under the switches, every record's placement as without them (the
    # device rescue's score2 may move an XS tag)
    assert ([ln.split("\t")[:9] for ln in body["pe_sw.sam"]]
            == [ln.split("\t")[:9] for ln in body["pe.sam"]])
    for a, b in (("fin.sam", "out.sam"), ("pe_fin.sam", "pe.sam")):
        assert ([ln.split("\t")[:9] for ln in body[a]]
                == [ln.split("\t")[:9] for ln in body[b]]), a
    api = open(tmp_path / "api.sam").read().splitlines()
    assert api == [ln.rstrip("\n") for ln in body["out.sam"]
                   if not ln.startswith("@")]
    prim = _primaries(tmp_path / "long.sam")
    assert [t[0] for t in prim] == [f"l{i}" for i in range(8)]
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 7
    prim = _primaries(tmp_path / "long_pe.sam")
    assert [t[0] for t in prim] == [f"p{i // 2}" for i in range(8)]
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 7
    assert (tmp_path / "g.fma5.npz").exists()
    assert (tmp_path / "e.ert6.npz").exists()
    assert (tmp_path / "k.cp3.npz").exists()
