"""The port's in-memory index store (``bwa_mem_scale_tpu_torch/store.py``,
the reference's src/bwa_shm.cpp) on the CPU:

- the three tests of ``tests/test_store.py`` against the port's store:
  the MEMSCALE budget policy, a stage-attach round trip whose aligner
  (built from the attached, read-only pieces) gives the regions of one
  built from the files, and a stale store refused;
- a store staged by either package attaches in the other with equal
  arrays;
- ``load-shm`` -> ``mem --device cpu`` -> ``remove-shm`` through the
  port's CLI into a temporary store directory: ``mem`` attaches, its SAM
  body is byte-equal to ``mem`` from the files, and ``remove-shm``
  leaves no store;
- a full-SA index with its ERT, staged by either package: the ``ert``
  piece attaches in the other with equal arrays, and the port's ``mem``
  attached to it seeds with the trie and writes the SAM body of ``mem``
  from the files.
"""

import os

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu import store as jstore
from bwa_mem_scale_tpu.index.artifacts import save_index
from bwa_mem_scale_tpu.index.bntseq import decode_bases
from bwa_mem_scale_tpu.index.build import build_index
from bwa_mem_scale_tpu_torch import cli, store
from bwa_mem_scale_tpu_torch.config import MemOptions
from bwa_mem_scale_tpu_torch.index.artifacts import load_index
from bwa_mem_scale_tpu_torch.index.perfect import (build_perfect_table,
                                                   save_perfect_table)
from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table, save_fma
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig)

from conftest import make_genome, sample_reads

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A 20 kbp index saved by the JAX package, the port's FMA (K = 4) and
    EMF (seed 40) tables beside it, and a store directory."""
    d = tmp_path_factory.mktemp("idx")
    prefix = str(d / "g")
    save_index(build_index(make_genome(20000, seed=8)), prefix)
    idx = load_index(prefix)
    save_fma(build_fma_table(DeviceFMIndex.from_host(idx, "cpu"), K=4,
                             chunk=256), prefix)
    save_perfect_table(build_perfect_table(idx, seed_len=40), prefix)
    return prefix, idx, str(d / "store")


def test_budget_policy(staged):
    prefix, idx, sdir = staged
    sizes = {k: os.stat(v).st_size
             for k, v in store.discover_artifacts(prefix).items()}
    assert set(store.plan_budget(prefix, None)) == {"index", "fma", "emf"}
    gb = (sizes["index"] + 10) / (1 << 30)
    assert store.plan_budget(prefix, gb) == ["index"]
    gb = (sizes["index"] + sizes["fma"] + 10) / (1 << 30)
    assert set(store.plan_budget(prefix, gb)) == {"index", "fma"}
    with pytest.raises(ValueError):
        store.plan_budget(prefix, sizes["index"] / 4 / (1 << 30))


def test_stage_attach_roundtrip(staged):
    prefix, idx, sdir = staged
    store.stage(prefix, None, store_dir=sdir, log=lambda m: None)
    att = store.attach(prefix, store_dir=sdir)
    assert att is not None and att.has("fma") and att.has("emf")
    idx2 = store.index_from_store(att.pieces["index"])
    np.testing.assert_array_equal(idx2.cp_mask, idx.cp_mask)
    np.testing.assert_array_equal(idx2.sa_samples, idx.sa_samples)
    assert not idx2.sa_samples.flags.writeable       # a map of the store
    assert idx2.bns.l_pac == idx.bns.l_pac
    assert idx2.bns.anns[0].name == idx.bns.anns[0].name
    fma = store.fma_from_store(att.pieces["fma"])
    assert fma.K == 4 and fma.ladder_s.shape[0] == 4 ** 4
    emf = store.emf_from_store(att.pieces["emf"])
    assert emf.seed_len == 40

    # an aligner built from the store gives the same regions, at both
    # position layouts (the int64 one keeps the mapped arrays' dtype)
    cfg = PipelineConfig(max_coords=64, max_chains=8, max_seeds_per_chain=8,
                         max_regs=8)
    reads = sample_reads(idx.bns, 8, 40, seed=2, err_rate=0.02)
    codes = np.stack([r[0] for r in reads]).astype(np.int32)
    lens = np.full(8, 40, dtype=np.int32)
    a1 = GpuAligner(idx, "cpu", MemOptions(), cfg)
    a2 = GpuAligner(idx2, "cpu", MemOptions(), cfg, fma=fma, emf=emf)
    r1 = a1.align_batch(codes, lens)
    r2 = a2.align_batch(codes, lens)
    for x, y in zip(r1, r2):
        assert [(r.rb, r.re, r.score) for r in x] == \
            [(r.rb, r.re, r.score) for r in y]
    assert any(r1)
    a2.fmi = DeviceFMIndex.from_host(idx2, "cpu", force_int64=True)
    a2.dfma = fma.to_device(torch.int64)
    r3 = a2.align_batch(codes, lens)
    assert [[(r.rb, r.re, r.score) for r in x] for x in r3] == \
        [[(r.rb, r.re, r.score) for r in x] for x in r1]
    # the device EMF probe on the attached table's read-only maps
    pm = a2.emf_filter(codes, lens)
    assert pm is not None and (pm["code"] >= 2).all()


def test_stale_store_rejected(staged):
    prefix, idx, sdir = staged
    store.stage(prefix, None, store_dir=sdir, log=lambda m: None)
    os.utime(prefix + ".tpuidx.npz")
    assert store.attach(prefix, store_dir=sdir) is None
    assert store.remove(prefix, store_dir=sdir)
    assert store.attach(prefix, store_dir=sdir) is None


@pytest.mark.parametrize("stager", ["jax", "port"])
def test_store_attaches_across_packages(staged, tmp_path, stager):
    prefix, idx, _ = staged
    sdir = str(tmp_path / "store")
    src, dst = (jstore, store) if stager == "jax" else (store, jstore)
    root = src.stage(prefix, None, store_dir=sdir, log=lambda m: None)
    assert root == os.path.join(sdir, store._store_name(prefix))
    a = store.attach(prefix, store_dir=sdir)
    b = jstore.attach(prefix, store_dir=sdir)
    assert a is not None and b is not None and a.root == b.root
    assert set(a.pieces) == set(b.pieces) == {"index", "fma", "emf"}
    for kind in a.pieces:
        assert set(a.pieces[kind]) == set(b.pieces[kind])
        for name, arr in a.pieces[kind].items():
            np.testing.assert_array_equal(arr, b.pieces[kind][name])
            assert arr.dtype == b.pieces[kind][name].dtype
    i1 = store.index_from_store(a.pieces["index"])
    i2 = jstore.index_from_store(b.pieces["index"])
    for f in ("count", "cp_count", "cp_mask", "sa_samples", "ref_string"):
        np.testing.assert_array_equal(getattr(i1, f), getattr(i2, f))
    e1 = store.emf_from_store(a.pieces["emf"])
    e2 = jstore.emf_from_store(b.pieces["emf"])
    for f in ("loc", "fp", "cnt", "mlidx", "ml_off", "ml_locs"):
        np.testing.assert_array_equal(getattr(e1, f), getattr(e2, f))
    assert dst.remove(prefix, store_dir=sdir)
    assert src.attach(prefix, store_dir=sdir) is None


def _body(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


def test_load_shm_mem_remove_shm(tmp_path, monkeypatch, capfd):
    bns = make_genome(12000, seed=9, n_contigs=2)
    with open(tmp_path / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    reads = sample_reads(bns, 40, 60, seed=2, err_rate=0.02)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i, (c, _, _) in enumerate(reads):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    g = str(tmp_path / "g")
    monkeypatch.setattr(store, "DEFAULT_STORE_DIR", str(tmp_path / "shm"))
    mem = ["mem", g, fq, "--device", "cpu", "--batch-reads", "16"]
    assert cli.main(["index", str(tmp_path / "g.fa"), "-p", g]) == 0
    assert cli.main(["perfect-index", g, "-l", "60"]) == 0
    assert cli.main(mem + ["-o", str(tmp_path / "files.sam")]) == 0
    assert "attached" not in capfd.readouterr().err
    assert cli.main(["load-shm", g]) == 0
    err = capfd.readouterr().err
    root = os.path.join(str(tmp_path / "shm"), store._store_name(g))
    assert f"* index store ready at {root}" in err
    assert "* staged emf" in err
    assert cli.main(mem + ["-o", str(tmp_path / "shm.sam")]) == 0
    err = capfd.readouterr().err
    assert f"* attached in-memory index store at {root}" in err
    assert "EMF perfect-match table loaded (seed_len=60)" in err
    assert _body(tmp_path / "shm.sam") == _body(tmp_path / "files.sam")
    assert len(_body(tmp_path / "shm.sam")) >= 40
    assert cli.main(["remove-shm", g]) == 0
    assert "* removed" in capfd.readouterr().err
    assert not os.path.exists(root)
    assert cli.main(["remove-shm", g]) == 0
    assert "* no store found" in capfd.readouterr().err


@pytest.mark.parametrize("stager", ["jax", "port"])
def test_store_with_ert_attaches_across_packages(tmp_path, monkeypatch,
                                                  capfd, stager):
    from bwa_mem_scale_tpu.index.ert import build_ert, save_ert
    bns = make_genome(12000, seed=9, n_contigs=2)
    g = str(tmp_path / "g")
    jidx = build_index(bns, sa_compx=0)
    save_index(jidx, g)
    save_ert(build_ert(jidx.ref_string, jidx.sa_samples, K=6), g)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i, (c, _, _) in enumerate(sample_reads(bns, 40, 60, seed=2,
                                                   err_rate=0.02)):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    sdir = str(tmp_path / "shm")
    src = jstore if stager == "jax" else store
    src.stage(g, None, store_dir=sdir, log=lambda m: None)
    a = store.attach(g, store_dir=sdir)
    b = jstore.attach(g, store_dir=sdir)
    assert set(a.pieces) == set(b.pieces) == {"index", "ert"}
    e1 = store.ert_from_store(a.pieces["ert"])
    e2 = jstore.ert_from_store(b.pieces["ert"])
    assert (e1.K, e1.max_depth, e1.n_nodes) == (e2.K, e2.max_depth,
                                                 e2.n_nodes)
    for f in ("kmer_lo", "kmer_cnt", "kmer_ptr", "node_lo", "node_cnt",
              "child_ptr", "root_children"):
        np.testing.assert_array_equal(getattr(e1, f), getattr(e2, f))
    mem = ["mem", g, fq, "--device", "cpu", "--batch-reads", "16"]
    assert cli.main(mem + ["-o", str(tmp_path / "files.sam")]) == 0
    err = capfd.readouterr().err
    assert "attached" not in err and "* ERT index loaded (K=6, " in err
    monkeypatch.setattr(store, "DEFAULT_STORE_DIR", sdir)
    assert cli.main(mem + ["-o", str(tmp_path / "shm.sam")]) == 0
    err = capfd.readouterr().err
    assert "* attached in-memory index store at " in err
    assert "* ERT index loaded (K=6, " in err
    assert _body(tmp_path / "shm.sam") == _body(tmp_path / "files.sam")
    assert len(_body(tmp_path / "shm.sam")) >= 40
    assert store.remove(g, store_dir=sdir)
