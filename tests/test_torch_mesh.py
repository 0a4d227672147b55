"""Several devices, port vs JAX on the CPU, exact (arrays and SAM bytes).

The port's mesh (``parallel/mesh.py``) runs its shards on ``cpu`` k times,
the counterpart of the JAX tests' virtual CPU devices:

- ``sharded_align_fn`` over 2 shards against the JAX package's
  ``sharded_align_fn(make_mesh(2))`` at ``tests/test_mesh.py``'s tiny
  shapes: every output key equal, shape included (the JAX mesh is
  compiled once, at this one size);
- at 4 and 8 shards, the port's regions against the JAX package's
  unsharded regions (``tests/test_mesh.py`` holds those equal to the JAX
  mesh's);
- the one-hot, sweep with the FMA table (``with_fma``) and ERT
  (``with_ert``) engines and the forced int64 layout at 2 shards against
  the port's unsharded outputs (earlier tests hold those to JAX);
- ``sharded_emf_fn`` against the JAX package's at 2 shards;
- ``run_alignment`` SE SAM, PE records and ``SeStream`` under a port
  mesh, byte-equal to the JAX package's single-device run and to the
  unsharded port;
- ``mem --devices 4 --device cpu``: the SAM body equal to the JAX
  package's single-device body; the refusals' messages.

The retry tiers under a mesh are ``tests/test_torch_mesh_retry.py``.
"""

import io

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
from bwa_mem_scale_tpu_torch.index.build import build_index as t_build
from bwa_mem_scale_tpu_torch.index.perfect import (
    build_perfect_table as t_build_emf)
from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                    simulate_reads)
from bwa_mem_scale_tpu_torch.ops.chain import DeviceBns
from bwa_mem_scale_tpu_torch.ops.emf import DeviceEmf
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
from bwa_mem_scale_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                   sharded_align_fn,
                                                   sharded_emf_fn)
from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                    PipelineConfig as TCfg,
                                                    seed_chain_extend)
from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment as t_run
from bwa_mem_scale_tpu_torch.pipeline.stream import SeStream

torch.set_num_threads(1)

CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8, max_regs=8)
L, B = 64, 16


def cpus(n):
    return make_mesh(devices=["cpu"] * n)


def regions_by_read(packed):
    out = {}
    for row in np.asarray(packed).reshape(-1, packed.shape[-1]):
        if not row[0]:
            continue
        rb = (int(row[11]) << 31) | int(row[10])
        re = (int(row[13]) << 31) | int(row[12])
        out.setdefault(int(row[1]), []).append(
            (int(row[2]), int(row[3]), int(row[4]), rb, re))
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def demo():
    """tests/test_mesh.py's setup: the demo genome of 12,000 bp, 16 reads
    of 64 bp at 2% errors; the port's index state on the CPU."""
    idx = t_build(demo_genome(12000, 0))
    codes, lens = simulate_reads(idx.bns, B, L, err_rate=0.02)
    return dict(idx=idx, codes=np.asarray(codes, np.int32),
                lens=np.asarray(lens, np.int32),
                fmi=DeviceFMIndex.from_host(idx, "cpu"),
                dbns=DeviceBns.from_host(idx.bns, "cpu"))


@pytest.fixture(scope="module")
def jax_demo(demo):
    """The JAX package's sharded step over 2 devices and its unsharded
    step, on the same reads."""
    import jax
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.models.aligner import build_demo_aligner
    from bwa_mem_scale_tpu.parallel.mesh import (make_mesh as j_mesh,
                                                 sharded_align_fn as j_saf)
    from bwa_mem_scale_tpu.pipeline.align import (PipelineConfig,
                                                  seed_chain_extend as j_sce)
    opt, cfg = MemOptions(), PipelineConfig(**CAPS)
    jal = build_demo_aligner(genome_bp=12000, opt=opt, cfg=cfg)
    c, ln = jnp.asarray(demo["codes"]), jnp.asarray(demo["lens"])
    sharded = j_saf(j_mesh(2), opt, cfg, L)(jal.fmi, jal.dbns, c, ln)
    plain = jax.jit(lambda f, d, cc, ll: j_sce(
        f, d, cc, ll, L=L, opt=opt, cfg=cfg, fma=None, ert=None))(
        jal.fmi, jal.dbns, c, ln)
    return dict(sharded={k: np.asarray(v) for k, v in sharded.items()},
                plain={k: np.asarray(v) for k, v in plain.items()})


def test_sharded_align_fn_equal_to_jax(demo, jax_demo):
    got = sharded_align_fn(cpus(2), TOpt(), TCfg(**CAPS), L)(
        demo["fmi"], demo["dbns"], demo["codes"], demo["lens"])
    want = jax_demo["sharded"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert (want["read"][want["valid"]] >= B // 2).any()


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_regions_equal_to_jax_unsharded(demo, jax_demo, n):
    got = sharded_align_fn(cpus(n), TOpt(), TCfg(**CAPS), L)(
        demo["fmi"], demo["dbns"], demo["codes"], demo["lens"])
    want = regions_by_read(jax_demo["plain"]["packed"])
    assert want and regions_by_read(got["packed"].numpy()) == want
    assert got["pair_overflow"].shape == (n,)


def _per_read(out):
    return {k: out[k].numpy() for k in ("meta", "frac_rep", "smem_cnt",
                                        "coord_total", "read_overflow")}


@pytest.mark.parametrize("engine", ["onehot", "sweep_fma", "ert", "int64"])
def test_engines_at_two_shards_equal_to_unsharded(engine):
    """Every seeding engine and the forced int64 layout under a 2-shard
    mesh: the unsharded port's regions and per-read outputs."""
    from bwa_mem_scale_tpu_torch.index.ert import build_ert_from_index
    from bwa_mem_scale_tpu_torch.ops.ert import DeviceErt
    from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
    g = demo_genome(12000, 3)
    idx = t_build(g, sa_compx=0) if engine == "ert" else t_build(g)
    codes, lens = simulate_reads(idx.bns, B, L, seed=4, err_rate=0.02)
    codes, lens = np.asarray(codes, np.int32), np.asarray(lens, np.int32)
    fmi = DeviceFMIndex.from_host(idx, "cpu", force_int64=engine == "int64")
    dbns = DeviceBns.from_host(idx.bns, "cpu")
    cfg = TCfg(seed_engine="onehot" if engine == "onehot" else "sweep",
               **CAPS)
    extra, kw = [], {}
    if engine == "sweep_fma":
        extra = [build_fma_table(fmi, K=4, chunk=256).to_device(
            fmi.pos_dtype, "cpu")]
        kw = dict(with_fma=True)
    if engine == "ert":
        ert = build_ert_from_index(idx, K=4, max_depth=L)
        extra = [DeviceErt.from_host(ert, fmi.sa_samples, idx.count, "cpu")]
        kw = dict(with_ert=True)
    got = sharded_align_fn(cpus(2), TOpt(), cfg, L, **kw)(
        fmi, dbns, codes, lens, *extra)
    want = seed_chain_extend(
        fmi, dbns, torch.as_tensor(codes), torch.as_tensor(lens), L=L,
        opt=TOpt(), cfg=cfg, fma=extra[0] if engine == "sweep_fma" else None,
        ert=extra[0] if engine == "ert" else None)
    assert regions_by_read(want["packed"].numpy())
    assert (regions_by_read(got["packed"].numpy())
            == regions_by_read(want["packed"].numpy()))
    for k, v in _per_read(want).items():
        np.testing.assert_array_equal(_per_read(got)[k], v, err_msg=k)
    assert got["rb"].dtype == want["rb"].dtype
    assert fmi.pos_dtype == (torch.int64 if engine == "int64"
                             else torch.int32)


def test_sharded_emf_fn_equal_to_jax(demo):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index.perfect import build_perfect_table
    from bwa_mem_scale_tpu.models.aligner import demo_genome as j_genome
    from bwa_mem_scale_tpu.ops.emf import DeviceEmf as JEmf
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    from bwa_mem_scale_tpu.parallel.mesh import (make_mesh as j_mesh,
                                                 sharded_emf_fn as j_sef)
    idx = demo["idx"]
    codes = demo["codes"].copy()
    g = idx.bns.seq
    for i in range(0, B, 2):      # exact reads: hits on both strands
        codes[i] = g[100 * i: 100 * i + L]
        if i % 4:
            codes[i] = (3 - codes[i])[::-1]
    jidx = build_index(j_genome(12000, 0))
    jemf = build_perfect_table(jidx, seed_len=L)
    want = j_sef(j_mesh(2))(JEmf.from_host(jemf), JFmi.from_host(jidx).ref,
                            jnp.asarray(codes), jnp.asarray(demo["lens"]))
    temf = DeviceEmf.from_host(t_build_emf(idx, seed_len=L), "cpu")
    got = sharded_emf_fn(cpus(2))(temf, demo["fmi"].ref, codes,
                                  demo["lens"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert (np.asarray(want["code"]) >= 3).sum() >= B // 2


def _write_fastq(path, codes):
    with open(path, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 20 kbp genome with its EMF table (saved by the JAX package), 24
    SE reads (a third with errors, so the EMF probe misses them) and 8
    PE pairs; the JAX package's single-device SE SAM, PE records and
    SeStream records."""
    from conftest import make_genome
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment
    from bwa_mem_scale_tpu.pipeline.stream import SeStream as JStream
    tmp = tmp_path_factory.mktemp("mesh")
    idx = build_index(make_genome(20000, seed=42))
    emf = build_perfect_table(idx, seed_len=80)
    prefix = str(tmp / "g")
    save_index(idx, prefix)
    save_perfect_table(emf, prefix)
    g = idx.bns.seq
    rng = np.random.RandomState(5)
    se = np.zeros((24, 80), np.int32)
    for i in range(24):
        p = rng.randint(0, len(g) - 80)
        se[i] = g[p: p + 80]
        if i % 3 == 0:
            se[i][rng.rand(80) < 0.03] = rng.randint(0, 4)
    fq = _write_fastq(tmp / "r.fq", se)
    pe = np.zeros((16, 80), np.int32)
    for p in range(8):
        pos = rng.randint(0, len(g) - 140)
        pe[2 * p] = g[pos: pos + 80]
        pe[2 * p + 1] = (3 - g[pos + 60: pos + 140])[::-1]
        if p % 3 == 0:
            pe[2 * p][rng.rand(80) < 0.03] = rng.randint(0, 4)
    cfg = PipelineConfig(seed_engine="onehot", max_pairs=256, **CAPS)
    jal = TpuAligner(idx, MemOptions(), cfg, emf=emf)
    buf = io.StringIO()
    run_alignment(jal, [fq], buf, batch_reads=8)
    out, mates = jal.align_pairs_and_finalize(pe, np.full(16, 80, np.int32))
    st = JStream(jal, 8, 80)
    for k in range(3):
        st.feed(se[8 * k: 8 * k + 8], np.full(8, 80, np.int32), 8 * k)
    st.flush()
    return dict(prefix=prefix, fq=fq, se=se, pe=pe, tidx=t_load(prefix),
                emf=emf, sam=buf.getvalue(), pe_recs=_recs(out, mates),
                stream=_stream_recs(dict(st.ready())), tmp=tmp)


def _recs(out, mates):
    return ([[(r.rid, r.pos, r.mapq, r.flag, tuple(r.cigar or ()), r.NM,
               r.MD, r.XA) for r in rr] for rr in out],
            [None if m is None else (m.rid, m.pos, m.is_rev,
                                     tuple(m.cigar or ())) for m in mates])


def _stream_recs(got):
    return [[(r.rid, r.pos, r.mapq, r.flag, tuple(r.cigar or ()))
             for r in got[i]] for i in range(len(got))]


def _port_aligner(runs, mesh):
    from bwa_mem_scale_tpu_torch.index.perfect import load_perfect_table
    temf = load_perfect_table(f"{runs['prefix']}.emf80.npz")
    return GpuAligner(runs["tidx"], "cpu", TOpt(),
                      TCfg(seed_engine="onehot", max_pairs=256, **CAPS),
                      emf=temf, mesh=mesh)


@pytest.mark.parametrize("n", [None, 2, 4])
def test_se_pe_stream_under_mesh_equal_to_jax(runs, n):
    mesh = cpus(n) if n else None
    al = _port_aligner(runs, mesh)
    buf = io.StringIO()
    assert t_run(al, [runs["fq"]], buf, batch_reads=8) == 24
    assert buf.getvalue() == runs["sam"]
    out, mates = al.align_pairs_and_finalize(runs["pe"],
                                             np.full(16, 80, np.int32))
    assert _recs(out, mates) == runs["pe_recs"]
    st = SeStream(al, 8, 80)
    for k in range(3):
        st.feed(runs["se"][8 * k: 8 * k + 8], np.full(8, 80, np.int32),
                8 * k)
    st.flush()
    assert _stream_recs(dict(st.ready())) == runs["stream"]
    assert al.emf_hits > 0


def test_align_and_finalize_device_probe_under_mesh(runs):
    """The device EMF probe read-sharded with seeding: the unsharded
    port's records, hits included."""
    codes = runs["se"][:16]
    lens = np.full(16, 80, np.int32)
    recs = []
    for mesh in (None, cpus(4)):
        al = _port_aligner(runs, mesh)
        assert al.emf_filter(codes, lens) is not None
        recs.append(_stream_recs(dict(enumerate(
            al.align_and_finalize(codes, lens)))))
        assert al.emf_hits > 0
    assert recs[0] == recs[1]


def test_mem_cli_devices_equal_to_jax(runs, tmp_path, capsys):
    out = tmp_path / "m.sam"
    al = cli.mem([runs["prefix"], runs["fq"], "-o", str(out), "--device",
                  "cpu", "--devices", "4", "--batch-reads", "8"])
    assert isinstance(al.mesh, Mesh) and al.mesh.size == 4
    assert "* device mesh: 4x read-sharded" in capsys.readouterr().err
    with open(out) as f:
        body = "".join(ln for ln in f if not ln.startswith("@"))
    assert body == runs["sam"]


def test_mem_cli_mesh_refusals(runs, monkeypatch):
    base = [runs["prefix"], runs["fq"], "-o", "/dev/null"]
    with pytest.raises(SystemExit,
                       match="--batch-reads must be divisible by --devices"):
        cli.mem(base + ["--device", "cpu", "--devices", "3",
                        "--batch-reads", "8"])
    # one card, two asked for: the JAX CLI's message
    from bwa_mem_scale_tpu_torch import device as t_device
    monkeypatch.setattr(t_device, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--devices 2 but only 1 available"):
        cli.mem(base + ["--devices", "2"])
    with pytest.raises(ValueError, match="3 devices asked, 1 CUDA"):
        make_mesh(3)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        sharded_align_fn(cpus(3), TOpt(), TCfg(**CAPS), L)(
            None, None, np.zeros((8, L), np.int32), np.zeros(8, np.int32))
