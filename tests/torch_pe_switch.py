"""Shared data for the tests of the device DP switches (not a test module).

``pe_data`` builds a three-contig genome, its index and EMF table (saved
by the JAX package, loaded by the port), 48 FR pairs in two FASTQ files
(exact pairs, mates without a seed that rescue finds, random mates, mates
on another contig, N bases), and runs the JAX package's PE
``run_alignment`` once with the given ``BWA_TPU_NO_NATIVE_*`` variables
set, recording each call of one JAX device function (its numpy inputs
and outputs) through ``record``.
"""

import io
import os

import numpy as np

from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases

B, L = 32, 101                 # 16 pairs a batch
N_PAIRS = 48
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def pairs(bns, n_pairs, seed):
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
                m = rng.rand(L) < 0.02
                r[m] = (r[m] + rng.randint(1, 4, m.sum())) % 4
        if p % 5 == 2:                       # an indel in read 1
            r1 = np.concatenate([r1[:40], r1[43:], bns.seq[pos + L:
                                                           pos + L + 3]])
        if p % 8 == 3:                       # no seed: found by rescue
            r2[5::10] = (r2[5::10] + 1) % 4
        if p % 7 == 5:                       # random mate
            r2 = rng.randint(0, 4, L).astype(np.uint8)
        if p % 11 == 7:
            r1[rng.randint(0, L, 2)] = 4
        codes[2 * p], codes[2 * p + 1] = r1, r2
    return codes


def write_fastq(path, codes, ids):
    with open(path, "w") as f:
        for i in ids:
            f.write(f"@p{i // 2}\n{decode_bases(codes[i])}\n+\n"
                    f"{chr(35 + i % 38) * L}\n")
    return str(path)


def pe_data(tmp, env: dict, module, name: str):
    """The data set and the JAX PE SAM under `env`, recording the calls of
    module.name: dict(prefix, fq1, fq2, sam, calls [(args, outputs)])."""
    from conftest import make_genome
    import pytest
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    idx = build_index(make_genome(30000, seed=23, n_contigs=3))
    emf = build_perfect_table(idx, seed_len=L)
    codes = pairs(idx.bns, N_PAIRS, seed=6)
    ids = range(2 * N_PAIRS)
    fq1 = write_fastq(tmp / "r1.fq", codes, ids[0::2])
    fq2 = write_fastq(tmp / "r2.fq", codes, ids[1::2])
    prefix = str(tmp / "g")
    save_index(idx, prefix)
    save_perfect_table(emf, prefix)
    calls = []
    fn = getattr(module, name)

    def record(*args, **kw):
        out = fn(*args, **kw)
        calls.append(([np.asarray(a) if hasattr(a, "shape") else a
                       for a in args],
                      {k: np.asarray(v) for k, v in out._asdict().items()}))
        return out

    jal = TpuAligner(idx, MemOptions(), JCfg(seed_engine="onehot", **CAPS),
                     emf=emf)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(module, name, record)
        j_run(jal, [fq1, fq2], out, batch_reads=B, paired=True)
    assert not any(os.environ.get(k) for k in env)
    return dict(prefix=prefix, fq1=fq1, fq2=fq2, sam=out.getvalue(),
                calls=calls, tmp=tmp)


def port_sam(d, env: dict, device="cpu", extra=()):
    """The port's CLI `mem` body on d's pairs under `env`."""
    import pytest
    from bwa_mem_scale_tpu_torch import cli
    out = d["tmp"] / f"port_{abs(hash((tuple(env), device, extra)))}.sam"
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        al = cli.mem([d["prefix"], d["fq1"], d["fq2"], "-o", str(out),
                      "--device", device, "--batch-reads", str(B), *extra])
    with open(out) as f:
        return "".join(ln for ln in f if not ln.startswith("@")), al
