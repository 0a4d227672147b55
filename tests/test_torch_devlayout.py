"""The genome-scale device-layout cache, ``DeviceFMIndex.from_host_cached``
(``<prefix>.devlayout3.npz``), port vs JAX on the CPU, exact.

The index is the small genome's, saved by the JAX package with its
``seq_len`` set to 2^31 (as ``tests/test_torch_int64.py`` makes it), so
that both packages take the int64 layout; for the layout and the files
its checkpoint counts are lifted (``test_torch_int64._lift``, "steps"),
so that the cache's high bytes ``cp_hi`` are not all zero.

- the port's ``_int64_layout`` equal to the JAX package's, key by key in
  dtype, shape and value, with the reference 1-D and (a small
  ``REF_2D_LIMIT`` in both packages) packed [n/128, 128];
- a cache the JAX package wrote loads in the port, tensor for tensor
  equal to ``from_host(force_int64=True)``; one the port wrote loads in
  the JAX package, equal to its own ``from_host(force_int64=True)``; the
  reader leaves the file as it was and does not rebuild the layout;
- a warm load does not rebuild; an int32 index, or one with no
  ``source_prefix``, writes no file; a k-step table on the wide layout
  raises; a cache that does not fit the index raises, naming the file;
- `mem` on the 2^31 index gives the JAX package's SAM body cold (the
  cache written) and warm (the cache read).
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch import cli
from bwa_mem_scale_tpu_torch.index.artifacts import load_index as t_load
from bwa_mem_scale_tpu_torch.ops import occ as tocc
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi

from test_torch_int64 import _lift, _reads, _write_fastq

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

B, L = 32, 101
CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
CACHE = ".devlayout3.npz"
# REF_2D_LIMIT in both packages: the default (the 20 kbp forward strand
# stays 1-D) and one below it (packed [n/128, 128])
LIMITS = {"ref_1d": None, "ref_2d": 4096}


def _save(small_index, tmp, name, lifted=True, seq_len=1 << 31):
    """The JAX package's index file under tmp/name, lifted or not, with
    its seq_len replaced; the prefix."""
    from bwa_mem_scale_tpu.index.artifacts import save_index
    prefix = str(tmp / name)
    save_index(_lift(small_index, "steps") if lifted else small_index,
               prefix)
    path = prefix + ".tpuidx.npz"
    z = np.load(path)
    arrs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrs["meta"]).decode())
    meta["seq_len"] = seq_len
    arrs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrs)
    return prefix


def _limit(monkeypatch, limit):
    if LIMITS[limit] is not None:
        from bwa_mem_scale_tpu.ops import occ as jocc
        monkeypatch.setattr(jocc, "REF_2D_LIMIT", LIMITS[limit])
        monkeypatch.setattr(tocc, "REF_2D_LIMIT", LIMITS[limit])


def _refuse(*a, **k):
    raise AssertionError("the device layout was rebuilt")


def _equal_fmi(got, want):
    """Two port DeviceFMIndex objects, field for field (tensors in dtype,
    shape and value)."""
    for f in dataclasses.fields(TFmi):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def _jax_arrays(jf):
    return {k: np.asarray(getattr(jf, k))
            for k in ("count", "cp_fused32", "cp_hi", "sa_ms", "sa_ls",
                      "sentinel_index", "ref")}


@pytest.mark.parametrize("limit", list(LIMITS))
def test_int64_layout_equal_to_jax(small_index, tmp_path, monkeypatch,
                                   limit):
    from bwa_mem_scale_tpu.index.artifacts import load_index as j_load
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    _limit(monkeypatch, limit)
    prefix = _save(small_index, tmp_path, "g")
    want = JFmi._int64_layout(j_load(prefix))
    got = TFmi._int64_layout(t_load(prefix))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, k)
    assert got["cp_hi"].any()
    assert got["ref"].ndim == (2 if LIMITS[limit] else 1)


@pytest.mark.parametrize("limit", list(LIMITS))
def test_jax_cache_loads_in_port(small_index, tmp_path, monkeypatch, limit):
    from bwa_mem_scale_tpu.index.artifacts import load_index as j_load
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    _limit(monkeypatch, limit)
    prefix = _save(small_index, tmp_path, "g")
    JFmi.from_host_cached(j_load(prefix))
    raw = open(prefix + CACHE, "rb").read()
    monkeypatch.setattr(TFmi, "_int64_layout", _refuse)
    tidx = t_load(prefix)
    got = TFmi.from_host_cached(tidx, "cpu")
    _equal_fmi(got, TFmi.from_host(tidx, "cpu", force_int64=True))
    assert got.pos_dtype == torch.int64 and got.hi_counts != [0] * 4
    assert open(prefix + CACHE, "rb").read() == raw


@pytest.mark.parametrize("limit", list(LIMITS))
def test_port_cache_loads_in_jax(small_index, tmp_path, monkeypatch, limit):
    from bwa_mem_scale_tpu.index.artifacts import load_index as j_load
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex as JFmi
    _limit(monkeypatch, limit)
    prefix = _save(small_index, tmp_path, "g")
    TFmi.from_host_cached(t_load(prefix), "cpu")
    raw = open(prefix + CACHE, "rb").read()
    assert sorted(os.listdir(tmp_path)) == ["g" + CACHE, "g.tpuidx.npz"]
    jidx = j_load(prefix)
    want = _jax_arrays(JFmi.from_host(jidx, force_int64=True))
    monkeypatch.setattr(JFmi, "_int64_layout", _refuse)
    got = _jax_arrays(JFmi.from_host_cached(jidx))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, k)
    assert open(prefix + CACHE, "rb").read() == raw


def test_warm_load_does_not_rebuild(small_index, tmp_path, monkeypatch):
    prefix = _save(small_index, tmp_path, "g")
    tidx = t_load(prefix)
    cold = TFmi.from_host_cached(tidx, "cpu")
    monkeypatch.setattr(TFmi, "_int64_layout", _refuse)
    warm = TFmi.from_host_cached(tidx, "cpu")
    _equal_fmi(warm, cold)
    _equal_fmi(warm, TFmi.from_host(tidx, "cpu", force_int64=True))


@pytest.mark.parametrize("case", ["int32", "no_prefix"])
def test_no_file_without_wide_positions_and_prefix(small_index, tmp_path,
                                                   monkeypatch, case):
    """An int32 index, or an index with no source_prefix (attached to a
    store), takes from_host and writes nothing."""
    prefix = _save(small_index, tmp_path, "g", lifted=False,
                   seq_len=(small_index.seq_len if case == "int32"
                            else 1 << 31))
    tidx = t_load(prefix)
    if case == "no_prefix":
        tidx = dataclasses.replace(tidx, source_prefix=None)
    monkeypatch.setattr(TFmi, "_int64_layout", _refuse)
    got = TFmi.from_host_cached(tidx, "cpu")
    _equal_fmi(got, TFmi.from_host(tidx, "cpu"))
    assert got.pos_dtype == (torch.int32 if case == "int32" else torch.int64)
    assert os.listdir(tmp_path) == ["g.tpuidx.npz"]


def test_kstep_table_on_the_wide_layout_raises(small_index, tmp_path):
    prefix = _save(small_index, tmp_path, "g")
    with pytest.raises(ValueError, match="k-step table is int32-path only"):
        TFmi.from_host_cached(t_load(prefix), "cpu", cp2=object())
    assert not os.path.exists(prefix + CACHE)


@pytest.mark.parametrize("key", ["cp_fused32", "cp_hi", "sa_ls", "ref"])
def test_mismatched_cache_raises(small_index, tmp_path, key):
    """A cache of another index (rows, samples or reference length that
    differ) is refused with the file's name, never aligned on."""
    prefix = _save(small_index, tmp_path, "g")
    tidx = t_load(prefix)
    lay = TFmi._int64_layout(tidx)
    lay[key] = lay[key][:-1]
    np.savez(prefix + CACHE, **lay)
    with pytest.raises(ValueError, match=f"g{CACHE}: {key}"):
        TFmi.from_host_cached(tidx, "cpu")


@pytest.fixture(scope="module")
def jax_sam(small_index, tmp_path_factory):
    """The JAX package's SE SAM (int32 layout, EMF table) on 80 reads, and
    the index and table it saved."""
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table)
    from bwa_mem_scale_tpu.pipeline.align import (TpuAligner,
                                                  PipelineConfig as JCfg)
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment as j_run
    tmp = tmp_path_factory.mktemp("mem")
    fq = _write_fastq(tmp / "r.fq", _reads(small_index.bns.seq, 80, seed=5))
    emf = build_perfect_table(small_index, seed_len=L)
    save_perfect_table(emf, str(tmp / "g"))
    jal = TpuAligner(small_index, MemOptions(),
                     JCfg(seed_engine="onehot", **CAPS), emf=emf)
    sam = io.StringIO()
    j_run(jal, [fq], sam, batch_reads=B)
    return dict(fq=fq, emf=str(tmp / f"g.emf{L}.npz"), sam=sam.getvalue())


def test_mem_cold_and_warm_equal_to_jax(small_index, jax_sam, tmp_path,
                                        monkeypatch):
    """`mem` on the index whose seq_len is 2^31: cold it writes the
    cache, warm it reads it (the layout not rebuilt); both SAM bodies the
    JAX package's."""
    prefix = _save(small_index, tmp_path, "big", lifted=False)
    os.symlink(jax_sam["emf"], prefix + f".emf{L}.npz")
    bodies = []
    for run in ("cold", "warm"):
        if run == "warm":
            monkeypatch.setattr(TFmi, "_int64_layout", _refuse)
        out = tmp_path / f"{run}.sam"
        al = cli.mem([prefix, jax_sam["fq"], "-o", str(out), "--device",
                      "cpu", "--batch-reads", str(B)])
        assert al.fmi.pos_dtype == torch.int64 and al.emf_hits > 0
        assert os.path.exists(prefix + CACHE)
        with open(out) as f:
            bodies.append("".join(ln for ln in f if not ln.startswith("@")))
    assert bodies == [jax_sam["sam"]] * 2
