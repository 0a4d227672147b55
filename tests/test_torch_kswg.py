"""The CIGAR DP (banded global alignment with traceback), port vs JAX on
the CPU, exact:

- the plain ``ops/kswg.py::ksw_global_batch`` (and
  ``kswg_cuda.ksw_global_batch_cuda`` on CPU tensors) equal to the JAX
  function on every output, on ``tests/test_device_kswg.py``'s generator
  (seed 99, 40 pairs, N codes added) at the finalizer's shape buckets,
  and on the CIGAR jobs of a real PE batch (the JAX Python PE path under
  ``BWA_TPU_NO_NATIVE_PE`` and ``BWA_TPU_NO_NATIVE_KSWG``);
- the plain version against the scalar oracle ``ref/ksw.py::ksw_global``
  (score and CIGAR through ``rle_cigar``);
- the kernel's CPU twin (``kswg_cuda.kswg_twin``) equal to the plain
  version, its band-only direction store included;
- PE ``mem`` under the two variables: the port's CLI SAM body byte-equal
  to the JAX package's under the same variables, CIGARs through the
  device DP; a native library that fails to load still raises without
  the variable;
- the kernel against its twin and the plain version on the card
  (``cuda``).
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.config import MemOptions
from bwa_mem_scale_tpu_torch.ops import kswg_cuda
from bwa_mem_scale_tpu_torch.ops.kswg import ksw_global_batch, rle_cigar
from bwa_mem_scale_tpu_torch.ref.ksw import ksw_global

import torch_pe_switch as data

torch.set_num_threads(1)

ENV = {"BWA_TPU_NO_NATIVE_PE": "1", "BWA_TPU_NO_NATIVE_KSWG": "1"}
OPT = MemOptions()
GAPS = (OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins)


def _generator(seed=99, n=40, qmax=120, P=64, QL=128, TL=192, n_codes=True):
    """tests/test_device_kswg.py's pairs (w >= |tlen - qlen| + 3), padded
    to the finalizer's buckets (P a power of two, padding pairs of length
    0 and w 1); a few N codes on both sides."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        qlen = rng.randint(5, qmax)
        q = rng.randint(0, 4, qlen).astype(np.int32)
        t = q.copy()
        for _ in range(rng.binomial(qlen, 0.06)):
            p = rng.randint(0, len(t))
            op = rng.randint(3)
            if op == 0:
                t[p] = (t[p] + rng.randint(1, 4)) % 4
            elif op == 1 and len(t) > 3:
                t = np.delete(t, p)
            else:
                t = np.insert(t, p, rng.randint(0, 4))
        w = max(abs(len(t) - len(q)) + 3, rng.randint(3, 30))
        pairs.append((q, t.astype(np.int32), w))
    qs = np.zeros((P, QL), np.int32)
    ts = np.zeros((P, TL), np.int32)
    ql, tl = np.zeros(P, np.int32), np.zeros(P, np.int32)
    ws = np.ones(P, np.int32)
    for i, (q, t, w) in enumerate(pairs):
        qs[i, :len(q)], ts[i, :len(t)] = q, t
        ql[i], tl[i], ws[i] = len(q), len(t), w
    if n_codes:
        qs[3, 5] = ts[7, 2] = ts[9, 0] = 4
    return pairs, (qs, ql, ts, tl, ws)


def _port(arrs, fn=ksw_global_batch):
    r = fn(*(torch.as_tensor(x) for x in arrs), *GAPS, OPT.mat)
    return {k: v.numpy() for k, v in r._asdict().items()}


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    from bwa_mem_scale_tpu.ops import kswg as jkswg
    return data.pe_data(tmp_path_factory.mktemp("kswg"), ENV, jkswg,
                        "ksw_global_batch")


def test_plain_equal_to_jax_generator():
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.kswg import ksw_global_batch as jfn
    _, arrs = _generator()
    want = jfn(*(jnp.asarray(x) for x in arrs), *GAPS, OPT.mat)
    for fn in (ksw_global_batch, kswg_cuda.ksw_global_batch_cuda):
        got = _port(arrs, fn)
        for k, v in want._asdict().items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
            assert got[k].dtype == np.asarray(v).dtype, k


def test_plain_equal_to_jax_on_cigar_jobs(pe):
    """Every CIGAR DP call of the JAX Python PE path (first round and band
    widening), its recorded outputs."""
    assert pe["calls"]
    for args, want in pe["calls"]:
        got = _port(args[:5])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_plain_equal_to_scalar_oracle():
    pairs, arrs = _generator(n_codes=False)
    got = _port(arrs)
    for i, (q, t, w) in enumerate(pairs):
        score, cigar = ksw_global(q, t, OPT.mat, *GAPS, w)
        assert got["score"][i] == score, i
        assert rle_cigar(got["ops"][i], int(got["n_ops"][i]),
                         int(got["tail_del"][i]),
                         int(got["tail_ins"][i])) == cigar, i


@pytest.mark.parametrize("seed", [99, 5])
def test_twin_equal_to_plain(seed):
    _, arrs = _generator(seed=seed)
    want = _port(arrs)
    zb = np.zeros((arrs[0].shape[0], arrs[2].shape[1],
                   kswg_cuda.band_width(arrs[4].max(), arrs[0].shape[1])),
                  np.uint8)
    got, passes, steps = kswg_cuda.kswg_twin(*arrs, *GAPS, OPT.mat,
                                             zb_out=zb)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    np.testing.assert_array_equal(steps, want["n_ops"])
    cells = kswg_cuda.band_cells(arrs[1], arrs[3], arrs[4])
    assert (passes * 32 >= cells).all() and (passes <= cells).all()


def test_twin_equal_to_plain_on_cigar_jobs(pe):
    for args, want in pe["calls"][:2]:
        got, _, _ = kswg_cuda.kswg_twin(*args[:5], *GAPS, OPT.mat)
        for k, v in want.items():
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)


def test_pe_mem_under_switch_equal_to_jax(pe, monkeypatch):
    """`mem` with BWA_TPU_NO_NATIVE_PE and BWA_TPU_NO_NATIVE_KSWG: the
    Python PE path, CIGARs (NM/MD on the host) from the device DP (plain
    on the CPU), the JAX package's SAM bytes under the same variables."""
    calls = []
    fn = kswg_cuda.ksw_global_batch_cuda
    monkeypatch.setattr(kswg_cuda, "ksw_global_batch_cuda",
                        lambda *a: calls.append(a[0].shape) or fn(*a))
    body, _ = data.port_sam(pe, ENV)
    assert body == pe["sam"]
    assert len(calls) == len(pe["calls"])


def test_missing_native_library_raises(monkeypatch):
    """Unlike the JAX package, a libkswg that fails to load is an error
    unless BWA_TPU_NO_NATIVE_KSWG asks for the device DP."""
    from bwa_mem_scale_tpu_torch.pipeline import native_kswg
    from bwa_mem_scale_tpu_torch.pipeline.finalize import BatchFinalizer
    monkeypatch.setattr(native_kswg, "available", lambda: False)
    monkeypatch.delenv("BWA_TPU_NO_NATIVE_KSWG", raising=False)
    with pytest.raises(RuntimeError, match="libkswg"):
        BatchFinalizer(OPT, None)
    monkeypatch.setenv("BWA_TPU_NO_NATIVE_KSWG", "1")
    fin = BatchFinalizer(OPT, None, "cpu")
    assert not fin.native and fin.device == torch.device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["generator", "pe", "long"])
def test_kernel_equal_to_twin_and_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    if case == "generator":
        _, arrs = _generator()
    elif case == "pe":
        _, arrs = _generator(seed=3, n=1000, qmax=152, P=1024, QL=160,
                             TL=256)
    else:
        _, arrs = _generator(seed=4, n=6, qmax=2500, P=16, QL=2528, TL=2624)
    dev = torch.device("cuda")
    args = [torch.as_tensor(x, device=dev) for x in arrs]
    before = kswg_cuda.ksw_global_batch_cuda.launches
    got = kswg_cuda.ksw_global_batch_cuda(*args, *GAPS, OPT.mat)
    assert kswg_cuda.ksw_global_batch_cuda.launches == before + 1
    want = ksw_global_batch(*args, *GAPS, OPT.mat)
    for k in want._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    if case != "pe":
        tw, _, _ = kswg_cuda.kswg_twin(*arrs, *GAPS, OPT.mat)
        for k in want._fields:
            np.testing.assert_array_equal(getattr(got, k).cpu().numpy(),
                                          getattr(tw, k), err_msg=k)
