"""The mate-rescue local SW (ksw_align2), port vs JAX on the CPU, exact:

- the plain ``ops/kswa.py::ksw_align_batch`` (and
  ``kswa_cuda.ksw_align_batch_cuda`` on CPU tensors) equal to the JAX
  function on every output, on random jobs with planted matches, N codes
  and empty lengths, and on the rescue jobs of a real PE batch (the JAX
  Python PE path under ``BWA_TPU_NO_NATIVE_PE`` and
  ``BWA_TPU_NO_NATIVE_KSWA``);
- the plain version against the scalar oracle ``ref/ksw_align.py``
  (score2 included: the oracle keeps the same documented divergence from
  the reference);
- the kernel's CPU twin (``kswa_cuda.kswa_twin``, the wavefront step by
  step) equal to the plain version, also on a tie for qe across two
  lanes, a reverse stop within the scan's last 31 rows and K = 16;
- PE ``mem`` under the two variables: the port's CLI SAM body byte-equal
  to the JAX package's under the same variables, rescue through the
  device path; without the variable the native library runs;
- the kernel against its twin and the plain version on the card
  (``cuda``).
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.config import MemOptions
from bwa_mem_scale_tpu_torch.ops import kswa_cuda
from bwa_mem_scale_tpu_torch.ops.kswa import ksw_align_batch
from bwa_mem_scale_tpu_torch.ref.ksw_align import ksw_align

import torch_pe_switch as data

torch.set_num_threads(1)

ENV = {"BWA_TPU_NO_NATIVE_PE": "1", "BWA_TPU_NO_NATIVE_KSWA": "1"}
OPT = MemOptions()
MINSC = OPT.min_seed_len * OPT.a
MAX_MAT = int(OPT.mat.max())


def _jobs(seed, J, L, T):
    """Random query / target codes (N included), a query prefix planted
    in each target with substitutions (in every other job a second,
    shorter copy: a second best), lengths from 0 to the width."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 5, (J, L)).astype(np.int32)
    t = rng.randint(0, 5, (J, T)).astype(np.int32)
    for j in range(J):
        s = rng.randint(0, T - 30)
        n = rng.randint(10, min(L, T - s))
        t[j, s:s + n] = q[j, :n]
        m = rng.rand(n) < 0.05
        t[j, s:s + n][m] = rng.randint(0, 4, m.sum())
        if j % 2 and s >= 22:
            t[j, :20] = q[j, :20]
    ql = rng.randint(0, L + 1, J).astype(np.int32)
    tl = rng.randint(0, T + 1, J).astype(np.int32)
    ql[:4] = L
    tl[:4] = T
    return q, ql, t, tl


def _port(q, ql, t, tl, fn=ksw_align_batch):
    r = fn(*(torch.as_tensor(x) for x in (q, ql, t, tl)), OPT.mat,
           OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC, MAX_MAT)
    return {k: v.numpy() for k, v in r._asdict().items()}


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    from bwa_mem_scale_tpu.ops import kswa as jkswa
    return data.pe_data(tmp_path_factory.mktemp("kswa"), ENV, jkswa,
                        "ksw_align_batch")


@pytest.mark.parametrize("shape", [(40, 96, 384), (24, 160, 640),
                                   (16, 32, 128)])
def test_plain_equal_to_jax(shape):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.kswa import ksw_align_batch as jfn
    q, ql, t, tl = _jobs(sum(shape), *shape)
    want = jfn(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t),
               jnp.asarray(tl), jnp.asarray(OPT.mat, jnp.int32), OPT.o_del,
               OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC, MAX_MAT)
    for fn in (ksw_align_batch, kswa_cuda.ksw_align_batch_cuda):
        got = _port(q, ql, t, tl, fn)
        for k, v in want._asdict().items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
            assert got[k].dtype == np.int32
    if shape[2] >= 384:     # room for both copies
        assert (got["tb"] >= 0).any() and (got["score2"] > 0).any()


def test_plain_equal_to_jax_on_rescue_jobs(pe):
    """Every rescue batch of the JAX Python PE path, its recorded outputs."""
    assert pe["calls"]
    n = 0
    for args, want in pe["calls"]:
        q, ql, t, tl = args[:4]
        got = _port(q, ql, t, tl)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        n += int((got["tb"] >= 0).sum())
    assert n > 0


def test_plain_equal_to_scalar_oracle():
    q, ql, t, tl = _jobs(7, 40, 96, 384)
    got = _port(q, ql, t, tl)
    for j in range(len(q)):
        r = ksw_align(q[j, :ql[j]], t[j, :tl[j]], OPT.mat, OPT.o_del,
                      OPT.e_del, OPT.o_ins, OPT.e_ins, minsc=MINSC)
        assert (got["score"][j], got["te"][j], got["qe"][j],
                got["score2"][j], got["te2"][j], got["tb"][j],
                got["qb"][j]) == (r.score, r.te, r.qe, r.score2, r.te2,
                                  r.tb, r.qb), j


@pytest.mark.parametrize("shape", [(40, 96, 384), (12, 512, 256),
                                   (8, 20, 128)])
def test_twin_equal_to_plain(shape):
    q, ql, t, tl = _jobs(3 + sum(shape), *shape)
    want = _port(q, ql, t, tl)
    got, rows = kswa_cuda.kswa_twin(q, ql, t, tl, OPT.mat, OPT.o_del,
                                    OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC,
                                    MAX_MAT)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    # each scan its rows and the pipeline's depth at most (the reverse one
    # stops past the row that reaches the score)
    assert (rows <= (np.minimum(tl, t.shape[1]) + 31) * 2).all()


def _case(name):
    """(q, ql, t, tl) of a job set the wavefront's edges meet: two columns
    in different lanes tie for qe on the best row (qe the first); the
    reverse scan's stopping row within its last 31 rows (tb small);
    K = 16 with every query 512 columns."""
    rng = np.random.RandomState(23)
    if name == "qe-tie":            # L = 96: K = 3, lanes 8 and 24 tie
        q = rng.randint(0, 4, (4, 96)).astype(np.int32)
        t = rng.randint(0, 4, (4, 256)).astype(np.int32)
        for j in range(4):
            q[j, 50:75] = q[j, :25]
            t[j, 40 * j:40 * j + 25] = q[j, :25]
            # neither copy's match extends: the bases around differ
            q[j, [25, 75]] = (t[j, 40 * j + 25] + 1) % 4
            if j:
                q[j, 49] = (t[j, 40 * j - 1] + 1) % 4
        return q, np.full(4, 96, np.int32), t, np.full(4, 256, np.int32)
    if name == "reverse-stop":      # the match starts at target column 5
        q = rng.randint(0, 4, (4, 64)).astype(np.int32)
        t = rng.randint(0, 4, (4, 128)).astype(np.int32)
        for j in range(4):
            t[j, 2 + j:2 + j + 40] = q[j, 10:50]
        return q, np.full(4, 64, np.int32), t, np.full(4, 128, np.int32)
    q, ql, t, tl = _jobs(29, 6, 512, 768)
    return q, np.full(6, 512, np.int32), t, tl


@pytest.mark.parametrize("name", ["qe-tie", "reverse-stop", "K16"])
def test_twin_equal_to_plain_edges(name):
    """The twin equal to the plain version where the wavefront's edges
    are: the tie's qe, the reverse stop near the scan's end, all 32 lanes
    of K = 16 live."""
    q, ql, t, tl = _case(name)
    want = _port(q, ql, t, tl)
    got, steps = kswa_cuda.kswa_twin(q, ql, t, tl, OPT.mat, OPT.o_del,
                                     OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC,
                                     MAX_MAT)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    if name == "qe-tie":
        assert (want["qe"] == 24).all() and (want["score"] == 25).all()
    elif name == "reverse-stop":
        assert ((want["tb"] <= 5) & (want["qb"] == 10)).all()
        assert (want["te"] - want["tb"] >= want["te"] + 1 - 31).all()
    else:
        assert kswa_cuda.k_for(q.shape[1]) == 16 and (want["tb"] >= 0).any()


def test_twin_equal_to_plain_on_rescue_jobs(pe):
    for args, want in pe["calls"][:2]:
        got, _ = kswa_cuda.kswa_twin(*args[:4], OPT.mat, OPT.o_del,
                                     OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC,
                                     MAX_MAT)
        for k, v in want.items():
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)


def test_pe_mem_under_switch_equal_to_jax(pe, monkeypatch):
    """`mem` with BWA_TPU_NO_NATIVE_PE and BWA_TPU_NO_NATIVE_KSWA: the
    Python PE path, rescue in the device SW (plain on the CPU), the JAX
    package's SAM bytes under the same variables."""
    from bwa_mem_scale_tpu_torch.pipeline import native_kswa
    calls = []
    fn = kswa_cuda.ksw_align_batch_cuda
    monkeypatch.setattr(kswa_cuda, "ksw_align_batch_cuda",
                        lambda *a: calls.append(a[0].shape) or fn(*a))
    native = []
    nat_fn = native_kswa.align_batch
    monkeypatch.setattr(native_kswa, "align_batch",
                        lambda *a: native.append(1) or nat_fn(*a))
    body, _ = data.port_sam(pe, ENV)
    assert body == pe["sam"]
    assert len(calls) == len(pe["calls"]) and not native
    # without the variable, the native library rescues
    body2, _ = data.port_sam(pe, {"BWA_TPU_NO_NATIVE_PE": "1"})
    assert native and len(calls) == len(pe["calls"])
    assert body2.count("\n") == body.count("\n")


def test_rescue_without_native_library_raises(monkeypatch):
    """Unlike the JAX package, the port does not switch to the device when
    the native library fails to load: only the variable does."""
    from bwa_mem_scale_tpu_torch.pipeline import native_kswa, pe as t_pe

    def fail():
        raise ImportError("native kswa source missing")

    monkeypatch.setattr(native_kswa, "_load", fail)
    monkeypatch.delenv("BWA_TPU_NO_NATIVE_KSWA", raising=False)
    job = t_pe._RescueJob(pair=0, end=1, seq=np.zeros(30, np.uint8),
                          target=np.zeros(200, np.uint8), is_rev=False, rb=0,
                          l_ms=30, rid=0, is_alt=False)
    with pytest.raises(Exception):
        t_pe.run_rescue_jobs(OPT, [job])
    monkeypatch.setenv("BWA_TPU_NO_NATIVE_KSWA", "1")
    (score, te, qe, score2, tb, qb), = t_pe.run_rescue_jobs(OPT, [job])
    assert (score, te, qe, tb, qb) == (30, 29, 29, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(60, 96, 384), (2000, 160, 640),
                                   (64, 512, 1024), (64, 32, 128)])
def test_kernel_equal_to_twin_and_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, ql, t, tl = _jobs(11 + sum(shape), *shape)
    dev = torch.device("cuda")
    args = [torch.as_tensor(x, device=dev) for x in (q, ql, t, tl)]
    before = kswa_cuda.ksw_align_batch_cuda.launches
    got = kswa_cuda.ksw_align_batch_cuda(*args, OPT.mat, OPT.o_del, OPT.e_del,
                                         OPT.o_ins, OPT.e_ins, MINSC,
                                         MAX_MAT)
    assert kswa_cuda.ksw_align_batch_cuda.launches == before + 1
    want = ksw_align_batch(*args, OPT.mat, OPT.o_del, OPT.e_del, OPT.o_ins,
                           OPT.e_ins, MINSC, MAX_MAT)
    for k in want._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    if shape[0] <= 64:
        tw, steps = kswa_cuda.kswa_twin(q, ql, t, tl, OPT.mat, OPT.o_del,
                                        OPT.e_del, OPT.o_ins, OPT.e_ins,
                                        MINSC, MAX_MAT)
        for k in want._fields:
            np.testing.assert_array_equal(getattr(got, k).cpu().numpy(),
                                          getattr(tw, k), err_msg=k)
        np.testing.assert_array_equal(
            kswa_cuda.ksw_align_batch_cuda.last_steps.cpu().numpy(), steps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qe-tie", "reverse-stop", "K16"])
def test_kernel_edges_equal_to_twin(name):
    """The kernel on the wavefront's edge cases: every output and each
    job's steps equal to the twin's, the outputs to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, ql, t, tl = _case(name)
    args = [torch.as_tensor(x, device="cuda") for x in (q, ql, t, tl)]
    got = kswa_cuda.ksw_align_batch_cuda(*args, OPT.mat, OPT.o_del,
                                         OPT.e_del, OPT.o_ins, OPT.e_ins,
                                         MINSC, MAX_MAT)
    tw, steps = kswa_cuda.kswa_twin(q, ql, t, tl, OPT.mat, OPT.o_del,
                                    OPT.e_del, OPT.o_ins, OPT.e_ins, MINSC,
                                    MAX_MAT)
    want = _port(q, ql, t, tl)
    for k in want:
        np.testing.assert_array_equal(getattr(got, k).cpu().numpy(),
                                      want[k], err_msg=k)
        np.testing.assert_array_equal(getattr(tw, k), want[k], err_msg=k)
    np.testing.assert_array_equal(
        kswa_cuda.ksw_align_batch_cuda.last_steps.cpu().numpy(), steps)
