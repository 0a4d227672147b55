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
  version: band-indexed strips of 1 to 16 positions and segments (their
  state in shared or in global memory), the rows of nibbles in shared
  memory or in tiles (a small block, or a block's share of an SM at many
  pairs), w = 0, empty sides, the left edge, gap scores that carry E and
  F across strips;
- ``plan`` and ``block_budget``: the shapes that raise, the wide bands
  that run with their state in global memory, the share of an SM;
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


def _twin_case(case):
    """(arrays, gap scores, block, budget) of a twin case: `block` stands
    for SMEM_BUDGET (a whole block's shared memory; None as it is),
    `budget` for the call's ``block_budget`` (None: the whole block). The
    generator at seeds 99 and 5; w = 0; pairs of tlen or qlen 0; a band of
    201 positions at QL = TL = 309 (w = 100: 8 positions a lane); w = 300
    there (two segments of 512), their state in shared memory or, in a
    block too small for it beside a tile of rows, in global memory; rows
    of nibbles in tiles (a small block), the traceback crossing tiles;
    w = 100 at a block's share of an SM at 1,024 pairs (132 SMs, 12 blocks
    an SM), in tiles too; gap scores of 1, which carry E and F across
    strips' edges; targets shorter than w, whose rows all lie at the left
    edge."""
    if isinstance(case, int):
        return _generator(seed=case)[1], GAPS, None, None
    if case in ("w0", "len0", "left"):
        arrs = list(_generator(seed=7, n=20, qmax=60, P=32, QL=64, TL=96)[1])
        if case == "w0":
            arrs[4] = np.zeros_like(arrs[4])
        elif case == "len0":
            arrs[1][:5] = 0
            arrs[3][5:10] = 0
        else:
            arrs[3] = np.minimum(arrs[3], 6)
            arrs[4] = np.maximum(arrs[4], 12)
        return arrs, GAPS, None, None
    arrs = list(_generator(seed=11, n=12, qmax=300, P=16, QL=309, TL=309)[1])
    if case in ("w100", "share"):
        arrs[4] = np.full_like(arrs[4], 100)
        return arrs, GAPS, None, (kswg_cuda.block_budget(1024, 132, 12)
                                  if case == "share" else None)
    if case in ("segments", "state"):
        arrs[4] = np.full_like(arrs[4], 300)
        return arrs, (2, 1, 1, 1), 30000 if case == "segments" else 12000, \
            None
    return arrs, (1, 1, 1, 1) if case == "gaps" else GAPS, (
        2000 if case == "tiles" else None), None


TWIN_CASES = [99, 5, "w0", "len0", "left", "w100", "segments", "state",
              "tiles", "share", "gaps"]


@pytest.mark.parametrize("seed", TWIN_CASES)
def test_twin_equal_to_plain(seed, monkeypatch):
    """kswg_twin (the kernel's band-indexed strips, nibble rows and
    traceback) equal to the plain version on every output; its steps are
    n_ops, a pass a segment a row covers the band's cells, the tile cases
    cross tiles, and the state case keeps its state in global memory."""
    arrs, gaps, block, budget = _twin_case(seed)
    if block is not None:
        monkeypatch.setattr(kswg_cuda, "SMEM_BUDGET", block)
    want = _port(arrs, lambda *a: ksw_global_batch(*a[:5], *gaps, a[-1]))
    QL, TL = arrs[0].shape[1], arrs[2].shape[1]
    _, S = kswg_cuda.strip(int(arrs[4].max()), QL, TL)
    got, passes, steps, tiles = kswg_cuda.kswg_twin(*arrs, *gaps, OPT.mat,
                                                    budget=budget)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    np.testing.assert_array_equal(steps, want["n_ops"])
    # each pair's own strip: a pass a segment a row, covering its cells
    ql, tl = np.clip(arrs[1], 0, QL), np.clip(arrs[3], 0, TL)
    rs = np.array([kswg_cuda.strip(min(w, max(q, t)), QL, TL) for w, q, t
                   in zip(arrs[4].tolist(), ql.tolist(), tl.tolist())])
    cells = kswg_cuda.band_cells(arrs[1], arrs[3], arrs[4])
    assert (passes == tl * rs[:, 1]).all()
    assert (passes * 32 * rs[:, 0] >= cells).all()
    assert (S > 1) == (seed in ("segments", "state"))
    assert (tiles.max() >= 2) == (seed in ("tiles", "segments", "state",
                                           "share"))
    _, _, zsb = kswg_cuda.plan(QL, TL, int(arrs[4].max()), budget)
    assert (zsb > 0) == (seed == "state")


def test_block_budget():
    """A whole block while the pairs are no more than the SMs; past them
    an even share of an SM among the blocks it holds at once, at most the
    kernel's blocks an SM."""
    assert kswg_cuda.block_budget(16, 132, 12) == kswg_cuda.SMEM_BUDGET
    assert kswg_cuda.block_budget(132, 132, 12) == kswg_cuda.SMEM_BUDGET
    assert kswg_cuda.block_budget(133, 132, 12) == 233472 // 2 - 1152
    assert kswg_cuda.block_budget(1024, 132, 12) == 233472 // 8 - 1152
    assert kswg_cuda.block_budget(65536, 132, 12) == 233472 // 12 - 1152
    for P in (133, 512, 1024, 65536):      # every block fits on its SM
        per_sm = min(-(-P // 132), 12)
        assert per_sm * (kswg_cuda.block_budget(P, 132, 12) + 1024
                         + 128) <= 233472


@pytest.mark.parametrize("shape", [
    (2400, 2432, 100, "share"), (29024, 29024, 10000, "state"),
    (29024, 29024, 29024, "state"), (29024, 100000, 100000, "state"),
    (29024, 200000, 100, "tiles"), (29024, 101300, 101300, "raises"),
    (29024, 202300, 100, "raises")])
def test_plan_limits(shape):
    """The long reads at a block's share of an SM take tiles of more than
    TILE_ROWS rows; wide bands at QL = TL = 29,024 (which the first form of
    this design refused) run with their state in global memory; a call
    raises only when its codes and one row pass a block: TL past about
    100,000 at the widest band, past about 200,000 at a narrow one."""
    QL, TL, w, form = shape
    if form == "raises":
        with pytest.raises(ValueError, match="no room for one row"):
            kswg_cuda.plan(QL, TL, w)
        return
    budget = kswg_cuda.block_budget(1024, 132, 12) if form == "share" else \
        None
    rest, zrb, zsb = kswg_cuda.plan(QL, TL, w, budget)
    R, S = kswg_cuda.strip(w, QL, TL)
    RB, ST = kswg_cuda.row_bytes(R, S), kswg_cuda.state_bytes(R, S)
    assert kswg_cuda.codes_bytes(QL, TL) + rest <= kswg_cuda.SMEM_BUDGET
    assert zrb == RB and (zsb > 0) == (form == "state")
    room = kswg_cuda.SMEM_BUDGET - kswg_cuda.codes_bytes(QL, TL)
    rows = (rest - (ST - zsb)) // RB
    assert rows >= min(kswg_cuda.TILE_ROWS, (room - (ST - zsb)) // RB)
    if form == "share":                     # the share, past a tile
        assert kswg_cuda.TILE_ROWS < rows < TL
        assert rest <= budget - kswg_cuda.codes_bytes(QL, TL)


def test_twin_equal_to_plain_on_cigar_jobs(pe):
    for args, want in pe["calls"][:2]:
        got, _, _, _ = kswg_cuda.kswg_twin(*args[:5], *GAPS, OPT.mat)
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
@pytest.mark.parametrize("case", ["generator", "pe", "long", "many", "wide",
                                  "tiles", "segments", "state"])
def test_kernel_equal_to_twin_and_plain(case, monkeypatch):
    """The kernel against the plain version (and its twin, but on the
    batches of 1,024 pairs): the generator, phase 7's shapes, long reads
    (16 pairs, a whole block each; 1,024 pairs, a share of an SM each, in
    tiles), a band of 8 positions a lane (w = 100), the tile form (a
    small block) and two segments (w = 300, gap scores of 1 and 2) with
    their state in shared and in global memory; a launch whose rest
    leaves the widest band no row is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gaps, block = GAPS, None
    if case == "generator":
        _, arrs = _generator()
    elif case == "pe":
        _, arrs = _generator(seed=3, n=1000, qmax=152, P=1024, QL=160,
                             TL=256)
    elif case == "long":
        _, arrs = _generator(seed=4, n=6, qmax=2500, P=16, QL=2528, TL=2624)
    elif case == "many":
        _, arrs = _generator(seed=6, n=600, qmax=2500, P=1024, QL=2528,
                             TL=2624)
    else:
        arrs, gaps, block, _ = _twin_case({"wide": "w100"}.get(case, case))
    if block is not None:
        monkeypatch.setattr(kswg_cuda, "SMEM_BUDGET", block)
    dev = torch.device("cuda")
    args = [torch.as_tensor(x, device=dev) for x in arrs]
    before = kswg_cuda.ksw_global_batch_cuda.launches
    got = kswg_cuda.ksw_global_batch_cuda(*args, *gaps, OPT.mat)
    assert kswg_cuda.ksw_global_batch_cuda.launches == before + 1
    want = ksw_global_batch(*args, *gaps, OPT.mat)
    for k in want._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    P, QL, TL = *arrs[0].shape, arrs[2].shape[1]
    w_max = int(arrs[4].max())
    _, zrb, zsb = kswg_cuda.launch_plan(dev, P, QL, TL, w_max)
    assert (zrb > 0) == (case in ("many", "tiles", "segments", "state"))
    assert (zsb > 0) == (case == "state")
    if case not in ("pe", "many"):
        tw, _, _, _ = kswg_cuda.kswg_twin(*arrs, *gaps, OPT.mat)
        for k in want._fields:
            np.testing.assert_array_equal(getattr(got, k).cpu().numpy(),
                                          getattr(tw, k), err_msg=k)
    # csrc/kswg.cu refuses a rest that leaves the widest band no row
    R, S = kswg_cuda.strip(w_max, QL, TL)
    short = kswg_cuda.row_bytes(R, S) - 16
    monkeypatch.setattr(kswg_cuda, "launch_plan",
                        lambda *a: (short, kswg_cuda.row_bytes(R, S), 0))
    with pytest.raises(RuntimeError, match="kswg_launch failed"):
        kswg_cuda.launch(*args, *gaps, OPT.mat, w_max)
