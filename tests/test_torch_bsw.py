"""Banded SW extension: the port's plain PyTorch version against the JAX
package's jnp kernel and its Pallas kernel (interpret mode), at the
shapes of tests/test_bsw_pallas.py and at band w and 2w; a PyTorch twin
of the CUDA kernel's lane-blocked row step (csrc/bsw.cu) against the jnp
kernel at query widths 33, 101, 151 and 255 (K = 2, 4, 5 and 8 columns a
lane), band w and 2w, z-drop on and off, and against the Pallas kernel
at one band a width; and, on a GPU, the CUDA kernel against the plain
version at the same widths, at edge batch sizes, at the column-tiled
instantiation's widths (800 and 2,200 columns), and `mem -x pacbio` on
800 bp reads on the card against the CPU run. Integer DP, exact
equality.

The JAX side is imported inside the tests that use it, so the CUDA cases
also run on a machine without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_bsw.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops.bsw import (banded_swa_batch as t_bsw,
                                             scoring)
from bwa_mem_scale_tpu_torch.ops import bsw_cuda
from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# o_del, e_del, o_ins, e_ins, zdrop
PEN = (6, 1, 6, 1, 100)
WIDTHS = (33, 101, 151, 255)        # K = 2, 4, 5, 8 columns a lane
NEG, BIG = -(1 << 30), 1 << 30


def _mat():
    mat = np.full((5, 5), -4, np.int32)
    np.fill_diagonal(mat, 1)
    mat[4, :] = -1
    mat[:, 4] = -1
    return mat


def _pairs(seed, P=64, QL=33, TL=57):
    """Near-matches, random pairs, dead lanes, N bases and z-drop
    triggers, as in tests/test_bsw_pallas.py plus N and z-drop rows."""
    r = np.random.RandomState(seed)
    qs = r.randint(0, 4, (P, QL)).astype(np.int32)
    ts = r.randint(0, 4, (P, TL)).astype(np.int32)
    n_real = P // 2
    ts[:n_real, :QL] = qs[:n_real]
    flip = r.rand(n_real, QL) < 0.05
    ts[:n_real, :QL] = np.where(flip, r.randint(0, 4, (n_real, QL)),
                                ts[:n_real, :QL])
    qs[r.rand(P, QL) < 0.01] = 4
    ts[r.rand(P, TL) < 0.01] = 4
    # z-drop: a good prefix, then garbage
    ts[n_real:n_real + 4, :QL // 2] = qs[n_real:n_real + 4, :QL // 2]
    q_lens = r.randint(5, QL + 1, P).astype(np.int32)
    t_lens = np.minimum(q_lens + r.randint(0, 30, P), TL).astype(np.int32)
    dead = r.rand(P) < 0.2
    q_lens[dead] = 0
    t_lens[dead & (r.rand(P) < 0.5)] = 0
    h0 = r.randint(5, 30, P).astype(np.int32)
    return qs, q_lens, ts, t_lens, h0


def _torch_args(arrs, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrs]


@pytest.mark.parametrize("w", [12, 24])
@pytest.mark.parametrize("seed", [0, 7])
def test_plain_bsw_equals_jnp_and_pallas(seed, w):
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.bsw import banded_swa_batch as j_bsw
    from bwa_mem_scale_tpu.ops.bsw_pallas import banded_swa_batch_pallas
    arrs = _pairs(seed)
    jargs = [jnp.asarray(a) for a in arrs]
    want = j_bsw(*jargs, w, *PEN, _mat())
    pallas = banded_swa_batch_pallas(*jargs, w, *PEN, _mat(), block=32,
                                     interpret=True)
    got = t_bsw(*_torch_args(arrs), w, *PEN, _mat())
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), f)
        np.testing.assert_array_equal(np.asarray(getattr(pallas, f)),
                                      getattr(got, f).numpy(), f)


def test_cuda_wrapper_on_cpu_tensors_runs_plain():
    """On CPU tensors the wrapper is the plain version (no launch)."""
    arrs = _pairs(3)
    before = banded_swa_batch_cuda.launches
    a = banded_swa_batch_cuda(*_torch_args(arrs), 12, *PEN, _mat())
    b = t_bsw(*_torch_args(arrs), 12, *PEN, _mat())
    assert banded_swa_batch_cuda.launches == before
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_lane_columns_and_limit():
    """The instantiation a query width takes: registers, shared memory,
    and past the widest of those (767 columns) the column-tiled one."""
    assert [bsw_cuda.lane_columns(q) for q in (31, 33, 101, 151, 255, 256,
                                               383, 384, 767)] \
        == [1, 2, 4, 5, 8, 12, 12, 16, 24]
    assert bsw_cuda.MAX_QL == 767
    assert [bsw_cuda.lane_columns(q) for q in (768, 2200, 5000)] \
        == [bsw_cuda.TILED] * 3
    assert bsw_cuda.TILED not in bsw_cuda.K_VALUES


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _equal_on_card(arrs, w, pen, dev):
    before = banded_swa_batch_cuda.launches
    got = banded_swa_batch_cuda(*_torch_args(arrs, dev), w, *pen, _mat())
    torch.cuda.synchronize()
    assert banded_swa_batch_cuda.launches == before + 1
    want = t_bsw(*_torch_args(arrs, dev), w, *pen, _mat())
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("QL", WIDTHS + (383, 767))
def test_cuda_kernel_equals_plain(QL):
    """The kernel against the plain version at the main path's bands
    (100 and 200, target QL + 208); 383 and 767 keep the row in shared
    memory (K = 12 and 24)."""
    dev = _cuda()
    for seed, w, zdrop in ((0, 100, 100), (7, 200, 0)):
        arrs = _pairs(seed, P=300, QL=QL, TL=QL + 208)
        _equal_on_card(arrs, w, PEN[:4] + (zdrop,), dev)


@pytest.mark.cuda
def test_cuda_kernel_edges():
    """One pair, a batch that is not a multiple of the block's warps, an
    all-dead batch; a length past its row raises before any launch."""
    dev = _cuda()
    for P in (1, 301):
        _equal_on_card(_pairs(P, P=P, QL=101, TL=309), 100, PEN, dev)
    qs, q_lens, ts, t_lens, h0 = _pairs(5, P=64, QL=101, TL=309)
    got = _equal_on_card((qs, q_lens * 0, ts, t_lens, h0), 100, PEN, dev)
    assert torch.equal(got.score.cpu(), torch.as_tensor(h0))
    assert int(got.gscore.max()) == -1 and int(got.qle.abs().max()) == 0
    before = banded_swa_batch_cuda.launches
    t_lens[0] = 310
    with pytest.raises(ValueError, match="exceeds its row count"):
        banded_swa_batch_cuda(*_torch_args((qs, q_lens, ts, t_lens, h0),
                                           dev), 100, *PEN, _mat())
    assert banded_swa_batch_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("QL", [800, 2200])
def test_cuda_tiled_kernel_equals_plain(QL):
    """Past 767 columns the column-tiled instantiation, bit-equal to the
    plain version: bands 40 (-x pacbio's w) and 100 with z-drop, 200
    without, and one pair, 4 and 301 pairs (the last block part full)."""
    dev = _cuda()
    assert bsw_cuda.lane_columns(QL) == bsw_cuda.TILED
    for seed, P, w, zdrop in ((0, 301, 40, 100), (1, 4, 100, 100),
                              (7, 301, 200, 0), (9, 1, 100, 100)):
        arrs = _pairs(seed, P=P, QL=QL, TL=QL + 208)
        _equal_on_card(arrs, w, PEN[:4] + (zdrop,), dev)


@pytest.mark.cuda
def test_cuda_mem_pacbio_800bp_equals_cpu(tmp_path):
    """`mem -x pacbio` on 800 bp reads (query width 800, past the shared
    memory tiers, below the preset's 880-column seed-SW threshold) on
    the card writes the CPU run's SAM bytes, through the tiled kernel."""
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    _cuda()
    bns = demo_genome(60000, seed=3, n_contigs=2)
    with open(tmp_path / "g.fa", "w") as f:
        for a in bns.anns:
            f.write(f">{a.name}\n"
                    f"{decode_bases(bns.seq[a.offset:a.offset + a.length])}"
                    "\n")
    codes, _ = simulate_reads(bns, 24, 800, seed=4, err_rate=0.03)
    with open(tmp_path / "r.fq", "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{decode_bases(c)}\n+\n{'I' * len(c)}\n")
    g = str(tmp_path / "g")
    assert cli.main(["index", g + ".fa", "-p", g]) == 0
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = tmp_path / f"{device}.sam"
        before = banded_swa_batch_cuda.launches
        cli.mem([g, str(tmp_path / "r.fq"), "-x", "pacbio", "-o",
                 str(out[device]), "--device", device])
        launched = banded_swa_batch_cuda.launches - before
        assert (launched > 0) == (device == "cuda")
    body = {d: [ln for ln in p.read_text().splitlines()
                if not ln.startswith("@PG")] for d, p in out.items()}
    assert body["cuda"] == body["cpu"]
    assert sum(1 for ln in body["cpu"] if not ln.startswith("@")) >= 24


def _kernel_twin(qs, q_lens, ts, t_lens, h0, w, o_del, e_del, o_ins, e_ins,
                 zdrop, mat):
    """csrc/bsw.cu's row step in PyTorch, the warp's lanes a dimension:
    each pair's DP row as [P, NT, 32, KT], lane l holding columns t*32*KT
    + l*KT .. + KT - 1 of tile t. Up to 767 columns one tile of K columns
    a lane (bsw_warp_kernel); past that tiles of KT = 8 (bsw_tiled_kernel),
    run one after another with the F prefix max and the H before the
    tile carried, and tiles outside [min(bg, en), max(bg, en)] skipped.
    The kernel's in-lane loops run along KT, its shuffles and warp
    reductions along the lanes; a pair stops where the kernel's warp
    breaks. Returns the kernel's six outputs."""
    i32 = torch.int32
    P, QL = qs.shape
    K = bsw_cuda.lane_columns(QL)
    KT = bsw_cuda.TILE // 32 if K == bsw_cuda.TILED else K
    TW = 32 * KT                                   # columns a tile
    NT = -(-(QL + 1) // TW)
    sc = scoring(mat)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    c_all = torch.arange(NT * TW, dtype=i32).reshape(1, NT, 32, KT)
    lane = torch.arange(32).reshape(1, 32)

    def up(x, d):        # __shfl_up_sync: lanes below d keep their own
        return torch.cat([x[:, :d], x[:, :-d]], 1)

    def bc(x):           # a per-pair value seen by every lane and column
        return x.reshape(-1, 1, 1)

    q = torch.full((P, NT * TW), 4, dtype=i32)
    q[:, :QL] = qs.clamp(0, 4)
    q = q.reshape(P, NT, 32, KT)
    qx = q_lens * sc["mx"]
    wp = torch.minimum(
        (torch.div(qx - o_ins, e_ins, rounding_mode="trunc") + 1).clamp(1),
        (torch.div(qx - o_del, e_del, rounding_mode="trunc") + 1).clamp(1)
    ).clamp(max=w)

    # first row: the ramp up to its first failing column (a warp min)
    bc4 = lambda x: x.reshape(-1, 1, 1, 1)
    h_of_1 = (h0 - oe_ins).clamp(min=0)
    ramp = bc4(h_of_1) - e_ins * (c_all - 1)
    fail = torch.where((c_all >= 1) & (ramp <= e_ins), c_all,
                       BIG).reshape(P, -1).amin(1)
    v = torch.where(c_all <= bc4(fail), ramp.clamp(min=0), 0)
    v = torch.where(c_all == 1, bc4(h_of_1),
                    torch.where(c_all == 0, bc4(h0), v))
    H = torch.where(c_all <= bc4(q_lens), v, 0)
    E = torch.zeros_like(H)

    beg = torch.zeros(P, dtype=i32)
    end = q_lens.clone()
    max_sc = h0.clone()
    max_i = torch.full((P,), -1, dtype=i32)
    max_j, max_ie, gscore = max_i.clone(), max_i.clone(), max_i.clone()
    max_off = torch.zeros(P, dtype=i32)
    alive = (q_lens > 0) & (t_lens > 0)
    for i in range(ts.shape[1]):
        live = alive & (i < t_lens)
        if not bool(live.any()):
            break
        tb = bc(ts[:, i].clamp(0, 4))
        bg = torch.maximum(beg, i - wp)
        en = torch.minimum(torch.minimum(end, i + wp + 1), q_lens)
        h1_first = torch.where(
            bg == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)
        B, N = bc(bg), bc(en)
        t0 = torch.minimum(bg, en) // TW
        t1 = (torch.maximum(bg, en) // TW).clamp(max=NT - 1)
        carry = torch.full((P,), NEG, dtype=i32)
        hcarry = torch.zeros(P, dtype=i32)
        lmax = torch.full((P, 32), -1, dtype=i32)
        larg, tail = lmax.clone(), lmax.clone()
        lead = torch.full((P, 32), BIG, dtype=i32)
        mine = torch.zeros((P, 32), dtype=i32)
        for t in range(NT):
            act = live & (t0 <= t) & (t <= t1)
            c, Ht, Et, qt = c_all[:, t], H[:, t], E[:, t], q[:, t]
            nn = (tb == 4) | (qt == 4)
            M = torch.where(Ht != 0, Ht + torch.where(
                nn, sc["sc_n"], torch.where(tb == qt, sc["sc_match"],
                                            sc["sc_mis"])), 0)
            inb = (c >= B) & (c < N)
            # the in-lane scan of the F keys, then the warp's exclusive
            # max-scan of the lane aggregates (5 shuffle steps), then the
            # carry of the earlier tiles
            key = torch.where(inb, (M - oe_ins).clamp(min=0) + e_ins * c,
                              NEG)
            lane_incl = torch.cummax(key, 2).values
            excl_in = torch.cat([torch.full((P, 32, 1), NEG, dtype=i32),
                                 lane_incl[..., :-1]], 2)
            incl = lane_incl[..., -1]
            for d in (1, 2, 4, 8, 16):     # lanes below d read their own
                incl = torch.maximum(incl, up(incl, d))
            run0 = torch.maximum(torch.where(lane == 0, NEG, up(incl, 1)),
                                 carry[:, None])
            carry = torch.where(act, torch.maximum(carry, incl[:, 31]),
                                carry)
            run = torch.maximum(run0[..., None], excl_in)
            f = (run - e_ins * (c - 1)).clamp(min=0)  # 0 at bg: no key before
            h = torch.where(inb, torch.maximum(torch.maximum(M, Et), f), 0)
            # the shift by one: lane l's first column takes lane l-1's
            # last H, lane 0's the H before the tile
            hprev = torch.cat([torch.where(lane == 0, hcarry[:, None],
                                           up(h[..., -1], 1))[..., None],
                               h[..., :-1]], 2)
            hcarry = torch.where(act, h[:, 31, -1], hcarry)
            # the lane's max so far, and the last column attaining it
            tmax = torch.where(inb, h, -1).amax(2)
            targ = torch.where(inb & (h == tmax[..., None]), c, -1).amax(2)
            better = act[:, None] & (tmax >= lmax)
            lmax = torch.where(better, tmax, lmax)
            larg = torch.where(better, targ, larg)
            enext = torch.maximum((M - oe_del).clamp(min=0), Et - e_del)
            nh = torch.where((c > B) & (c <= N), hprev, Ht)
            nh = torch.where(c == B, bc(h1_first), nh)
            ne = torch.where(inb, enext, Et)
            at = c == N
            nh = torch.where(at, torch.where(N > B, hprev, bc(h1_first)), nh)
            ne = torch.where(at, 0, ne)
            here = act[:, None] & at.any(2)
            mine = torch.where(here, torch.where(at, nh, 0).sum(2, dtype=i32),
                               mine)
            # the shrink: first and last non-zero column
            nz = (nh != 0) | (ne != 0)
            lead = torch.where(act[:, None], torch.minimum(
                lead, torch.where(nz & inb, c, BIG).amin(2)), lead)
            ttail = torch.where(nz & (c >= torch.minimum(B, N)) & (c <= N),
                                c, -1).amax(2)
            tail = torch.where(act[:, None] & (ttail >= 0), ttail, tail)
            H[:, t] = torch.where(bc(act), nh, Ht)
            E[:, t] = torch.where(bc(act), ne, Et)
        raw = lmax.amax(1)
        mj = torch.where(lmax == raw[:, None], larg, -1).amax(1)
        # h1_last: one lane owns column en, its H >= 0, the others' 0
        h1_last = mine.amax(1)
        lead, tail = lead.amin(1), tail.amax(1)

        gupd = live & (en == q_lens) & (gscore <= h1_last)
        gscore = torch.where(gupd, h1_last, gscore)
        max_ie = torch.where(gupd, i, max_ie)
        m = raw.clamp(min=0)
        brk0 = live & (m == 0)
        better = live & ~brk0 & (m > max_sc)
        max_off = torch.where(better, torch.maximum(max_off, (mj - i).abs()),
                              max_off)
        di, dj = i - max_i, mj - max_j
        delta = torch.where(di > dj, max_sc - m - (di - dj) * e_del,
                            max_sc - m - (dj - di) * e_ins)
        brkz = (live & ~brk0 & ~better & (delta > zdrop) if zdrop > 0
                else torch.zeros_like(live))
        max_sc = torch.where(better, m, max_sc)
        max_i = torch.where(better, i, max_i)
        max_j = torch.where(better, mj, max_j)
        beg2 = torch.where(lead < BIG, lead, en)
        end2 = torch.minimum(torch.where(tail >= 0, tail, beg2 - 1) + 2,
                             q_lens)
        beg = torch.where(live, beg2, beg)
        end = torch.where(live, end2, end)
        alive = live & ~brk0 & ~brkz
    return (max_sc, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)


@pytest.mark.parametrize("zdrop", [100, 0])
@pytest.mark.parametrize("band", ["w", "2w"])
@pytest.mark.parametrize("QL", WIDTHS + (800,))
def test_kernel_twin_equals_jnp_and_pallas(QL, band, zdrop):
    """The kernel's lane-blocked row step, exact against the jnp kernel
    (and the port's plain version) in every case, and against the
    Pallas kernel at band w with z-drop on up to 255 columns; 800
    columns take the tiled row step (4 tiles)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.bsw import banded_swa_batch as j_bsw
    from bwa_mem_scale_tpu.ops.bsw_pallas import banded_swa_batch_pallas
    arrs = _pairs(QL, QL=QL, TL=QL + 24)
    w = QL // 3 * (2 if band == "2w" else 1)
    pen = PEN[:4] + (zdrop,)
    jargs = [jnp.asarray(a) for a in arrs]
    want = j_bsw(*jargs, w, *pen, _mat())
    got = _kernel_twin(*_torch_args(arrs), w, *pen, _mat())
    plain = t_bsw(*_torch_args(arrs), w, *pen, _mat())
    refs = [want]
    if band == "w" and zdrop and QL in WIDTHS:
        refs.append(banded_swa_batch_pallas(*jargs, w, *pen, _mat(),
                                            block=32, interpret=True))
    for k, f in enumerate(FIELDS):
        for ref in refs:
            np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                          got[k].numpy(), f)
        np.testing.assert_array_equal(getattr(plain, f).numpy(),
                                      got[k].numpy(), f)
    assert (got[0] > torch.as_tensor(arrs[4])).any()     # real extensions
