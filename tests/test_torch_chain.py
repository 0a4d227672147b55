"""Seed chaining and the chain filter: the CUDA kernels' CPU twins
(``chain_cuda.chain_seeds_twin``, ``chain_filter_twin``, the kernels' own
loops), the port's lockstep versions and the JAX package's
``chain_seeds_device`` / ``chain_filter_device`` / ``frac_rep_device`` on
one seeded synthetic batch, exactly equal. The batch holds reverse-strand
hits, an alt contig, seeds that bridge two contigs or the strands'
junction, chains of equal weight, reads past the chain and seed
capacities, SMEMs over max_occ, and a read whose overlap and drop tests
a float32 product would decide the other way.

The anchor sentinel: a seed at or above 2^29 - 1 (the empty-key marker)
still finds its lower chain in the port; the JAX package's chains differ
there and only there.

Planted reads put the warp kernels' chunk boundaries to work: more than
32 chains, keys equal to a seed's rbeg, a full chain, and (on the overlap
step alone) a first dominating chain in the second chunk of 32.

On a GPU (``-m cuda``) each kernel against its plain version, with its
per-read steps and rounds equal to its twin's, at the main path's and
both retry tiers' capacities (the last also past 48 KB of shared memory),
on the planted reads, on chip_smoke.py's repeat batch, and on the
sentinel read above and below the marker:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_chain.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import chain as tchain
from bwa_mem_scale_tpu_torch.ops import chain_cuda
from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

OFFSETS = np.array([0, 4000, 7000, 12000, 16000], np.int64)
IS_ALT = np.array([False, False, True, False, True])
L_PAC = 20000
W, GAP = 100, 10000                    # MemOptions' w and max_chain_gap
MAX_OCC = 500
# mem_chain_flt's options: the defaults, and a set whose products
# (27 >= 90 * 0.3, 27 < 90 * 0.3) a float32 multiply decides the other
# way, with a weight floor and an extension cap
FLT = {"default": dict(min_chain_weight=0, mask_level=0.5,
                       max_chain_gap=GAP, drop_ratio=0.5, min_seed_len=19,
                       max_chain_extend=1 << 30),
       "float64": dict(min_chain_weight=20, mask_level=0.3,
                       max_chain_gap=GAP, drop_ratio=0.3, min_seed_len=19,
                       max_chain_extend=2)}
CAPS = {"roomy": (16, 8), "tiny": (4, 2)}


def synthetic_batch(seed, B=48, M=12, NC=64):
    """SMEM buffers ((m, n)-sorted) and their SA-expanded coordinates for
    B reads, from numpy's RandomState(seed): 1-5 loci a read (forward,
    reverse, in an alt contig, across a contig boundary or the strands'
    junction), each SMEM placed at each locus with probability 0.8 on
    the locus' diagonal, or off it by a few bases or by thousands. The
    last read is the float64 case: SMEMs [0, 27), [0, 90) and [63, 153)
    alone at three loci (weights 27, 90, 90). Returns numpy arrays
    (m, n, s, cnt, lens, rbeg, seed_idx, total)."""
    rng = np.random.RandomState(seed)
    m = np.zeros((B, M), np.int32)
    n = np.zeros((B, M), np.int32)
    s = np.zeros((B, M), np.int32)
    cnt = np.zeros(B, np.int32)
    lens = np.zeros(B, np.int32)
    rbeg = np.zeros((B, NC), np.int32)
    seed_idx = np.zeros((B, NC), np.int32)
    total = np.zeros(B, np.int32)
    edges = [int(o) for o in OFFSETS[1:]] + [L_PAC]
    for b in range(B - 1):
        L = rng.randint(60, 160)
        k = rng.randint(0, M + 1)
        qb = rng.randint(0, L - 12, k)
        ln = np.minimum(rng.randint(12, 70, k), L - qb)
        o = np.lexsort((qb + ln - 1, qb))
        m[b, :k], n[b, :k] = qb[o], (qb + ln - 1)[o]
        s[b, :k] = np.where(rng.rand(k) < 0.15, rng.randint(501, 900, k),
                            rng.randint(1, 4, k))
        cnt[b], lens[b] = k + (rng.rand() < 0.05), L
        loci = []
        for _ in range(rng.randint(1, 6)):
            kind = rng.randint(6)
            if kind == 0:                       # across a contig boundary
                loci.append(edges[rng.randint(len(edges) - 1)] - 40)
            elif kind == 1:                     # across the junction
                loci.append(L_PAC - rng.randint(20, 80))
            elif kind == 2:                     # in an alt contig
                loci.append(rng.randint(7000, 11800))
            else:                               # forward or reverse
                loci.append(rng.randint(0, 2 * L_PAC - 200))
        if rng.rand() < 0.3:                    # a repeat: one locus twice
            loci.append(loci[0] + rng.randint(3000, 6000))
        c = 0
        for i in range(k):
            for locus in loci:
                if rng.rand() < 0.2 or c >= NC:
                    continue
                r = rng.rand()
                off = (0 if r < 0.7 else rng.randint(-6, 7) if r < 0.9
                       else rng.randint(-5000, 5000))
                rbeg[b, c] = max(locus + m[b, i] + off, 0)
                seed_idx[b, c] = i
                c += 1
        total[b] = c
    b = B - 1
    m[b, :3], n[b, :3] = (0, 0, 63), (26, 89, 152)
    s[b, :3], cnt[b], lens[b] = 1, 3, 153
    rbeg[b, :3], seed_idx[b, :3], total[b] = (1000, 2000, 3063), (0, 1, 2), 3
    return m, n, s, cnt, lens, rbeg, seed_idx, total


def _smems(m, n, s, cnt, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)
    return SmemBuf(t(m), t(n), t(np.zeros_like(m)), t(np.zeros_like(m)),
                   t(s), t(cnt))


def _bns(device="cpu"):
    return tchain.DeviceBns(offsets=torch.as_tensor(OFFSETS, device=device),
                            is_alt=torch.as_tensor(IS_ALT, device=device),
                            l_pac=L_PAC)


def _coord_valid(total, NC):
    return np.arange(NC)[None, :] < np.asarray(total)[:, None]


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(5)


@pytest.fixture(scope="module", params=list(CAPS), ids=list(CAPS))
def chained(request, batch):
    """The batch chained at the param's (C, S) by the JAX package, the
    port's lockstep and the kernel's twin."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import smem as jsmem
    m, n, s, cnt, lens, rbeg, seed_idx, total = batch
    C, S = CAPS[request.param]
    valid = _coord_valid(total, rbeg.shape[1])
    kw = dict(w=W, max_chain_gap=GAP, max_chains=C, max_seeds_per_chain=S)
    j = lambda a: jnp.asarray(a)
    jsm = jsmem.SmemBuf(j(m), j(n), j(np.zeros_like(m)), j(np.zeros_like(m)),
                        j(s), j(cnt))
    jb = jchain.DeviceBns(offsets=j(OFFSETS), is_alt=j(IS_ALT), l_pac=L_PAC)
    jch = jchain.chain_seeds_device(jb, jsm, j(rbeg), j(seed_idx), j(valid),
                                    **kw)
    stats = {}
    tch = tchain.chain_seeds_device(
        _bns(), _smems(m, n, s, cnt), torch.as_tensor(rbeg),
        torch.as_tensor(seed_idx), torch.as_tensor(valid), stats=stats, **kw)
    twin, steps, rounds = chain_cuda.chain_seeds_twin(
        OFFSETS, L_PAC, m, n, rbeg, seed_idx, valid, **kw)
    return dict(caps=request.param, jax=(jch, jsm, jb), port=tch,
                twin=twin, steps=steps, rounds=rounds, stats=stats)


def test_chain_seeds_twin_equal_to_lockstep_and_jax(batch, chained):
    """Every Chains field of the twin, the lockstep and the JAX package
    equal; the twin walks each read's coordinates (the lockstep's
    chain_steps is the longest); the batch reaches what it is built to
    reach: reverse-strand, alt and skipped (bridging) seeds, seed and
    chain overflow at the tiny capacities."""
    jch, tch, twin = chained["jax"][0], chained["port"], chained["twin"]
    for f in tchain.Chains._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jch, f)),
                                      getattr(tch, f).numpy(), f)
        np.testing.assert_array_equal(getattr(twin, f),
                                      getattr(tch, f).numpy(), f)
    total = batch[7]
    np.testing.assert_array_equal(chained["steps"], total)
    assert chained["stats"]["chain_steps"] == total.max()
    live = np.arange(twin.rid.shape[1])[None, :] < twin.n[:, None]
    rids = twin.rid[live]
    assert IS_ALT[rids].any() and (~IS_ALT[rids]).any()
    assert (twin.seed_rbeg[twin.seed_len > 0] >= L_PAC).any()
    m, n, rbeg, seed_idx = batch[0], batch[1], batch[5], batch[6]
    skipped = {chain_cuda._intv2rid(OFFSETS, L_PAC, int(rbeg[b, c]),
                                    int(rbeg[b, c] + n[b, seed_idx[b, c]]
                                        + 1 - m[b, seed_idx[b, c]]))
               for b in range(len(total)) for c in range(total[b])}
    assert {-2, -1} <= skipped        # over the junction, over contigs
    if chained["caps"] == "tiny":
        assert twin.overflow.sum() > 5
        assert (twin.n == 4).any() and (twin.n_seeds == 2).any()
    else:
        assert not twin.overflow[-1]


@pytest.mark.parametrize("flt", list(FLT))
def test_chain_filter_twin_equal_to_lockstep_and_jax(batch, chained, flt):
    """order, kept, w_by_slot and frac_rep of the filter kernel's twin,
    the port's chain_filter_frac_rep and the JAX package's
    chain_filter_device + frac_rep_device: equal, at the default options
    and at options whose comparisons need float64. The batch has chains
    of equal weight in one read, and every kept value; the last read's
    kept values are those float64 gives (float32 gives others)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    m, n, s, cnt, lens, rbeg, seed_idx, total = batch
    jch, jsm, jb = chained["jax"]
    kw = FLT[flt]
    want = (*jchain.chain_filter_device(jch, jb, **kw),
            jchain.frac_rep_device(jsm, jnp.asarray(lens), MAX_OCC))
    got = tchain.chain_filter_frac_rep(
        chained["port"], _bns(), _smems(m, n, s, cnt), torch.as_tensor(lens),
        max_occ=MAX_OCC, **kw)
    twin = chain_cuda.chain_filter_twin(IS_ALT, chained["twin"], m, n, s,
                                        cnt, lens, max_occ=MAX_OCC, **kw)
    for name, a, b, c in zip(("order", "kept", "w_by_slot", "frac_rep"),
                             want, got, twin):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
        np.testing.assert_array_equal(c, b.numpy(), name)
    order, kept, w_slot, frac_rep, steps, rounds = twin
    w_sorted = np.take_along_axis(w_slot, order, 1)
    n_ch = chained["twin"].n
    assert any(len(set(w_slot[b, :n_ch[b]])) < n_ch[b]      # equal weights
               for b in range(len(lens)))
    assert set(np.unique(kept)) == {0, 1, 2, 3} or flt == "float64"
    assert (frac_rep > 0).any() and steps.max() > 0
    # the float64 read: chain weights 90, 90, 27 in sorted order; at the
    # float64 options 27 >= 90 * 0.3 holds (the second chain overlaps the
    # first: 2, then 1 as its first) and 27 < 90 * 0.3 does not (the
    # third is kept: 2, then cut by max_chain_extend); float32 products
    # give [3, 3, 1]
    last = len(lens) - 1
    np.testing.assert_array_equal(w_sorted[last, :3], [90, 90, 27])
    f32 = np.float32
    assert (f32(27) >= f32(90) * f32(0.3)) != (27 >= 90 * 0.3)
    assert (f32(27) < f32(90) * f32(0.3)) != (27 < 90 * 0.3)
    np.testing.assert_array_equal(kept[last, :3],
                                  [3, 1, 0] if flt == "float64" else [3, 3, 1])


SENTINEL_SHIFTS = dict(zip(["above-sentinel", "below-sentinel"],
                           [0, -300_000_000]))
SENTINEL_L_PAC = 400_000_000


def sentinel_read(shift):
    """One read, two loci ~50 Mbp apart on the reverse strand of a 400 Mbp
    genome (one contig), two colinear seeds each, at ~600 M + shift.
    Returns numpy arrays (m, n, s, cnt, lens, rbeg, seed_idx, total)."""
    a, b = 600_000_000 + shift, 650_000_000 + shift
    m = np.array([[0, 30]], np.int32)
    n = np.array([[19, 49]], np.int32)
    rbeg = np.array([[a, b, a + 30, b + 30]], np.int32)
    return (m, n, np.ones_like(m), np.array([2], np.int32),
            np.array([50], np.int32), rbeg,
            np.array([[0, 0, 1, 1]], np.int32), np.array([4], np.int32))


@pytest.mark.parametrize("shift", list(SENTINEL_SHIFTS.values()),
                         ids=list(SENTINEL_SHIFTS))
def test_chain_anchor_sentinel(shift):
    """The sentinel read: at ~600 M, above the empty-key marker 2^29 - 1,
    the port's lockstep and the kernel's twin give the reference's two
    chains of two seeds; the JAX package, which counts the marker as a
    key, gives three ([2, 1, 1]). Shifted below the marker all three
    give [2, 2] and equal arrays."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import smem as jsmem
    l_pac = SENTINEL_L_PAC
    m, n, ones, cnt, _, rbeg, seed_idx, _ = sentinel_read(shift)
    a, b = int(rbeg[0, 0]), int(rbeg[0, 1])
    valid = np.ones((1, 4), bool)
    kw = dict(w=W, max_chain_gap=GAP, max_chains=8, max_seeds_per_chain=4)
    offsets, is_alt = np.zeros(1, np.int64), np.zeros(1, bool)
    tb = tchain.DeviceBns(offsets=torch.as_tensor(offsets),
                          is_alt=torch.as_tensor(is_alt), l_pac=l_pac)
    tch = tchain.chain_seeds_device(tb, _smems(m, n, ones, cnt),
                                    torch.as_tensor(rbeg),
                                    torch.as_tensor(seed_idx),
                                    torch.as_tensor(valid), **kw)
    twin, _, _ = chain_cuda.chain_seeds_twin(offsets, l_pac, m, n, rbeg,
                                             seed_idx, valid, **kw)
    j = jnp.asarray
    jch = jchain.chain_seeds_device(
        jchain.DeviceBns(offsets=j(offsets), is_alt=j(is_alt), l_pac=l_pac),
        jsmem.SmemBuf(j(m), j(n), j(ones), j(ones), j(ones), j([2])),
        j(rbeg), j(seed_idx), j(valid), **kw)
    counts = lambda ch: [int(v) for v in np.asarray(ch.n_seeds)[0]
                         [:int(np.asarray(ch.n)[0])]]
    assert counts(tch) == counts(twin) == [2, 2]
    for f in tchain.Chains._fields:
        np.testing.assert_array_equal(getattr(twin, f),
                                      getattr(tch, f).numpy(), f)
    if shift:
        assert counts(jch) == [2, 2]
        for f in tchain.Chains._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jch, f)),
                                          getattr(tch, f).numpy(), f)
    else:
        assert min(a, b) > tchain.BIG and counts(jch) == [2, 1, 1]


def test_chain_wrappers_on_cpu_run_plain(batch):
    """On CPU tensors chain_seeds_cuda and chain_filter_cuda are their
    plain versions (no launch), with the lockstep's chain_steps."""
    m, n, s, cnt, lens, rbeg, seed_idx, total = batch
    valid = torch.as_tensor(_coord_valid(total, rbeg.shape[1]))
    sm, bns = _smems(m, n, s, cnt), _bns()
    kw = dict(w=W, max_chain_gap=GAP, max_chains=16, max_seeds_per_chain=8)
    before = (chain_cuda.chain_seeds_cuda.launches,
              chain_cuda.chain_filter_cuda.launches)
    st_a, st_b = {}, {}
    args = (torch.as_tensor(rbeg), torch.as_tensor(seed_idx), valid)
    a = chain_cuda.chain_seeds_cuda(bns, sm, *args, stats=st_a, **kw)
    b = tchain.chain_seeds_device(bns, sm, *args, stats=st_b, **kw)
    assert st_a == st_b and all(torch.equal(x, y) for x, y in zip(a, b))
    fkw = dict(FLT["default"], max_occ=MAX_OCC)
    fa = chain_cuda.chain_filter_cuda(a, bns, sm, torch.as_tensor(lens),
                                      stats=st_a, **fkw)
    fb = tchain.chain_filter_frac_rep(b, bns, sm, torch.as_tensor(lens),
                                      stats=st_b, **fkw)
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert (chain_cuda.chain_seeds_cuda.launches,
            chain_cuda.chain_filter_cuda.launches) == before


# ---- planted reads: the warp kernels' chunk boundaries ------------------

PLANTED = ["over-32-chains", "equal-keys", "full-chain",
           "dominated-in-second-chunk"]
PLANTED_CAPS = (64, 4)                 # C, S
EQUAL_KEY = 15_000                     # in contig 3, forward strand
DOMINATED_STEPS = 703                  # the last case's filter steps


def _plain_loci(n, span):
    """n loci 500 bp apart whose [locus, locus + span) lies in one
    non-alt contig, forward or reverse."""
    loci = [100 + 500 * k for k in range(2 * L_PAC // 500)]
    rid = lambda p: chain_cuda._intv2rid(OFFSETS, L_PAC, p, p + span)
    return [p for p in loci if rid(p) >= 0 and not IS_ALT[rid(p)]][:n]


def planted_batch(NC=96, M=8):
    """One read a case of PLANTED, at C = 64 and S = 4 (numpy arrays (m,
    n, s, cnt, lens, rbeg, seed_idx, total)):
    - over-32-chains: 40 loci 300 bp apart, each two colinear seeds, the
      first seeds in shuffled order, then the second seeds: 40 chains, so
      the lower chains are sought among more than 32 anchors and the
      ranks take two chunks of keys;
    - equal-keys: 31 chains below EQUAL_KEY, then three seeds at
      EQUAL_KEY whose query spans forbid a merge, then one at EQUAL_KEY +
      20 colinear with the third: each new key goes after the equal keys
      (the 32 keys <= EQUAL_KEY fill the first chunk of ranks), so the
      last seed's lower chain is the third, and it appends;
    - full-chain: six colinear seeds at one locus, then one far away: the
      chain takes four (S) and refuses two appends, and the far seed still
      starts a chain;
    - dominated-in-second-chunk: 36 chains of weight 100 (query [0, 100)
      35 times, [150, 250) once) and one of weight 40 (query [160,
      200)), each at its own locus: in weight order the light chain's
      overlap loop meets significant-free chains 0-34 and its first
      dominating chain at position 35, the second chunk's fourth lane
      (DOMINATED_STEPS filter steps at the default options)."""
    rng = np.random.RandomState(1)
    B = len(PLANTED)
    m = np.zeros((B, M), np.int32)
    n = np.zeros((B, M), np.int32)
    s = np.ones((B, M), np.int32)
    cnt = np.zeros(B, np.int32)
    lens = np.zeros(B, np.int32)
    rbeg = np.zeros((B, NC), np.int32)
    seed_idx = np.zeros((B, NC), np.int32)
    total = np.zeros(B, np.int32)

    def read(b, smems, coords, length):
        for i, (qb, qe) in enumerate(smems):
            m[b, i], n[b, i] = qb, qe - 1
        cnt[b], lens[b], total[b] = len(smems), length, len(coords)
        for c, (si, r) in enumerate(coords):
            seed_idx[b, c], rbeg[b, c] = si, r

    loci = 100 + 300 * np.arange(40)
    read(0, [(0, 20), (30, 50)],
         [(0, int(p)) for p in rng.permutation(loci)]
         + [(1, int(p) + 30) for p in rng.permutation(loci)], 60)
    read(1, [(0, 20), (150, 170), (300, 320), (320, 340)],
         [(0, int(p)) for p in loci[:31]] + [(0, EQUAL_KEY), (1, EQUAL_KEY),
                                             (2, EQUAL_KEY),
                                             (3, EQUAL_KEY + 20)], 360)
    read(2, [(25 * k, 25 * k + 20) for k in range(7)],
         [(k, 2000 + 25 * k) for k in range(6)] + [(6, 30_000)], 180)
    s[2, :2] = MAX_OCC + 100                 # two repetitive SMEMs
    far = _plain_loci(37, 250)
    read(3, [(0, 100), (150, 250), (160, 200)],
         [(0, p) for p in far[:35]] + [(1, far[35]), (2, far[36])], 260)
    return m, n, s, cnt, lens, rbeg, seed_idx, total


@pytest.fixture(scope="module")
def planted():
    """The planted batch chained and filtered (both option sets) by the
    JAX package, the port's lockstep and the kernels' twins."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import smem as jsmem
    m, n, s, cnt, lens, rbeg, seed_idx, total = planted_batch()
    C, S = PLANTED_CAPS
    valid = _coord_valid(total, rbeg.shape[1])
    kw = dict(w=W, max_chain_gap=GAP, max_chains=C, max_seeds_per_chain=S)
    j = jnp.asarray
    jsm = jsmem.SmemBuf(j(m), j(n), j(np.zeros_like(m)), j(np.zeros_like(m)),
                        j(s), j(cnt))
    jb = jchain.DeviceBns(offsets=j(OFFSETS), is_alt=j(IS_ALT), l_pac=L_PAC)
    jch = jchain.chain_seeds_device(jb, jsm, j(rbeg), j(seed_idx), j(valid),
                                    **kw)
    sm = _smems(m, n, s, cnt)
    tch = tchain.chain_seeds_device(_bns(), sm, torch.as_tensor(rbeg),
                                    torch.as_tensor(seed_idx),
                                    torch.as_tensor(valid), **kw)
    twin, steps, rounds = chain_cuda.chain_seeds_twin(
        OFFSETS, L_PAC, m, n, rbeg, seed_idx, valid, **kw)
    flt = {}
    for name, fkw in FLT.items():
        flt[name] = (
            (*jchain.chain_filter_device(jch, jb, **fkw),
             jchain.frac_rep_device(jsm, j(lens), MAX_OCC)),
            tchain.chain_filter_frac_rep(tch, _bns(), sm,
                                         torch.as_tensor(lens),
                                         max_occ=MAX_OCC, **fkw),
            chain_cuda.chain_filter_twin(IS_ALT, twin, m, n, s, cnt, lens,
                                         max_occ=MAX_OCC, **fkw))
    return dict(jax=jch, port=tch, twin=twin, steps=steps, rounds=rounds,
                total=total, flt=flt)


@pytest.mark.parametrize("case", PLANTED)
def test_chain_planted_twin_equal_to_lockstep_and_jax(planted, case):
    """The planted case's read: every Chains field of the twin, the
    lockstep and the JAX package equal, and order, kept, w_by_slot and
    frac_rep of the filter's twin, the lockstep and the JAX package
    equal at both option sets; then what the case plants holds."""
    b = PLANTED.index(case)
    jch, tch, twin = planted["jax"], planted["port"], planted["twin"]
    for f in tchain.Chains._fields:
        want = getattr(tch, f).numpy()[b]
        np.testing.assert_array_equal(np.asarray(getattr(jch, f))[b], want, f)
        np.testing.assert_array_equal(getattr(twin, f)[b], want, f)
    assert planted["steps"][b] == planted["total"][b]
    for name, (want, got, tw) in planted["flt"].items():
        for what, a, p, t in zip(("order", "kept", "w_by_slot", "frac_rep"),
                                 want, got, tw):
            np.testing.assert_array_equal(np.asarray(a)[b], p.numpy()[b],
                                          f"{name} {what}")
            np.testing.assert_array_equal(t[b], p.numpy()[b],
                                          f"{name} {what}")
    nch = int(twin.n[b])
    if case == "over-32-chains":
        assert nch == 40 and (twin.n_seeds[b, :40] == 2).all()
        assert (np.diff(twin.key[b, :40]) > 0).all()
    elif case == "equal-keys":
        assert nch == 34
        np.testing.assert_array_equal(twin.key[b, 31:34], [EQUAL_KEY] * 3)
        np.testing.assert_array_equal(twin.slot[b, 31:34], [31, 32, 33])
        np.testing.assert_array_equal(twin.n_seeds[b, 31:34], [1, 1, 2])
    elif case == "full-chain":
        assert nch == 2 and twin.overflow[b]
        np.testing.assert_array_equal(twin.n_seeds[b, :2], [4, 1])
        assert planted["flt"]["default"][2][3][b] > 0       # frac_rep
    else:
        order, kept, w_slot, _, steps, _ = planted["flt"]["default"][2]
        np.testing.assert_array_equal(
            w_slot[b, order[b, :37]], [100] * 36 + [40])
        assert steps[b] == DOMINATED_STEPS
        assert kept[b, 35] == 3 and kept[b, 36] in (0, 1)


WIDE = dict(offsets=np.zeros(1, np.int64), is_alt=np.zeros(1, bool),
            l_pac=2_000_000, C=1100, S=2)
WIDE_STEPS = 1071 + 1029 * 1030 // 2 + 1030 + 40 * 1031


def wide_read():
    """One read of 1,071 chains on a 2 Mbp contig, each one seed at its
    own locus (numpy arrays as planted_batch): 1,030 of query [0, 100),
    one of [150, 250), all weighing 100, then 40 of [160, 200) weighing
    40. At C = 1,100 the light chains' rows reach past 1,024 positions,
    a second chunk of 32 words of j, and their first dominating chain is
    position 1,030, there; the heavy rows overlap every earlier chain
    and drop none (WIDE_STEPS filter steps at the default options)."""
    m = np.array([[0, 150, 160]], np.int32)
    n = np.array([[99, 249, 199]], np.int32)
    coords = ([(0, 100 + 500 * k) for k in range(1030)] + [(1, 600_000)]
              + [(2, 700_000 + 500 * k) for k in range(40)])
    rbeg = np.array([[r for _, r in coords]], np.int32)
    seed_idx = np.array([[i for i, _ in coords]], np.int32)
    return (m, n, np.ones_like(m), np.array([3], np.int32),
            np.array([250], np.int32), rbeg, seed_idx,
            np.array([len(coords)], np.int32))


def test_chain_over_1024_chains_twin_equal_to_lockstep_and_jax():
    """The wide read: the twins, the port's lockstep and the JAX package
    equal on every Chains field and on order, kept, w_by_slot and
    frac_rep at the default options; the light chains are dropped by
    position 1,030 (WIDE_STEPS steps)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops import chain as jchain
    from bwa_mem_scale_tpu.ops import smem as jsmem
    m, n, s, cnt, lens, rbeg, seed_idx, total = wide_read()
    valid = _coord_valid(total, rbeg.shape[1])
    kw = dict(w=W, max_chain_gap=GAP, max_chains=WIDE["C"],
              max_seeds_per_chain=WIDE["S"])
    fkw = FLT["default"]
    j = jnp.asarray
    jsm = jsmem.SmemBuf(j(m), j(n), j(np.zeros_like(m)), j(np.zeros_like(m)),
                        j(s), j(cnt))
    jb = jchain.DeviceBns(offsets=j(WIDE["offsets"]),
                          is_alt=j(WIDE["is_alt"]), l_pac=WIDE["l_pac"])
    jch = jchain.chain_seeds_device(jb, jsm, j(rbeg), j(seed_idx), j(valid),
                                    **kw)
    tb = tchain.DeviceBns(offsets=torch.as_tensor(WIDE["offsets"]),
                          is_alt=torch.as_tensor(WIDE["is_alt"]),
                          l_pac=WIDE["l_pac"])
    sm = _smems(m, n, s, cnt)
    tch = tchain.chain_seeds_device(tb, sm, torch.as_tensor(rbeg),
                                    torch.as_tensor(seed_idx),
                                    torch.as_tensor(valid), **kw)
    twin, _, _ = chain_cuda.chain_seeds_twin(
        WIDE["offsets"], WIDE["l_pac"], m, n, rbeg, seed_idx, valid, **kw)
    for f in tchain.Chains._fields:
        want = getattr(tch, f).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(jch, f)), want, f)
        np.testing.assert_array_equal(getattr(twin, f), want, f)
    assert int(twin.n[0]) == 1071
    want = (*jchain.chain_filter_device(jch, jb, **fkw),
            jchain.frac_rep_device(jsm, j(lens), MAX_OCC))
    got = tchain.chain_filter_frac_rep(tch, tb, sm, torch.as_tensor(lens),
                                       max_occ=MAX_OCC, **fkw)
    tw = chain_cuda.chain_filter_twin(WIDE["is_alt"], twin, m, n, s, cnt,
                                      lens, max_occ=MAX_OCC, **fkw)
    for what, a, p, t in zip(("order", "kept", "w_by_slot", "frac_rep"),
                             want, got, tw):
        np.testing.assert_array_equal(np.asarray(a), p.numpy(), what)
        np.testing.assert_array_equal(t, p.numpy(), what)
    assert tw[4][0] == WIDE_STEPS
    assert (tw[1][0, 1031:1071] <= 1).all() and tw[1][0, 1030] == 3


def _overlap_serial(i, qb, qe, wt, alt, kept, first, *, mask_level,
                    max_chain_gap, drop_ratio, min_seed_len):
    """One i of the overlap loop, j after j (the one-thread form): returns
    (kept[i], the j visited)."""
    large = drop = False
    visited = 0
    for j in range(i):
        visited += 1
        if kept[j] <= 0 or (alt[j] and not alt[i]):
            continue
        b_max, e_min = max(qb[j], qb[i]), min(qe[j], qe[i])
        min_l = min(qe[j] - qb[j], qe[i] - qb[i])
        if (e_min <= b_max or min_l >= max_chain_gap
                or not float(e_min - b_max) >= min_l * mask_level):
            continue
        large = True
        if first[j] < 0:
            first[j] = i
        if (float(wt[i]) < wt[j] * drop_ratio
                and wt[j] - wt[i] >= (min_seed_len << 1)):
            drop = True
            break
    return (0 if drop else (2 if large else 3)), visited


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_test_ballot_equal_to_serial(seed):
    """chain_cuda.overlap_test (the filter kernel's form: bit masks of the
    significant and dominating j, then the kept ones 32 words a round)
    against the serial loop, on arbitrary positions that need not be in
    weight order: kept[i], the visited j and every first equal. The planted i =
    45 has significant, non-dominating j in the first chunk and its first
    dominating j at 40, in the second: 41 j visited, first = i for the
    significant j up to 40 only. (In weight order a dominating j makes
    every significant j before it dominate too, so a read never sets
    this up; the bit-mask rule rests on no order.)"""
    rng = np.random.RandomState(seed)
    N = 80
    qb = rng.randint(0, 150, N).tolist()
    qe = [b + int(rng.randint(10, 120)) for b in qb]
    wt = rng.randint(20, 200, N).tolist()
    alt = (rng.rand(N) < 0.2).tolist()
    kept = rng.choice([0, 2, 3], N).tolist()
    # the planted i: j < 32 overlap it with weights near its own, j = 40
    # overlaps it and outweighs it; j in 32-39 do not overlap it
    i = 45
    qb[i], qe[i], wt[i], alt[i] = 100, 160, 50, True
    for j in range(32):
        qb[j], qe[j], wt[j], kept[j] = 90, 170, 60, 3
    for j in range(32, 40):
        qb[j], qe[j] = 0, 50
    qb[40], qe[40], wt[40], kept[40] = 110, 150, 150, 2
    flt = dict(FLT["default"])
    del flt["min_chain_weight"], flt["max_chain_extend"]
    for k in range(1, N):
        f_ballot, f_serial = [-1] * N, [-1] * N
        got = chain_cuda.overlap_test(k, qb, qe, wt, alt, kept, f_ballot,
                                      **flt)
        want = _overlap_serial(k, qb, qe, wt, alt, kept, f_serial, **flt)
        assert got[:2] == want and f_ballot == f_serial, k
        assert got[2] == 1                  # one round of 32 words
        if k == i:
            assert got[:2] == (0, 41)
            assert f_ballot[:41] == [i] * 32 + [-1] * 8 + [i]


# ---- on the card ------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernels_vs_plain(dev, bns_args, smems, rbeg, seed_idx, total, lens, C,
                      S, flt):
    """Both kernels against their plain versions and twins on one batch
    (device tensors): every array equal, the per-read steps and rounds
    equal to the twins', one launch each, and no host synchronisation in either
    wrapper (torch's sync debug mode raises on one). Returns the
    kernel's Chains."""
    offsets, is_alt, l_pac = bns_args
    bns = tchain.DeviceBns(offsets=torch.as_tensor(offsets, device=dev),
                           is_alt=torch.as_tensor(is_alt, device=dev),
                           l_pac=l_pac)
    valid = (torch.arange(rbeg.shape[1], device=dev)[None, :]
             < total[:, None])
    kw = dict(w=W, max_chain_gap=GAP, max_chains=C, max_seeds_per_chain=S)
    before = (chain_cuda.chain_seeds_cuda.launches,
              chain_cuda.chain_filter_cuda.launches)
    stats = {}
    fkw = dict(flt, max_occ=MAX_OCC)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = chain_cuda.chain_seeds_cuda(bns, smems, rbeg, seed_idx, valid,
                                          stats=stats, **kw)
        fgot = chain_cuda.chain_filter_cuda(got, bns, smems, lens,
                                            stats=stats, **fkw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps = chain_cuda.chain_seeds_cuda.last_steps.cpu().numpy()
    f_steps = chain_cuda.chain_filter_cuda.last_steps.cpu().numpy()
    want = tchain.chain_seeds_device(bns, smems, rbeg, seed_idx, valid,
                                     **kw)
    for f in tchain.Chains._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    cpu = lambda a: a.cpu().numpy()
    sm = [cpu(a) for a in (smems.m, smems.n, smems.s, smems.cnt)]
    twin, t_steps, t_rounds = chain_cuda.chain_seeds_twin(
        offsets, l_pac, sm[0], sm[1], cpu(rbeg), cpu(seed_idx), cpu(valid),
        **kw)
    np.testing.assert_array_equal(steps, t_steps)
    np.testing.assert_array_equal(
        chain_cuda.chain_seeds_cuda.last_rounds.cpu().numpy(), t_rounds)
    assert int(stats["chain_steps"]) == t_steps.max()
    assert int(stats["chain_flt_steps"]) == f_steps.max()
    assert int(stats["chain_rounds"]) == t_rounds.max()
    fwant = tchain.chain_filter_frac_rep(want, bns, smems, lens, **fkw)
    for name, a, b in zip(("order", "kept", "w_by_slot", "frac_rep"),
                          fgot, fwant):
        assert torch.equal(a, b), name
    ftwin = chain_cuda.chain_filter_twin(
        is_alt, tchain.Chains(*(cpu(a) for a in got)), *sm, cpu(lens),
        **fkw)
    np.testing.assert_array_equal(f_steps, ftwin[4])
    np.testing.assert_array_equal(
        chain_cuda.chain_filter_cuda.last_rounds.cpu().numpy(), ftwin[5])
    assert int(stats["chain_flt_rounds"]) == ftwin[5].max()
    assert (chain_cuda.chain_seeds_cuda.launches,
            chain_cuda.chain_filter_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("flt", list(FLT))
@pytest.mark.parametrize("caps", list(CAPS), ids=list(CAPS))
def test_chain_kernels_synthetic_equal_to_plain(caps, flt):
    """The synthetic batch on the card (alt and bridging seeds, equal
    weights, overflow at the tiny capacities, the float64 read): both
    kernels equal to their plain versions, steps equal to the twins'."""
    dev = _cuda()
    m, n, s, cnt, lens, rbeg, seed_idx, total = synthetic_batch(5)
    t = lambda a: torch.as_tensor(a, device=dev)
    ch = _kernels_vs_plain(dev, (OFFSETS, IS_ALT, L_PAC),
                           _smems(m, n, s, cnt, dev), t(rbeg), t(seed_idx),
                           t(total), t(lens), *CAPS[caps], FLT[flt])
    if caps == "tiny":
        assert bool(ch.overflow.any())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", list(SENTINEL_SHIFTS.values()),
                         ids=list(SENTINEL_SHIFTS))
def test_chain_kernels_anchor_sentinel(shift):
    """The sentinel read on the card (l_pac 400 Mbp, reverse-strand seeds
    at ~600 M, above the empty-key marker, and shifted below it): both
    kernels equal to their plain versions and twins, and the kernel's
    chains the reference's two of two seeds."""
    dev = _cuda()
    m, n, s, cnt, lens, rbeg, seed_idx, total = sentinel_read(shift)
    t = lambda a: torch.as_tensor(a, device=dev)
    ch = _kernels_vs_plain(dev, (np.zeros(1, np.int64), np.zeros(1, bool),
                                 SENTINEL_L_PAC),
                           _smems(m, n, s, cnt, dev), t(rbeg), t(seed_idx),
                           t(total), t(lens), 8, 4, FLT["default"])
    assert int(ch.n[0]) == 2
    assert ch.n_seeds[0, :2].tolist() == [2, 2]
    assert (int(rbeg.min()) > tchain.BIG) == (shift == 0)


@pytest.fixture(scope="module")
def card_batch():
    """A 1 Mbp genome in three contigs (the last alt) whose first 1 kbp is
    copied to 24 places (3 substitutions each), indexed by the port (no
    JAX on the card), and 512 reads of 101 bp (1% errors), a quarter of
    them exact copies from that window, so that their SMEMs have tens of
    coordinates and chains."""
    _cuda()
    from bwa_mem_scale_tpu_torch.index.build import build_index
    from bwa_mem_scale_tpu_torch.models.aligner import (demo_genome,
                                                       simulate_reads)
    bns = demo_genome(1_000_000, seed=42, n_contigs=3)
    bns.anns[-1].is_alt = True
    rng = np.random.RandomState(3)
    for k in range(1, 25):
        at = k * 40_000
        bns.seq[at:at + 1000] = bns.seq[:1000]
        bns.seq[at + rng.randint(0, 1000, 3)] = rng.randint(0, 4, 3)
    codes, lens = simulate_reads(bns, 512, 101, seed=8, err_rate=0.01)
    for i in range(0, 512, 4):
        start = rng.randint(0, 900)
        codes[i] = bns.seq[start:start + 101]
    return build_index(bns), codes, lens


def _card_seeds(idx, codes, lens, B, NC, dev):
    """The first B reads seeded and SA-looked-up on the card at the main
    path's depth (24): (bns arrays, smems, rbeg, seed_idx, total, lens)."""
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.ops.sal import expand_and_lookup
    from bwa_mem_scale_tpu_torch.ops.smem_oh import collect_smems_oh
    fmi = DeviceFMIndex.from_host(idx, dev)
    c = torch.as_tensor(codes[:B], device=dev)
    ln = torch.as_tensor(lens[:B], device=dev)
    opt = MemOptions()
    smems = collect_smems_oh(
        fmi, c, ln, min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        emit_depth=24, stack_depth=24)
    rbeg, seed_idx, _, total, _ = expand_and_lookup(fmi, smems, opt.max_occ,
                                                    NC)
    bns = idx.bns
    return ((np.asarray(bns.offsets, np.int64), np.asarray(bns.is_alt, bool),
             int(bns.l_pac)), smems, rbeg, seed_idx, total, ln)


TIERS = {"main": (512, 512, 64, 32), "tier1": (64, 1024, 256, 64),
         "tier2": (8, 16384, 1024, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(TIERS.values()), ids=list(TIERS))
def test_chain_kernels_equal_to_plain(card_batch, tier):
    """Seeds of the batch (the port's seeding and SA lookup on the card)
    chained and filtered by the kernels and by the plain versions at the
    main path's capacities (512 reads, 512 coordinates, 64 chains of 32
    seeds) and the retry tiers' (64 reads at 1024 / 256 / 64, 8 reads at
    16384 / 1024 / 256): every array equal, steps and rounds equal to the
    twins'."""
    dev = _cuda()
    B, NC, C, S = tier
    bns, smems, rbeg, seed_idx, total, ln = _card_seeds(*card_batch, B, NC,
                                                        dev)
    assert int(total.max()) > 20
    _kernels_vs_plain(dev, bns, smems, rbeg, seed_idx, total, ln, C, S,
                      FLT["default"])


@pytest.mark.cuda
def test_chain_kernels_large_shared_memory():
    """The wide read on the card at C = 1,800, whose chain state (7 words
    a chain in chain_seeds, 50.4 KB; 7 a chain and 64 a 32 chains in the
    filter, 65.0 KB) takes both kernels past the 48 KB default of dynamic
    shared memory: equal to the plain versions and twins. A read of more
    chains than one block's shared memory holds raises."""
    dev = _cuda()
    C = 1800
    assert 4 * 7 * C > 49152
    m, n, s, cnt, lens, rbeg, seed_idx, total = wide_read()
    t = lambda a: torch.as_tensor(a, device=dev)
    bns = (WIDE["offsets"], WIDE["is_alt"], WIDE["l_pac"])
    smems = _smems(m, n, s, cnt, dev)
    ch = _kernels_vs_plain(dev, bns, smems, t(rbeg), t(seed_idx), t(total),
                           t(lens), C, WIDE["S"], FLT["default"])
    assert int(ch.n[0]) == 1071
    for kernel in (0, 1):
        assert chain_cuda.LIB.call("chain_max_chains", kernel) >= C
    too_many = chain_cuda.LIB.call("chain_max_chains", 0) + 1
    dbns = tchain.DeviceBns(*(torch.as_tensor(a, device=dev)
                              for a in bns[:2]), bns[2])
    valid = (torch.arange(rbeg.shape[1], device=dev)[None, :]
             < t(total)[:, None])
    with pytest.raises(ValueError, match="shared memory"):
        chain_cuda.chain_seeds_cuda(dbns, smems, t(rbeg), t(seed_idx), valid,
                                    w=W, max_chain_gap=GAP,
                                    max_chains=too_many,
                                    max_seeds_per_chain=1)


@pytest.mark.cuda
@pytest.mark.parametrize("flt", list(FLT))
def test_chain_kernels_planted_equal_to_plain(flt):
    """The planted reads on the card at C = 64 and S = 4 (40 chains, so
    two chunks of keys; keys equal to rbeg; a full chain refusing
    appends; a first dominating chain in the overlap loop's second
    chunk): both kernels equal to their plain versions and twins."""
    dev = _cuda()
    m, n, s, cnt, lens, rbeg, seed_idx, total = planted_batch()
    t = lambda a: torch.as_tensor(a, device=dev)
    ch = _kernels_vs_plain(dev, (OFFSETS, IS_ALT, L_PAC),
                           _smems(m, n, s, cnt, dev), t(rbeg), t(seed_idx),
                           t(total), t(lens), *PLANTED_CAPS, FLT[flt])
    assert ch.n.tolist() == [40, 34, 2, 37]


@pytest.mark.cuda
def test_chain_kernels_over_1024_chains_equal_to_plain():
    """The wide read on the card at C = 1,100 (1,071 chains: the lower
    chains among 34 chunks of keys, the filter's rows past 32 words):
    both kernels equal to their plain versions and twins."""
    dev = _cuda()
    m, n, s, cnt, lens, rbeg, seed_idx, total = wide_read()
    t = lambda a: torch.as_tensor(a, device=dev)
    ch = _kernels_vs_plain(dev, (WIDE["offsets"], WIDE["is_alt"],
                                 WIDE["l_pac"]),
                           _smems(m, n, s, cnt, dev), t(rbeg), t(seed_idx),
                           t(total), t(lens), WIDE["C"], WIDE["S"],
                           FLT["default"])
    assert int(ch.n[0]) == 1071
    assert int(chain_cuda.chain_filter_cuda.last_steps[0]) == WIDE_STEPS


@pytest.mark.cuda
def test_chain_kernels_repeat_batch_equal_to_plain():
    """chip_smoke.py phase 5's repeat batch (tools/batches.py::
    repeat_batch: 512 reads on a 2 Mbp genome with a 1 kbp window in 25
    copies and a 150 bp unit in 600) seeded on the card and chained at
    the main path's shapes: both kernels equal to their plain versions
    and twins, at both option sets; the batch has reads of 25 chains and
    more (the window's copies) and overflows."""
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    dev = _cuda()
    B, NC, C, S = TIERS["main"]
    args = _card_seeds(*repeat_batch(B, 101), B, NC, dev)
    for flt in FLT.values():
        ch = _kernels_vs_plain(dev, *args, C, S, flt)
    assert int(ch.n.max()) >= 25 and bool(ch.overflow.any())


@pytest.mark.cuda
def test_round_probe_kernel_equal_to_plain():
    """csrc/round_probe.cu (the chaining floors' yardstick, one warp's
    dependent rounds) against its numpy model at 0, 1 and 257 rounds,
    and a positive cost a round."""
    from bwa_mem_scale_tpu_torch.tools import round_cost
    dev = _cuda()
    host = round_cost.table()
    tab = torch.as_tensor(host, device=dev)
    for n in (0, 1, 257):
        np.testing.assert_array_equal(
            round_cost.round_probe(tab, n).cpu().numpy(),
            round_cost.round_probe_plain(host, n))
    assert round_cost.round_us(dev) > 0
