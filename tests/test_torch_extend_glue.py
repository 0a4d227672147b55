"""The extension stage's glue (csrc/extend.cu through
``ops/extend_cuda.py``; plain versions ``ops/extend.py``), exact
(tolerance 0: integer arrays, and meta's float32 copies of them).

- ``seed_chain_extend`` through the plain versions (the CPU route)
  against the JAX program, every key of the dict and every row, the
  invalid pair rows included, in seven cases: a three-contig genome with
  planted repeats at ``test_torch_align``'s CAPS, with a dead lane,
  reads at the genome's ends (chains bridging l_pac) and across contig
  boundaries (chains clamped to their contig); TINY (reads over R); the
  same reads at PX 30 (a read whose candidates straddle PX); ROOMY; tier
  2's C / S / R (1,024 / 256 / 2,048) on six reads; the forced int64
  layout; and the long-read ``seed_sw_filter`` path (-W 10, 100-320 bp
  reads), which feeds ``ext_select`` its own seed_live and seed_score.
- Each kernel's CPU twin (``ext_*_twin``: the kernel's own loop, block,
  warp, lane or thread, chain by chain, rank by counting; the fused BSW
  round's twin the plain BSW rows, then each warp's band epilogue with
  the coverage over its lanes) against its plain version on every call
  the seven cases make; the candidate selection's twin (its load groups,
  the carried rbeg, the warp's 32-way contig search) at the default and
  tier-2 widths on a 48-contig genome (two search rounds), chains
  bridging l_pac, chains with no live seed and int64 positions; the pair
  compaction's twin over several chunks; the plain versions' BSW length
  flag.
- The wrappers run the plain versions on CPU tensors.
On a GPU (``-m cuda``): each kernel launch of ``seed_chain_extend``
against its plain version on the same inputs, at both layouts and at tier
2's widths, with the launch counts (one each, the fused BSW round four
times, BSW four); the extension under
``torch.cuda.set_sync_debug_mode("error")``; and the BSW length check
raising through ``fetch_extend`` on an over-long target. The JAX side is imported inside the tests that use it,
so the CUDA cases also run without JAX:
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_extend_glue.py
"""

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.config import MemOptions as TOpt
from bwa_mem_scale_tpu_torch.config import needs_seed_sw_filter
from bwa_mem_scale_tpu_torch.ops import extend, extend_cuda
from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex as TFmi
from bwa_mem_scale_tpu_torch.pipeline import align as talign

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

CAPS = dict(max_coords=64, max_chains=8, max_seeds_per_chain=8,
            max_regs=8, max_pairs=128)
TINY = dict(max_coords=16, max_chains=4, max_seeds_per_chain=4,
            max_regs=4, max_pairs=16)
ROOMY = dict(max_coords=2048, max_chains=128, max_seeds_per_chain=64,
             max_regs=256, max_pairs=16 * 256)
TIER2 = dict(max_coords=512, max_chains=1024, max_seeds_per_chain=256,
             max_regs=2048, max_pairs=6 * 2048)
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
CONTIG = 20_000
WRAPPERS = ("ext_select_cuda", "ext_pairs_cuda", "ext_stage_cuda",
            "ext_bsw_band_cuda")
TWINS = {"ext_select_cuda": extend_cuda.ext_select_twin,
         "ext_pairs_cuda": extend_cuda.ext_pairs_twin,
         "ext_stage_cuda": extend_cuda.ext_stage_twin,
         "ext_bsw_band_cuda": extend_cuda.ext_bsw_band_twin}
PLAINS = {"ext_select_cuda": extend.ext_select,
          "ext_pairs_cuda": extend.ext_pairs,
          "ext_stage_cuda": extend.ext_stage,
          "ext_bsw_band_cuda": extend.ext_bsw_band}
# name: (capacities, reads, read length, forced int64, -W 10 long reads)
CASES = {
    "caps-edges": (CAPS, 40, 101, False, False),
    "tiny": (TINY, 32, 101, False, False),
    "straddle": (dict(CAPS, max_pairs=30), 40, 101, False, False),
    "roomy": (ROOMY, 24, 101, False, False),
    "tier2": (TIER2, 6, 101, False, False),
    "int64": (CAPS, 24, 101, True, False),
    "long": (CAPS, 12, 320, False, True),
}


def _genome():
    """Three 20 kbp contigs of random bases, a 300 bp window planted six
    times (reads there make several chains)."""
    rng = np.random.RandomState(17)
    seq = rng.randint(0, 4, 3 * CONTIG).astype(np.uint8)
    unit = seq[5000:5300].copy()
    for p in (9000, 14000, 23000, 31000, 47000, 55000):
        seq[p: p + 300] = unit
    return seq


def _reads(seq, B, L, long_reads, seed):
    """Reads of the edge cases first (the genome's start and end on both
    strands, two contig boundaries, the repeat), then random ones with 2%
    substitutions, every third reverse-complemented; lane 3 dead. With
    long_reads, lengths of 100-L bp padded to L."""
    rng = np.random.RandomState(seed)
    n_tot = len(seq)
    starts = [0, n_tot - L, CONTIG - L // 2, 2 * CONTIG - L // 3, 5000 - 20,
              n_tot - L - 7, 3]
    codes = np.full((B, L), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        n = L if not long_reads or i < 2 else rng.randint(100, L + 1)
        p = starts[i] if i < len(starts) else rng.randint(0, n_tot - n)
        p = min(p, n_tot - n)
        s = seq[p: p + n].astype(np.int32).copy()
        if i >= len(starts):
            m = rng.rand(n) < 0.02
            s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
        if i % 3 == 2 or i == len(starts) - 2:
            s = COMP[s[::-1]].astype(np.int32)
        codes[i, :n] = s
        lens[i] = n
    lens[3] = 0                                  # a dead lane
    return codes, lens


def _opt(long_reads):
    return dict(min_chain_weight=10) if long_reads else {}


def _recorded(run):
    """run() with the four wrappers recorded at align's call sites:
    (its output, {wrapper's name: [(args, kwargs)]})."""
    real = {n: getattr(talign, n) for n in WRAPPERS}
    calls = {n: [] for n in WRAPPERS}

    def rec(n):
        def call(*a, **k):
            calls[n].append((a, k))
            return real[n](*a, **k)
        return call
    for n in WRAPPERS:
        setattr(talign, n, rec(n))
    try:
        out = run()
    finally:
        for n, fn in real.items():
            setattr(talign, n, fn)
    return out, calls


def _port_index(seq):
    from bwa_mem_scale_tpu_torch.index.bntseq import Annotation, BntSeq
    from bwa_mem_scale_tpu_torch.index.build import build_index
    anns = [Annotation(name=f"ctg{i}", anno="(null)", offset=i * CONTIG,
                       length=CONTIG, n_ambs=0) for i in range(3)]
    return build_index(BntSeq(l_pac=len(seq), anns=anns, ambs=[], seq=seq))


def _port_run(idx, name, dev):
    caps, B, L, wide, long_reads = CASES[name]
    codes, lens = _reads(idx.bns.seq, B, L, long_reads, seed=11)
    opt = TOpt(**_opt(long_reads))
    cfg = talign.PipelineConfig(seed_engine="onehot", **caps)
    fmi = TFmi.from_host(idx, dev, force_int64=wide)
    dbns = talign.DeviceBns.from_host(idx.bns, dev)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    out, calls = _recorded(lambda: talign.seed_chain_extend(
        fmi, dbns, c, ln, L, opt=opt, cfg=cfg))
    return dict(out=out, calls=calls, codes=codes, lens=lens, opt=opt,
                cfg=cfg, fmi=fmi, dbns=dbns, L=L)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The JAX package's index of the genome, saved and loaded by the
    port; the port's runs of each case, made once."""
    from bwa_mem_scale_tpu.index.artifacts import save_index
    from bwa_mem_scale_tpu.index.bntseq import Annotation, BntSeq
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    seq = _genome()
    anns = [Annotation(name=f"ctg{i}", anno="(null)", offset=i * CONTIG,
                       length=CONTIG, n_ambs=0) for i in range(3)]
    jidx = build_index(BntSeq(l_pac=len(seq), anns=anns, ambs=[], seq=seq))
    prefix = str(tmp_path_factory.mktemp("ext") / "g")
    save_index(jidx, prefix)
    return dict(jidx=jidx, tidx=load_index(prefix), runs={})


def _run(side, name):
    if name not in side["runs"]:
        side["runs"][name] = _port_run(side["tidx"], name, "cpu")
    return side["runs"][name]


def _flat(x):
    """The tensors of an output, nested tuples flattened in order."""
    if isinstance(x, tuple):
        return [t for v in x for t in _flat(v)]
    return [x]


def _same(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert torch.equal(a.cpu(), b.cpu()), (what, i)


@pytest.mark.parametrize("name", list(CASES))
def test_seed_chain_extend_equal_to_jax(side, name):
    """The port's dict through the plain versions against the JAX
    program's on the same index, reads and capacities: every key, every
    row (invalid pair rows included)."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.config import MemOptions as JOpt
    from bwa_mem_scale_tpu.ops import occ as jocc
    from bwa_mem_scale_tpu.pipeline import align as jalign
    caps, B, L, wide, long_reads = CASES[name]
    r = _run(side, name)
    jal = jalign.TpuAligner(side["jidx"], JOpt(**_opt(long_reads)),
                            jalign.PipelineConfig(seed_engine="onehot",
                                                  **caps))
    jf = jocc.DeviceFMIndex.from_host(side["jidx"], force_int64=True) \
        if wide else jal.fmi
    want = jal._jit_extend(jf, jal.dbns, jnp.asarray(r["codes"]),
                           jnp.asarray(r["lens"]), L=L)
    got = r["out"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert got["valid"].any()
    assert needs_seed_sw_filter(r["opt"], L) == long_reads


def test_cases_reach_the_paths(side):
    """The cases reach what they are for: chains bridging l_pac and chains
    clamped to an inner contig's edge and to 0 (caps-edges), reads over
    R (tiny), a read whose candidates straddle PX (straddle), tier 2's
    widths (tier2), the seed-SW filter's seed_live (long)."""
    r = _run(side, "caps-edges")
    (a, _), = r["calls"]["ext_select_cuda"]
    sel = extend.ext_select(*a)
    l_pac = r["dbns"].l_pac
    ch, order, kept = a[0], a[1], a[2]
    live = ch.n_seeds > 0
    assert ((sel.rmax0 == l_pac) | (sel.rmax1 == l_pac))[live].any()
    inner = torch.tensor([CONTIG, 2 * CONTIG, 2 * l_pac - CONTIG,
                          2 * l_pac - 2 * CONTIG])
    assert (torch.isin(sel.rmax0, inner) | torch.isin(sel.rmax1, inner))[
        live].any()
    assert (sel.rmax0 == 0)[live].any()
    assert _run(side, "tiny")["out"]["reg_overflow"].any()
    (a, k), = _run(side, "straddle")["calls"]["ext_pairs_cuda"]
    pr = extend.ext_pairs(*a, **k)
    assert bool(pr.pair_overflow)
    inside = set(pr.read[pr.valid].tolist())
    assert any(bool(pr.read_pair_of[b]) for b in inside)
    (a, _), = _run(side, "tier2")["calls"]["ext_select_cuda"]
    assert a[0].seed_qbeg.shape[1:] == (1024, 256)
    long_r = _run(side, "long")
    (a, _), = long_r["calls"]["ext_select_cuda"]
    assert a[3] is not None                     # the filter's seed_live


@pytest.mark.parametrize("name", list(CASES))
def test_twins_equal_to_plain(side, name):
    """Each kernel's twin against its plain version on every call the
    case's seed_chain_extend made: ext_select, ext_pairs and ext_stage
    once, the fused BSW round four times (phases 0-3)."""
    r = _run(side, name)
    assert [len(r["calls"][n]) for n in WRAPPERS] == [1, 1, 1, 4]
    for n in WRAPPERS:
        for a, k in r["calls"][n]:
            _same(TWINS[n](*a, **k), PLAINS[n](*a, **k), n)


def _select_inputs(C, S, wide, with_live, seed):
    """ext_select's inputs on four reads of 48 contigs (two rounds of the
    32-way search): chains spread over both strands, some near l_pac
    (bridging it) and near contig edges, some with no live seed; the
    contigs of 2^27 bp at int64 (positions past 2^32), of 5,000 at
    int32; with_live, the seed-SW filter's [B, C, S] mask."""
    from bwa_mem_scale_tpu_torch.ops.chain import Chains, DeviceBns
    rng = np.random.RandomState(seed)
    B, n_ctg = 4, 48
    ctg = (1 << 27) if wide else 5000
    l_pac = n_ctg * ctg
    offsets = np.arange(n_ctg, dtype=np.int64) * ctg
    lens = rng.randint(60, 102, B).astype(np.int32)
    n_seeds = rng.randint(0, S + 1, (B, C)).astype(np.int32)
    n_seeds[:, ::7] = 0                          # chains with no live seed
    anchor = rng.randint(0, 2 * l_pac - 200, (B, C)).astype(np.int64)
    anchor[:, 1::5] = l_pac - rng.randint(-60, 60, (B, len(range(1, C, 5))))
    edge = offsets[rng.randint(1, n_ctg, (B, len(range(2, C, 5))))]
    anchor[:, 2::5] = edge + rng.randint(-60, 60, edge.shape)
    anchor[:, 3::5] = 2 * l_pac - 1 - anchor[:, 2::5][:, :anchor[:, 3::5]
                                                       .shape[1]]
    qbeg = rng.randint(0, 80, (B, C, S)).astype(np.int32)
    slen = rng.randint(19, 40, (B, C, S)).astype(np.int32)
    rbeg = anchor[:, :, None] + qbeg + rng.randint(-30, 30, (B, C, S))
    rbeg = np.clip(rbeg, 0, 2 * l_pac - 1)
    score = rng.randint(0, 400, (B, C, S)).astype(np.int32)
    order = np.stack([rng.permutation(C) for _ in range(B)]).astype(np.int32)
    kept = rng.randint(0, 3, (B, C)).astype(np.int32)
    live = None
    if with_live:
        live = torch.as_tensor(rng.rand(B, C, S) < 0.7)
        live[:, ::9] = False
    t = torch.as_tensor
    pd = np.int64 if wide else np.int32
    z = torch.zeros((B, C), dtype=torch.int32)
    ch = Chains(z, z, t(np.full(B, C, np.int32)), z, t(n_seeds), t(qbeg),
                t(rbeg.astype(pd)), t(slen), t(score),
                torch.zeros(B, dtype=torch.bool))
    dbns = DeviceBns(t(offsets), torch.zeros(n_ctg, dtype=torch.bool), l_pac)
    return (ch, t(order), t(kept), live, t(score), t(lens), dbns, TOpt())


@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("widths", [(64, 32, 64, 8), (1024, 256, 2048, 32)])
def test_select_twin_shapes(widths, wide, with_live):
    """ext_select_kernel's twin (its load groups, the rbeg carried from
    the loading lane, the warp's 32-way contig search) against the plain
    ext_select at the default widths (C 64, S 32, R 64, 8 warps) and tier
    2's (1,024, 256, 2,048, 32 warps), int32 and int64 positions, with
    and without a seed-SW mask: every output equal; 48 contigs take the
    search two rounds; the inputs reach chains bridging l_pac, chains
    clamped at an inner contig's edge, chains with no live seed and a read
    over R."""
    C, S, R, warps = widths
    args = _select_inputs(C, S, wide, with_live, seed=C + 2 * wide
                          + with_live)
    want = extend.ext_select(*args, R)
    _same(extend_cuda.ext_select_twin(*args, R, warps=warps), want, widths)
    assert int(extend_cuda.ext_select_twin.last_rounds.max()) == 2
    ch, dbns = args[0], args[6]
    live = extend.live_seeds(ch, args[3])
    l_pac = dbns.l_pac
    none = ~live.any(2)
    assert none.any()
    some = ~none
    assert ((want.rmax0 == l_pac) | (want.rmax1 == l_pac))[some].any()
    inner = torch.cat([dbns.offsets[1:], 2 * l_pac - dbns.offsets[1:]])
    assert (torch.isin(want.rmax0, inner) | torch.isin(want.rmax1, inner))[
        some].any()
    assert want.reg_overflow.any() or R == 2048


@pytest.mark.parametrize("threads", [8, 1024])
def test_pairs_twin_over_chunks(threads):
    """The compaction's twin over several chunks of the block (2,500
    reads: three chunks of 1,024, or many of 8), with reads over R, empty
    reads and the batch past PX, against the plain version."""
    rng = np.random.RandomState(threads)
    B, R, PX = 2500, 6, 7000
    n_cand = torch.as_tensor(rng.randint(0, 9, B).astype(np.int32))
    sel = extend.Sel(n_cand, torch.zeros((B, R), dtype=torch.int32),
                     n_cand > R, torch.zeros((B, 4), dtype=torch.int64),
                     torch.zeros((B, 4), dtype=torch.int64))
    args = (sel, PX, torch.as_tensor(rng.randint(0, 30, B).astype(np.int32)),
            24, torch.as_tensor(rng.rand(B) < 0.05),
            torch.as_tensor(rng.rand(B) < 0.05),
            torch.as_tensor(rng.rand(B) < 0.05),
            torch.as_tensor(rng.rand(B).astype(np.float32)))
    want = extend.ext_pairs(*args)
    _same(extend_cuda.ext_pairs_twin(*args, threads=threads), want, threads)
    assert bool(want.pair_overflow) and want.read_pair_of.any()
    no_sw = args[:6] + (None, args[7])
    _same(extend_cuda.ext_pairs_twin(*no_sw, threads=threads),
          extend.ext_pairs(*no_sw), "sw_of None")


def test_wrappers_on_cpu_run_plain(side):
    """On CPU tensors each wrapper returns its plain version's output."""
    r = _run(side, "caps-edges")
    for n in WRAPPERS:
        for a, k in r["calls"][n]:
            _same(getattr(extend_cuda, n)(*a, **k), PLAINS[n](*a, **k), n)


def test_len_flag(side):
    """A BSW length past its row: the plain stage and band phases OR 1
    into the pairs' flag, the twins too (and clamp what they hand BSW);
    raise_len_flag raises the BSW check's message on an ExtendOut whose
    len_flag is set, and not on one without."""
    r = _run(side, "caps-edges")
    (a, k), = r["calls"]["ext_stage_cuda"]
    pr = a[0]
    assert int(pr.flag) == 0
    short = list(a)
    short[7] = 8                                # TL: every target over it
    for fn in (extend.ext_stage, extend_cuda.ext_stage_twin):
        flag = torch.zeros((1,), dtype=torch.int32)
        st = fn(pr._replace(flag=flag), *short[1:], **k)
        assert int(flag) == 1
    assert int(st.bl[1].max()) <= 8             # the twin's clamp
    out = extend.ExtendOut(a=torch.zeros(1))
    extend.raise_len_flag(out)
    out.len_flag = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds its row count"):
        extend.raise_len_flag(out)
    assert r["out"].len_flag is None            # the CPU route: no check


# ---- the kernels on the card --------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_index():
    return _port_index(_genome())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_equal_to_plain_on_card(card_index, name):
    """seed_chain_extend on the card: one launch of each kernel (the
    fused BSW round four, counted as BSW's too), each held against its
    plain version on the same inputs (max_abs_err 0), and the dict equal
    to the CPU route's."""
    dev = _cuda()
    wr = extend_cuda.WRAPPERS
    for w in wr + (banded_swa_batch_cuda,):
        w.launches = 0
    r = _port_run(card_index, name, dev)
    torch.cuda.synchronize()
    assert [w.launches for w in wr] == [1, 1, 1, 4]
    assert banded_swa_batch_cuda.launches == 4
    for n in WRAPPERS:
        for a, k in r["calls"][n]:
            got = getattr(extend_cuda, n)(*a, **k)
            want = PLAINS[n](*a, **k)
            torch.cuda.synchronize()
            _same(got, want, n)
    cpu = _port_run(card_index, name, "cpu")["out"]
    for key, v in cpu.items():
        assert torch.equal(r["out"][key].cpu(), v), key
    assert int(r["out"].len_flag.item()) == 0


@pytest.mark.cuda
def test_extend_has_no_host_sync_on_card(card_index):
    """extend_chains (the chain filter's outputs to the dict) under
    torch.cuda.set_sync_debug_mode("error"): seven launches, no raise."""
    dev = _cuda()
    real = talign.extend_chains
    args = []
    talign.extend_chains = lambda *a, **k: args.append((a, k)) or real(*a,
                                                                       **k)
    try:
        want = _port_run(card_index, "caps-edges", dev)["out"]
    finally:
        talign.extend_chains = real
    (a, k), = args
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = real(*a, **k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for key, v in want.items():
        assert torch.equal(got[key], v), key


@pytest.mark.cuda
def test_len_check_raises_on_card(card_index):
    """A target row shorter than the lengths (target_pad negative): the
    kernels flag it and fetch_extend raises the BSW check's message."""
    dev = _cuda()
    codes, lens = _reads(card_index.bns.seq, 64, 101, False, seed=3)
    cfg = talign.PipelineConfig(seed_engine="onehot", target_pad=-290,
                                **CAPS)
    fmi = TFmi.from_host(card_index, dev)
    out = talign.seed_chain_extend(
        fmi, talign.DeviceBns.from_host(card_index.bns, dev),
        torch.as_tensor(codes, device=dev), torch.as_tensor(lens, device=dev),
        101, opt=TOpt(), cfg=cfg)
    assert out.len_flag is not None
    # fetch_extend reads nothing of its aligner: the copy, then the raise
    with pytest.raises(ValueError, match="exceeds its row count"):
        talign.GpuAligner.fetch_extend(None, (codes, lens, None, out))
