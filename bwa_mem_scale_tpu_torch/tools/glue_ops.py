"""Count the PyTorch operations of each seeding engine's glue on one batch.

    python -m bwa_mem_scale_tpu_torch.tools.glue_ops [--device cpu] [--before DIR]

Runs ``collect_smems_oh`` (the one-hot engine), ``collect_smems_rl``
(the readlane engine, 64 worker lanes), ``collect_smems_device`` (the
sweep, with an FMA table of K = 11) and ``collect_smems_ert`` (the ERT
descent, K = 12, on the same genome's full-SA index) once on 512
simulated reads of 101 bp from a 1 Mbp genome with every seeding
kernel's call replaced by the output it gave on the same inputs, under
``torch.profiler``, and prints the outermost aten operations each
engine's glue issues a batch: each is one launch (or more) and a host
dispatch on the card, so the count is what the glue costs the host. A
count, not a time: it is the same on the CPU and on the card. The
one-hot and readlane engines' task list and merge are the kernels of
csrc/smem_glue.cu (``smem_cuda.reseed_tasks_cuda``,
``merge_smems_cuda``), replayed too; beside each, its earlier glue: the
same call with their plain versions (``smem.reseed_task_list``,
``merge_smems_plain``, the torch operations the engines issued before
csrc/smem_glue.cu) in their places, the walks replayed. On the card, the
one-hot stage as the main path calls it, nothing replayed (the wrappers'
allocations). Pass 3's
merged stage (``smems_seed_strategy_merged``) is one launch on the card,
so the sweep and the ERT replay it whole; so are the sweep's passes 1
and 2 (``sweep_cuda.sweep_pass_cuda``: the extension and its emission
in one launch each), which the sweep replays whole too. Then the merged
stage alone on the sweep's call: its earlier glue (the plain version's
torch operations with the restart chain replayed, run on the CPU, the
port's stage before csrc/sweep.cu's seed_strategy_merged_kernel) and the
stage as the main path calls it (on the card the kernel: the outputs' allocations, the
launch a ctypes call; on the CPU the plain version with its chase).

Then the SA lookup stage on the one-hot engine's SMEMs of the same batch
(512 coordinates a read): the earlier stage's glue
(``expand_and_lookup_plain`` with its walk replayed, the port's stage
before csrc/sal.cu) and ``expand_and_lookup`` as the main path calls it:
on the card the two kernels of csrc/sal.cu (the outputs' allocations;
the launches are ctypes calls, no aten operation), on the CPU the plain
version with its walk.

Then the extension (``align.extend_chains``: from the chain filter's
outputs to the dict) on the one-hot engine's call of the same batch at
the default PipelineConfig: with csrc/extend.cu's seven launches and
BSW's four replayed; with the plain versions of ``ops/extend.py`` (the
port's earlier glue) in the kernels' places and BSW replayed; and on the
card as the main path calls it, nothing replayed. With ``--before DIR``
(an earlier checkout, ``git archive``), also that checkout's
seed_chain_extend with its seeding, SA lookup, chaining and BSW replayed.
"""

from __future__ import annotations

import argparse
import contextlib
import types

import torch


def _replayed(targets, fn):
    """Run fn() once with each (module, name) of `targets` recording its
    outputs, then return a thunk that runs fn() with each replaying them."""
    real = {t: getattr(*t) for t in targets}
    seen = {t: [] for t in targets}

    def record(t):
        def call(*a, **k):
            out = real[t](*a, **k)
            seen[t].append(out)
            return out
        return call

    def replay(t):
        it = iter(seen[t])
        return lambda *a, **k: next(it)

    def with_swaps(swap):
        for t in targets:
            setattr(*t, swap(t))
        try:
            fn()
        finally:
            for t in targets:
                setattr(*t, real[t])

    with_swaps(record)
    return lambda: with_swaps(replay)


@contextlib.contextmanager
def _plain_glue(mod):
    """mod's task list and merge wrappers replaced by their plain
    versions, the engines' glue before csrc/smem_glue.cu."""
    from ..ops.smem import merge_smems_plain, reseed_task_list
    real = (mod.reseed_tasks_cuda, mod.merge_smems_cuda)
    mod.reseed_tasks_cuda, mod.merge_smems_cuda = (reseed_task_list,
                                                   merge_smems_plain)
    try:
        yield
    finally:
        mod.reseed_tasks_cuda, mod.merge_smems_cuda = real


def merged_call(mod, run):
    """The (arguments, keyword arguments but stats) of the one
    merged-stage call that run() makes through
    mod.smems_seed_strategy_merged."""
    real, calls = mod.smems_seed_strategy_merged, []
    mod.smems_seed_strategy_merged = lambda *a, **k: (
        calls.append((a, k)) or real(*a, **k))
    try:
        run()
    finally:
        mod.smems_seed_strategy_merged = real
    (a, k), = calls
    return a, {f: v for f, v in k.items() if f != "stats"}


def outer_ops(run, names: set = None) -> int:
    """The aten operations run() issues that no other aten operation
    issued; their names go into `names` when given."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    outer = [e.name for e in prof.events() if e.name.startswith("aten::")
             and (e.cpu_parent is None
                  or not e.cpu_parent.name.startswith("aten::"))]
    if names is not None:
        names.update(outer)
    return len(outer)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="glue_ops")
    p.add_argument("--device", default="cuda")
    p.add_argument("--before", metavar="DIR",
                   help="an earlier checkout (git archive of "
                        "bwa_mem_scale_tpu_torch and csrc): its extension's "
                        "operations too")
    args = p.parse_args(argv)
    from ..device import resolve_device
    from ..index.build import build_index
    from ..models.aligner import demo_genome, simulate_reads
    from ..index.ert import build_ert
    from ..ops import ert, ert_cuda, sal, smem, smem_oh, smem_rl, sweep_cuda
    from ..ops.fma import build_fma_table
    from ..ops.occ import DeviceFMIndex
    dev = resolve_device(args.device)
    bns = demo_genome(1_000_000, seed=42, n_contigs=1)
    idx = build_index(bns)
    codes, lens = simulate_reads(idx.bns, 512, 101, seed=8, err_rate=0.01)
    fmi = DeviceFMIndex.from_host(idx, dev)
    c, ln = torch.as_tensor(codes, device=dev), torch.as_tensor(lens,
                                                                device=dev)
    table = build_fma_table(fmi, K=11).to_device(fmi.pos_dtype, dev)
    kw = dict(min_seed_len=19, split_len=28, split_width=10,
              max_mem_intv=20)
    full = build_index(bns, sa_compx=0)
    dert = ert.DeviceErt.from_host(build_ert(full.ref_string,
                                             full.sa_samples),
                                   full.sa_samples, full.count, dev)
    glue = ["reseed_tasks_cuda", "merge_smems_cuda"]
    run_oh = lambda: smem_oh.collect_smems_oh(fmi, c, ln, emit_depth=24,
                                              stack_depth=24, **kw)
    run_rl = lambda: smem_rl.collect_smems_rl(fmi, c, ln, lanes=64, **kw)
    walks = {smem_oh: ["one_pos_machine_cuda", "seed_strategy_machine_cuda"],
             smem_rl: ["readlane_one_pos_cuda", "readlane_strategy_cuda"]}
    counts = {}
    for mod, run in ((smem_oh, run_oh), (smem_rl, run_rl)):
        now = outer_ops(_replayed([(mod, n) for n in walks[mod] + glue],
                                  run))
        with _plain_glue(mod):
            earlier = outer_ops(_replayed([(mod, n) for n in walks[mod]],
                                          run))
        counts[mod] = (earlier, now)
    onehot, readlane = counts[smem_oh], counts[smem_rl]
    sweep = _replayed(
        [(sweep_cuda, "sweep_pass_cuda"),
         (smem, "smems_seed_strategy_merged")],
        lambda: smem.collect_smems_device(fmi, c, ln, fma=table, **kw))
    trie = _replayed(
        [(ert_cuda, "ert_extend_all_positions_cuda"),
         (ert, "smems_seed_strategy_merged")],
        lambda: ert.collect_smems_ert(dert, fmi.ref, c, ln,
                                      pos_dtype=fmi.pos_dtype,
                                      seq_len=2 * fmi.l_pac, **kw))
    print(f"glue operations a batch (B=512, L=101, outermost aten ops, the "
          f"kernels' calls and the merged stage replayed): one-hot "
          f"{onehot[1]} (the earlier glue {onehot[0]}), readlane "
          f"{readlane[1]} ({readlane[0]}), sweep {outer_ops(sweep)}, ERT "
          f"{outer_ops(trie)}")
    if dev.type == "cuda":
        names = set()
        n = outer_ops(run_oh, names)
        print(f"one-hot stage operations a batch as the main path calls it "
              f"(collect_smems_oh, nothing replayed: five launches, the "
              f"rest the wrappers' allocations): {n} "
              f"({', '.join(sorted(names))})")
    a, k = merged_call(smem, lambda: smem.collect_smems_device(
        fmi, c, ln, fma=table, **kw))
    real = smem.smems_seed_strategy_merged
    cpu = lambda x: {f: v.cpu() for f, v in x.items()} if isinstance(
        x, dict) else x.cpu() if isinstance(x, torch.Tensor) else x
    cpu_args = (types.SimpleNamespace(count=a[0].count.cpu()),
                *(cpu(x) for x in a[1:]))
    glue = outer_ops(_replayed([(smem, "strategy_chase")],
                               lambda: real(*cpu_args, **k)))
    names = set()
    stage = outer_ops(lambda: real(*a, **k), names)
    how = ("the kernel of csrc/sweep.cu: " + ", ".join(sorted(names))
           if dev.type == "cuda" else "the plain version, its restart "
           "chain included, on the CPU")
    print(f"merged stage operations a batch (the sweep's call, outermost "
          f"aten ops): the earlier glue (the plain version, its chase "
          f"replayed) {glue}; smems_seed_strategy_merged {stage} ({how})")
    smems = smem_oh.collect_smems_oh(fmi, c, ln, emit_depth=24,
                                     stack_depth=24, **kw)
    earlier = _replayed([(sal, "sa_lookup_plain")],
                        lambda: sal.expand_and_lookup_plain(fmi, smems, 500,
                                                            512))
    stage = outer_ops(lambda: sal.expand_and_lookup(fmi, smems, 500, 512))
    how = ("the kernels of csrc/sal.cu" if dev.type == "cuda" else
           "the plain version, its walk included, on the CPU")
    print(f"SA lookup stage operations a batch (B=512, C=512, outermost "
          f"aten ops): the earlier stage's glue (expand_and_lookup_plain, "
          f"its walk replayed) {outer_ops(earlier)}; expand_and_lookup "
          f"{stage} ({how})")
    extension_ops(fmi, c, ln, idx, dev, args.before)
    return 0


EXT_WRAPPERS = ("ext_select_cuda", "ext_pairs_cuda", "ext_stage_cuda",
                "ext_bsw_band_cuda")


@contextlib.contextmanager
def _plain_ext(align):
    """align's extension wrappers replaced by their plain versions
    (ops/extend.py: the port's extension glue before csrc/extend.cu)."""
    from ..ops import extend
    real = {n: getattr(align, n) for n in EXT_WRAPPERS}
    for n in EXT_WRAPPERS:
        setattr(align, n, getattr(extend, n[:-len("_cuda")]))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(align, n, fn)


def before_extension_ops(root: str, idx, c, ln, dev) -> int:
    """The outermost aten operations of an earlier checkout's
    seed_chain_extend on the batch with its seeding, SA lookup, chaining
    and BSW calls replayed: its extension's glue."""
    import importlib
    from .probe_before_after import load_before
    load_before(root)
    old = importlib.import_module("probe_before.pipeline.align")
    occ = importlib.import_module("probe_before.ops.occ")
    chain = importlib.import_module("probe_before.ops.chain")
    cfg = old.PipelineConfig(seed_engine="onehot")
    fmi = occ.DeviceFMIndex.from_host(idx, dev)
    dbns = chain.DeviceBns.from_host(idx.bns, dev)
    from ..config import MemOptions
    run = lambda: old.seed_chain_extend(fmi, dbns, c, ln, c.shape[1],
                                        opt=MemOptions(), cfg=cfg)
    # BSW by the name the checkout's align calls it
    return outer_ops(_replayed(
        [(old, n) for n in ("collect_seeds", "expand_and_lookup",
                            "chain_and_filter", "bsw_rows",
                            "banded_swa_batch_cuda") if hasattr(old, n)],
        run))


def extension_ops(fmi, c, ln, idx, dev, before=None) -> None:
    """The extension's operations a batch (``align.extend_chains``, from
    the chain filter's outputs to the dict) on the batch's call of
    seed_chain_extend at the default PipelineConfig (C 64, S 32, R 64,
    PX 4,096): with its seven launches replayed (select, pairs, stage and
    the four BSW rounds with their band phases); with the plain versions
    in the kernels' places (the port's earlier glue) and the plain BSW
    inside them replayed; and on the card as the main path calls it,
    nothing replayed."""
    from ..config import MemOptions
    from ..ops import extend
    from ..ops.chain import DeviceBns
    from ..pipeline import align
    dbns = DeviceBns.from_host(idx.bns, dev)
    real, seen = align.extend_chains, []
    align.extend_chains = lambda *a, **k: seen.append((a, k)) or real(*a,
                                                                      **k)
    try:
        out = align.seed_chain_extend(
            fmi, dbns, c, ln, c.shape[1], opt=MemOptions(),
            cfg=align.PipelineConfig(seed_engine="onehot"))
    finally:
        align.extend_chains = real
    (a, k), = seen
    run = lambda: real(*a, **k)
    now = outer_ops(_replayed([(align, n) for n in EXT_WRAPPERS], run))
    with _plain_ext(align):
        earlier = outer_ops(_replayed([(extend, "banded_swa_rows")], run))
    print(f"extension operations a batch (B=512, L=101, C=64, S=32, R=64, "
          f"PX=4,096, {int(out['valid'].sum())} pairs valid; outermost aten "
          f"ops of align.extend_chains): the seven launches replayed {now}; "
          f"the earlier glue (the plain versions of ops/extend.py in the "
          f"kernels' places, BSW replayed) {earlier}"
          + ("" if before is None else
             f"; the earlier checkout's seed_chain_extend, its seeding, SA "
             f"lookup, chaining and BSW replayed, "
             f"{before_extension_ops(before, idx, c, ln, dev)}"))
    if dev.type == "cuda":
        names = set()
        n = outer_ops(run, names)
        print(f"extension operations a batch as the main path calls it "
              f"(nothing replayed: seven launches, the rest the wrappers' "
              f"allocations and views): {n} ({', '.join(sorted(names))})")


if __name__ == "__main__":
    raise SystemExit(main())
