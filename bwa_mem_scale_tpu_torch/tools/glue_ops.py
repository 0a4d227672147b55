"""Count the PyTorch operations of each seeding engine's glue on one batch.

    python -m bwa_mem_scale_tpu_torch.tools.glue_ops [--device cpu]

Runs ``collect_smems_oh`` (the one-hot engine) and
``collect_smems_device`` (the sweep, with an FMA table of K = 11) once on
512 simulated reads of 101 bp from a 1 Mbp genome with every seeding
kernel's call replaced by the output it gave on the same inputs, under
``torch.profiler``, and prints the outermost aten operations each
engine's glue issues a batch: each is one launch (or more) and a host
dispatch on the card, so the count is what the glue costs the host. A
count, not a time: it is the same on the CPU and on the card.
"""

from __future__ import annotations

import argparse

import torch


def _replayed(mod, names, fn):
    """Run fn() once with mod's `names` recording their outputs, then
    return a thunk that runs fn() with each name replaying them."""
    real = {n: getattr(mod, n) for n in names}
    seen = {n: [] for n in names}

    def record(n):
        def call(*a, **k):
            out = real[n](*a, **k)
            seen[n].append(out)
            return out
        return call

    def replay(n):
        it = iter(seen[n])
        return lambda *a, **k: next(it)

    for n in names:
        setattr(mod, n, record(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(mod, n, real[n])

    def run():
        for n in names:
            setattr(mod, n, replay(n))
        try:
            fn()
        finally:
            for n in names:
                setattr(mod, n, real[n])
    return run


def outer_ops(run) -> int:
    """The aten operations run() issues that no other aten operation
    issued."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="glue_ops")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..device import resolve_device
    from ..index.build import build_index
    from ..models.aligner import demo_genome, simulate_reads
    from ..ops import smem, smem_oh, sweep_cuda
    from ..ops.fma import build_fma_table
    from ..ops.occ import DeviceFMIndex
    dev = resolve_device(args.device)
    idx = build_index(demo_genome(1_000_000, seed=42, n_contigs=1))
    codes, lens = simulate_reads(idx.bns, 512, 101, seed=8, err_rate=0.01)
    fmi = DeviceFMIndex.from_host(idx, dev)
    c, ln = torch.as_tensor(codes, device=dev), torch.as_tensor(lens,
                                                                device=dev)
    table = build_fma_table(fmi, K=11).to_device(fmi.pos_dtype, dev)
    kw = dict(min_seed_len=19, split_len=28, split_width=10,
              max_mem_intv=20)
    onehot = _replayed(
        smem_oh, ["one_pos_machine_cuda", "seed_strategy_machine_cuda"],
        lambda: smem_oh.collect_smems_oh(fmi, c, ln, emit_depth=24,
                                         stack_depth=24, **kw))
    sweep = _replayed(
        sweep_cuda, ["extend_all_positions_cuda", "strategy_chase_cuda"],
        lambda: smem.collect_smems_device(fmi, c, ln, fma=table, **kw))
    print(f"glue operations a batch (B=512, L=101, outermost aten ops, the "
          f"kernels' calls replayed): one-hot {outer_ops(onehot)}, sweep "
          f"{outer_ops(sweep)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
