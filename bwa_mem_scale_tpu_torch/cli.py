"""Command-line interface of the PyTorch/CUDA port.

    python -m bwa_mem_scale_tpu_torch.cli index g.fa -p g
    python -m bwa_mem_scale_tpu_torch.cli perfect-index g -l 101
    python -m bwa_mem_scale_tpu_torch.cli mem g reads.fq -o out.sam \\
        --device cuda
    python -m bwa_mem_scale_tpu_torch.cli mem g r1.fq r2.fq -o out.sam
    python -m bwa_mem_scale_tpu_torch.cli mem g interleaved.fq -p

The ``mem`` options are the JAX CLI's own (its ``_add_mem_opts`` and
``_opts_from_args``), plus ``--device`` (default ``cuda``; the CPU runs
only when named). Two FASTQ files, or ``-p`` with one, run paired-end;
``-I`` fixes the insert-size statistics. What the port does not run yet
is refused with a "not ported yet" error: several devices or hosts,
other seeding engines, ERT/FMA/k-step tables and int64-position
genomes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from . import __version__
from ._shared.cli import _add_mem_opts, _opts_from_args


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch index")
    p.add_argument("fasta")
    p.add_argument("-p", dest="prefix", default=None)
    p.add_argument("-s", dest="sa_compx", type=int, default=3,
                   help="SA sampling shift: keep every 2^s-th entry "
                        "(0 = full SA; 3 = reference default)")
    args = p.parse_args(argv)
    from ._shared.index.bntseq import parse_fasta
    from ._shared.index.build import build_index
    from ._shared.index.artifacts import save_index
    prefix = args.prefix or args.fasta
    t0 = time.time()
    bns = parse_fasta(args.fasta)
    alt_path = args.fasta + ".alt"
    if os.path.exists(alt_path):
        # bwa-mem .alt convention: the contig name is the first column
        with open(alt_path) as f:
            alt_names = {line.split()[0] for line in f
                         if line.strip() and not line.startswith("@")}
        for a in bns.anns:
            a.is_alt = a.name in alt_names
    print(f"* l_pac={bns.l_pac} n_seqs={bns.n_seqs}; building index",
          file=sys.stderr)
    path = save_index(build_index(bns, sa_compx=args.sa_compx), prefix)
    print(f"* wrote {path} in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def cmd_perfect_index(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch "
                                     "perfect-index")
    p.add_argument("prefix")
    p.add_argument("-l", dest="seed_len", type=int, default=151)
    args = p.parse_args(argv)
    from ._shared.index.artifacts import load_index
    from ._shared.index.perfect import (build_perfect_table,
                                        save_perfect_table)
    table = build_perfect_table(load_index(args.prefix), args.seed_len)
    print(f"* wrote {save_perfect_table(table, args.prefix)}",
          file=sys.stderr)
    return 0


def find_emf(prefix: str):
    """The EMF perfect-match table next to the index, if built."""
    from ._shared.index.perfect import load_perfect_table
    for path in sorted(glob.glob(f"{prefix}.emf*.npz"), reverse=True):
        return load_perfect_table(path)
    return None


def _not_ported(what: str):
    raise SystemExit(f"mem: {what} is not ported yet")


def _fixed_pes(spec: str):
    """The four orientations' insert-size stats for ``-I mean[,std[,max
    [,min]]]``: FR fixed, the others failed (the JAX CLI's rule)."""
    from ._shared.pipeline.pe import PeStat
    parts = [float(x) for x in spec.split(",")]
    mean = parts[0]
    std = parts[1] if len(parts) > 1 else mean * 0.1
    hi = parts[2] if len(parts) > 2 else int(mean + 4 * std + 0.499)
    lo = parts[3] if len(parts) > 3 else int(mean - 4 * std + 0.499)
    pes = [PeStat() for _ in range(4)]
    pes[1] = PeStat(low=max(int(lo), 1), high=int(hi), avg=mean, std=std,
                    failed=False)
    return pes


def mem(argv):
    """Run ``mem`` with command-line arguments; returns the GpuAligner
    (its counters: emf_hits, overflow_retried, stats, prof)."""
    # add_help off: -h is the reference's max-XA-hits option
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch mem",
                                add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("prefix")
    p.add_argument("fastq", nargs="+")
    p.add_argument("-o", dest="output", default="-")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu (the CPU only when named)")
    _add_mem_opts(p)
    args = p.parse_args(argv)
    if len(args.fastq) > 2:
        raise SystemExit("mem: at most two FASTQ files")
    if args.devices > 1:
        _not_ported("--devices > 1")
    if args.num_hosts > 1:
        _not_ported("--num-hosts > 1")
    if args.seed_engine is not None:
        _not_ported(f"--seed-engine {args.seed_engine} (the port seeds "
                    f"with the one-hot machine)")
    for pattern, what in ((".ert*.npz", "the ERT index"),
                          (".fma*.npz", "the FMA table"),
                          (".cp[23].npz", "the k-step table")):
        if glob.glob(args.prefix + pattern):
            _not_ported(f"{what} ({args.prefix}{pattern})")
    opt = _opts_from_args(args)

    from ._shared.index.artifacts import load_index
    from ._shared.io.sam import sam_header
    from ._shared.utils.profiling import PROFILER
    from .device import resolve_device
    from .pipeline.align import GpuAligner, PipelineConfig, StageProfile
    from .pipeline.driver import run_alignment

    device = resolve_device(args.device)
    with PROFILER.phase("index_load"):
        idx = load_index(args.prefix)
        if not idx.pos_fits_int32:
            _not_ported("an int64-position genome (seq_len >= 2^31)")
        if args.ignore_alt:
            for a in idx.bns.anns:
                a.is_alt = False
        emf = find_emf(args.prefix)
        if emf is not None:
            print(f"* EMF perfect-match table loaded "
                  f"(seed_len={emf.seed_len})", file=sys.stderr)
        aligner = GpuAligner(idx, device, opt,
                             PipelineConfig(seed_engine="onehot"), emf=emf)
    if args.verbosity >= 4:
        # synchronised per-stage device seconds (the -v 4 stage table)
        aligner.prof = StageProfile(device)

    skip_reads = 0
    if args.checkpoint and args.output != "-" \
            and os.path.exists(args.checkpoint):
        with open(args.checkpoint) as f:
            ck = json.load(f)
        if ck.get("inputs") != args.fastq:
            raise SystemExit("checkpoint was written for different "
                             f"inputs: {ck.get('inputs')}")
        skip_reads = int(ck["reads_emitted"])
        print(f"* resuming after {skip_reads} reads ({args.checkpoint})",
              file=sys.stderr)
    resuming = skip_reads > 0
    out = (sys.stdout if args.output == "-"
           else open(args.output, "a" if resuming else "w"))
    try:
        rg_id = None
        if args.rg_line:
            for field in args.rg_line.replace("\\t", "\t").split("\t"):
                if field.startswith("ID:"):
                    rg_id = field[3:]
        if not resuming:
            out.write(sam_header(idx.bns, args.rg_line,
                                 pg_cl=" ".join(sys.argv)))
        if args.insert_spec:
            aligner.pes = _fixed_pes(args.insert_spec)
            fr = aligner.pes[1]
            print(f"* fixed FR insert size: mean {fr.avg} std {fr.std} "
                  f"proper [{fr.low}, {fr.high}]", file=sys.stderr)
        n_reads = run_alignment(
            aligner, args.fastq, out, batch_reads=args.batch_reads,
            chunk_bp=args.chunk_bp, rg_id=rg_id,
            paired=args.smart_pairing or len(args.fastq) == 2,
            skip_reads=skip_reads, checkpoint_path=args.checkpoint,
            verbosity=args.verbosity)
    finally:
        if out is not sys.stdout:
            out.close()
    PROFILER.report()
    aligner.emf_report()
    aligner.tick_report()
    print(f"* aligned {n_reads} reads on {device}", file=sys.stderr)
    return aligner


def cmd_mem(argv):
    mem(argv)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"index": cmd_index, "mem": cmd_mem,
            "perfect-index": cmd_perfect_index}
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: bwa_mem_scale_tpu_torch "
              "{index,perfect-index,mem,version} ...", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(__version__)
        return 0
    if cmd not in cmds:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 1
    return cmds[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
