"""Command-line interface of the PyTorch/CUDA port.

    python -m bwa_mem_scale_tpu_torch.cli index g.fa -p g
    python -m bwa_mem_scale_tpu_torch.cli perfect-index g -l 101
    python -m bwa_mem_scale_tpu_torch.cli smem-table g -k 11
    python -m bwa_mem_scale_tpu_torch.cli kstep-table g [-k 2|3]
    python -m bwa_mem_scale_tpu_torch.cli ert-index g [-k 12] [--max-depth 320]
    python -m bwa_mem_scale_tpu_torch.cli mem g reads.fq -o out.sam \\
        --device cuda
    python -m bwa_mem_scale_tpu_torch.cli mem g r1.fq r2.fq -o out.sam
    python -m bwa_mem_scale_tpu_torch.cli mem g interleaved.fq -p
    python -m bwa_mem_scale_tpu_torch.cli mem g reads.fq --seed-engine sweep
    python -m bwa_mem_scale_tpu_torch.cli mem g reads.fq --seed-engine readlane
    python -m bwa_mem_scale_tpu_torch.cli load-shm g [-g GB]
    python -m bwa_mem_scale_tpu_torch.cli remove-shm g

The ``mem`` options are the JAX CLI's (``_add_mem_opts`` and
``_opts_from_args`` are copies of its own), plus ``--device`` (default
``cuda``; the CPU runs only when named). Two FASTQ files, or ``-p`` with
one, run paired-end; ``-I`` fixes the insert-size statistics. Seeding
runs the one-hot machine (``ops/smem_oh.py``) unless ``--seed-engine``
names the position-parallel sweep (``sweep``, ``ops/smem.py``), which
takes the FMA ladder table that ``smem-table`` writes next to the index
(``{prefix}.fma{K}.npz``), or the read-per-lane machines (``readlane``,
``ops/smem_rl.py``, on ``PipelineConfig.seed_lanes`` worker lanes);
the one-hot and readlane engines ignore the table, with the JAX CLI's
note. ``ert-index`` builds the ERT suffix trie (``{prefix}.ert{K}.npz``,
``index/ert.py``); ``mem`` loads it next to a full-SA index (``index -s
0``) and seeds with its descent (``ops/ert.py``) on every path, as the
JAX CLI does (with no engine named the run reports the sweep engine; a
named readlane engine drops the trie, with the JAX CLI's note); next to a
sampled index the file is ignored with the JAX CLI's warning. ``-v 4``
prints the JAX CLI's device stage table of the first batch
(``pipeline/stageprof.py``) and, at the end, the port's synchronised
stage seconds over every batch. ``kstep-table`` writes the bigram
(``-k 2``) or trigram (``-k 3``) checkpoint table (``{prefix}.cp{K}.npz``,
``index/kstep.py``); ``mem`` loads it after the index (the trigram table
first, an unreadable file skipped with the JAX CLI's warning), even when
attached to a store, and every engine and tier extends K bases a row
fetch with it (int32-position indexes only, as in JAX). ``load-shm``
stages the index and its tables into the in-memory store (``store.py``,
the JAX package's layout, under a -g budget), ``remove-shm`` drops it,
and ``mem`` attaches to a staged store before it reads any file.
``--devices N`` runs every device stage read-sharded over N devices
(``parallel/mesh.py``: the first N cards with ``--device cuda``, N CPU
shards with ``--device cpu``); ``--num-hosts`` / ``--host-id`` align every
Nth batch into a SAM part of this host's, and ``--coordinator host:port``
joins the hosts in a ``torch.distributed`` gloo group, as the JAX CLI
joins them with ``jax.distributed``. An index of 2^31 positions or more
(hg38) runs on the int64-position layout (``ops/occ.py``), without the
k-step table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from . import __version__
from .config import (MemOptions, MEM_F_ALL, MEM_F_SOFTCLIP,
                     MEM_F_NO_RESCUE, MEM_F_NOPAIRING,
                     MEM_F_NO_MULTI, MEM_F_PRIMARY5,
                     MEM_F_KEEP_SUPP_MAPQ)


def _add_mem_opts(p: argparse.ArgumentParser):
    p.add_argument("-t", type=int, default=1, dest="n_threads",
                   help="accepted for bwa-mem command-line compatibility; "
                        "has no effect (the JAX package reads it nowhere "
                        "either)")
    p.add_argument("-k", type=int, default=19, dest="min_seed_len")
    p.add_argument("-w", type=int, default=100, dest="band_width")
    p.add_argument("-d", type=int, default=100, dest="zdrop")
    p.add_argument("-r", type=float, default=1.5, dest="split_factor")
    p.add_argument("-y", type=int, default=20, dest="max_mem_intv")
    p.add_argument("-c", type=int, default=500, dest="max_occ")
    p.add_argument("-A", type=int, default=1, dest="match")
    p.add_argument("-B", type=int, default=4, dest="mismatch")
    p.add_argument("-O", type=str, default="6,6", dest="gap_open")
    p.add_argument("-E", type=str, default="1,1", dest="gap_ext")
    p.add_argument("-L", type=str, default="5,5", dest="clip_pen")
    p.add_argument("-U", type=int, default=17, dest="pen_unpaired")
    p.add_argument("-T", type=int, default=30, dest="min_score")
    p.add_argument("-D", type=float, default=0.50, dest="drop_ratio")
    p.add_argument("-W", type=int, default=0, dest="min_chain_weight")
    p.add_argument("-G", type=int, default=10000, dest="max_chain_gap")
    p.add_argument("-m", type=int, default=50, dest="max_matesw")
    p.add_argument("-S", action="store_true", dest="skip_rescue",
                   help="skip mate rescue")
    p.add_argument("-P", action="store_true", dest="skip_pairing",
                   help="skip pairing (rescue still runs unless -S)")
    p.add_argument("-a", action="store_true", dest="output_all")
    p.add_argument("-Y", action="store_true", dest="softclip_supp")
    p.add_argument("-M", action="store_true", dest="mark_secondary",
                   help="mark shorter split hits as secondary")
    p.add_argument("-C", action="store_true", dest="copy_comment",
                   help="append FASTA/FASTQ comment to SAM")
    p.add_argument("-j", action="store_true", dest="ignore_alt",
                   help="treat ALT contigs as primary")
    p.add_argument("-5", action="store_true", dest="primary5",
                   help="smallest-coordinate split hit is primary")
    p.add_argument("-q", action="store_true", dest="keep_supp_mapq",
                   help="don't cap MAPQ of supplementary alignments")
    p.add_argument("-h", "--xa-hits", type=str, default="5,200",
                   dest="xa_hits",
                   help="max XA hits [primary,alt]")
    p.add_argument("-K", type=int, default=None, dest="chunk_bp",
                   help="process this many bp per batch (determinism)")
    p.add_argument("-p", action="store_true", dest="smart_pairing",
                   help="first input is interleaved paired-end")
    p.add_argument("-I", type=str, default=None, dest="insert_spec",
                   help="mean[,std[,max[,min]]] fixed insert size")
    p.add_argument("-v", type=int, default=3, dest="verbosity")
    p.add_argument("-R", type=str, default=None, dest="rg_line")
    p.add_argument("-x", type=str, default=None, dest="read_type",
                   help="preset: pacbio, pbref, ont2d, intractg "
                        "(src/fastmap.cpp:1129-1169)")
    p.add_argument("--batch-reads", type=int, default=512,
                   help="device batch size in reads")
    p.add_argument("--devices", type=int, default=1,
                   help="run the device pipeline read-sharded over "
                        "the first N local devices (index replicated "
                        "per chip; batch-reads must divide evenly)")
    p.add_argument("--seed-engine", choices=("sweep", "readlane"),
                   default=None,
                   help="SMEM seeding engine: the one-hot read-per-task "
                        "machine (default) or the position-parallel "
                        "sweep, which takes the FMA table (identical "
                        "output)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="sidecar file tracking emitted reads; rerun "
                        "with the same arguments resumes and appends")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host mode: total hosts sharing the "
                        "FASTQ stream (each aligns every Nth batch "
                        "and writes its own SAM part; global read "
                        "ids preserved so parts byte-match the "
                        "single-host run)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's rank in [0, num-hosts)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the torch.distributed group of "
                        "the hosts (optional; no collective runs on the "
                        "data path)")


def _opts_from_args(args) -> MemOptions:
    o_del, o_ins = (int(x) for x in args.gap_open.split(","))
    e_del, e_ins = (int(x) for x in args.gap_ext.split(","))
    p5, p3 = (int(x) for x in args.clip_pen.split(","))
    xa = [int(x) for x in args.xa_hits.split(",")]

    # -x read-type presets (src/fastmap.cpp:1129-1169) and the -A
    # rescaling of update_a (src/fastmap.cpp:716-730). "Explicitly
    # set" is approximated as "differs from the argparse default"
    # (the reference tracks opt0 bits; the corner where a user
    # re-passes a default value explicitly behaves as unset here).
    def _unset(name, default):
        return getattr(args, name) == default

    mode = args.read_type
    if mode is not None:
        if mode == "intractg":
            if _unset("gap_open", "6,6"):
                o_del = o_ins = 16
            if _unset("mismatch", 4):
                args.mismatch = 9
            if _unset("clip_pen", "5,5"):
                p5 = p3 = 5
        elif mode in ("pacbio", "pbref", "ont2d"):
            if _unset("gap_open", "6,6"):
                o_del = o_ins = 1
            if _unset("gap_ext", "1,1"):
                e_del = e_ins = 1
            if _unset("mismatch", 4):
                args.mismatch = 1
            if _unset("split_factor", 1.5):
                args.split_factor = 10.0
            if mode == "ont2d":
                if _unset("min_chain_weight", 0):
                    args.min_chain_weight = 20
                if _unset("min_seed_len", 19):
                    args.min_seed_len = 14
            else:
                if _unset("min_chain_weight", 0):
                    args.min_chain_weight = 40
                if _unset("min_seed_len", 19):
                    args.min_seed_len = 17
            if _unset("clip_pen", "5,5"):
                p5 = p3 = 0
        else:
            raise SystemExit(f"unknown read type '{mode}'")
    elif args.match != 1:
        # update_a: -A rescales every default-valued penalty
        a = args.match
        if _unset("mismatch", 4):
            args.mismatch *= a
        if _unset("min_score", 30):
            args.min_score *= a
        if _unset("gap_open", "6,6"):
            o_del *= a
            o_ins *= a
        if _unset("gap_ext", "1,1"):
            e_del *= a
            e_ins *= a
        if _unset("zdrop", 100):
            args.zdrop *= a
        if _unset("clip_pen", "5,5"):
            p5 *= a
            p3 *= a
        if _unset("pen_unpaired", 17):
            args.pen_unpaired *= a
    opt = MemOptions(
        a=args.match, b=args.mismatch, o_del=o_del, o_ins=o_ins,
        e_del=e_del, e_ins=e_ins, pen_clip5=p5, pen_clip3=p3,
        w=args.band_width, zdrop=args.zdrop,
        min_seed_len=args.min_seed_len, split_factor=args.split_factor,
        max_mem_intv=args.max_mem_intv, max_occ=args.max_occ,
        T=args.min_score, pen_unpaired=args.pen_unpaired,
        drop_ratio=args.drop_ratio,
        min_chain_weight=args.min_chain_weight,
        max_chain_gap=args.max_chain_gap, max_matesw=args.max_matesw,
        max_XA_hits=xa[0],
        max_XA_hits_alt=xa[1] if len(xa) > 1 else 200,
        copy_comment=args.copy_comment)
    if args.output_all:
        opt.flag |= MEM_F_ALL
    if args.softclip_supp:
        opt.flag |= MEM_F_SOFTCLIP
    if args.skip_rescue:
        opt.flag |= MEM_F_NO_RESCUE
    if args.skip_pairing:
        opt.flag |= MEM_F_NOPAIRING
    if args.mark_secondary:
        opt.flag |= MEM_F_NO_MULTI
    if args.primary5:
        opt.flag |= MEM_F_PRIMARY5
    if args.keep_supp_mapq:
        opt.flag |= MEM_F_KEEP_SUPP_MAPQ
    opt.ignore_alt = args.ignore_alt
    return opt


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch index")
    p.add_argument("fasta")
    p.add_argument("-p", dest="prefix", default=None)
    p.add_argument("-s", dest="sa_compx", type=int, default=3,
                   help="SA sampling shift: keep every 2^s-th entry "
                        "(0 = full SA; 3 = reference default)")
    args = p.parse_args(argv)
    from .index.bntseq import parse_fasta
    from .index.build import build_index
    from .index.artifacts import save_index
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
    p.add_argument("-g", dest="budget_gb", type=float, default=None,
                   help="table memory budget in GB (MEMSCALE partial "
                        "EMF: only the earliest-position seeds get "
                        "entries; misses take the normal path)")
    p.add_argument("--chunked", action="store_true",
                   help="force the streaming chunked builder (auto "
                        "for genomes over 256 Mbp or with -g)")
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.perfect import (build_perfect_table,
                                build_perfect_table_chunked,
                                save_perfect_table)
    idx = load_index(args.prefix)
    chunked = (args.chunked or args.budget_gb is not None
               or idx.bns.l_pac > (256 << 20))
    if chunked:
        budget = (int(args.budget_gb * (1 << 30))
                  if args.budget_gb else None)
        table = build_perfect_table_chunked(
            idx, args.seed_len, budget_bytes=budget,
            log=lambda m: print(m, file=sys.stderr))
    else:
        table = build_perfect_table(idx, args.seed_len)
    print(f"* wrote {save_perfect_table(table, args.prefix)}",
          file=sys.stderr)
    return 0


def cmd_smem_table(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch smem-table")
    p.add_argument("prefix")
    p.add_argument("-k", dest="kmer", type=int, default=None,
                   help="ladder k-mer length (default 11, the "
                        "reference's ALL_SMEM_MAX_BP)")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu (the CPU only when named)")
    args = p.parse_args(argv)
    from .device import resolve_device
    from .index.artifacts import load_index
    from .ops.occ import DeviceFMIndex
    from .ops.fma import build_fma_table, save_fma, DEFAULT_FMA_K
    device = resolve_device(args.device)
    idx = load_index(args.prefix)
    fmi = DeviceFMIndex.from_host(idx, device)
    t0 = time.time()
    fma = build_fma_table(fmi, K=args.kmer or DEFAULT_FMA_K)
    path = save_fma(fma, args.prefix)
    print(f"* wrote {path} in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def find_fma(prefix: str):
    """The FMA ladder table next to the index, if built (the reference
    auto-loads .all_smem.* when SMEM_ACCEL is on,
    src/FMI_search.cpp:394-411)."""
    from .ops.fma import load_fma
    for path in sorted(glob.glob(f"{prefix}.fma*.npz"), reverse=True):
        try:
            return load_fma(path)
        except Exception as e:
            print(f"* WARNING: ignoring unreadable FMA table {path}: "
                  f"{e}", file=sys.stderr)
    return None


def cmd_kstep_table(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch kstep-table")
    p.add_argument("prefix")
    p.add_argument("-k", type=int, default=2, choices=(2, 3),
                   help="gram size: 2 (bigram, 5 B/position) or 3 "
                        "(trigram, 21 B/position, FWD walks consume "
                        "three bases per gather)")
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.kstep import build_cp2, save_cp2
    idx = load_index(args.prefix)
    t0 = time.time()
    cp2 = build_cp2(idx, K=args.k)
    path = save_cp2(cp2, args.prefix)
    print(f"* wrote {path} ({cp2.nbytes() / 1e6:.0f} MB) in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def find_cp2(prefix: str):
    """The k-step checkpoint table next to the index, if built
    (``kstep-table``; the trigram table preferred)."""
    from .index.kstep import load_cp2
    for k in (3, 2):
        path = f"{prefix}.cp{k}.npz"
        if os.path.exists(path):
            try:
                return load_cp2(path)
            except Exception as e:
                print(f"* WARNING: ignoring unreadable k-step table "
                      f"{path}: {e}", file=sys.stderr)
    return None


def cmd_ert_index(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch ert-index")
    p.add_argument("prefix")
    p.add_argument("-k", dest="kmer", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.ert import (build_ert_from_index, save_ert, DEFAULT_ERT_K,
                            DEFAULT_MAX_DEPTH)
    idx = load_index(args.prefix)
    t0 = time.time()
    ert = build_ert_from_index(idx, K=args.kmer or DEFAULT_ERT_K,
                               max_depth=args.max_depth or DEFAULT_MAX_DEPTH)
    path = save_ert(ert, args.prefix)
    print(f"* wrote {path} ({ert.n_nodes} nodes) in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def find_ert(prefix: str, idx):
    """The ERT trie next to the index, if built (it needs a full-SA index,
    the reference's ERT memory class)."""
    from .index.ert import load_ert
    for path in sorted(glob.glob(f"{prefix}.ert*.npz"), reverse=True):
        try:
            ert = load_ert(path)
            if idx.sa_compx != 0:
                print(f"* WARNING: {path} needs a full-SA index "
                      f"(rebuild with index -s 0); ignoring",
                      file=sys.stderr)
                return None
            return ert
        except Exception as e:
            print(f"* WARNING: ignoring unreadable ERT index {path}: "
                  f"{e}", file=sys.stderr)
    return None


def find_emf(prefix: str):
    """The EMF perfect-match table next to the index, if built."""
    from .index.perfect import load_perfect_table
    for path in sorted(glob.glob(f"{prefix}.emf*.npz"), reverse=True):
        try:
            return load_perfect_table(path)
        except Exception as e:
            print(f"* WARNING: ignoring unreadable EMF table {path}: "
                  f"{e}", file=sys.stderr)
    return None


def _fixed_pes(spec: str):
    """The four orientations' insert-size stats for ``-I mean[,std[,max
    [,min]]]``: FR fixed, the others failed (the JAX CLI's rule)."""
    from .pipeline.pe import PeStat
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
    opt = _opts_from_args(args)

    from .index.artifacts import load_index
    from .io.sam import sam_header
    from .utils.profiling import PROFILER
    import torch
    from .device import resolve_device
    from .pipeline.align import GpuAligner, PipelineConfig, StageProfile
    from .pipeline.driver import run_alignment

    device = resolve_device(args.device)
    with PROFILER.phase("index_load"):
        from . import store as _store
        att = _store.attach(args.prefix)
        if att is not None:
            print(f"* attached in-memory index store at {att.root}",
                  file=sys.stderr)
            idx = _store.index_from_store(att.pieces["index"])
            fma = (_store.fma_from_store(att.pieces["fma"])
                   if att.has("fma") else None)
            emf = (_store.emf_from_store(att.pieces["emf"])
                   if att.has("emf") else None)
            ert = (_store.ert_from_store(att.pieces["ert"])
                   if att.has("ert") else None)
        else:
            idx = load_index(args.prefix)
            fma = find_fma(args.prefix)
            emf = find_emf(args.prefix)
            ert = find_ert(args.prefix, idx)
        # from its file even when attached to a store, as the JAX CLI
        cp2 = find_cp2(args.prefix)
        if args.ignore_alt:
            for a in idx.bns.anns:
                a.is_alt = False
        if fma is not None:
            print(f"* FMA ladder table loaded (K={fma.K})", file=sys.stderr)
        if emf is not None:
            print(f"* EMF perfect-match table loaded "
                  f"(seed_len={emf.seed_len})", file=sys.stderr)
        if cp2 is not None:
            print(f"* {cp2.K}-step ({'tri' if cp2.K == 3 else 'bi'}"
                  f"gram) checkpoint table loaded", file=sys.stderr)
        if ert is not None and idx.sa_compx == 0:
            print(f"* ERT index loaded (K={ert.K}, {ert.n_nodes} nodes)",
                  file=sys.stderr)
        elif ert is not None:
            ert = None
        # the JAX CLI's rules: an auto-loaded ERT seeds, and with no engine
        # named the run reports the sweep engine; a named readlane engine
        # drops the trie; the one-hot and readlane engines ignore the FMA
        # table
        engine = args.seed_engine or "onehot"
        if engine in ("readlane", "onehot") and ert is not None:
            if args.seed_engine is None:
                engine = "sweep"
            else:
                print("* note: readlane seeding selected; ignoring "
                      "auto-loaded ERT index", file=sys.stderr)
                ert = None
        if engine in ("readlane", "onehot") and fma is not None:
            print(f"* note: {engine} seeding ignores the FMA table",
                  file=sys.stderr)
            fma = None
        mesh = None
        if args.devices > 1:
            from .parallel.mesh import Mesh
            # the first N cards, or N CPU shards (the JAX CLI's virtual
            # CPU devices)
            n_avail = (torch.cuda.device_count() if device.type == "cuda"
                       else args.devices)
            if args.devices > n_avail:
                raise SystemExit(f"--devices {args.devices} but only "
                                 f"{n_avail} available")
            if args.batch_reads % args.devices:
                raise SystemExit("--batch-reads must be divisible by "
                                 "--devices")
            mesh = Mesh([f"cuda:{i}" for i in range(args.devices)]
                        if device.type == "cuda" else ["cpu"] * args.devices)
            print(f"* device mesh: {args.devices}x read-sharded",
                  file=sys.stderr)
        aligner = GpuAligner(idx, device, opt,
                             PipelineConfig(seed_engine=engine), emf=emf,
                             fma=fma, ert=ert, cp2=cp2, mesh=mesh)
    if args.verbosity >= 4:
        # the JAX CLI's one-shot device stage table on the first batch,
        # and synchronised per-stage device seconds over every batch
        aligner.stage_profile_pending = True
        aligner.prof = StageProfile(device)

    host_shard = None
    group = False
    if args.num_hosts > 1:
        if not (0 <= args.host_id < args.num_hosts):
            raise SystemExit("--host-id must be in [0, num-hosts)")
        if args.checkpoint:
            raise SystemExit("--checkpoint is per-host-stream; not "
                             "supported with --num-hosts")
        if args.coordinator:
            # the hosts' process group, in place of the JAX CLI's
            # jax.distributed.initialize. gloo, not NCCL: nothing on the
            # card is exchanged, and no collective runs on the data path
            # (per-host FASTQ sharding needs none); a barrier at the end
            import torch.distributed as dist
            dist.init_process_group(
                "gloo", init_method=f"tcp://{args.coordinator}",
                world_size=args.num_hosts, rank=args.host_id)
            group = True
            print(f"* torch.distributed: host {args.host_id}/"
                  f"{args.num_hosts} via {args.coordinator}",
                  file=sys.stderr)
        host_shard = (args.num_hosts, args.host_id)
        print(f"* multi-host shard: batches {args.host_id} mod "
              f"{args.num_hosts}", file=sys.stderr)

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
            host_shard=host_shard, verbosity=args.verbosity)
    finally:
        if out is not sys.stdout:
            out.close()
    if group:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    PROFILER.report()
    aligner.emf_report()
    aligner.tick_report()
    print(f"* aligned {n_reads} reads on {device}", file=sys.stderr)
    return aligner


def cmd_mem(argv):
    mem(argv)
    return 0


def cmd_load_shm(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch load-shm")
    p.add_argument("prefix")
    p.add_argument("-g", dest="budget_gb", type=float, default=None,
                   help="memory budget in GB (MEMSCALE policy)")
    a = p.parse_args(argv)
    from . import store as _store
    root = _store.stage(a.prefix, a.budget_gb,
                        log=lambda m: print(m, file=sys.stderr))
    print(f"* index store ready at {root}", file=sys.stderr)
    return 0


def cmd_remove_shm(argv):
    p = argparse.ArgumentParser(prog="bwa_mem_scale_tpu_torch remove-shm")
    p.add_argument("prefix")
    a = p.parse_args(argv)
    from . import store as _store
    ok = _store.remove(a.prefix)
    print("* removed" if ok else "* no store found", file=sys.stderr)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"index": cmd_index, "mem": cmd_mem,
            "perfect-index": cmd_perfect_index,
            "smem-table": cmd_smem_table, "kstep-table": cmd_kstep_table,
            "ert-index": cmd_ert_index,
            "load-shm": cmd_load_shm, "remove-shm": cmd_remove_shm}
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: bwa_mem_scale_tpu_torch {index,perfect-index,"
              "smem-table,kstep-table,ert-index,mem,load-shm,remove-shm,"
              "version} ...",
              file=sys.stderr)
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
