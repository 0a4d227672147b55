#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card:    CUDA present; prints nvidia-smi's name and power limit.
  2. build:   compiles csrc/bsw.cu (the banded-SW kernel) and
              csrc/probes.cu (the probe kernels) from source, one nvcc
              each, both at once; prints ptxas's register report.
  3. kernel:  the CUDA kernel against the plain PyTorch BSW on the card
              at main-path shapes (4096 pairs, query 101, target 309,
              band 100 and 200), all six outputs bit-equal; both timed.
  4. mem:     a 4.6 Mbp genome (the size of E. coli K-12) and 10,000
              simulated 101 bp single-end reads (1% substitutions, half
              reverse-complemented, true positions kept); the port's CLI
              `index`, `perfect-index -l 101` and `mem --device cuda`;
              every read emitted once in input order, >= 95% of the
              primaries of reads the EMF table did not resolve within
              5 bp of the true position and strand, the BSW kernel
              launched; reads/s, and per-stage seconds from a second
              `mem -v 4` run with synchronised stage timers.
  5. slice:   seed_chain_extend on one batch of phase 4 with the kernel
              and with the plain BSW: packed and meta equal.
  6. probes:  the probe path through its entry points, `probe_cuda` and
              `probe_cuda_rates ABCDEF` on the card (every probe OK,
              every probe kernel launched, the rate lines printed); then
              each of the eight probe kernels against its plain PyTorch
              version at the path's shapes, equal arrays, both timed in
              turns.
  7. pe:      paired-end `mem --device cuda` on phase 4's genome and
              index: 5,000 simulated FR pairs of 101 bp (insert 300 +-
              30, 1% substitutions, read 2 reverse-complemented) in two
              FASTQ files; every read emitted once in input order (read
              1 then read 2), the BSW kernel launched, >= 95% of non-EMF
              primaries within 5 bp of the true position and strand,
              >= 90% of pairs with both mates mapped flagged proper, the
              median |TLEN| of proper pairs within 5% of 300; reads/s and
              the host PE stage's seconds beside the device stages'.

Prints the kernel JSON line (all nine kernels), then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}.
Imports nothing of JAX.
"""

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bwa_mem_scale_tpu_torch.tools.timing import (  # noqa: E402
    card_line, device_ms, time_ms)

GENOME_BP = 4_600_000
N_READS = 10_000
READ_LEN = 101
BATCH = 512
N_PAIRS = 5_000
INSERT, INSERT_SD = 300, 30
P, QL, TL = 4096, 101, 309       # main-path BSW shapes (w = 100)


def log(msg=""):
    print(msg, flush=True)


def bsw_pairs(rng, n, ql, tl):
    """Near-matches, random pairs, dead lanes, N bases, z-drop rows."""
    qs = rng.randint(0, 4, (n, ql)).astype(np.int32)
    ts = rng.randint(0, 4, (n, tl)).astype(np.int32)
    near = n // 2
    off = rng.randint(0, tl - ql, near)
    for i in range(near):
        src = qs[i].copy()
        flip = rng.rand(ql) < 0.02
        src[flip] = rng.randint(0, 4, flip.sum())
        ts[i, off[i]: off[i] + ql] = src
    qs[rng.rand(n, ql) < 0.005] = 4
    ts[rng.rand(n, tl) < 0.005] = 4
    zd = slice(near, near + n // 16)         # good prefix, then garbage
    ts[zd, : ql // 3] = qs[zd, : ql // 3]
    q_lens = rng.randint(1, ql + 1, n).astype(np.int32)
    q_lens[:near] = ql
    t_lens = rng.randint(1, tl + 1, n).astype(np.int32)
    dead = rng.rand(n) < 0.1
    q_lens[dead & (rng.rand(n) < 0.5)] = 0
    t_lens[dead] = 0
    h0 = rng.randint(10, 60, n).astype(np.int32)
    return qs, q_lens, ts, t_lens, h0


def phase_kernel(dev, card):
    import torch
    from bwa_mem_scale_tpu_torch._shared.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops.bsw import banded_swa_batch
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    opt = MemOptions()
    pen = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop, opt.mat)
    arrs = [torch.as_tensor(a, device=dev)
            for a in bsw_pairs(np.random.RandomState(11), P, QL, TL)]
    bands = (opt.w, opt.w << 1)
    res = {w: dict(ms=[], plain_ms=[]) for w in bands}
    for w in bands:
        got = banded_swa_batch_cuda(*arrs, w, *pen)
        want = banded_swa_batch(*arrs, w, *pen)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            bad = [f for f, a, b in zip(got._fields, got, want)
                   if not torch.equal(a, b)]
            raise SystemExit(f"kernel != plain BSW at w={w}: fields {bad}")
        res[w]["err"] = err
    # time in turns (w, 2w, 2w, w) so clock ramps do not favour one
    for w in bands + bands[::-1]:
        res[w]["ms"].append(
            time_ms(lambda: banded_swa_batch_cuda(*arrs, w, *pen), 10, dev))
        res[w]["plain_ms"].append(
            time_ms(lambda: banded_swa_batch(*arrs, w, *pen), 2, dev))
    for w in bands:
        r = res[w]
        r["ms"] = sum(r["ms"]) / 2
        r["plain_ms"] = sum(r["plain_ms"]) / 2
        log(f"[kernel] bsw P={P} QL={QL} TL={TL} w={w}: bit-equal "
            f"(max_abs_err {r['err']}); kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms (mean of 2 turns)  [{card}]")
    return res[opt.w]


def write_inputs(tmp):
    from bwa_mem_scale_tpu_torch._shared.index.bntseq import decode_bases
    from bwa_mem_scale_tpu_torch.models.aligner import (
        demo_genome, simulate_reads_with_truth)
    bns = demo_genome(GENOME_BP, seed=7, n_contigs=1)
    seq = decode_bases(bns.seq)
    with open(os.path.join(tmp, "g.fa"), "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    codes, lens, pos, is_rev = simulate_reads_with_truth(
        bns, N_READS, READ_LEN, seed=8, err_rate=0.01)
    qual = "I" * READ_LEN
    with open(os.path.join(tmp, "r.fq"), "w") as f:
        for i in range(N_READS):
            f.write(f"@r{i}\n{decode_bases(codes[i])}\n+\n{qual}\n")
    return codes, lens, pos, is_rev


def check_sam(path, emf_hit, pos, is_rev):
    """Every read once, in input order; placement of non-EMF primaries."""
    order, ok, n_checked = [], 0, 0
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            t = ln.split("\t", 5)
            flag = int(t[1])
            if flag & 0x900:
                continue
            i = int(t[0][1:])
            order.append(i)
            if emf_hit[i]:
                continue
            n_checked += 1
            if (not flag & 0x4 and abs(int(t[3]) - 1 - pos[i]) <= 5
                    and bool(flag & 0x10) == bool(is_rev[i])):
                ok += 1
    if order != list(range(N_READS)):
        raise SystemExit("mem: reads not emitted once each in input order")
    frac = ok / max(n_checked, 1)
    log(f"[mem] {ok}/{n_checked} non-EMF primaries within 5 bp of the "
        f"true position and strand ({100 * frac:.2f}%)")
    if frac < 0.95:
        raise SystemExit("mem: fewer than 95% of primaries placed")


def phase_mem(dev, card, tmp):
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch._shared.index.perfect import (
        emf_lookup_host, load_perfect_table)
    from bwa_mem_scale_tpu_torch._shared.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.emf import FW_MATCHED, RC_MATCHED
    codes, lens, pos, is_rev = write_inputs(tmp)
    g, fq = os.path.join(tmp, "g"), os.path.join(tmp, "r.fq")
    t0 = time.perf_counter()
    for argv in (["index", g + ".fa", "-p", g],
                 ["perfect-index", g, "-l", str(READ_LEN)]):
        if cli.main(argv) != 0:
            raise SystemExit(f"cli {argv[0]} failed")
    log(f"[mem] index + perfect-index: {time.perf_counter() - t0:.1f} s "
        f"(host)")
    mem_argv = [g, fq, "-o", os.path.join(tmp, "out.sam"),
                "--device", "cuda", "--batch-reads", str(BATCH)]

    banded_swa_batch_cuda.launches = 0          # main path starts here
    t0 = time.perf_counter()
    al = cli.mem(mem_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = banded_swa_batch_cuda.launches   # main path ends here

    pt = load_perfect_table(g + ".emf101.npz")
    idx = load_index(g)
    code = emf_lookup_host(pt, idx.ref_string, codes, lens)["code"]
    emf_hit = (code == FW_MATCHED) | (code == RC_MATCHED)
    check_sam(os.path.join(tmp, "out.sam"), emf_hit, pos, is_rev)
    if launches <= 0:
        raise SystemExit("mem: the BSW kernel was never launched")
    log(f"[mem] {N_READS} reads in {wall:.2f} s = {N_READS / wall:.1f} "
        f"reads/s end to end (mem call incl. index load)  [{card}]")
    log(f"[mem] bsw kernel launches {launches}; EMF hits {al.emf_hits}/"
        f"{al.emf_checked}; overflow-retried reads {al.overflow_retried} "
        f"({al.overflow_oracle} to oracle); device batches {al.batches}")
    per = {k: v / al.batches for k, v in sorted(al.stats.items())}
    log("[mem] loop ticks per batch: "
        + ", ".join(f"{k} {v:.1f}" for k, v in per.items()))

    al4 = cli.mem(mem_argv + ["-v", "4"])
    sec = al4.prof.seconds
    log(f"[mem -v 4] synchronised stage seconds over {al4.batches} batches:"
        f" seed {sec['seed']:.3f}, sal {sec['sal']:.3f}, chain "
        f"{sec['chain']:.3f}, bsw {sec['bsw']:.3f}  [{card}]")
    first = np.flatnonzero(~emf_hit)[:BATCH]
    return launches, al, codes[first], lens[first]


def phase_slice(dev, card, al, codes, lens):
    import dataclasses
    import torch
    from bwa_mem_scale_tpu_torch.pipeline.align import seed_chain_extend
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    outs = {}
    for eng in ("auto", "plain"):
        cfg = dataclasses.replace(al.cfg, bsw_engine=eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = seed_chain_extend(al.fmi, al.dbns, c, ln, READ_LEN,
                                opt=al.opt, cfg=cfg)
        torch.cuda.synchronize()
        outs[eng] = (out, time.perf_counter() - t0)
    for key in ("packed", "meta"):
        if not torch.equal(outs["auto"][0][key], outs["plain"][0][key]):
            raise SystemExit(f"slice: {key} differs kernel vs plain BSW")
    n_valid = int(outs["auto"][0]["valid"].sum())
    log(f"[slice] seed_chain_extend on {len(codes)} reads ({n_valid} "
        f"pairs): packed and meta equal; whole call {outs['auto'][1]:.3f} s "
        f"with the kernel BSW, {outs['plain'][1]:.3f} s with the plain BSW"
        f"  [{card}]")


def write_pairs(tmp, bns):
    """FR pairs as tests/test_pe.py simulates them: read 1 forward at the
    fragment's start, read 2 the reverse complement of its end. Writes
    r1.fq and r2.fq (mates named p<i>); returns the interleaved codes
    [2N, L], lens, true leftmost positions and strands."""
    from bwa_mem_scale_tpu_torch._shared.index.bntseq import decode_bases
    rng = np.random.RandomState(9)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    frag = np.maximum(rng.normal(INSERT, INSERT_SD, N_PAIRS).astype(np.int64),
                      READ_LEN + 10)
    start = (rng.rand(N_PAIRS) * (bns.l_pac - frag)).astype(np.int64)
    pos = np.stack([start, start + frag - READ_LEN], 1).reshape(-1)
    codes = bns.seq[pos[:, None] + np.arange(READ_LEN)].astype(np.int32)
    codes[1::2] = comp[codes[1::2, ::-1]]
    sub = rng.rand(*codes.shape) < 0.01
    codes[sub] = (codes[sub] + rng.randint(1, 4, int(sub.sum()))) % 4
    is_rev = np.tile([False, True], N_PAIRS)
    qual = "I" * READ_LEN
    for mate in (0, 1):
        with open(os.path.join(tmp, f"r{mate + 1}.fq"), "w") as f:
            for i in range(mate, 2 * N_PAIRS, 2):
                f.write(f"@p{i // 2}\n{decode_bases(codes[i])}\n+\n{qual}\n")
    return codes, np.full(2 * N_PAIRS, READ_LEN, np.int32), pos, is_rev


def check_pe_sam(path, emf_hit, pos, is_rev):
    """Order and mate flags, placement of non-EMF primaries, proper-pair
    share and the median insert of proper pairs."""
    prim = []
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            t = ln.split("\t", 9)
            if not int(t[1]) & 0x900:
                prim.append((t[0], int(t[1]), int(t[3]), int(t[8])))
    if [p[0] for p in prim] != [f"p{i // 2}" for i in range(2 * N_PAIRS)] \
            or not all(p[1] & (0x40 if i % 2 == 0 else 0x80)
                       for i, p in enumerate(prim)):
        raise SystemExit("pe: reads not emitted once each in input order "
                         "(read 1, then read 2)")
    flag = np.array([p[1] for p in prim])
    placed = ((flag & 0x4) == 0) & (np.abs(np.array([p[2] for p in prim])
                                           - 1 - pos) <= 5) \
        & (((flag & 0x10) != 0) == is_rev)
    frac = placed[~emf_hit].mean()
    log(f"[pe] {int(placed[~emf_hit].sum())}/{int((~emf_hit).sum())} "
        f"non-EMF primaries within 5 bp of the true position and strand "
        f"({100 * frac:.2f}%)")
    both = ((flag[0::2] | flag[1::2]) & 0x4) == 0
    proper = both & ((flag[0::2] & 0x2) != 0)
    share = proper.sum() / max(both.sum(), 1)
    tlen = np.median(np.abs([p[3] for p in prim[0::2]])[proper])
    log(f"[pe] {int(proper.sum())}/{int(both.sum())} pairs with both mates "
        f"mapped are proper ({100 * share:.2f}%); median |TLEN| of proper "
        f"pairs {tlen:.1f} (insert {INSERT} +- {INSERT_SD})")
    if frac < 0.95:
        raise SystemExit("pe: fewer than 95% of primaries placed")
    if share < 0.90:
        raise SystemExit("pe: fewer than 90% of mapped pairs proper")
    if abs(tlen - INSERT) > 0.05 * INSERT:
        raise SystemExit(f"pe: median |TLEN| {tlen} not within 5% of "
                         f"{INSERT}")


def phase_pe(dev, card, tmp):
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch._shared.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch._shared.index.perfect import (
        emf_lookup_host, load_perfect_table)
    from bwa_mem_scale_tpu_torch._shared.utils.profiling import PROFILER
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.emf import FW_MATCHED, RC_MATCHED
    g, sam = os.path.join(tmp, "g"), os.path.join(tmp, "pe.sam")
    idx = load_index(g)
    codes, lens, pos, is_rev = write_pairs(tmp, idx.bns)
    PROFILER.totals.clear()
    PROFILER.counts.clear()

    banded_swa_batch_cuda.launches = 0          # PE path starts here
    t0 = time.perf_counter()
    al = cli.mem([g, os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq"),
                  "-o", sam, "--device", "cuda", "--batch-reads", str(BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = banded_swa_batch_cuda.launches   # PE path ends here

    pt = load_perfect_table(g + ".emf101.npz")
    code = emf_lookup_host(pt, idx.ref_string, codes, lens)["code"]
    check_pe_sam(sam, (code == FW_MATCHED) | (code == RC_MATCHED), pos,
                 is_rev)
    if launches <= 0:
        raise SystemExit("pe: the BSW kernel was never launched")
    n = 2 * N_PAIRS
    sec = PROFILER.totals
    log(f"[pe] {n} reads ({N_PAIRS} pairs) in {wall:.2f} s = "
        f"{n / wall:.1f} reads/s end to end (mem call incl. index load)  "
        f"[{card}]")
    log(f"[pe] bsw kernel launches {launches}; EMF hits {al.emf_hits}/"
        f"{al.emf_checked}; overflow-retried reads {al.overflow_retried}; "
        f"device batches {al.batches}")
    log(f"[pe] seconds: device stages (dispatch_extend, host clock) "
        f"{sec['dispatch_extend']:.3f}, fetch {sec['fetch_pack']:.3f}, "
        f"host PE stage native_pe_c {sec['native_pe_c']:.3f} (pe_rows "
        f"{sec['pe_rows']:.3f}), EMF probe {sec['emf_probe_host']:.3f}, "
        f"SAM write {sec['sam_write']:.3f}, index load "
        f"{sec['index_load']:.3f}  [{card}]")
    return launches


def phase_probes(dev, card):
    """The probe path through its entry points, then each probe kernel
    against its plain version at the path's shapes."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import probe_kernels as pk
    from bwa_mem_scale_tpu_torch.tools import probe_cuda, probe_cuda_rates
    t0 = time.perf_counter()
    pk.reset_launches()                         # probe path starts here
    rcs = (probe_cuda.main(["--device", "cuda"]),
           probe_cuda_rates.main(["ABCDEF", "--device", "cuda"]))
    torch.cuda.synchronize()
    launches = pk.launch_counts()               # probe path ends here
    if any(rcs):
        raise SystemExit(f"probes: entry points exited {rcs}")
    idle = [n for n, c in launches.items() if c <= 0]
    if idle:
        raise SystemExit(f"probes: kernels never launched: {idle}")
    log(f"[probes] probe_cuda and probe_cuda_rates ABCDEF: all OK in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")

    res = {}
    cases = probe_cuda_rates.kernel_cases(dev)
    for name, kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise SystemExit(f"probes: {name} kernel != plain version")
        res[name] = dict(err=int((got.long() - want.long()).abs().max()),
                         ms=[], plain_ms=[])
    # device time (a spin kernel holds the stream while the calls are
    # queued) in turns (kernel, plain, plain, kernel) so clock ramps do
    # not favour one; the wall time of back-to-back calls beside it
    for turn in range(2):
        for name, kernel, plain in cases:
            for which in (("ms", "plain_ms") if turn == 0
                          else ("plain_ms", "ms")):
                fn = kernel if which == "ms" else plain
                res[name][which].append(device_ms(fn, 20, dev))
    for name, kernel, plain in cases:
        r = res[name]
        r["ms"] = sum(r["ms"]) / 2
        r["plain_ms"] = sum(r["plain_ms"]) / 2
        log(f"[probes] {name}: equal to plain (max_abs_err {r['err']}); "
            f"device time kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (mean of 2 turns); back to back a call"
            f" kernel {time_ms(kernel, 20, dev):.4f} ms, plain "
            f"{time_ms(plain, 20, dev):.4f} ms  [{card}]")
    log(f"[probes] phase 6 took {time.perf_counter() - t0:.1f} s")
    return [{"name": name, "route": "cuda", "source": "csrc/probes.cu",
             "replaces": pk.REPLACES[name], "launches": launches[name],
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"]} for name, r in res.items()]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    card = card_line(dev)
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name} x{torch.cuda.device_count()}")

    from bwa_mem_scale_tpu_torch.ops import bsw_cuda, probe_kernels
    with ThreadPoolExecutor(2) as ex:           # one nvcc a source, at once
        builds = [ex.submit(bsw_cuda.build, force=True, verbose=True),
                  ex.submit(probe_kernels.build, force=True, verbose=True)]
        probes_seconds = builds[1].result()[1]
        builds[0].result()
    log(f"[build] csrc/bsw.cu -> {os.path.relpath(bsw_cuda.LIB_PATH, REPO)}"
        f" in {bsw_cuda.build_seconds:.2f} s; csrc/probes.cu -> "
        f"{os.path.relpath(probe_kernels.LIB_PATH, REPO)} in "
        f"{probes_seconds:.2f} s (in parallel)")

    k = phase_kernel(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches, al, codes, lens = phase_mem(dev, card, tmp)
        phase_slice(dev, card, al, codes, lens)
        probes = phase_probes(dev, card)
        phase_pe(dev, card, tmp)

    log(json.dumps({"kernels": [{
        "name": "banded_swa_batch", "route": "cuda",
        "source": "csrc/bsw.cu",
        "replaces": "bwa_mem_scale_tpu/ops/bsw_pallas.py:56",
        "launches": launches, "max_abs_err": k["err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}] + probes}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
