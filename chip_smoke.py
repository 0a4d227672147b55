#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card:    CUDA present; prints nvidia-smi's name and power limit.
  2. build:   compiles csrc/bsw.cu (the banded-SW kernel),
              csrc/probes.cu (the probe kernels), csrc/smem.cu (the
              FM walks: SMEM passes 1-2, pass 3 and the SA walk),
              csrc/chain.cu (chaining and the chain filter),
              csrc/sweep.cu (the sweep engine), csrc/seedsw.cu (the
              seed-SW scorer), csrc/emf.cu (the EMF probe), csrc/ert.cu
              (the ERT descent), csrc/readlane.cu (the readlane
              engine), csrc/kswg.cu (the CIGAR DP), csrc/kswa.cu (the
              rescue SW), csrc/sal.cu (the SA lookup stage),
              csrc/smem_glue.cu (the one-hot seeding stage's task list
              and merge), csrc/extend.cu (the extension stage's glue) and
              csrc/round_probe.cu (a warp's dependent round) from source,
              one nvcc each, all at once; prints ptxas's registers and
              spills for each FM walk, glue, extension, sweep, ERT,
              chaining, seed-SW and BSW kernel (for the BSW kernel and
              its fused form with the extension's band epilogue,
              bsw_band_kernel, one line an instantiation, failing on a
              spill at K = 4 or 5 columns a lane) and the measured cost
              of a round.
  3. kernel:  the CUDA kernel against the plain PyTorch BSW on the card
              at main-path shapes (4096 pairs, query 101, target 309,
              band 100 and 200), all six outputs bit-equal; the live
              pairs, rows and band cells the input needs, and the bound
              they set; the kernel's device time, the wrapper's wall
              time back to back and the plain version's, in turns.
  4. mem:     a 4.6 Mbp genome (the size of E. coli K-12) and 10,000
              simulated 101 bp single-end reads (1% substitutions, half
              reverse-complemented, true positions kept); the port's CLI
              `index`, `perfect-index -l 101` and `mem --device cuda`;
              every read emitted once in input order, >= 95% of the
              primaries of reads the EMF table did not resolve within
              5 bp of the true position and strand, the BSW kernel
              launched, the SMEM passes 1-2 kernel at least twice a
              device batch and the pass-3, both glue (csrc/smem_glue.cu),
              SA lookup stage (csrc/sal.cu), both chaining and the
              extension's select, pairs and stage kernels (csrc/extend.cu)
              at least once a batch, its fused BSW round (BSW with the
              band phase inside, counted as BSW's too) four times,
              the bare SA walk (sa_walk_kernel) never; reads/s, and per-stage seconds (the chain stage
              among them) from a second `mem -v 4` run with synchronised
              stage timers.
  5. slice:   seed_chain_extend on one batch of phase 4 with the kernels
              and with the plain SMEM passes 1 and
              2, with the plain seeding glue, with the plain pass 3 and
              SA lookup, with the plain chaining, and with the plain
              extension glue (ops/extend.py): packed and meta equal; the
              batch's seven extension launches (csrc/extend.cu: select,
              pairs, stage and the four fused BSW rounds), made by a
              further call outside the timed ones, each equal to its
              plain version (max_abs_err 0; a fused round against the
              plain BSW and the plain band phase) with its device time,
              plain time, bound (the bytes these inputs need; a fused
              round adds BSW's) and launch floor (one read or one
              pair); the extension alone (align.extend_chains) timed,
              run under torch.cuda.set_sync_debug_mode("error"), and the
              BSW length
              check raising through fetch_extend on an over-long target;
              the extension launches at the retry tiers' capacities (64
              and 8 reads) and on the repeat batch held the same way; collect_smems_oh with the kernels and with the
              plain passes and glue at the three retry-tier depths (24,
              48, the read length; reseed factors 2, 8, 256): SmemBuf
              equal; the batch's two glue launches (the task list, the
              merge; csrc/smem_glue.cu), as made and at each tier and on
              the repeat batch, each equal to its plain version with its
              bound (the bytes it moves, each input once: glue_work),
              launch floor (the kernel on the first read alone) and
              device time; the four BSW calls of the
              batch (the fused rounds' BSW inputs), each with its live
              pairs, rows, cells, bound, the standalone kernel's device
              time and the wrapper's wall time; the batch's two SMEM
              passes 1-2 launches, its pass-3
              launch and its SA lookup stage call, as made, each equal to
              its
              plain version (per-lane steps too, where the plain version
              counts them), with its steps, bound (passes 1-3: the
              distinct 32-byte rows their twins count, the twins' steps
              and rounds equal to the launch's; 64 bytes a step on the
              repeat batch and at int64), rounds (passes 1-2: the dependent occ round trips of each
              task; a pass-3 or SA-walk step is one; the stage's five
              arrays, every slot, and its steps equal to the plain
              version's, the bare walk held and timed on the plain
              version's rows, and at each retry tier's coordinate capacity and
              on the repeat batch), latency floor (the
              longest task's rounds x 0.224 us), the kernel's device time
              and the plain version's; its two chaining launches, as
              made, each equal field by field to its plain version, with
              its steps, rounds, bound, latency floor (the longest read's
              rounds, its warp's dependent steps, x the cost of a round
              that tools/round_cost.py measures in the same run), the
              kernel's device time and the plain version's; then a
              batch whose reads have many chains and deep interval
              stacks (512 reads on a 2 Mbp genome with repeats, at the
              same shapes): packed and meta
              equal with the plain chaining, its two SMEM passes 1-2
              launches, its pass-3 launch and its two chaining launches
              held and timed the same way, and the filter at non-default
              options equal to its plain version; the batch must reach
              the overlap, drop and first paths, a repetitive SMEM and
              an overflow.
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
              1 then read 2), the BSW kernel launched, the SMEM
              passes 1-2, pass-3, SA lookup stage and chaining kernels
              at least once a device batch (the bare SA walk never),
              >= 95%
              of non-EMF
              primaries within 5 bp of the true position and strand,
              >= 90% of pairs with both mates mapped flagged proper, the
              median |TLEN| of proper pairs within 5% of 300; reads/s and
              the host PE stage's seconds beside the device stages'; the
              stage seconds of a second run with `-v 4`; after the timed
              run, one batch of mates through the run's aligner once more
              (hold_route), each extension launch held against its plain
              version.
  8. int64:   the int64-position layout (ops/occ.py), forced as the tests
              force it: phase 4's SE `mem` again, its SAM body byte-equal
              to phase 4's, each FM-walk and chaining kernel's int64 form
              launched at least once a device batch (passes 1-2 twice)
              and no int32 form, reads/s and `-v 4` stage seconds beside
              phase 4's; phase 5's batch and the repeat batch through
              seed_chain_extend at the int64 layout (packed and meta equal
              to the int32 layout's at the same depth; after the timed
              run, one batch through its aligner once more, each extension
              launch, int64 forms, held against its plain version), each
              int64 launch
              (the glue's two included) as made against its plain
              version (max_abs_err 0) with its bound and latency floor,
              and timed beside the int32 form on the same inputs; the SA lookup stage on samples + 2^33,
              pass 3 on a table whose counts are + 2^32, passes 1-3
              (one-hot and readlane) and the SA lookup stage with a
              non-empty high-word step table,
              chaining on the batch
              moved to two 3.1 Gbp genomes (positions past 2^31, reverse
              ones past 2^32, a seed over the strands' junction), each
              against its plain version; the layout's device bytes and
              hg38's, reckoned. The device-layout cache: SE `mem` on a
              copy of phase 4's index whose seq_len is 2^31, cold (it
              writes big.devlayout3.npz) and warm (it reads it), each SAM
              body byte-equal to phase 4's and each int64 form launched
              every batch; each run's index load beside
              from_host(force_int64=True)'s; the cached layout equal to
              from_host(force_int64=True) on the card, tensor for tensor.
  (Phases 9, 12, 13 and 14 also hold the extension launches of each of
  their `mem` routes against their plain versions, as phase 8 does: one
  batch through the run's aligner after its timed run, hold_route.)
  9. sweep:   the position-parallel sweep engine with the FMA ladder
              table (csrc/sweep.cu): `smem-table` (K = 11) through the
              CLI on the card, its seconds and the table's device bytes,
              build_fma_table alone with its bound; SE `mem --seed-engine
              sweep` on phase 4's reads, its SAM body byte-equal to phase
              4's, both sweep kernels launched every device batch (the
              sweep twice) and no one-hot seeding kernel, reads/s and `-v
              4` stage seconds beside phase 4's; the same at the forced
              int64 layout (int64 forms only); PE `mem --seed-engine
              sweep` byte-equal to phase 7's; phase 5's batch and the
              repeat batch through collect_smems_device with and without
              the table, at both layouts: SmemBuf equal to the plain
              versions', each launch as made (two sweep passes, each
              its extension and its emission in one launch, and one
              merged stage) against its plain version (records and
              SmemBuf, max_abs_err 0, per-lane or per-read steps), with
              its total and longest-lane steps, bound (the sweep, where
              its twin runs (every int32 run, and phase 5's batch with
              the table at int64): the distinct 32-byte checkpoint rows
              and ladder sectors the twin counts, read once, the codes,
              the task list and the outputs, and 45 operations an FM
              step; the merged stage: its codes, the visited columns'
              records and its outputs), latency floor (the sweep: the
              longest lane's row fetches x an L2 trip + one HBM trip;
              the merged stage: an L2 trip + the longest read's steps x
              a warp's round; all measured), device and plain times;
              the engines' seeding kernels side by side.
 10. longread: the long-read regime (the seed-SW filter of
              mem_flt_chained_seeds, ops/seedsw.py, csrc/seedsw.cu) on
              phase 4's genome, index and EMF table: SE `mem --device cuda`
              on (a) 2,000 reads of 800-2,500 bp at default options
              and (b) 300 reads of 3,000-6,000 bp under -x pacbio (1%
              substitutions, every second read reverse-complemented);
              each run: every read once in input order, >= 95% of
              primaries within 5 bp of the true position and strand, the
              seed-SW kernel launched exactly once a call of the filter
              (each device batch and each retry call), reads/s, the stage
              seconds of a second run with `-v 4` (seedsw among them), the
              overflow tiers' reads (tier 1, tier 2, oracle) and the
              ladder's seconds; then the first 512 reads of (a) through
              seed_chain_extend with the seed-SW launch captured, held
              against the plain version (max_abs_err 0), with its jobs,
              DP cells, longest job, bound, latency floor (the longest
              job alone), device and plain times; the batch's peak
              device memory and its four BSW calls (past 767 columns,
              the tiled instantiation) equal to the plain BSW, and its
              extension launches (on the filter's seed_live and
              seed_score) each equal to its plain version.
 11. emf:     the device EMF probe (csrc/emf.cu) behind the in-process
              single-end API, and the in-memory index store: (a) phase
              4's 10,000 reads through GpuAligner(..., emf=table)
              .align_and_finalize in batches of 512 on phase 4's index
              and table; every batch's EMF launch, as made, equal to its
              plain version (max_abs_err 0), its codes equal to the host
              probe's, the hits equal to phase 4's EMF count, every read's
              primary equal to phase 4's SAM, the EMF kernel launched
              once a batch and the SE kernels at least once; the API's
              reads/s, one batch's kernel device ms, plain ms, the host
              probe's ms, bound, latency floor (the longest read's
              dependent trips, counted by the kernel's twin
              emf_lookup_twin, x one dependent HBM trip, probe B on a
              512 MiB table in this run) and the table's device bytes;
              (b) a
              1 Mbp genome whose 64 units (60 bp, 4 copies each) share a
              prefix longer than the seed (a table at -l 51): 512 exact
              reads, each kernel output equal to the plain version's,
              every read placed on its own copy, >= 100 of them through
              the rescue; (c) the store staged into a temporary directory
              under a -g budget (index and EMF table, not the FMA table),
              attached, an aligner on the card from its read-only pieces,
              run_alignment's SE SAM body byte-equal to phase 4's; the
              load from the store beside the load from files (host
              clock), and /dev/shm's size.
 12. ert:     ERT seeding (ops/ert.py, csrc/ert.cu): phase 4's genome
              indexed by the CLI's `index -s 0`, `perfect-index -l 101`
              and `ert-index` (K = 12, depth 320; nodes, build seconds,
              the device record's MiB); SE `mem --device cuda` with the
              trie auto-loaded: phase 4's checks, the descent kernel
              launched twice a device batch and the merged stage and the
              SA lookup stage (its walk a gather of the full SA) once, no
              other seeding kernel, the SAM body equal to `mem
              --seed-engine
              sweep` on the same index and EMF table without the trie
              (a differing read only with its cause: the depth cap, the
              24-bit count's saturation, a retry tier), the same at the
              forced int64 layout (the int64 form, SAM equal); `-v 4`
              stage seconds of both engines; PE with phase 7's checks and
              the same rule; the descent against its plain version on
              (a) phase 5's batch, (b) 512 exact 400 bp reads from the
              repeat genome's 1 kbp window (`tools/batches.py::
              depth_cap_batch`, a lane reaching the depth cap) and (c)
              (a) at the forced int64 layout, each launch with its node
              and leaf steps, bound, latency floor (the longest lane's
              node steps + leaf words of 16 bytes x one dependent trip in
              the L2, measured by probe B in the run; the node steps
              alone beside it), device and plain times, and each
              batch's merged-stage launch against its plain version (as
              phase 9's), the sweep's beside (a); `load-shm` staging the trie's piece, `mem`
              attached to it (SAM equal to the file-loaded run) and
              `remove-shm`.

 13. kstep:   the k-step fold (index/kstep.py, csrc/fmi_step.cuh ext_kt;
              passes 1-3 read the k-gram table alone):
              `kstep-table -k 2` and `-k 3` through the CLI on phase 4's
              index (seconds, the tables' device bytes against nb x 160
              and nb x 672 reckoned); SE `mem` with each table (SAM body
              byte-equal to phase 4's, every passes 1-2 and pass-3 launch
              a k-step form, none a 1-step one, reads/s and `-v 4` stage
              seconds beside phase 4's), PE (byte-equal to phase 7's) and
              SE `--seed-engine sweep` with the K=11 FMA table
              (byte-equal to phase 9's, every sweep launch a k-step
              form); at both tables, on phase 5's batch
              collect_smems_oh at the tiers' depths (24, 48, the read
              length) with the kernels against the plain passes, and on
              it and the repeat batch each k-step launch as made
              (passes 1-2 and pass 3 one-hot, the sweep's two passes
              with the FMA table), each
              equal to its plain version (max_abs_err 0, steps too) and
              to the K = 1 form on the same inputs, with its rounds
              beside K = 1's, bound (passes 1-3 on phase 5's batch: the
              twin's distinct 32-byte k-gram groups, the twin's steps and
              rounds equal to the launch's; the repeat batch's 64 bytes a
              step; the sweep's pass 1 on phase 5's batch at K = 2: the
              twin's distinct rows and ladder sectors, as phase 9),
              latency floor (the longest lane's rounds x one dependent
              load over the batch's k-gram table's footprint, probe B,
              the median of 5 turns measured in the run, stopping where
              it reads below the trip over the 1-step table by more than
              the turns' spread and 5%;
              the sweep adds one HBM trip for its start) and device ms
              (the K = 1 form's time beside it is
              tools/kstep_before_after.py's); the tiers' glue launches
              held as phase 5's.
 14. readlane: the readlane engine (csrc/readlane.cu): SE `mem
              --seed-engine readlane` (SAM byte-equal to phase 4's), its
              `-v 4` table, PE, the forced int64 layout and the k-step
              tables, then each form at each pool against the plain
              machines (and at K = 1 its total ticks against the twins'),
              with its latency floor from the longest lane's rounds; the
              SmemBuf at each pool equal to the same call with the plain
              glue (the task list and merge kernels are the one-hot
              engine's).
 15. mesh:    several devices and hosts, and the device DP loops: (a)
              2,048 of phase 4's reads through align_and_finalize (the
              device EMF probe sharded), 512 of phase 7's pairs through
              align_pairs_and_finalize and 1,536 reads through SeStream,
              on a mesh of the first two cards (or cuda:0 twice on one
              card) and on one device: records equal, each main-path
              kernel and the EMF probe launched on every shard (counts by
              shard printed), wall times printed (host clock, no scaling
              claimed), then one batch through the mesh's aligner, each
              shard's extension launches held against their plain
              versions; (b) SE `mem --num-hosts 2 --host-id 0/1
              --coordinator localhost:<port>` as two processes: the parts'
              union byte-equal to phase 4's SAM body; `mem --devices 2`
              failing with the JAX CLI's message on one card (byte-equal
              to phase 4's on two); (d) PE `mem` under
              BWA_TPU_NO_NATIVE_PE, _KSWG and _KSWA (the Python PE path,
              the CIGAR DP and the rescue SW on the card): phase 7's
              gate, the SAM lines that differ from phase 7's, reads/s;
              (c) the CIGAR DP kernel (csrc/kswg.cu) on the largest call
              that run made and on the CIGAR jobs of 16 long reads
              (800-2,500 bp), the rescue SW kernel (csrc/kswa.cu) on its
              largest rescue call, each against its plain version
              (max_abs_err 0) with its jobs, DP cells, bound, latency
              floor (the CIGAR DP: the longest job's rows x a row step
              measured in the run, and its rows + traceback steps x a
              warp's dependent round, tools/round_cost.py; the rescue SW:
              the longest job's wavefront steps, both scans, x a step
              measured in the run), kernel and
              plain times; (e) tools/multichip.py on the mesh.
 16. finalize: the Python finalize path (BWA_TPU_NO_NATIVE_FINALIZE: the
              JAX package's Python record path and SAM writer): phase
              4's reads and phase 7's pairs through `mem`, alone and with
              BWA_TPU_NO_NATIVE_KSWG (the CIGAR DP on the card); each
              run meets phase 4's or phase 7's gate, launches each
              main-path kernel at least once a device batch (passes 1-2
              twice) and the bare SA walk never, the CIGAR DP kernel
              exactly when _KSWG is set; reads/s beside the native run's
              and the SAM lines that differ from it.

Prints the kernel JSON line (all forty-eight kernels, each with its bound: the
larger of its bytes over the HBM rate and its integer operations over
the INT32 rate, and the time of one PyTorch call computing the same
function where there is one), then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}.
Imports nothing of JAX.
"""

import contextlib
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bwa_mem_scale_tpu_torch.tools.round_cost import (  # noqa: E402
    TRIP_TICKS, dependent_trip_us, trip_turns)
from bwa_mem_scale_tpu_torch.tools.timing import (  # noqa: E402
    card_line, device_ms, time_ms)

GENOME_BP = 4_600_000
N_READS = 10_000
READ_LEN = 101
BATCH = 512
N_PAIRS = 5_000
INSERT, INSERT_SD = 300, 30
P, QL, TL = 4096, 101, 309       # main-path BSW shapes (w = 100)
# the bound's rates on an H100 SXM: HBM from the data sheet; INT32 from
# 64 INT32 lanes an SM x 132 SMs x 1.98 GHz (the data sheet lists none)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations a band cell of the BSW recurrence: score 4 (N test,
# match test, two selects), M 2, H 2, row max 2, E 4, F 4, band test 2
BSW_OPS_PER_CELL = 20
# an SMEM step: two 32-byte checkpoint rows; the occ of 4 bases at both
# ends (shift, mask, 4 AND, 4 popcount, 4 add each: 2 x 14), the four
# sizes 4, the sentinel test 3, the base's k, l and s 6, the interval
# tests 4
SMEM_BYTES_PER_STEP = 64
SMEM_OPS_PER_STEP = 45
# an SA-walk iteration: one 32-byte checkpoint row, or the 4-byte sample
# that ends the walk; the sample test 2, the row index and its clamp 3, y
# and the bit 3, the base 8 (4 AND, 4 selects), the sentinel test 1, the
# top mask 3, the count word, mask and C selects 3, AND, popcount and the
# two adds 4
SAL_ROW_BYTES = 32
SAL_OPS_PER_STEP = 27
# the SA lookup stage around the walk (csrc/sal.cu): a slot's owner test,
# seed_idx select and three stores 5 (a walked slot's binary search and
# row arithmetic are small beside its walk); an SMEM's count (compare,
# divide, two clamps) and its share of the warp's scan 8
SAL_OPS_PER_SLOT = 5
SAL_OPS_PER_SMEM = 8
# the dependent checkpoint-row load on the 4.6 Mbp table (probe B, L2;
# PERF.md section 6), the latency floor of a lane's step
STEP_US = 0.224
# chaining (csrc/chain.cu), a warp a read. The latency floor is the
# longest read's rounds (the warp's dependent steps, each waiting on a
# shared-memory or global trip; each kernel counts its own) x the cost of
# a round measured in this run (tools/round_cost.py: a dependent
# shared-memory load, a shuffle and a ballot of one warp). Integer
# operations the function needs: a coordinate of chain_seeds 50 (the
# contig search 10, the lower chain's search 8, test_and_merge 25, the
# append or insert 7); for chain_filter a seed of the weight scans 12, an
# overlap test 20, an SMEM of the frac_rep scan 2 (its occurrence test
# and the loop's), and 8 more for one over max_occ (its end, the segment
# test, the length added or the end's maximum)
CHAIN_OPS_PER_COORD = 50
FLT_OPS_PER_SEED, FLT_OPS_PER_TEST = 12, 20
FLT_OPS_PER_SMEM, FLT_OPS_PER_REP = 2, 8


def log(msg=""):
    print(msg, flush=True)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` and do `ops` integer operations."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def bsw_work(args):
    """Live pairs, rows walked, the longest pair's rows and index, band
    cells, and the bound of one BSW call (its plain version counts them):
    inputs read once, the [6, P] output written once, BSW_OPS_PER_CELL a
    cell."""
    from bwa_mem_scale_tpu_torch.ops.bsw import banded_swa_batch
    st = {"bsw_rows_per_pair": None}
    banded_swa_batch(*args, stats=st)
    qs, q_lens, ts, t_lens, h0 = args[:5]
    live = int(((q_lens > 0) & (t_lens > 0)).sum())
    nbytes = 4 * (qs.numel() + ts.numel() + 3 * len(h0) + 6 * len(h0))
    cells = st.get("bsw_cells", 0)
    per = st["bsw_rows_per_pair"]
    return dict(live=live, rows=st.get("bsw_pair_rows", 0),
                max_rows=0 if per is None else int(per.max()), cells=cells,
                longest=None if per is None else int(per.argmax()),
                bound=bound(nbytes, BSW_OPS_PER_CELL * cells))


def bsw_launch_only(args):
    """A thunk of the kernel's launch alone on `args` (int32 CUDA tensors
    with lengths in range) through bsw_rows, the lengths stacked once: no
    length check, no sync."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import bsw_cuda
    qs, q_lens, ts, t_lens, h0 = args[:5]
    rows = (qs.contiguous(), torch.stack([q_lens, t_lens]), ts.contiguous(),
            h0.contiguous())
    return lambda: bsw_cuda.bsw_rows(*rows, *args[5:12])


def bsw_calls_of(rounds):
    """The BSW calls inside the extension's fused rounds
    (ext_bsw_band_cuda's [(args, kwargs)] as made), each in
    banded_swa_batch's form: qs, q_lens, ts, t_lens, h0, w, the gap
    penalties, zdrop and mat (ops/extend.py::bsw_inputs)."""
    import inspect
    from bwa_mem_scale_tpu_torch.ops import extend, extend_cuda
    sig = inspect.signature(extend_cuda.ext_bsw_band_cuda)
    out = []
    for args, kw in rounds:
        a = sig.bind(*args, **kw).arguments
        opt = a["opt"]
        q, lens, t, h0, w = extend.bsw_inputs(a["phase"], a["st"], a["lens"],
                                              a["left"], opt)
        out.append((q, lens[0], t, lens[1], h0, w, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, opt.zdrop, opt.mat))
    return out


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
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops.bsw import banded_swa_batch
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    opt = MemOptions()
    pen = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop, opt.mat)
    arrs = [torch.as_tensor(a, device=dev)
            for a in bsw_pairs(np.random.RandomState(11), P, QL, TL)]
    bands = (opt.w, opt.w << 1)
    res = {w: dict(ms=[], wall_ms=[], plain_ms=[], alone_ms=[])
           for w in bands}
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
        res[w].update(bsw_work((*arrs, w, *pen)))
    # in turns (w, 2w, 2w, w) so clock ramps do not favour one; the
    # longest pair alone is the latency floor of its rows
    for w in bands + bands[::-1]:
        r = res[w]
        r["ms"].append(device_ms(bsw_launch_only((*arrs, w, *pen)), 20, dev))
        one = [a[r["longest"]:r["longest"] + 1] for a in arrs]
        r["alone_ms"].append(
            device_ms(bsw_launch_only((*one, w, *pen)), 20, dev))
        r["wall_ms"].append(
            time_ms(lambda: banded_swa_batch_cuda(*arrs, w, *pen), 20, dev))
        r["plain_ms"].append(
            time_ms(lambda: banded_swa_batch(*arrs, w, *pen), 2, dev))
    for w in bands:
        r = res[w]
        for key in ("ms", "wall_ms", "plain_ms", "alone_ms"):
            r[key] = sum(r[key]) / 2
        log(f"[kernel] bsw P={P} QL={QL} TL={TL} w={w}: bit-equal "
            f"(max_abs_err {r['err']}); {r['live']} live pairs walk "
            f"{r['rows']} rows (longest {r['max_rows']}) and {r['cells']} "
            f"band cells: bound {r['bound'][0]:.5f} ms by {r['bound'][1]}; "
            f"kernel device time {r['ms']:.5f} ms (the longest pair alone "
            f"{r['alone_ms']:.5f} ms), wrapper call back to back "
            f"{r['wall_ms']:.5f} ms, plain {r['plain_ms']:.3f} ms (mean of "
            f"2 turns)  [{card}]")
    return res[opt.w]


def write_inputs(tmp):
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
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


def main_path_wrappers():
    """{kernel name: wrapper} of the main path's kernels (phase 4's), the
    bare SA walk (never launched there) and the CIGAR DP."""
    from bwa_mem_scale_tpu_torch.ops import (bsw_cuda, chain_cuda,
                                             extend_cuda, kswg_cuda,
                                             sal_cuda, smem_cuda)
    return {"banded_swa_batch": bsw_cuda.banded_swa_batch_cuda,
            "one_pos_machine": smem_cuda.one_pos_machine_cuda,
            "seed_strategy_machine": smem_cuda.seed_strategy_machine_cuda,
            "expand_and_lookup": sal_cuda.expand_and_lookup_cuda,
            "sa_walk": smem_cuda.sa_walk_cuda,
            "chain_seeds": chain_cuda.chain_seeds_cuda,
            "chain_filter": chain_cuda.chain_filter_cuda,
            "ksw_global_batch": kswg_cuda.ksw_global_batch_cuda,
            "reseed_tasks": smem_cuda.reseed_tasks_cuda,
            "merge_smems": smem_cuda.merge_smems_cuda,
            **{name: getattr(extend_cuda, attr)
               for name, attr, _ in EXT_KERNELS}}


def ext_launch_check(what, launches, batches):
    """SystemExit unless the extension kernels launched once a device
    batch each (the fused BSW round four times) and BSW four times."""
    for name, per in (("ext_select", 1), ("ext_pairs", 1), ("ext_stage", 1),
                      ("ext_bsw_band", 4), ("banded_swa_batch", 4)):
        if launches[name] < per * batches:
            raise SystemExit(f"{what}: the {name} kernel launched "
                             f"{launches[name]} times over {batches} device "
                             f"batches, fewer than {per} a batch")


def phase_mem(dev, card, tmp):
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    from bwa_mem_scale_tpu_torch.index.perfect import (
        emf_lookup_host, load_perfect_table)
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
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

    wrappers = main_path_wrappers()
    for w in wrappers.values():                 # main path starts here
        w.launches = 0
    PROFILER.totals.clear()
    t0 = time.perf_counter()
    al = cli.mem(mem_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    index_load = PROFILER.totals["index_load"]
    launches = {n: w.launches for n, w in wrappers.items()}
    # main path ends here

    pt = load_perfect_table(g + ".emf101.npz")
    idx = load_index(g)
    code = emf_lookup_host(pt, idx.ref_string, codes, lens)["code"]
    emf_hit = (code == FW_MATCHED) | (code == RC_MATCHED)
    check_sam(os.path.join(tmp, "out.sam"), emf_hit, pos, is_rev)
    if launches["banded_swa_batch"] <= 0:
        raise SystemExit("mem: the BSW kernel was never launched")
    if launches["one_pos_machine"] < 2 * al.batches:
        raise SystemExit(f"mem: the SMEM kernel launched "
                         f"{launches['one_pos_machine']} times over "
                         f"{al.batches} device batches, fewer than two a "
                         f"batch")
    for name in ("seed_strategy_machine", "expand_and_lookup",
                 "chain_seeds", "chain_filter", "reseed_tasks",
                 "merge_smems"):
        if launches[name] < al.batches:
            raise SystemExit(f"mem: the {name} kernel launched "
                             f"{launches[name]} times over {al.batches} "
                             f"device batches, fewer than one a batch")
    if launches["sa_walk"]:
        raise SystemExit(f"mem: the bare SA walk launched "
                         f"{launches['sa_walk']} times on the mem path")
    ext_launch_check("mem", launches, al.batches)
    log(f"[mem] {N_READS} reads in {wall:.2f} s = {N_READS / wall:.1f} "
        f"reads/s end to end (mem call incl. index load)  [{card}]")
    log(f"[mem] kernel launches {launches}; EMF hits {al.emf_hits}/"
        f"{al.emf_checked}; overflow-retried reads {al.overflow_retried} "
        f"({al.overflow_oracle} to oracle); device batches {al.batches}")
    per = {k: float(v) / al.batches for k, v in sorted(al.stats.items())}
    log("[mem] loop ticks (lockstep) and longest lane's steps (FM-walk "
        "and chaining kernels) per batch: "
        + ", ".join(f"{k} {v:.1f}" for k, v in per.items()))

    al4 = cli.mem(mem_argv + ["-v", "4"])
    sec = al4.prof.seconds
    log(f"[mem -v 4] synchronised stage seconds over {al4.batches} batches:"
        f" seed {sec['seed']:.4f}, sal {sec['sal']:.4f}, chain "
        f"{sec['chain']:.4f}, bsw {sec['bsw']:.4f}  [{card}]")
    first = np.flatnonzero(~emf_hit)[:BATCH]
    se = dict(argv=mem_argv, wall=wall, batches=al.batches, seconds=dict(sec),
              index_load=index_load, emf_hits=al.emf_hits, codes=codes,
              lens=lens, pos=pos, is_rev=is_rev, emf_hit=emf_hit)
    return launches, al, codes[first], lens[first], se


def phase_slice(dev, card, al, codes, lens):
    import dataclasses
    import torch
    from bwa_mem_scale_tpu_torch.ops import chain, extend, sal, smem_oh
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.pipeline import align
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    # the wrappers of the path, by the module attribute the path calls
    real = {(smem_oh, "one_pos_machine_cuda"): smem_oh.one_pos_machine_cuda,
            (smem_oh, "seed_strategy_machine_cuda"):
                smem_oh.seed_strategy_machine_cuda,
            (sal, "expand_and_lookup_cuda"): sal.expand_and_lookup_cuda,
            (align, "chain_seeds_cuda"): align.chain_seeds_cuda,
            (align, "chain_filter_cuda"): align.chain_filter_cuda,
            (smem_oh, "reseed_tasks_cuda"): smem_oh.reseed_tasks_cuda,
            (smem_oh, "merge_smems_cuda"): smem_oh.merge_smems_cuda,
            **{(align, attr): getattr(align, attr)
               for _, attr, _ in EXT_KERNELS}}
    calls = {name: [] for _, name in real}

    def recorder(name, fn):            # the batch's calls, as made
        def record(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return record

    key = {name: (mod, name) for mod, name in real}
    k12, k3 = key["one_pos_machine_cuda"], key["seed_strategy_machine_cuda"]
    kwalk, kts = key["expand_and_lookup_cuda"], key["reseed_tasks_cuda"]
    kseeds, kflt = key["chain_seeds_cuda"], key["chain_filter_cuda"]
    kmerge = key["merge_smems_cuda"]
    plain = glue_plain()
    runs = (("auto", "auto", {k: recorder(k[1], fn)
                              for k, fn in real.items()}),
            ("plain_seed", "auto", {k12: smem_oh.one_pos_machine}),
            ("plain_glue", "auto", {kts: plain["reseed_tasks_cuda"],
                                    kmerge: plain["merge_smems_cuda"]}),
            ("plain_walks", "auto", {k3: smem_oh.seed_strategy_machine,
                                     kwalk: sal.expand_and_lookup_plain}),
            ("plain_chain", "auto", {kseeds: chain.chain_seeds_device,
                                     kflt: chain.chain_filter_frac_rep}),
            ("plain_ext", "auto", {key[attr]: getattr(extend, name)
                                   for name, attr, _ in EXT_KERNELS}))
    outs = {}
    for run, bsw_eng, swaps in runs:
        cfg = dataclasses.replace(al.cfg, bsw_engine=bsw_eng)
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = align.seed_chain_extend(al.fmi, al.dbns, c, ln, READ_LEN,
                                          opt=al.opt, cfg=cfg)
            torch.cuda.synchronize()
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)
        outs[run] = (out, time.perf_counter() - t0)
    with ext_recorded() as ext_made:    # untimed: each extension launch
        align.seed_chain_extend(al.fmi, al.dbns, c, ln, READ_LEN, opt=al.opt,
                                cfg=al.cfg)
    for run, what in (("plain_seed", "SMEM passes 1-2"),
                      ("plain_glue", "seeding glue"),
                      ("plain_walks", "pass 3 and SA lookup"),
                      ("plain_chain", "chaining"),
                      ("plain_ext", "extension glue (ops/extend.py)")):
        for key in ("packed", "meta"):
            if not torch.equal(outs["auto"][0][key], outs[run][0][key]):
                raise SystemExit(f"slice: {key} differs kernel vs plain "
                                 f"{what}")
    n_valid = int(outs["auto"][0]["valid"].sum())
    log(f"[slice] seed_chain_extend on {len(codes)} reads ({n_valid} "
        f"pairs): packed and meta equal with the kernels and with the "
        f"plain SMEM passes 1-2, the plain seeding glue, the plain pass 3 "
        f"and SA lookup, the plain chaining and the plain extension glue "
        f"(BSW's rounds included); whole call {outs['auto'][1]:.3f} s with "
        f"the kernels, "
        f"{outs['plain_seed'][1]:.3f} s with the plain SMEM passes 1-2, "
        f"{outs['plain_glue'][1]:.3f} s with the plain seeding glue, "
        f"{outs['plain_walks'][1]:.3f} s with the plain pass 3 and SA "
        f"lookup, {outs['plain_chain'][1]:.3f} s with the plain chaining, "
        f"{outs['plain_ext'][1]:.3f} s with the plain extension glue  "
        f"[{card}]")
    # the BSW calls as the fused rounds made them, in the wrapper's form
    bsw_calls = bsw_calls_of(calls["ext_bsw_band_cuda"])
    if len(bsw_calls) != 4:
        raise SystemExit(f"slice: {len(bsw_calls)} BSW calls, expected 4")
    path = []
    bsw = banded_swa_batch_cuda
    for n, args in enumerate(bsw_calls):
        wk = bsw_work(args)
        ms = device_ms(bsw_launch_only(args), 20, dev)
        wall = time_ms(lambda: bsw(*args), 20, dev)
        path.append(dict(wk, ms=ms, wall_ms=wall))
        log(f"[slice] bsw call {n + 1}/4 (P={args[0].shape[0]}, QL="
            f"{args[0].shape[1]}, TL={args[2].shape[1]}, w={args[5]}): "
            f"{wk['live']} live pairs, {wk['rows']} rows (longest "
            f"{wk['max_rows']}), {wk['cells']} cells; bound "
            f"{wk['bound'][0]:.5f} ms by {wk['bound'][1]}; kernel device "
            f"time {ms:.5f} ms, wrapper call back to back {wall:.5f} ms"
            f"  [{card}]")
    for name, want in (("one_pos_machine_cuda", 2),
                       ("seed_strategy_machine_cuda", 1),
                       ("expand_and_lookup_cuda", 1),
                       ("chain_seeds_cuda", 1),
                       ("chain_filter_cuda", 1),
                       ("reseed_tasks_cuda", 1), ("merge_smems_cuda", 1),
                       ("ext_select_cuda", 1), ("ext_pairs_cuda", 1),
                       ("ext_stage_cuda", 1), ("ext_bsw_band_cuda", 4)):
        if len(calls[name]) != want:
            raise SystemExit(f"slice: {len(calls[name])} {name} launches, "
                             f"expected {want}")
    smem = [smem_launch(dev, card, n, args, twin=True)
            for n, (args, _) in enumerate(calls["one_pos_machine_cuda"])]
    p3 = seed_strategy_launch(dev, card,
                              calls["seed_strategy_machine_cuda"][0][0],
                              twin=True)
    walk = sal_stage_launch(dev, card, *calls["expand_and_lookup_cuda"][0])
    seeds = chain_seeds_launch(dev, card, *calls["chain_seeds_cuda"][0])
    flt = chain_filter_launch(dev, card, *calls["chain_filter_cuda"][0])
    glue = {name: glue_launch(dev, card, "phase 5's batch, as made", attr,
                              calls[attr][0][0])
            for name, attr, _ in GLUE_KERNELS}
    hold_ext(ext_made, "phase 5's batch", card)
    ext = ext_time(ext_made, dev, card, "phase 5's batch")
    ext["whole"] = ext_whole(dev, card, al, c, ln)
    ext_tiers(dev, card, al, c, ln)
    smem_tiers(dev, card, al, c, ln)
    repeat_slice(dev, card, al)
    return path, smem, p3, walk, seeds, flt, glue, ext


def walk_launch(dev, what, kernel, plain, args, plain_reps, kw=None):
    """One FM-walk or chaining launch of the batch, as made: the kernel
    against its plain version on every output (each equal) and, where the
    plain version counts them, on its per-lane steps; its per-lane steps
    and, where the kernel counts them, its per-task rounds (dependent
    round trips); the latency floor (the longest lane's rounds, else its
    steps, x STEP_US; the chaining launches restate it); the kernel's
    device time (mean of 2, around the plain version's time). Returns
    (the kernel's output, the numbers)."""
    import torch
    kw = {k: v for k, v in (kw or {}).items() if k != "stats"}
    got = kernel(*args, **kw)
    steps = kernel.last_steps.long()
    rounds = getattr(kernel, "last_rounds", None)
    rounds = steps if rounds is None else rounds.long()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if isinstance(got, dict):                # the sweep's records
        if set(got) != set(want):
            raise SystemExit(f"slice: {what}: keys {sorted(got)} != "
                             f"{sorted(want)}")
        pairs = [(got[k], want[k]) for k in want]
    else:
        pairs = (list(zip(got, want)) if isinstance(got, tuple)
                 else [(got, want)])
    bad = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in pairs)
    if bad or err:
        raise SystemExit(f"slice: {what} != plain in outputs {bad} "
                         f"(max_abs_err {err})")
    plain_steps = getattr(plain, "last_steps", None)
    if plain_steps is not None and not torch.equal(steps, plain_steps.long()):
        raise SystemExit(f"slice: {what}: the kernel's per-lane steps differ "
                         f"from the plain version's")
    ms = [device_ms(lambda: kernel(*args, **kw), 20, dev)]
    plain_ms = time_ms(lambda: plain(*args, **kw), plain_reps, dev)
    ms.append(device_ms(lambda: kernel(*args, **kw), 20, dev))
    longest = int(rounds.max())
    return got, dict(err=err, ms=sum(ms) / 2, plain_ms=plain_ms,
                     steps=int(steps.sum()), longest=int(steps.max()),
                     rounds=int(rounds.sum()), longest_rounds=longest,
                     floor=longest * STEP_US * 1e-3)


def log_walk(card, what, r, detail, tag="slice"):
    trips = ("" if r["rounds"] == r["steps"] else
             f", {r['rounds']} rounds, the longest task "
             f"{r['longest_rounds']}")
    log(f"[{tag}] {what}: equal to the plain version (max_abs_err "
        f"{r['err']}); {detail}, the longest lane {r['longest']}{trips}; "
        f"bound {r['bound'][0]:.6f} ms by {r['bound'][1]}, latency floor "
        f"{r['floor']:.5f} ms ({r['longest_rounds']} x {STEP_US} us); "
        f"kernel device time {r['ms']:.5f} ms (mean of 2), plain "
        f"{r['plain_ms']:.2f} ms  [{card}]")


def twin_rows(kernel, twin, args) -> int:
    """The distinct 32-byte checkpoint rows a K = 1 launch's walks read:
    the kernel's twin (ops/smem_cuda.py) on the launch's host inputs, its
    per-lane steps (and rounds, where it counts them) equal to the
    launch's (kernel.last_steps / last_rounds), or SystemExit."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem_cuda
    steps = kernel.last_steps.cpu().numpy()
    rounds = kernel.last_rounds.cpu().numpy()
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in args[1:]]
    tw = twin(*smem_cuda.twin_tables(args[0])[:3], *host)
    if not (np.array_equal(tw[6], steps) and np.array_equal(tw[7], rounds)):
        raise SystemExit(f"slice: {twin.__name__}'s steps or rounds differ "
                         f"from the launch's")
    return len(twin.last_reads)


def smem_launch(dev, card, n, args, batch="the batch", twin=False):
    """One SMEM passes 1-2 launch against the plain machine, with its
    bound: the inputs, the outputs (m and n 4 bytes, k, l and s the
    positions' 4 or 8; not the per-lane steps and rounds, which only
    instrument the run), 45 operations a step and, with `twin`, the
    distinct 32-byte rows its twin reads (twin_rows), else 64 bytes a
    step; its latency floor from the longest task's rounds."""
    from bwa_mem_scale_tpu_torch.ops.smem_cuda import (one_pos_machine_cuda,
                                                       one_pos_twin)
    from bwa_mem_scale_tpu_torch.ops.smem_oh import one_pos_machine
    args = args[:11]                           # without stats
    what = f"smem launch {n + 1}/2, {batch}"
    _, r = walk_launch(dev, what, one_pos_machine_cuda, one_pos_machine,
                       args, 1)
    codes, T, M = args[1], args[3].shape[0], args[9]
    pb = args[0].pos_dtype.itemsize
    nbytes = (4 * (codes.numel() + codes.shape[0] + 3 * T) + T
              + (8 + 3 * pb) * T * M + 4 * T)
    reads = f"{r['steps']} steps"
    if twin:
        r["rows"] = twin_rows(one_pos_machine_cuda, one_pos_twin, args)
        nbytes += 32 * r["rows"]
        reads += (f", {r['rows']} distinct 32-byte rows (the twin, its "
                  f"steps and rounds equal)")
    else:
        nbytes += SMEM_BYTES_PER_STEP * r["steps"]
    r["bound"] = bound(nbytes, SMEM_OPS_PER_STEP * r["steps"])
    log_walk(card, f"{what} (pass {n + 1}: T={T}, {int(args[6].sum())} "
             f"valid tasks, B={codes.shape[0]}, L={codes.shape[1]}, "
             f"max_out={M}, stack depth {args[10]})", r, reads)
    return r


def seed_strategy_launch(dev, card, args, batch="the batch", twin=False):
    """A pass-3 launch against the plain machine, with its bound: the
    inputs, the outputs (k, l and s at the positions' width; not the
    per-lane steps), 45 operations a step (the same occ step as passes
    1-2) and, with `twin`, the distinct 32-byte rows its twin reads, else
    64 bytes a step; one ext an iteration, so its rounds are its
    steps."""
    from bwa_mem_scale_tpu_torch.ops.smem_cuda import (
        seed_strategy_machine_cuda, seed_strategy_twin)
    from bwa_mem_scale_tpu_torch.ops.smem_oh import seed_strategy_machine
    args = args[:6]                            # without stats
    what = f"pass-3 launch, {batch}"
    got, r = walk_launch(dev, what, seed_strategy_machine_cuda,
                         seed_strategy_machine, args, 1)
    codes, M = args[1], args[5]
    B = codes.shape[0]
    pb = args[0].pos_dtype.itemsize
    nbytes = 4 * (codes.numel() + B) + (8 + 3 * pb) * B * M + 4 * B
    reads = f"{int(got.cnt.sum())} seeds, {r['steps']} steps (rounds)"
    if twin:
        r["rows"] = twin_rows(seed_strategy_machine_cuda, seed_strategy_twin,
                              args)
        nbytes += 32 * r["rows"]
        reads += f", {r['rows']} distinct 32-byte rows (the twin)"
    else:
        nbytes += SMEM_BYTES_PER_STEP * r["steps"]
    r["bound"] = bound(nbytes, SMEM_OPS_PER_STEP * r["steps"])
    log_walk(card, f"{what} (B={B}, L={codes.shape[1]}, max_intv="
             f"{args[3]}, min_seed_len={args[4]}, max_out={M})", r, reads)
    return r


def sal_launch(dev, card, args, batch="the batch"):
    """The batch's SA-walk launch against the plain walk, with its bound:
    a 32-byte row and 27 operations an iteration, except each valid
    lane's last, a sample of the positions' 4 or 8 bytes (a lane that
    ends on the sentinel row loads a row instead, which keeps this a
    lower bound); pos of the valid lanes (a prefix of the flat list),
    valid and the values once each, not the per-lane steps."""
    from bwa_mem_scale_tpu_torch.ops.sal import sa_lookup_plain
    from bwa_mem_scale_tpu_torch.ops.smem_cuda import sa_walk_cuda
    args = args[:3]                            # without stats
    what = f"SA-walk launch, {batch}"
    got, r = walk_launch(dev, what, sa_walk_cuda, sa_lookup_plain, args, 2)
    N, n_valid = got.numel(), int(args[2].sum())
    pb = args[0].pos_dtype.itemsize
    nbytes = (SAL_ROW_BYTES * (r["steps"] - n_valid) + pb * n_valid
              + pb * n_valid + (1 + pb) * N)
    r["bound"] = bound(nbytes, SAL_OPS_PER_STEP * r["steps"])
    log_walk(card, f"{what} (N={N} lanes, {n_valid} valid, sa_compx "
             f"{args[0].sa_compx})", r, f"{r['steps']} iterations")
    return r


def sal_stage_launch(dev, card, args, kw, batch="the batch"):
    """A call of the SA lookup stage's kernel pair (csrc/sal.cu), as made,
    against expand_and_lookup_plain on all five outputs, every slot, and
    on its per-lane steps; the bare walk (sal_launch) held against its
    plain version on the plain version's own list of walked rows (the
    flat list, or the [B, C] grid), whose count is the bound's walked
    slots (the two walks' per-lane steps are compared by
    tools/sal_before_after.py, not here); the bound: the SMEM records
    read once (cnt, s of every SMEM below its read's count, and k of
    every SMEM that owns a walked slot:
    a valid slot, on the flat path one among the list's first K), the
    five outputs written once (rbeg at the positions' 4 or 8 bytes, seed_idx 4 and
    coord_valid 1 a slot, total 4 and overflow 1 a read), a 32-byte row
    and SAL_OPS_PER_STEP operations a walk iteration but each walked
    slot's last, a sample (a lane that ends on the sentinel row loads a
    row instead, which keeps this a lower bound), SAL_OPS_PER_SLOT
    operations a slot and SAL_OPS_PER_SMEM an SMEM; the latency floor
    from the longest lane's rows; the pair's device time, the host wall of
    one synchronised call, and the plain version's. Returns the numbers,
    the bare walk's under "walk"."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import sal
    from bwa_mem_scale_tpu_torch.ops.sal_cuda import (expand_and_lookup_cuda,
                                                      flat_size)
    what = f"SA lookup stage (csrc/sal.cu), {batch}"
    got, r = walk_launch(dev, what, expand_and_lookup_cuda,
                         sal.expand_and_lookup_plain, args, 1, kw)
    steps = expand_and_lookup_cuda.last_steps.clone()
    walked = []
    real = sal.sa_lookup_plain
    sal.sa_lookup_plain = lambda *a, **k: walked.append(a[:3]) or real(*a,
                                                                       **k)
    try:
        sal.expand_and_lookup_plain(*args, **{k: v for k, v in kw.items()
                                              if k != "stats"})
    finally:
        sal.sa_lookup_plain = real
    fmi, pos, valid = walked[0]
    if fmi.sa_compx:
        r["walk"] = sal_launch(dev, card, (fmi, pos, valid), batch)
    r["wall_ms"] = time_ms(lambda: expand_and_lookup_cuda(
        *args, **{k: v for k, v in kw.items() if k != "stats"}), 20, dev)
    smems, C = args[1], args[3]
    rbeg, seed_idx, coord_valid, total, overflow = got
    B, M = smems.m.shape
    pb = rbeg.element_size()
    n_smem = int(smems.cnt.clamp(0, M).sum())
    n_walked = int(valid.sum())
    flat_k = args[4] if len(args) > 4 else kw.get("flat_k")
    K = flat_size(B, C, flat_k)
    walked_slots = coord_valid.clone()
    if B * C > K:                    # the flat list's first K entries
        first = total.long().cumsum(0) - total.long()
        walked_slots &= (first[:, None]
                         + torch.arange(C, device=dev)[None, :]) < K
    if int(walked_slots.sum()) != n_walked:
        raise SystemExit(f"slice: {what}: {int(walked_slots.sum())} walked "
                         f"slots by the flat list's rule, {n_walked} rows "
                         f"walked by the plain version")
    rows = torch.arange(B, device=dev)[:, None] * M + seed_idx.long()
    n_ksmem = int(torch.unique(rows[walked_slots]).numel())
    nbytes = (pb * n_smem + 4 * B + pb * n_ksmem
              + (pb + 5) * B * C + 5 * B
              + SAL_ROW_BYTES * (r["steps"] - n_walked) + pb * n_walked)
    r["bound"] = bound(nbytes, SAL_OPS_PER_STEP * r["steps"]
                       + SAL_OPS_PER_SLOT * B * C + SAL_OPS_PER_SMEM * n_smem)
    r.update(coords=int(total.sum()), walked=n_walked,
             lanes=int(steps.numel()), overflowed=int(overflow.sum()))
    log_walk(card, f"{what} (B={B}, M={M}, C={C}, {r['lanes']} lanes, "
             f"{n_walked} walked, {r['coords']} coordinates, "
             f"{r['overflowed']} reads overflowed, sa_compx {fmi.sa_compx}, "
             f"{rbeg.dtype}; a synchronised call's host wall "
             f"{r['wall_ms']:.5f} ms)", r, f"{r['steps']} iterations")
    return r


def chain_seeds_launch(dev, card, args, kw, batch="the batch"):
    """A chain_seeds launch as made, against the lockstep, with its bound:
    the coordinate prefix (rbeg, seed_idx, and coord_valid up to each
    read's first invalid entry), the SMEM rows it names (m, n), the
    contig offsets, and every output once, the [4, B, C, S] seed planes
    included (rbeg, its plane and the keys at the positions' 4 or 8
    bytes; not the per-read steps and rounds), against
    CHAIN_OPS_PER_COORD a coordinate; latency floor: the longest read's
    rounds x the measured cost of a round (tools/round_cost.py)."""
    import torch
    from bwa_mem_scale_tpu_torch.ops.chain import chain_seeds_device
    from bwa_mem_scale_tpu_torch.ops.chain_cuda import chain_seeds_cuda
    from bwa_mem_scale_tpu_torch.tools.round_cost import round_us
    per_round = round_us(dev)
    got, r = walk_launch(dev, "chain_seeds launch", chain_seeds_cuda,
                         chain_seeds_device, args, 2, kw)
    bns, smems, rbeg, seed_idx, coord_valid = args
    (B, NC), M = rbeg.shape, smems.m.shape[1]
    C, S = got.seed_qbeg.shape[1:]
    total = coord_valid.sum(1)
    rows = torch.arange(B, device=dev)[:, None] * M + seed_idx.long()
    n_rows = int(torch.unique(rows[coord_valid]).numel())
    n_coord = int(total.sum())
    n_ended = int((total < NC).sum())     # reads whose walk reads a false
    pb = rbeg.element_size()
    nbytes = ((5 + pb) * n_coord + n_ended + 8 * n_rows
              + 8 * bns.offsets.numel() + (12 + pb) * B * C
              + (12 + pb) * B * C * S + 5 * B)
    r["bound"] = bound(nbytes, CHAIN_OPS_PER_COORD * n_coord)
    r["floor"] = r["longest_rounds"] * per_round * 1e-3
    r.update(coords=n_coord, chains=int(got.n.sum()),
             max_chains=int(got.n.max()), overflowed=int(got.overflow.sum()))
    log(f"[slice] chain_seeds launch, {batch} (B={B}, NC={NC}, C={C}, "
        f"S={S}): equal to the plain version, each field (max_abs_err "
        f"{r['err']}); {n_coord} coordinates, the longest read "
        f"{r['longest']}, {r['rounds']} rounds (the longest read "
        f"{r['longest_rounds']}), {r['chains']} chains (at most "
        f"{r['max_chains']} a read), {r['overflowed']} reads overflowed; "
        f"bound {r['bound'][0]:.6f} ms by {r['bound'][1]}, latency floor "
        f"{r['floor']:.5f} ms ({r['longest_rounds']} x "
        f"{per_round:.5f} us); kernel device time {r['ms']:.5f} ms "
        f"(a wrapper call, its output allocation included; mean of 2), "
        f"plain {r['plain_ms']:.2f} ms  [{card}]")
    return r


def chain_filter_launch(dev, card, args, kw, batch="the batch"):
    """A chain_filter launch as made, against chain_filter_frac_rep, with
    its bound: the chain count, the live slots' rid and seed count, their
    seeds (qbeg, rbeg, len; rbeg at the positions' 4 or 8 bytes), the
    is_alt entries of their contigs, the frac_rep scan's reads (s of
    every SMEM at the positions' width, m and n of those over max_occ),
    cnt, lens, and the outputs (order, kept, w_by_slot, frac_rep); operations FLT_OPS_PER_* a seed, overlap test, SMEM and
    SMEM over max_occ; latency floor: the longest read's rounds x
    the measured cost of a round (tools/round_cost.py)."""
    import torch
    from bwa_mem_scale_tpu_torch.ops.chain import chain_filter_frac_rep
    from bwa_mem_scale_tpu_torch.ops.chain_cuda import chain_filter_cuda
    from bwa_mem_scale_tpu_torch.tools.round_cost import round_us
    per_round = round_us(dev)
    got, r = walk_launch(dev, "chain_filter launch", chain_filter_cuda,
                         chain_filter_frac_rep, args, 2, kw)
    ch, bns, smems, lens = args
    B, C, S = ch.seed_qbeg.shape
    M = smems.m.shape[1]
    live = torch.arange(C, device=dev)[None, :] < ch.n.long()[:, None]
    n_live = int(live.sum())
    n_seeds = int(ch.n_seeds[live].sum())
    rids = ch.rid[live]
    n_alt = int(torch.unique(rids[rids >= 0]).numel())
    scanned = (torch.arange(M, device=dev)[None, :]
               < smems.cnt.long()[:, None])
    n_smem = int(scanned.sum())
    n_rep = int((scanned & (smems.s > kw["max_occ"])).sum())
    tests = r["steps"] - n_live
    pb = ch.seed_rbeg.element_size()
    nbytes = (4 * B + 8 * n_live + (8 + pb) * n_seeds + n_alt + pb * n_smem
              + 8 * n_rep + 8 * B + 12 * B * C + 4 * B)
    r["bound"] = bound(nbytes, FLT_OPS_PER_SEED * n_seeds
                       + FLT_OPS_PER_TEST * tests + FLT_OPS_PER_SMEM * n_smem
                       + FLT_OPS_PER_REP * n_rep)
    kept = got[1]
    r["floor"] = r["longest_rounds"] * per_round * 1e-3
    r.update(tests=tests, kept={k: int(((kept == k) & live).sum())
                                for k in range(4)},
             rep_reads=int((got[3] > 0).sum()))
    log(f"[slice] chain_filter launch, {batch} (B={B}, C={C}, S={S}, "
        f"M={M}): equal to the plain version, each output (max_abs_err "
        f"{r['err']}); {n_live} live chains of {n_seeds} seeds, {tests} "
        f"overlap tests, kept 3/2/1/0: {r['kept'][3]}/{r['kept'][2]}/"
        f"{r['kept'][1]}/{r['kept'][0]}, {n_smem} SMEMs scanned ({n_rep} "
        f"over max_occ; {r['rep_reads']} reads with frac_rep > 0), the "
        f"longest read {r['longest']} steps, {r['rounds']} rounds (the "
        f"longest read {r['longest_rounds']}); bound {r['bound'][0]:.6f} "
        f"ms by {r['bound'][1]}, latency floor {r['floor']:.5f} ms "
        f"({r['longest_rounds']} x {per_round:.5f} us); kernel device "
        f"time {r['ms']:.5f} ms (mean of 2), plain {r['plain_ms']:.2f} ms  "
        f"[{card}]")
    return r


def repeat_slice(dev, card, al):
    """Phase 5 on a batch whose reads have many chains and deep interval
    stacks (tools/batches.py::repeat_batch): seed_chain_extend at the
    main path's shapes with the kernels and with the plain chaining,
    packed and meta equal; its two SMEM passes 1-2 launches and its
    pass-3 launch, as made, each equal to its plain version with its
    steps, rounds, bound, latency floor and times; its SA lookup stage
    call (sal_stage_launch) and its two chaining launches the same way; the filter again at options that cut and drop
    chains (min_chain_weight 20, mask_level 0.3, drop_ratio 0.3,
    max_chain_extend 2), equal to its plain version. Fails unless the
    batch reaches the filter's overlap, drop and first paths, a
    repetitive SMEM and a chain overflow. Returns the launches'
    numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import chain, sal, smem_oh
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    t0 = time.perf_counter()
    idx, codes, lens = repeat_batch(BATCH, READ_LEN)
    fmi = DeviceFMIndex.from_host(idx, dev)
    dbns = chain.DeviceBns.from_host(idx.bns, dev)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    real = {(align, "chain_seeds_cuda"): align.chain_seeds_cuda,
            (align, "chain_filter_cuda"): align.chain_filter_cuda,
            (smem_oh, "one_pos_machine_cuda"): smem_oh.one_pos_machine_cuda,
            (smem_oh, "seed_strategy_machine_cuda"):
                smem_oh.seed_strategy_machine_cuda,
            (sal, "expand_and_lookup_cuda"): sal.expand_and_lookup_cuda}
    calls = {name: [] for _, name in real}

    def recorder(name, fn):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return record

    outs = []
    for swaps in ({k: recorder(k[1], fn) for k, fn in real.items()},
                  {(align, "chain_seeds_cuda"): chain.chain_seeds_device,
                   (align, "chain_filter_cuda"): chain.chain_filter_frac_rep}):
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        try:
            with (ext_recorded() if not outs
                  else contextlib.nullcontext()) as made:
                outs.append(align.seed_chain_extend(
                    fmi, dbns, c, ln, READ_LEN, opt=al.opt, cfg=al.cfg))
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)
        if len(outs) == 1:
            ext_made = made
    for key in ("packed", "meta"):
        if not torch.equal(outs[0][key], outs[1][key]):
            raise SystemExit(f"slice: repeat batch {key} differs kernel vs "
                             f"plain chaining")
    hold_ext(ext_made, "repeat batch", card)
    log(f"[slice] repeat batch ({len(codes)} reads on a 2 Mbp genome with "
        f"repeats; made, indexed and seeded in "
        f"{time.perf_counter() - t0:.1f} s): seed_chain_extend packed and "
        f"meta equal with the kernels and with the plain chaining")
    want = {"chain_seeds_cuda": 1, "chain_filter_cuda": 1,
            "one_pos_machine_cuda": 2, "seed_strategy_machine_cuda": 1,
            "expand_and_lookup_cuda": 1}
    if any(len(calls[k]) != n for k, n in want.items()):
        raise SystemExit(f"slice: repeat batch calls "
                         f"{ {k: len(v) for k, v in calls.items()} }")
    smem = [smem_launch(dev, card, n, args, batch="repeat batch")
            for n, (args, _) in enumerate(calls["one_pos_machine_cuda"])]
    p3 = seed_strategy_launch(dev, card,
                              calls["seed_strategy_machine_cuda"][0][0],
                              batch="repeat batch")
    sal_stage_launch(dev, card, *calls["expand_and_lookup_cuda"][0],
                     batch="repeat batch")
    seeds = chain_seeds_launch(dev, card, *calls["chain_seeds_cuda"][0],
                               batch="repeat batch")
    flt = chain_filter_launch(dev, card, *calls["chain_filter_cuda"][0],
                              batch="repeat batch")
    tier_against_plain(fmi, c, ln, al.opt, 24, 2, dev, card, "repeat batch")
    (ch, *rest), kw = calls["chain_filter_cuda"][0]
    kw = dict(kw, stats=None, min_chain_weight=20, mask_level=0.3,
              drop_ratio=0.3, max_chain_extend=2)
    got = real[(align, "chain_filter_cuda")](ch, *rest, **kw)
    want = chain.chain_filter_frac_rep(ch, *rest, **kw)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a, b)]
    if bad:
        raise SystemExit(f"slice: repeat batch chain_filter at "
                         f"non-default options != plain in outputs {bad}")
    kept = got[1]
    log(f"[slice] chain_filter launch, repeat batch, min_chain_weight 20, "
        f"mask_level 0.3, drop_ratio 0.3, max_chain_extend 2: equal to the "
        f"plain version, each output; kept 3/2/1: {int((kept == 3).sum())}/"
        f"{int((kept == 2).sum())}/{int((kept == 1).sum())}, "
        f"{int((kept[:, 0] == 0).sum())} reads with none  [{card}]")
    if not (flt["tests"] > 0 and flt["kept"][0] and flt["kept"][1]
            and flt["kept"][2] and flt["rep_reads"] and seeds["overflowed"]
            and seeds["max_chains"] >= 3):
        raise SystemExit(f"slice: the repeat batch misses a path of the "
                         f"chaining kernels: {seeds}, {flt}")
    return smem, p3, seeds, flt


# the one-hot stage's glue kernels (csrc/smem_glue.cu): the name in the
# JSON line, the wrapper's name in ops/smem_cuda.py, the JAX glue each
# replaces
GLUE_KERNELS = (
    ("reseed_tasks", "reseed_tasks_cuda",
     "bwa_mem_scale_tpu/ops/smem_oh.py:772"),
    ("merge_smems", "merge_smems_cuda",
     "bwa_mem_scale_tpu/ops/smem_oh.py:794"))
# each glue kernel's largest max_abs_err over every launch held
GLUE_ERR = {name: 0.0 for name, _, _ in GLUE_KERNELS}


def glue_plain():
    """{glue wrapper's name: its plain version (the same signature)}."""
    from bwa_mem_scale_tpu_torch.ops.smem import (merge_smems_plain,
                                                  reseed_task_list)
    return {"reseed_tasks_cuda": reseed_task_list,
            "merge_smems_cuda": merge_smems_plain}


def glue_calls(run, mods):
    """run() with the glue wrappers recorded where each module of `mods`
    calls them: (run's result, [(wrapper's name, args, output)] in call
    order)."""
    from bwa_mem_scale_tpu_torch.ops import smem_cuda
    real = {attr: getattr(smem_cuda, attr) for _, attr, _ in GLUE_KERNELS}
    made = []

    def recorder(attr):
        def record(*args):
            out = real[attr](*args)
            made.append((attr, args, out))
            return out
        return record
    saved = [(mod, attr, getattr(mod, attr)) for mod in mods for attr in real]
    for mod, attr, _ in saved:
        setattr(mod, attr, recorder(attr))
    try:
        result = run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return result, made


@contextlib.contextmanager
def plain_glue(mod):
    """mod's glue wrappers replaced by their plain versions."""
    saved = {attr: getattr(mod, attr) for attr in glue_plain()}
    for attr, fn in glue_plain().items():
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(mod, attr, fn)


def glue_work(attr, args):
    """(bytes, integer operations) the glue function needs on these
    inputs, each input read once and each output written once. The task
    list: each read's count and its live slots' m, n and s; the tasks
    (three int32 and a flag) and each read's flag, first task and count;
    8 operations a live slot (the candidate tests, the midpoint) and 24 a
    read (its share of the scans). The merge: pass 1's and pass 3's whole
    rows and counts (every slot is copied), pass 2's kept entries and its
    valid tasks' counts, the spans and flags, the output rows and counts;
    3 operations a comparison of the rank (V^2 for V valid entries) and 4
    a slot written."""
    import torch
    if attr == "reseed_tasks_cuda":
        p1, T = args[:2]
        B, M = p1.m.shape
        live = int(p1.cnt.clamp(0, M).sum())
        return (4 * B + (8 + p1.s.element_size()) * live + 13 * T + 9 * B,
                8 * live + 24 * B)
    p1, p2t, p3, t_read, t_valid, _, _, _, _ = args
    B, M = p1.m.shape
    parts = 2 if p3 is None else 3
    slot = 8 + 3 * p1.k.element_size()
    c2 = torch.zeros((B,), dtype=torch.int64, device=p1.m.device)
    c2 = c2.index_add_(0, t_read.long()[t_valid],
                       p2t.cnt.clamp(0, M)[t_valid].long()).clamp(max=M)
    v = p1.cnt.clamp(0, M) + c2
    if p3 is not None:
        v = v + p3.cnt.clamp(0, M)
    nbytes = ((parts - 1) * (slot * B * M + 4 * B) + slot * int(c2.sum())
              + 4 * int(t_valid.sum()) + 9 * B + slot * B * parts * M
              + 4 * B)
    return nbytes, int((3 * v.long() ** 2).sum()) + 4 * B * parts * M


def glue_launch(dev, card, what, attr, args, got=None):
    """One glue launch as made (`got` its output; None: launched here)
    against its plain version on the same inputs: every output equal
    (max_abs_err 0; the task list's int32 fields against the plain
    version's int64 read and position-typed minimum interval), with its
    bound (glue_work), its launch floor (the same kernel on the batch's
    first read alone: a launch and one read's work, measured), its device
    time (mean of 2, around the plain version's) and the plain version's
    time. Returns the numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem_cuda
    from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf
    kernel, plain = getattr(smem_cuda, attr), glue_plain()[attr]
    if got is None:
        got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    pairs = list(zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in pairs)
    if err or not all(torch.equal(a.to(b.dtype), b) for a, b in pairs):
        raise SystemExit(f"glue: {what}: {attr} != plain (max_abs_err "
                         f"{err})")
    name = next(n for n, a, _ in GLUE_KERNELS if a == attr)
    GLUE_ERR[name] = max(GLUE_ERR[name], err)
    head = lambda b: SmemBuf(*(f[:1] for f in b))
    if attr == "reseed_tasks_cuda":
        one = (head(args[0]), 2, *args[2:])
    else:
        p1, p2t, p3, t_read, t_valid, first, count, of, pass_of = args
        n = int(count[0])                  # the first read's tasks: 0 .. n-1
        one = (head(p1), SmemBuf(*(f[:n] for f in p2t)),
               None if p3 is None else head(p3), t_read[:n], t_valid[:n],
               first[:1], count[:1], of[:1], pass_of)
    ms = [device_ms(lambda: kernel(*args), 20, dev)]
    plain_ms = time_ms(lambda: plain(*args), 2, dev)
    ms.append(device_ms(lambda: kernel(*args), 20, dev))
    floor = device_ms(lambda: kernel(*one), 20, dev)
    nbytes, ops = glue_work(attr, args)
    r = dict(err=err, ms=sum(ms) / 2, plain_ms=plain_ms, floor=floor,
             bound=bound(nbytes, ops), bytes=nbytes, ops=ops)
    B, M = args[0].m.shape
    log(f"[glue] {what}, {name} (B={B}, M={M}"
        + (f", T={args[1]}" if name == "reseed_tasks" else
           f", W={got.m.shape[1]}, pass overflow {bool(args[8])}")
        + f"): equal to the plain version (max_abs_err {err}); bound "
        f"{r['bound'][0]:.6f} ms by {r['bound'][1]} ({nbytes} bytes, {ops} "
        f"operations), launch floor {floor:.5f} ms (the first read alone); "
        f"kernel device time {r['ms']:.5f} ms (mean of 2), plain "
        f"{plain_ms:.3f} ms  [{card}]")
    return r

# the extension stage's kernels (csrc/extend.cu): the name in the JSON
# line, the wrapper's name in ops/extend_cuda.py (pipeline/align.py calls
# it by that name), the JAX lines each replaces
EXT_KERNELS = (
    ("ext_select", "ext_select_cuda",
     "bwa_mem_scale_tpu/pipeline/align.py:202"),
    ("ext_pairs", "ext_pairs_cuda",
     "bwa_mem_scale_tpu/pipeline/align.py:331"),
    ("ext_stage", "ext_stage_cuda",
     "bwa_mem_scale_tpu/pipeline/align.py:359"),
    ("ext_bsw_band", "ext_bsw_band_cuda",
     "bwa_mem_scale_tpu/pipeline/align.py:410"))
# each extension kernel's largest max_abs_err over every launch held
EXT_ERR = {name: 0.0 for name, _, _ in EXT_KERNELS}


@contextlib.contextmanager
def ext_recorded():
    """align's extension wrappers recording each launch as the path makes
    it: yields [(wrapper's name, positional arguments, output, mesh
    shard)]."""
    import inspect
    import threading
    from bwa_mem_scale_tpu_torch.ops import extend_cuda
    from bwa_mem_scale_tpu_torch.parallel.mesh import current_shard
    from bwa_mem_scale_tpu_torch.pipeline import align
    made, lock = [], threading.Lock()
    real = {a: getattr(align, a) for _, a, _ in EXT_KERNELS}

    def recorder(a):
        sig = inspect.signature(getattr(extend_cuda, a))

        def call(*args, **kw):
            out = real[a](*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.arguments.pop("stats", None)   # the run's, not the launch's
            with lock:
                made.append((a, bound.args, out, current_shard()))
            return out
        return call
    for a in real:
        setattr(align, a, recorder(a))
    try:
        yield made
    finally:
        for a, fn in real.items():
            setattr(align, a, fn)


def ext_fresh_flag(attr, args):
    """args with the pairs' BSW length flag cloned (the stage and the band
    phases OR into it in place)."""
    args = list(args)
    i = {"ext_stage_cuda": 0, "ext_bsw_band_cuda": 2}.get(attr)
    if i is not None:
        args[i] = args[i]._replace(flag=args[i].flag.clone())
    return args


def ext_err(got, want):
    """(max_abs_err, every output equal in dtype, shape and value) of two
    outputs of an extension kernel (a tensor or nested tuples of them)."""
    flat = lambda x: ([t for v in x for t in flat(v)]
                      if isinstance(x, tuple) else [x])
    got, want = flat(got), flat(want)
    err, same = 0.0, len(got) == len(want)
    for a, b in zip(got, want):
        same = same and a.dtype == b.dtype and a.shape == b.shape
        if same and a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err, same


def hold_ext(made, what, card):
    """Each recorded extension launch (ext_recorded) against its plain
    version on the same inputs: every output at max_abs_err 0, or
    SystemExit. Returns {kernel name: launches held}."""
    import collections
    import torch
    from bwa_mem_scale_tpu_torch.ops import extend
    held = collections.Counter()
    for attr, args, out, _ in made:
        name = attr[:-len("_cuda")]
        want = getattr(extend, name)(*ext_fresh_flag(attr, args))
        err, same = ext_err(out, want)
        if err or not same:
            raise SystemExit(f"ext: {what}: a {name} launch != plain "
                             f"(max_abs_err {err}, dtypes and shapes "
                             f"{'equal' if same else 'differ'})")
        EXT_ERR[name] = max(EXT_ERR[name], err)
        held[name] += 1
    torch.cuda.synchronize()
    log(f"[ext] {what}: {sum(held.values())} extension launches as made, "
        f"each equal to its plain version (max_abs_err 0): {dict(held)}  "
        f"[{card}]")
    return held


def hold_route(al, codes, lens, what, card):
    """The extension launches of one batch of `al`'s route (its engine,
    position layout and mesh), made after the route's timed run, which
    keeps only the wrappers' counts: the batch's device stages once more
    (GpuAligner._device_step: no count, stat or batch of the aligner
    moves), each extension launch recorded and held against its plain
    version (hold_ext), on a mesh shard by shard."""
    import torch
    from bwa_mem_scale_tpu_torch.ops.extend import raise_len_flag
    codes = np.ascontiguousarray(codes[:BATCH], dtype=np.int32)
    lens = np.ascontiguousarray(lens[:BATCH], dtype=np.int32)
    L = int(codes.shape[1])
    with ext_recorded() as made:
        _, out = al._device_step(al._extend, codes, lens, L,
                                 probe=al._probes_on_device(L))
        torch.cuda.synchronize()
    raise_len_flag(out)
    if al.mesh is None:
        return hold_ext(made, what, card)
    for sh in range(al.mesh.size):
        mine = [m for m in made if m[3] == sh]
        if not mine:
            raise SystemExit(f"ext: {what}: shard {sh} made no extension "
                             f"launch")
        hold_ext(mine, f"{what}, shard {sh}", card)


def ext_time(made, dev, card, what):
    """Each extension kernel's launches of one seed_chain_extend call as
    made, timed alone (device ms, mean over its launches: the fused BSW
    round's four phases), beside its plain version (host clock, synchronised), its
    bound (tools/extend_before_after.py::ext_work: each distinct input
    byte read once, each output written once, the work these inputs need) and its launch
    floor (the kernel on one read or one pair). Returns {name: numbers}."""
    from bwa_mem_scale_tpu_torch.ops import extend, extend_cuda
    from bwa_mem_scale_tpu_torch.tools.extend_before_after import (
        ext_work, one_item)
    res = {}
    for name, attr, _ in EXT_KERNELS:
        calls = [args for a, args, _, _ in made if a == attr]
        k, p = getattr(extend_cuda, attr), getattr(extend, name)
        ms = [device_ms(lambda a=a: k(*a), 20, dev) for a in calls]
        plain = [time_ms(lambda a=a: p(*ext_fresh_flag(attr, a)), 2, dev)
                 for a in calls]
        ones = [one_item(attr, a) for a in calls]
        floor = [device_ms(lambda a=a: k(*a), 20, dev) for a in ones]
        work = [ext_work(attr, a) for a in calls]
        nbytes = sum(w[0] for w in work) / len(work)
        ops = sum(w[1] for w in work) / len(work)
        mean = lambda x: sum(x) / len(x)
        r = res[name] = dict(ms=mean(ms), plain_ms=mean(plain),
                             floor=mean(floor), bound=bound(nbytes, ops),
                             launches=len(calls))
        log(f"[ext] {what}, {name}: {len(calls)} launch"
            f"{'es' if len(calls) > 1 else ''} a call; kernel device time "
            f"{r['ms']:.5f} ms a launch ("
            + ", ".join(f"{x:.5f}" for x in ms)
            + f"), plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound'][0]:.6f} ms by {r['bound'][1]} ({nbytes:.0f} bytes,"
            f" {ops:.0f} operations), launch floor {r['floor']:.5f} ms (one "
            f"{'read' if name in ('ext_select', 'ext_pairs') else 'pair'})  "
            f"[{card}]")
    return res


def ext_whole(dev, card, al, c, ln):
    """Phase 5's batch: the extension alone (align.extend_chains, from the
    chain filter's outputs to the dict) timed on the card (device ms and
    a synchronised call's host wall), run once more under
    torch.cuda.set_sync_debug_mode("error") (no host synchronisation), and
    the BSW length check raising through fetch_extend on targets shorter
    than their lengths (target_pad set so that TL is 8)."""
    import dataclasses
    import torch
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.tools.timing import wall_ms
    real, seen = align.extend_chains, []
    align.extend_chains = lambda *a, **k: seen.append((a, k)) or real(*a,
                                                                      **k)
    try:
        want = align.seed_chain_extend(al.fmi, al.dbns, c, ln, READ_LEN,
                                       opt=al.opt, cfg=al.cfg)
    finally:
        align.extend_chains = real
    (a, k), = seen
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = real(*a, **k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    bad = [key for key, v in want.items() if not torch.equal(got[key], v)]
    if bad:
        raise SystemExit(f"ext: the extension under the sync debug mode "
                         f"differs in {bad}")
    ms = device_ms(lambda: real(*a, **k), 20, dev)
    wall = wall_ms(lambda: real(*a, **k))
    short = dataclasses.replace(al.cfg,
                                target_pad=8 - READ_LEN - 2 * al.opt.w)
    out = align.seed_chain_extend(al.fmi, al.dbns, c, ln, READ_LEN,
                                  opt=al.opt, cfg=short)
    try:
        al.fetch_extend((c.cpu().numpy(), ln.cpu().numpy(), None, out))
    except ValueError as e:
        if "exceeds its row count" not in str(e):
            raise
    else:
        raise SystemExit("ext: an over-long BSW length did not raise")
    log(f"[ext] phase 5's batch: the extension alone (extend_chains: "
        f"seven launches) {ms:.5f} ms device, {wall:.5f} ms host wall of a "
        f"synchronised call; no host synchronisation under "
        f"set_sync_debug_mode('error'); an over-long BSW length (TL 8) "
        f"raised through fetch_extend with the check's message  [{card}]")
    return dict(ms=ms, wall=wall)


def ext_tiers(dev, card, al, c, ln):
    """seed_chain_extend on phase 5's batch at the retry tiers'
    capacities (tier 1 on its first 64 reads, tier 2 on its first 8:
    align.tier_config, as GpuAligner sizes them), each extension launch
    held against its plain version."""
    from bwa_mem_scale_tpu_torch.pipeline import align
    t1 = align.tier_config(al.cfg, 1, 64)
    for tier, n, cfg in ((1, 64, t1), (2, 8, align.tier_config(t1, 2, 8))):
        with ext_recorded() as made:
            align.seed_chain_extend(al.fmi, al.dbns, c[:n], ln[:n], READ_LEN,
                                    opt=al.opt, cfg=cfg)
        hold_ext(made, f"phase 5's batch at tier {tier} ({n} reads, C "
                 f"{cfg.max_chains}, S {cfg.max_seeds_per_chain}, R "
                 f"{cfg.max_regs}, PX {cfg.max_pairs})", card)


def tier_against_plain(fmi, c, ln, opt, depth, rf, dev, card, batch):
    """collect_smems_oh at a retry tier's depth (24, 48 or None) and
    reseed factor with the kernels and with the plain passes 1-3 and the
    plain glue swapped in: the kernels' SmemBuf equal to the plain one,
    the task list and the merge launched once each, each held as made
    against its plain version (glue_launch). Returns (the SmemBuf,
    {glue wrapper's name: numbers}), or SystemExit."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem_oh
    tier = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
                emit_depth=depth, stack_depth=depth, reseed_factor=rf)
    got, made = glue_calls(
        lambda: smem_oh.collect_smems_oh(fmi, c, ln, **tier), [smem_oh])
    plain = {"one_pos_machine_cuda": smem_oh.one_pos_machine,
             "seed_strategy_machine_cuda": smem_oh.seed_strategy_machine,
             **glue_plain()}
    real = {n: getattr(smem_oh, n) for n in plain}
    for n, fn in plain.items():
        setattr(smem_oh, n, fn)
    try:
        want = smem_oh.collect_smems_oh(fmi, c, ln, **tier)
    finally:
        for n, fn in real.items():
            setattr(smem_oh, n, fn)
    torch.cuda.synchronize()
    bad = [f for f, a, b in zip(got._fields, got, want)
           if not torch.equal(a, b)]
    if bad:
        raise SystemExit(f"slice: collect_smems_oh at depth {depth} "
                         f"differs kernels vs plain: {bad}")
    if [a for a, _, _ in made] != ["reseed_tasks_cuda", "merge_smems_cuda"]:
        raise SystemExit(f"slice: collect_smems_oh at depth {depth} made "
                         f"the glue launches {[a for a, _, _ in made]}")
    return got, {attr: glue_launch(dev, card, f"{batch}, depth {depth}, "
                                   f"reseed factor {rf}", attr, args, out)
                 for attr, args, out in made}


def smem_tiers(dev, card, al, c, ln):
    """collect_smems_oh at the retry tiers' depths with the kernels and
    with the plain passes 1-3 and glue swapped in: SmemBuf equal, each
    glue launch held; on each tier's SMEMs the SA lookup stage at the
    tier's coordinate capacity (512, 1,024, 16,384) against its plain
    version (sal_stage_launch). (The whole collection's time, with the
    parent's in turns, is tools/smem_before_after.py --stage's.)"""
    opt = al.opt
    for depth, rf, coords in ((24, 2, 512), (48, 8, 1024),
                              (None, 256, 16384)):
        got, _ = tier_against_plain(al.fmi, c, ln, opt, depth, rf, dev,
                                    card, "phase 5's batch")
        log(f"[slice] collect_smems_oh at depth {depth}, reseed factor "
            f"{rf}: SmemBuf equal kernels vs plain passes 1-3 and glue "
            f"({int(got.cnt.clamp(max=got.m.shape[1]).sum())} SMEMs)")
        sal_stage_launch(dev, card, (al.fmi, got, opt.max_occ, coords), {},
                         batch=f"the batch at the tier of depth {depth}")


def write_pairs(tmp, bns):
    """FR pairs as tests/test_pe.py simulates them: read 1 forward at the
    fragment's start, read 2 the reverse complement of its end. Writes
    r1.fq and r2.fq (mates named p<i>); returns the interleaved codes
    [2N, L], lens, true leftmost positions and strands."""
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
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
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.perfect import (
        emf_lookup_host, load_perfect_table)
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    from bwa_mem_scale_tpu_torch.ops.emf import FW_MATCHED, RC_MATCHED
    g, sam = os.path.join(tmp, "g"), os.path.join(tmp, "pe.sam")
    idx = load_index(g)
    codes, lens, pos, is_rev = write_pairs(tmp, idx.bns)
    PROFILER.totals.clear()
    PROFILER.counts.clear()

    wrappers = main_path_wrappers()
    pe_argv = [g, os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq"),
               "-o", sam, "--device", "cuda", "--batch-reads", str(BATCH)]
    for w in wrappers.values():                 # PE path starts here
        w.launches = 0
    t0 = time.perf_counter()
    al = cli.mem(pe_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    # PE path ends here

    pt = load_perfect_table(g + ".emf101.npz")
    code = emf_lookup_host(pt, idx.ref_string, codes, lens)["code"]
    emf_hit = (code == FW_MATCHED) | (code == RC_MATCHED)
    check_pe_sam(sam, emf_hit, pos, is_rev)
    if launches["banded_swa_batch"] <= 0:
        raise SystemExit("pe: the BSW kernel was never launched")
    for name in ("one_pos_machine", "seed_strategy_machine",
                 "expand_and_lookup", "chain_seeds", "chain_filter",
                 "reseed_tasks", "merge_smems"):
        if launches[name] < al.batches:
            raise SystemExit(f"pe: the {name} kernel launched "
                             f"{launches[name]} times over {al.batches} "
                             f"device batches, fewer than one a batch")
    if launches["sa_walk"]:
        raise SystemExit(f"pe: the bare SA walk launched "
                         f"{launches['sa_walk']} times on the PE path")
    ext_launch_check("pe", launches, al.batches)
    hold_route(al, codes, lens, "phase 7's PE route (one batch of mates)",
               card)
    n = 2 * N_PAIRS
    sec = PROFILER.totals
    log(f"[pe] {n} reads ({N_PAIRS} pairs) in {wall:.2f} s = "
        f"{n / wall:.1f} reads/s end to end (mem call incl. index load)  "
        f"[{card}]")
    log(f"[pe] kernel launches {launches}; EMF hits {al.emf_hits}/"
        f"{al.emf_checked}; overflow-retried reads {al.overflow_retried}; "
        f"device batches {al.batches}")
    log(f"[pe] seconds: device stages (dispatch_extend, host clock) "
        f"{sec['dispatch_extend']:.3f}, fetch {sec['fetch_pack']:.3f}, "
        f"host PE stage native_pe_c {sec['native_pe_c']:.3f} (pe_rows "
        f"{sec['pe_rows']:.3f}), EMF probe {sec['emf_probe_host']:.3f}, "
        f"SAM write {sec['sam_write']:.3f}, index load "
        f"{sec['index_load']:.3f}  [{card}]")
    al4 = cli.mem(pe_argv + ["-v", "4"])
    sec = al4.prof.seconds
    log(f"[pe -v 4] synchronised stage seconds over {al4.batches} batches:"
        f" seed {sec['seed']:.3f}, sal {sec['sal']:.3f}, chain "
        f"{sec['chain']:.3f}, bsw {sec['bsw']:.3f}  [{card}]")
    return launches, dict(argv=pe_argv, wall=wall, emf_hit=emf_hit, pos=pos,
                          is_rev=is_rev, codes=codes, lens=lens)


# the int64 forms of the FM-walk and chaining kernels (phase 8): name,
# source, and the JAX loop each replaces at pos_dtype int64
INT64_FORMS = (
    ("one_pos_machine", "csrc/smem.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:174"),
    ("seed_strategy_machine", "csrc/smem.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:619"),
    ("expand_and_lookup", "csrc/sal.cu", "bwa_mem_scale_tpu/ops/sal.py:23"),
    ("chain_seeds", "csrc/chain.cu", "bwa_mem_scale_tpu/ops/chain.py:78"),
    ("chain_filter", "csrc/chain.cu", "bwa_mem_scale_tpu/ops/chain.py:299"),
    ("reseed_tasks", "csrc/smem_glue.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:772"),
    ("merge_smems", "csrc/smem_glue.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:794"))
# hg38 for the memory reckoning: 3.1e9 forward bases (GRCh38's primary
# assembly), the index's SA sampled 1 in 2^3 (`index`'s default sa_compx)
HG38_L_PAC = 3_100_000_000
HG38_SA_COMPX = 3


@contextlib.contextmanager
def forced_int64():
    """DeviceFMIndex.from_host takes the int64 layout (force_int64) for
    every caller, the CLI's GpuAligner included, as the tests force it."""
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    real = DeviceFMIndex.__dict__["from_host"]
    DeviceFMIndex.from_host = classmethod(
        lambda cls, idx, device, force_int64=False, cp2=None:
        real.__func__(cls, idx, device, True, cp2))
    try:
        yield
    finally:
        DeviceFMIndex.from_host = real


def big_index(tmp, prefix):
    """A copy of the index at `prefix` whose seq_len alone passes int32
    (2^31), beside a link to its EMF table: its positions take the int64
    layout by the index's own count, and `mem` keeps that layout in
    big.devlayout3.npz. Returns the copy's prefix."""
    big = os.path.join(tmp, "big")
    z = np.load(prefix + ".tpuidx.npz")
    arrs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrs["meta"]).decode())
    meta["seq_len"] = 1 << 31
    arrs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(big + ".tpuidx.npz", **arrs)
    os.symlink(prefix + f".emf{READ_LEN}.npz", big + f".emf{READ_LEN}.npz")
    return big


def same_fmi(a, b):
    """Two DeviceFMIndex objects equal field for field (tensors in dtype,
    shape and value)."""
    import dataclasses
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if (x is None or y is None or x.dtype != y.dtype
                    or x.shape != y.shape or not torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def sam_body(path):
    """A SAM file's lines but its @PG line."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def phase_cache(dev, card, tmp, se, wrappers):
    """Phase 8's device-layout cache: `mem` on big_index's copy of phase
    4's index cold (the cache written) and warm (read), each SAM body
    byte-equal to phase 4's, each int64 form launched every batch; each
    run's index load beside from_host(force_int64=True)'s; the warm
    layout equal to from_host(force_int64=True) on the card."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    big = big_index(tmp, se["argv"][0])
    cache = big + ".devlayout3.npz"
    body4 = sam_body(se["argv"][3])
    loads, walls = {}, {}
    for run in ("cold", "warm"):
        if (run == "cold") == os.path.exists(cache):
            raise SystemExit(f"int64 cache: {run} run, the cache "
                             f"{'present' if run == 'cold' else 'missing'}")
        out = os.path.join(tmp, f"big_{run}.sam")
        PROFILER.totals.clear()
        for w in wrappers.values():             # the cached path starts here
            w.launches = w.launches64 = 0
        t0 = time.perf_counter()
        al = cli.mem([big, se["argv"][1], "-o", out, *se["argv"][4:]])
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        launches = {n: w.launches64 for n, w in wrappers.items()}
        # the cached path ends here
        loads[run] = PROFILER.totals["index_load"]
        if sam_body(out) != body4:
            raise SystemExit(f"int64 cache: the {run} SAM differs from "
                             f"phase 4's")
        for name, n in launches.items():
            want = (2 if name == "one_pos_machine" else 1) * al.batches
            if n < want:
                raise SystemExit(f"int64 cache: {name}'s int64 form "
                                 f"launched {n} times over {al.batches} "
                                 f"batches in the {run} run")
    idx = load_index(big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forced = DeviceFMIndex.from_host(idx, dev, force_int64=True)
    torch.cuda.synchronize()
    t_forced = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = DeviceFMIndex.from_host_cached(idx, dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    if not (same_fmi(warm, forced) and same_fmi(al.fmi, forced)):
        raise SystemExit("int64 cache: the cached layout differs from "
                         "from_host(force_int64=True)")
    log(f"[int64 cache] mem on phase 4's index with seq_len 2^31: SAM "
        f"bodies cold and warm byte-equal to phase 4's; index load (mem's "
        f"PROFILER index_load: index, EMF table, aligner) cold "
        f"{loads['cold']:.3f} s (the cache written, "
        f"{os.path.getsize(cache)} bytes), warm {loads['warm']:.3f} s; "
        f"{N_READS / walls['cold']:.1f} / {N_READS / walls['warm']:.1f} "
        f"reads/s; the layout alone: from_host(force_int64=True) "
        f"{t_forced:.4f} s, from_host_cached warm {t_warm:.4f} s, equal "
        f"tensor for tensor on the card  [{card}]")
    return dict(cold=loads["cold"], warm=loads["warm"], forced=t_forced,
                warm_layout=t_warm)


def int64_wrappers():
    """{kernel name: wrapper} of the seven main-path kernels with an int64
    form."""
    from bwa_mem_scale_tpu_torch.ops import chain_cuda, sal_cuda, smem_cuda
    return {"one_pos_machine": smem_cuda.one_pos_machine_cuda,
            "seed_strategy_machine": smem_cuda.seed_strategy_machine_cuda,
            "expand_and_lookup": sal_cuda.expand_and_lookup_cuda,
            "chain_seeds": chain_cuda.chain_seeds_cuda,
            "chain_filter": chain_cuda.chain_filter_cuda,
            "reseed_tasks": smem_cuda.reseed_tasks_cuda,
            "merge_smems": smem_cuda.merge_smems_cuda}


def as_int32(v, fmi32):
    """An int64-form call's argument at int32: the index's int32 layout,
    SmemBuf's k, l and s, Chains' key and rbeg plane, and any int64 tensor
    as int32 (the same values: the genome's positions fit int32)."""
    import torch
    from bwa_mem_scale_tpu_torch.ops.chain import Chains
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.ops.smem import SmemBuf
    if isinstance(v, DeviceFMIndex):
        return fmi32
    if isinstance(v, (SmemBuf, Chains)):
        return type(v)(*(as_int32(t, fmi32) for t in v))
    if isinstance(v, torch.Tensor) and v.dtype == torch.int64:
        return v.to(torch.int32)
    return v


def int64_batch(dev, card, al, fmi64, fmi32, dbns, c, ln, batch):
    """One batch through seed_chain_extend at the int64 layout, every
    FM-walk and chaining call recorded: packed and meta equal to the int32
    layout's at the same seeding depth (the read length, int64's "auto");
    then each call, as made, against its plain version with its steps,
    bound and floor (the phase 5 functions), and timed beside the int32
    form on the same inputs at int32. Returns ({kernel name: the first
    call's numbers}, the calls)."""
    import dataclasses
    import torch
    from bwa_mem_scale_tpu_torch.ops import sal, smem_oh
    from bwa_mem_scale_tpu_torch.pipeline import align
    real = {(smem_oh, "one_pos_machine_cuda"): smem_oh.one_pos_machine_cuda,
            (smem_oh, "seed_strategy_machine_cuda"):
                smem_oh.seed_strategy_machine_cuda,
            (sal, "expand_and_lookup_cuda"): sal.expand_and_lookup_cuda,
            (align, "chain_seeds_cuda"): align.chain_seeds_cuda,
            (align, "chain_filter_cuda"): align.chain_filter_cuda,
            (smem_oh, "reseed_tasks_cuda"): smem_oh.reseed_tasks_cuda,
            (smem_oh, "merge_smems_cuda"): smem_oh.merge_smems_cuda}
    calls = {name: [] for _, name in real}

    def recorder(name, fn):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return record

    for (mod, name), fn in real.items():
        setattr(mod, name, recorder(name, fn))
    try:
        out64 = align.seed_chain_extend(fmi64, dbns, c, ln, READ_LEN,
                                        opt=al.opt, cfg=al.cfg)
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    cfg_l = dataclasses.replace(al.cfg, seed_emit_depth=None,
                                seed_stack_depth=None)
    out32 = align.seed_chain_extend(fmi32, dbns, c, ln, READ_LEN,
                                    opt=al.opt, cfg=cfg_l)
    torch.cuda.synchronize()
    for key in ("packed", "meta"):
        if not torch.equal(out64[key], out32[key]):
            raise SystemExit(f"int64: {batch}: {key} differs from the int32 "
                             f"layout's")
    want = {"one_pos_machine_cuda": 2, "seed_strategy_machine_cuda": 1,
            "expand_and_lookup_cuda": 1, "chain_seeds_cuda": 1,
            "chain_filter_cuda": 1, "reseed_tasks_cuda": 1,
            "merge_smems_cuda": 1}
    if any(len(calls[k]) != n for k, n in want.items()):
        raise SystemExit(f"int64: {batch} calls "
                         f"{ {k: len(v) for k, v in calls.items()} }")
    label = f"{batch}, int64 form"
    res = {"one_pos_machine": [smem_launch(dev, card, n, args, batch=label)
                               for n, (args, _) in
                               enumerate(calls["one_pos_machine_cuda"])],
           "seed_strategy_machine": seed_strategy_launch(
               dev, card, calls["seed_strategy_machine_cuda"][0][0],
               batch=label),
           "expand_and_lookup": sal_stage_launch(
               dev, card, *calls["expand_and_lookup_cuda"][0], batch=label),
           "chain_seeds": chain_seeds_launch(
               dev, card, *calls["chain_seeds_cuda"][0], batch=label),
           "chain_filter": chain_filter_launch(
               dev, card, *calls["chain_filter_cuda"][0], batch=label),
           **{name: glue_launch(dev, card, label, attr, calls[attr][0][0])
              for name, attr, _ in GLUE_KERNELS}}
    n_args = {"one_pos_machine": 11, "seed_strategy_machine": 6}
    for name, wrapper in int64_wrappers().items():
        for n, (args, kw) in enumerate(calls[wrapper.__name__]):
            args = args[:n_args.get(name, len(args))]
            kw = {k: v for k, v in kw.items() if k != "stats"}
            a32 = [as_int32(a, fmi32) for a in args]
            ms32 = device_ms(lambda: wrapper(*a32, **kw), 20, dev)
            r = (res[name][n] if name == "one_pos_machine" else res[name])
            r["ms32"] = ms32
            log(f"[int64] {name} launch {n + 1}, {batch}: int64 form "
                f"{r['ms']:.5f} ms, int32 form on the same inputs "
                f"{ms32:.5f} ms ({r['ms'] / ms32:.2f}x); bound "
                f"{r['bound'][0]:.6f} ms by {r['bound'][1]}, latency floor "
                f"{r['floor']:.5f} ms  [{card}]")
    res["one_pos_machine"] = res["one_pos_machine"][0]
    return res, calls


def int64_large_values(dev, card, fmi64, idx, calls):
    """Phase 8's values past 2^31 and 2^32 on phase 5's batch: the SA
    lookup stage (csrc/sal.cu) on samples lifted by 2^33; pass 3 on the lifted table (every count
    + 2^32: intervals past 2^32, rows read at clamped indices); passes 1-2
    with a step table whose steps lie past the last row (the decode loop
    runs, the counts stay true; on the lifted table passes 1-2's warp form
    is not the lockstep's function, since its keep rule rests on orders
    only an FM index keeps); chaining on the batch moved to two 3.1 Gbp
    genomes (MOVES), a seed over the strands' junction added. Each kernel
    against its plain version, exact."""
    import dataclasses
    import torch
    from bwa_mem_scale_tpu_torch.ops import chain, occ, sal, smem_cuda
    from bwa_mem_scale_tpu_torch.ops import chain_cuda, sal_cuda, smem_oh
    from bwa_mem_scale_tpu_torch.ops import smem_rl, smem_rl_cuda

    def same(what, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.equal(a, b)]
        if bad:
            raise SystemExit(f"int64: {what}: kernel != plain in {bad}")

    (_, smems, *stage), stage_kw = calls["expand_and_lookup_cuda"][0]
    stage_kw = {k: v for k, v in stage_kw.items() if k != "stats"}
    up = dataclasses.replace(fmi64, sa_samples=fmi64.sa_samples + (1 << 33))
    got = sal_cuda.expand_and_lookup_cuda(up, smems, *stage, **stage_kw)
    same("SA lookup on samples + 2^33", got,
         sal.expand_and_lookup_plain(up, smems, *stage, **stage_kw))
    base = sal_cuda.expand_and_lookup_cuda(fmi64, smems, *stage, **stage_kw)
    got, base, valid = got[0], base[0], got[2]
    lifted = got >= (1 << 33)
    if not (torch.equal(got[lifted] - (1 << 33), base[lifted])
            and torch.equal(got[~lifted], base[~lifted])):
        raise SystemExit("int64: the lifted samples' lookup is not the "
                         "lookup's values + 2^33")
    log(f"[int64] SA lookup stage on samples + 2^33: equal to the plain "
        f"version; {int(lifted.sum())} of {int(valid.sum())} coordinates "
        f"past 2^33 (max {int(got.max())}), each the int32 layout's value "
        f"+ 2^33")

    cnt = np.asarray(idx.cp_count, np.int64) + (1 << 32)
    fl = occ.DeviceFMIndex.from_host(dataclasses.replace(idx, cp_count=cnt),
                                     dev, force_int64=True)
    args = calls["seed_strategy_machine_cuda"][0][0]
    a = (fl, *args[1:3], (1 << 31) - 1, 2, READ_LEN)
    got = smem_cuda.seed_strategy_machine_cuda(*a)
    same("pass 3 on the lifted table", got, smem_oh.seed_strategy_machine(*a))
    if not torch.equal(smem_cuda.seed_strategy_machine_cuda.last_steps,
                       smem_oh.seed_strategy_machine.last_steps):
        raise SystemExit("int64: pass 3 on the lifted table: steps differ")
    log(f"[int64] pass 3 on the lifted table (counts + 2^32, max_intv 2^31 - 1, "
        f"min_seed_len 2): equal to the plain machine, steps too; "
        f"{int(got.cnt.sum())} seeds, k up to {int(got.k.max())}, l up to "
        f"{int(got.l.max())}")

    steps = torch.full_like(fmi64.cp_hi_steps, occ.NO_STEP)
    steps[:, 0] = fmi64.cp_fused.shape[0] + 5
    fs = dataclasses.replace(fmi64, cp_hi_steps=steps, hi_counts=[1] * 4)
    for n, (args, _) in enumerate(calls["one_pos_machine_cuda"]):
        a = (fs, *args[1:11])
        same(f"pass {n + 1} with a step table",
             smem_cuda.one_pos_machine_cuda(*a), smem_oh.one_pos_machine(*a))
    a = (fs, *calls["seed_strategy_machine_cuda"][0][0][1:6])
    same("pass 3 with a step table", smem_cuda.seed_strategy_machine_cuda(*a),
         smem_oh.seed_strategy_machine(*a))
    same("SA lookup with a step table",
         sal_cuda.expand_and_lookup_cuda(fs, smems, *stage, **stage_kw),
         sal.expand_and_lookup_plain(fs, smems, *stage, **stage_kw))
    # the readlane kernels (a warp a worker lane rests on the same orders
    # as one_pos_kernel) on the same tasks at full depth, 64 lanes
    for n, (args, _) in enumerate(calls["one_pos_machine_cuda"]):
        a = (fs, *args[1:10])
        rows = {} if n == 0 else {"out_rows": torch.arange(
            args[3].shape[0], device=args[3].device)}
        same(f"readlane pass {n + 1} with a step table",
             smem_rl_cuda.readlane_one_pos_cuda(*a, lanes=64, **rows),
             smem_rl.one_pos_machine(*a, **rows))
    a = (fs, *calls["seed_strategy_machine_cuda"][0][0][1:6])
    same("readlane pass 3 with a step table",
         smem_rl_cuda.readlane_strategy_cuda(*a, lanes=64),
         smem_rl.seed_strategy_machine(*a))
    log("[int64] passes 1-3 (one-hot and readlane) and the SA lookup stage "
        "with a step of every base past the last row (the decode loop run, "
        "one load a step): equal to the plain versions")

    (bns, smems, rbeg, seed_idx, valid_c), kw = calls["chain_seeds_cuda"][0]
    kw = {k: v for k, v in kw.items() if k != "stats"}
    (_, _, _, lens), fkw = calls["chain_filter_cuda"][0]
    fkw = {k: v for k, v in fkw.items() if k != "stats"}
    l_pac = bns.l_pac
    for move, (d0, d1) in (("fw", (HG38_L_PAC - l_pac, 0)),
                           ("rc", (1_000_000_000,
                                   HG38_L_PAC - 1_000_000_000 - l_pac))):
        def moved(p):
            return p + torch.where(p < l_pac, d0, d0 + 2 * d1)
        lp = l_pac + d0 + d1
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        off = [zero, bns.offsets + d0] + ([zero + l_pac + d0] if d1 else [])
        alt = torch.zeros(len(bns.is_alt) + 1 + (1 if d1 else 0),
                          dtype=torch.bool, device=dev)
        alt[1:1 + len(bns.is_alt)] = bns.is_alt
        mb = chain.DeviceBns(offsets=torch.cat(off), is_alt=alt, l_pac=lp)
        rb = moved(rbeg)
        rb[0, 0] = lp - 10                     # a seed over the junction
        valid_c = valid_c.clone()
        valid_c[0, 0] = True
        si = int(seed_idx[0, 0])
        bridges = int(smems.n[0, si] - smems.m[0, si]) + 1 > 10
        got = chain_cuda.chain_seeds_cuda(mb, smems, rb, seed_idx, valid_c,
                                          **kw)
        want = chain.chain_seeds_device(mb, smems, rb, seed_idx, valid_c,
                                        **kw)
        same(f"chain_seeds at 3.1 Gbp ({move})", tuple(got), tuple(want))
        ref = chain_cuda.chain_seeds_cuda(bns, smems, rbeg, seed_idx,
                                          valid_c, **kw)
        live = (torch.arange(ref.key.shape[1], device=dev)[None, :]
                < ref.n[:, None])
        live[0] = False                        # read 0 took the junction seed
        if not torch.equal(got.key[live], moved(ref.key[live])):
            raise SystemExit(f"int64: chains at 3.1 Gbp ({move}) are not the "
                             f"batch's, moved")
        same(f"chain_filter at 3.1 Gbp ({move})",
             chain_cuda.chain_filter_cuda(got, mb, smems, lens, **fkw),
             chain.chain_filter_frac_rep(got, mb, smems, lens, **fkw))
        seeded = got.seed_len > 0
        log(f"[int64] chaining on a 3.1 Gbp genome ({move}: forward "
            f"positions + {d0}, reverse + {d0 + 2 * d1}; l_pac {lp}): both "
            f"kernels equal to their plain versions; rbeg "
            f"{int(rb[valid_c].min())}-{int(rb[valid_c].max())}, the chains "
            f"the batch's moved; read 0's first seed at l_pac - 10 "
            f"{'bridges' if bridges else 'does not bridge'} the strands' "
            f"junction; {int(got.n.sum())} chains, seed rbeg up to "
            f"{int(got.seed_rbeg[seeded].max())}")


def phase_int64(dev, card, tmp, se, al, codes, lens, slice32):
    """Phase 8: the int64-position layout. Phase 4's SE `mem` with the
    layout forced (its main path: counts zeroed just before, read just
    after), its SAM body byte-equal to phase 4's, reads/s and `-v 4`
    stage seconds beside phase 4's; phase 5's batch and the repeat batch
    through each int64 form, as made, against the plain versions and
    beside the int32 forms; the values past 2^31 and 2^32; the layout's
    device bytes, and hg38's reckoned. Returns {kernel name: numbers} and
    the forced run's launches."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.ops import chain, extend_cuda
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex, HI_STEPS
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    t0 = time.perf_counter()
    wrappers = int64_wrappers()
    out = os.path.join(tmp, "out64.sam")
    argv = [*se["argv"][:2], "-o", out, *se["argv"][4:]]
    # the extension kernels with an int64 form (ext_pairs has none)
    ext64 = {name: getattr(extend_cuda, attr)
             for name, attr, _ in EXT_KERNELS if name != "ext_pairs"}
    with forced_int64():
        for w in (*wrappers.values(), *ext64.values()):
            w.launches = w.launches64 = 0       # int64 path starts here
        t1 = time.perf_counter()
        al64 = cli.mem(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: (w.launches, w.launches64)
                    for n, w in wrappers.items()}
        ext_launches = {n: (w.launches, w.launches64)
                        for n, w in ext64.items()}
        # int64 path ends here
        al4 = cli.mem(argv + ["-v", "4"])
    if al64.fmi.pos_dtype != torch.int64:
        raise SystemExit("int64: the forced run did not take the layout")

    if sam_body(out) != sam_body(se["argv"][3]):
        raise SystemExit("int64: the SE SAM differs from phase 4's")
    for name, (n, n64) in (*launches.items(), *ext_launches.items()):
        want = ({"one_pos_machine": 2, "ext_bsw_band": 4}.get(name, 1)
                * al64.batches)
        if n64 < want or n != n64:
            raise SystemExit(f"int64: {name} launched {n} times, {n64} in "
                             f"its int64 form, over {al64.batches} batches")
    hold_route(al64, codes, lens, "phase 8's forced int64 SE route", card)
    n_reads = N_READS
    log(f"[int64] SE mem at the forced layout: SAM body byte-equal to phase "
        f"4's; {n_reads} reads in {wall:.2f} s = {n_reads / wall:.1f} "
        f"reads/s (phase 4: {se['wall']:.2f} s = "
        f"{n_reads / se['wall']:.1f}); int64-form launches "
        f"{ {k: v[1] for k, v in (*launches.items(), *ext_launches.items())} }"
        f" over {al64.batches} "
        f"device batches; overflow-retried reads {al64.overflow_retried}  "
        f"[{card}]")
    sec, s32 = al4.prof.seconds, se["seconds"]
    log("[int64 -v 4] synchronised stage seconds, int64 (phase 4): "
        + ", ".join(f"{k} {sec[k]:.3f} ({s32[k]:.3f})"
                    for k in ("seed", "sal", "chain", "bsw"))
        + f"  [{card}]")
    cache = phase_cache(dev, card, tmp, se, wrappers)

    fmi64 = DeviceFMIndex.from_host(al.idx, dev, force_int64=True)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    res, calls = int64_batch(dev, card, al, fmi64, al.fmi, al.dbns, c, ln,
                             "phase 5's batch")
    for name, r in res.items():
        log(f"[int64] {name}: int64 form {r['ms']:.5f} ms at the int64 "
            f"path's shapes (int32 form there {r['ms32']:.5f} ms); the "
            f"int32 path's launch in phase 5 {slice32[name]['ms']:.5f} ms  "
            f"[{card}]")
    idx_r, codes_r, lens_r = repeat_batch(BATCH, READ_LEN)
    int64_batch(dev, card, al, DeviceFMIndex.from_host(idx_r, dev,
                                                       force_int64=True),
                DeviceFMIndex.from_host(idx_r, dev),
                chain.DeviceBns.from_host(idx_r.bns, dev),
                torch.as_tensor(codes_r, device=dev),
                torch.as_tensor(lens_r, device=dev), "repeat batch")
    int64_large_values(dev, card, fmi64, al.idx, calls)

    seq = 2 * HG38_L_PAC + 1
    rows, samples = -(-seq // 32), -(-seq // (1 << HG38_SA_COMPX))
    hg38 = {"checkpoint rows": 32 * rows, "SA samples": 8 * samples,
            "fw+rc reference": 2 * HG38_L_PAC,
            "C array and step table": 8 * (5 + 4 * HI_STEPS)}
    log(f"[int64] device bytes of the index, 4.6 Mbp genome: int64 layout "
        f"{fmi64.nbytes()}, int32 layout {al.fmi.nbytes()} (measured: the "
        f"tensors' sizes)")
    log(f"[int64] hg38 (l_pac {HG38_L_PAC}, seq_len {seq}, sa_compx "
        f"{HG38_SA_COMPX}), reckoned from the layout, not measured: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in hg38.items())
        + f"; {sum(hg38.values()) / 1e9:.2f} GB of the card's 80 GB")
    log(f"[int64] phase 8 took {time.perf_counter() - t0:.1f} s")
    res["launches"] = {k: v[1] for k, v in launches.items()}
    res["cache"] = cache
    return res


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
    cases = probe_cuda_rates.kernel_work(dev)
    for c in cases:
        got, want = c.kernel(), c.plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise SystemExit(f"probes: {c.name} kernel != plain version")
        lib = c.library
        if lib is not None and not torch.equal(lib().reshape(want.shape),
                                               want):
            log(f"[probes] {c.name}: the library call differs from the "
                f"plain version; no library time")
            lib = None
        res[c.name] = dict(err=int((got.long() - want.long()).abs().max()),
                           ms=[], plain_ms=[], library_ms=[], lib=lib,
                           bound=bound(c.nbytes, c.ops))
    # device time (a spin kernel holds the stream while the calls are
    # queued) in turns (kernel, plain, library, library, plain, kernel)
    # so clock ramps do not favour one; the wall time of back-to-back
    # calls beside it
    for turn in range(2):
        for c in cases:
            r = res[c.name]
            fns = [("ms", c.kernel), ("plain_ms", c.plain)]
            if r["lib"] is not None:
                fns.append(("library_ms", r["lib"]))
            for key, fn in (fns if turn == 0 else fns[::-1]):
                r[key].append(device_ms(fn, 20, dev))
    for c in cases:
        r = res[c.name]
        for key in ("ms", "plain_ms", "library_ms"):
            r[key] = sum(r[key]) / 2 if r[key] else None
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"[probes] {c.name}: equal to plain (max_abs_err {r['err']}); "
            f"bound {r['bound'][0]:.6f} ms by {r['bound'][1]}; device time "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library call {lib} (mean of 2 turns); back to back a call"
            f" kernel {time_ms(c.kernel, 20, dev):.4f} ms, plain "
            f"{time_ms(c.plain, 20, dev):.4f} ms  [{card}]")
    log(f"[probes] phase 6 took {time.perf_counter() - t0:.1f} s")
    return [{"name": name, "route": "cuda", "source": "csrc/probes.cu",
             "replaces": pk.REPLACES[name], "launches": launches[name],
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
            for name, r in res.items()]


# the sweep engine's kernels (phase 9, csrc/sweep.cu): name, wrapper
# attribute of ops/sweep_cuda.py, and the JAX loop each replaces
SWEEP_KERNELS = (
    ("sweep_extend", "sweep_pass_cuda", "bwa_mem_scale_tpu/ops/smem.py:109"),
    ("seed_strategy_merged", "seed_strategy_merged_cuda",
     "bwa_mem_scale_tpu/ops/smem.py:468"))
# the merged stage (csrc/sweep.cu seed_strategy_merged_kernel): a column
# of the read staged into the two masks 6 (the compare, the clamp, the
# count bit, two ballots' share); a visited column's glue 25 (the bounds
# 2, base_ok 3, died 3, zombie 2, E3 4, emit 3, fail3 and hit_n 3, nxt 3,
# the counts 2)
MERGED_OPS_PER_COL = 6
MERGED_OPS_PER_STEP = 25


def merged_launch(dev, card, what, kernel, args, kw, trip_us, round_us):
    """One merged-stage launch as made, through walk_launch against the
    plain version on the same inputs (every field and each read's steps);
    its bound: the codes, lengths and C array read once, each visited
    column's records (died_s, f3_s, f3_E, E, f3_ss) and each kept
    emission's f3_k and f3_l, the five [B, M] planes, cnt and steps
    written once; MERGED_OPS_PER_COL a column staged and
    MERGED_OPS_PER_STEP a visited column; its latency floor: one trip for
    the staged data (trip_us, probe B in the L2) and then the longest
    read's steps x a warp's dependent round (round_us,
    tools/round_cost.py), both measured in this run. Returns the
    numbers."""
    from bwa_mem_scale_tpu_torch.ops import smem
    kw = {k: v for k, v in kw.items() if k != "stats"}
    got, r = walk_launch(dev, what, kernel, smem.seed_strategy_merged_plain,
                         args, 1, kw)
    codes, M = args[1], args[6]
    B, L = codes.shape
    pb = got.k.element_size()
    kept = int(got.cnt.clamp(max=M).sum())
    nbytes = (4 * (B * L + B) + 5 * pb + (10 + pb) * r["steps"]
              + 2 * pb * kept + (8 + 3 * pb) * B * M + 8 * B)
    r["bound"] = bound(nbytes, MERGED_OPS_PER_COL * B * L
                       + MERGED_OPS_PER_STEP * r["steps"])
    r["floor"] = (trip_us + r["longest"] * round_us) * 1e-3
    log(f"[merged] {what}: equal to the plain version (max_abs_err "
        f"{r['err']}), each read's steps too; {r['steps']} chase steps over "
        f"{B} reads, the longest read {r['longest']}, {kept} emissions "
        f"kept; bound {r['bound'][0]:.6f} ms by {r['bound'][1]}; latency "
        f"floor {r['floor']:.5f} ms (one L2 trip {trip_us:.4f} us + "
        f"{r['longest']} x a warp's round {round_us:.4f} us, measured); "
        f"kernel device time {r['ms']:.5f} ms (one call with its "
        f"allocations, mean of 2), plain {r['plain_ms']:.2f} ms  [{card}]")
    return r


def sweep_wrappers():
    """{kernel name: wrapper} of the sweep engine's two kernels."""
    from bwa_mem_scale_tpu_torch.ops import sweep_cuda
    return {name: getattr(sweep_cuda, attr)
            for name, attr, _ in SWEEP_KERNELS}


def sweep_pass_launch(dev, card, what, args, kw, trips, twin=False):
    """One sweep pass launch as made (sweep_pass_cuda: the extension and
    the emission in one launch) against the plain version
    (sweep_pass_plain) on the same inputs: every SmemBuf field, the merged
    records and each lane's steps equal; its device time (mean of 2,
    around the plain version's). Latency floor: the longest lane's row
    fetches (its steps at K = 1) x the L2 trip + one HBM trip (the FMA
    start), `trips` = (L2 trip, HBM trip) in us, measured in this run.
    With `twin`, sweep_extend_twin on the same inputs (equal SmemBuf and
    steps) counts what the bound needs: the distinct 32-byte checkpoint
    rows the steps read and the ladder sectors the starts read, once
    each, beside the codes and lengths (and the task list) read once and
    the outputs written once, over 3.35 TB/s; SMEM_OPS_PER_STEP operations
    a step; and each lane's dependent trips before its first step.
    Returns the numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem, smem_cuda, sweep_cuda
    kernel = sweep_cuda.sweep_pass_cuda
    kw = {k: v for k, v in kw.items() if k != "stats"}
    kernel.keep_steps = True
    try:
        got, recs = kernel(*args, **kw)
    finally:
        kernel.keep_steps = False
    steps, rounds = kernel.last_steps.long(), kernel.last_rounds.long()
    want, wrecs = smem.sweep_pass_plain(*args, **kw)
    plain_steps = sweep_cuda.walked_steps(
        smem.extend_all_positions.last_steps, kw.get("tasks")).long()
    torch.cuda.synchronize()
    if set(recs) != set(wrecs):
        raise SystemExit(f"sweep: {what}: records {sorted(recs)} != "
                         f"{sorted(wrecs)}")
    pairs = list(zip(got, want)) + [(recs[f], wrecs[f]) for f in wrecs]
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in pairs)
    if err or not all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in pairs):
        raise SystemExit(f"sweep: {what} != plain (max_abs_err {err})")
    if not torch.equal(steps, plain_steps):
        raise SystemExit(f"sweep: {what}: per-lane steps differ from the "
                         f"plain version's (its lanes the launch walks)")
    ms = [device_ms(lambda: kernel(*args, **kw), 20, dev)]
    plain_ms = time_ms(lambda: smem.sweep_pass_plain(*args, **kw), 1, dev)
    ms.append(device_ms(lambda: kernel(*args, **kw), 20, dev))
    r = dict(err=err, ms=sum(ms) / 2, plain_ms=plain_ms,
             steps=int(steps.sum()), longest=int(steps.max()),
             rounds=int(rounds.sum()), longest_rounds=int(rounds.max()),
             bound=None)
    r["floor"] = (r["longest_rounds"] * trips[0] + trips[1]) * 1e-3
    fmi, codes, lens, msl, M = args[:5]
    B, P = codes.shape[0], kw["n_pos"]
    tasks = kw.get("tasks")
    detail = ""
    if twin:
        table = kw.get("fma")
        merged, K_eff = smem.sweep_window(table, 0, kw.get("p3_max_intv", 0),
                                          kw.get("p3_stop", 0))
        merged = merged and tasks is None
        tabs = smem_cuda.twin_tables(fmi)
        np_ = lambda t: t.cpu().numpy()
        tw = sweep_cuda.sweep_extend_twin(
            *tabs[:3], np_(codes), np_(lens), np.ones(B, np.int32), True, 0,
            kw.get("p3_max_intv", 0), kw.get("p3_stop", 0), P,
            ladders=None if not K_eff else tuple(
                np_(t) for t in (table.ladder_k, table.ladder_l,
                                 table.ladder_s)),
            K_eff=K_eff, hi_steps=tabs[3], kstep=smem_cuda.kstep_tables(fmi),
            emit=(msl, M),
            tasks=None if tasks is None else tuple(np_(t) for t in tasks))
        if not (np.array_equal(tw["steps"], np_(steps))
                and all(np.array_equal(np_(a), b)
                        for a, b in zip(got, tw["smem"]))):
            raise SystemExit(f"sweep: {what}: the twin's SMEMs or steps "
                             f"differ from the launch's")
        pb = fmi.pos_dtype.itemsize
        T = 0 if tasks is None else tasks[0].shape[0]
        nbytes = (32 * tw["rows"] + 32 * tw["ladder_sectors"]
                  + 4 * (codes.numel() + B) + 13 * T
                  + (8 + 3 * pb) * B * M + 4 * B
                  + ((10 + 3 * pb) * B * P if merged else 0))
        r["bound"] = bound(nbytes, SMEM_OPS_PER_STEP * r["steps"])
        r.update(rows=tw["rows"], sectors=tw["ladder_sectors"],
                 start_trips=int(tw["start_trips"].max()))
        detail = (f"; the twin: {tw['rows']} distinct checkpoint rows, "
                  f"{tw['ladder_sectors']} ladder sectors, at most "
                  f"{r['start_trips']} dependent trips before a lane's "
                  f"first step, equal SMEMs and steps; bound "
                  f"{r['bound'][0]:.6f} ms by {r['bound'][1]}")
    log(f"[sweep] {what}: equal to the plain version (max_abs_err "
        f"{r['err']}), every SmemBuf field, {len(recs)} record planes and "
        f"each lane's steps; {r['steps']} steps (the longest lane "
        f"{r['longest']}) in {r['rounds']} row fetches (the longest "
        f"{r['longest_rounds']}); {int(got.cnt.sum())} SMEMs{detail}; "
        f"latency floor {r['floor']:.5f} ms ({r['longest_rounds']} x "
        f"{trips[0]:.4f} us + {trips[1]:.4f} us); kernel device time "
        f"{r['ms']:.5f} ms (mean of 2), plain {r['plain_ms']:.2f} ms  "
        f"[{card}]")
    return r


def sweep_batch(dev, card, fmi, table, c, ln, batch, trips, twin=False):
    """collect_smems_device on one batch with the kernels, every launch
    recorded, equal to the whole call with the plain versions swapped in;
    then each launch as made (two sweep passes, one merged stage) against
    its plain version with its steps, floor and times (with `twin`, the
    passes' bounds from the twin); trips: (an L2 trip, a warp's round, an
    HBM trip) in us. Returns the three launches' numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem, sweep_cuda
    kw = dict(min_seed_len=19, split_len=28, split_width=10,
              max_mem_intv=20)
    real = {attr: getattr(sweep_cuda, attr) for _, attr, _ in SWEEP_KERNELS}
    plain = {"sweep_pass_cuda": smem.sweep_pass_plain,
             "seed_strategy_merged_cuda": smem.seed_strategy_merged_plain}
    calls = {attr: [] for attr in real}

    def recorder(attr, fn):
        def record(*args, **k):
            calls[attr].append((args, k))
            return fn(*args, **k)
        return record

    outs = []
    for swaps in ({a: recorder(a, fn) for a, fn in real.items()}, plain):
        for attr, fn in swaps.items():
            setattr(sweep_cuda, attr, fn)
        try:
            outs.append(smem.collect_smems_device(fmi, c, ln, fma=table,
                                                  **kw))
        finally:
            for attr, fn in real.items():
                setattr(sweep_cuda, attr, fn)
    torch.cuda.synchronize()
    bad = [f for f, a, b in zip(outs[0]._fields, *outs)
           if not torch.equal(a, b)]
    if bad:
        raise SystemExit(f"sweep: {batch}: collect_smems_device differs "
                         f"kernels vs plain: {bad}")
    if [len(v) for v in calls.values()] != [2, 1]:
        raise SystemExit(f"sweep: {batch}: calls "
                         f"{ {k: len(v) for k, v in calls.items()} }")
    got = outs[0]
    log(f"[sweep] {batch}: collect_smems_device SmemBuf equal with the "
        f"kernels and with the plain versions ({int(got.cnt.sum())} SMEMs, "
        f"{int((got.cnt == got.m.shape[1]).sum())} reads saturated)")
    K_eff = 0 if table is None else min(table.K, kw["min_seed_len"])
    res = []
    for n, (args, k) in enumerate(calls["sweep_pass_cuda"]):
        codes, B, P = args[1], args[1].shape[0], k["n_pos"]
        what = (f"{batch}, sweep launch {n + 1}/2 (pass {n + 1}: B={B}, "
                f"L={codes.shape[1]}, P={P}, M={args[4]}, FMA K_eff "
                f"{K_eff})")
        res.append(sweep_pass_launch(dev, card, what, args, k,
                                     (trips[0], trips[2]), twin))
    args, k = calls["seed_strategy_merged_cuda"][0]
    B, P = args[3]["E"].shape
    res.append(merged_launch(
        dev, card, f"{batch}, merged-stage launch (B={B}, "
        f"L={args[1].shape[1]}, P={P}, max_out={args[6]})",
        real["seed_strategy_merged_cuda"], args, k, *trips[:2]))
    return res


def phase_sweep(dev, card, tmp, se, pe, al, codes, lens, slice32):
    """Phase 9: the sweep engine with the FMA table. `smem-table` through
    the CLI; SE `mem --seed-engine sweep` (its main path: counts zeroed
    just before, read just after) with its SAM body byte-equal to phase
    4's, and again at the forced int64 layout; PE byte-equal to phase 7's;
    phase 5's batch and the repeat batch through collect_smems_device with
    and without the table, each launch against its plain version, at both
    layouts; the engines side by side. Returns {kernel name: numbers}."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.ops import chain_cuda, sal_cuda, smem_cuda
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.tools import round_cost
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    t0 = time.perf_counter()
    g = se["argv"][0]
    t1 = time.perf_counter()
    if cli.main(["smem-table", g, "--device", "cuda"]) != 0:
        raise SystemExit("sweep: smem-table failed")
    cli_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    fma = cli.find_fma(g)
    path = f"{g}.fma{fma.K}.npz"
    dev_table = fma.to_device(torch.int32, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    build_fma_table(al.fmi, K=fma.K)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    # K - 1 forward steps for each of the 4^K K-mers, their ladders out
    steps = (4 ** fma.K) * (fma.K - 1)
    bld = bound(SMEM_BYTES_PER_STEP * steps + dev_table.nbytes(),
                SMEM_OPS_PER_STEP * steps)
    log(f"[sweep] smem-table (K={fma.K}) through the CLI on the card in "
        f"{cli_s:.2f} s (build, copy to the host and the "
        f"{os.path.getsize(path)}-byte file); build_fma_table alone {build_s * 1e3:.1f} ms (torch "
        f"ops, host clock, synchronised; {steps} FM steps: bound "
        f"{bld[0]:.4f} ms by {bld[1]}, latency floor "
        f"{(fma.K - 1) * STEP_US * 1e-3:.5f} ms); the table on the card "
        f"{dev_table.nbytes()} bytes at int32, "
        f"{2 * dev_table.nbytes()} at int64; loading it (the file mapped, "
        f"narrowed to int32, copied to the card) {load_s:.3f} s, which "
        f"each sweep `mem` below pays in its index load  [{card}]")
    del dev_table

    sw = sweep_wrappers()
    others = {"one_pos_machine": smem_cuda.one_pos_machine_cuda,
              "seed_strategy_machine": smem_cuda.seed_strategy_machine_cuda,
              "expand_and_lookup": sal_cuda.expand_and_lookup_cuda,
              "chain_seeds": chain_cuda.chain_seeds_cuda,
              "chain_filter": chain_cuda.chain_filter_cuda,
              "banded_swa_batch": banded_swa_batch_cuda,
              "reseed_tasks": smem_cuda.reseed_tasks_cuda,
              "merge_smems": smem_cuda.merge_smems_cuda}
    counted = {**sw, **others}

    def run(argv, wide=False):
        """One `mem` run, its main path's counts: zeroed just before, read
        just after."""
        ctx = forced_int64() if wide else contextlib.nullcontext()
        with ctx:
            for w in counted.values():           # sweep path starts here
                w.launches = w.launches64 = 0
            PROFILER.totals.clear()
            t1 = time.perf_counter()
            a = cli.mem(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            n = {k: (w.launches, w.launches64) for k, w in counted.items()}
            # sweep path ends here
        hold_route(a, codes, lens, f"phase 9's mem --seed-engine sweep"
                   f"{' (int64)' if wide else ''}", card)
        a.index_load = PROFILER.totals["index_load"]
        if a.cfg.seed_engine != "sweep" or a.dfma is None:
            raise SystemExit("sweep: mem did not take the sweep with the "
                             "table")
        for name in sw:
            want = (2 if name == "sweep_extend" else 1) * a.batches
            got = n[name][1] if wide else n[name][0]
            if got < want or (wide and n[name][0] != n[name][1]):
                raise SystemExit(f"sweep: {name} launched {n[name]} times "
                                 f"(all, int64) over {a.batches} batches")
        for name in ("one_pos_machine", "seed_strategy_machine",
                     "reseed_tasks", "merge_smems"):
            if n[name][0]:
                raise SystemExit(f"sweep: the one-hot {name} kernel ran "
                                 f"{n[name][0]} times on the sweep path")
        for name in ("expand_and_lookup", "chain_seeds", "chain_filter",
                     "banded_swa_batch"):
            if n[name][0] < a.batches:
                raise SystemExit(f"sweep: {name} launched {n[name][0]} "
                                 f"times over {a.batches} batches")
        return a, wall, {k: v[1] if wide else v[0] for k, v in n.items()}

    argv = [g, se["argv"][1], "-o", os.path.join(tmp, "sweep.sam"),
            *se["argv"][4:], "--seed-engine", "sweep"]
    al_s, wall, launches = run(argv)
    if sam_body(argv[3]) != sam_body(se["argv"][3]):
        raise SystemExit("sweep: the SE SAM differs from phase 4's")
    per = {k: float(v) / al_s.batches for k, v in sorted(al_s.stats.items())
           if k.startswith(("sweep", "chase"))}
    log(f"[sweep] SE mem --seed-engine sweep with the table: SAM body "
        f"byte-equal to phase 4's; {N_READS} reads in {wall:.2f} s = "
        f"{N_READS / wall:.1f} reads/s (phase 4, one-hot: {se['wall']:.2f} "
        f"s = {N_READS / se['wall']:.1f}); launches {launches} over "
        f"{al_s.batches} device batches; overflow-retried reads "
        f"{al_s.overflow_retried}; index load (the table's included) "
        f"{al_s.index_load:.3f} s (phase 4: {se['index_load']:.3f})  "
        f"[{card}]")
    log("[sweep] per batch: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in per.items()))
    al4 = cli.mem(argv + ["-v", "4"])
    sec, s1 = al4.prof.seconds, se["seconds"]
    log("[sweep -v 4] synchronised stage seconds, sweep (phase 4, one-hot): "
        + ", ".join(f"{k} {sec[k]:.3f} ({s1[k]:.3f})"
                    for k in ("seed", "sal", "chain", "bsw")) + f"  [{card}]")
    argv64 = [g, se["argv"][1], "-o", os.path.join(tmp, "sweep64.sam"),
              *se["argv"][4:], "--seed-engine", "sweep"]
    al64, wall64, launches64 = run(argv64, wide=True)
    if al64.fmi.pos_dtype != torch.int64 or sam_body(argv64[3]) != sam_body(
            se["argv"][3]):
        raise SystemExit("sweep: the forced int64 SE SAM differs from phase "
                         "4's")
    log(f"[sweep] SE sweep at the forced int64 layout: SAM body byte-equal "
        f"to phase 4's; {wall64:.2f} s = {N_READS / wall64:.1f} reads/s; "
        f"int64-form launches {launches64}  [{card}]")
    pe_sam = os.path.join(tmp, "pe_sweep.sam")
    pe_argv = [*pe["argv"][:3], "-o", pe_sam, *pe["argv"][5:],
               "--seed-engine", "sweep"]
    al_p, wall_p, launches_p = run(pe_argv)
    if sam_body(pe_sam) != sam_body(pe["argv"][4]):
        raise SystemExit("sweep: the PE SAM differs from phase 7's")
    log(f"[sweep] PE mem --seed-engine sweep: SAM body byte-equal to phase "
        f"7's; {2 * N_PAIRS} reads in {wall_p:.2f} s = "
        f"{2 * N_PAIRS / wall_p:.1f} reads/s (phase 7: {pe['wall']:.2f} s); "
        f"launches {launches_p} over {al_p.batches} batches; index load "
        f"{al_p.index_load:.3f} s  [{card}]")

    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    idx_r, codes_r, lens_r = repeat_batch(BATCH, READ_LEN)
    fmi_r = {w: DeviceFMIndex.from_host(idx_r, dev, force_int64=w)
             for w in (False, True)}
    fma_r = build_fma_table(fmi_r[False], K=fma.K)
    fmi_4 = {False: al.fmi,
             True: DeviceFMIndex.from_host(al.idx, dev, force_int64=True)}
    res, p5 = {}, "phase 5's batch"
    trips = (dependent_trip_us(dev, L2_ROWS), round_cost.round_us(dev),
             dependent_trip_us(dev, HBM_ROWS))
    log(f"[sweep] the floors: one dependent trip in the L2 (probe B, "
        f"{L2_ROWS} rows) {trips[0]:.4f} us, a warp's dependent round "
        f"(tools/round_cost.py) {trips[1]:.4f} us, one dependent HBM trip "
        f"(probe B, {HBM_ROWS} rows) {trips[2]:.4f} us  [{card}]")
    for wide in (False, True):
        pd = torch.int64 if wide else torch.int32
        for batch, fmi, table, cc, ll in (
                ("phase 5's batch", fmi_4[wide], fma, c, ln),
                ("repeat batch", fmi_r[wide], fma_r,
                 torch.as_tensor(codes_r, device=dev),
                 torch.as_tensor(lens_r, device=dev))):
            for use in (True, False):
                label = (f"{batch}, {'with' if use else 'without'} the "
                         f"table{', int64 form' if wide else ''}")
                r = sweep_batch(dev, card, fmi, table.to_device(pd, dev)
                                if use else None, cc, ll, label, trips,
                                twin=not wide or (use and batch == p5))
                res[wide, batch, use] = r
                torch.cuda.empty_cache()
    one, bare = res[False, p5, True], res[False, p5, False]
    oh = [*slice32["one_pos_machine"], slice32["seed_strategy_machine"]]
    log(f"[sweep] engines on phase 5's batch, seeding kernels' device ms: "
        f"sweep with the table {one[0]['ms']:.5f} + {one[1]['ms']:.5f} + "
        f"merged stage {one[2]['ms']:.5f} = "
        f"{sum(r['ms'] for r in one):.5f} ({sum(r['steps'] for r in one)} "
        f"steps); without the table {sum(r['ms'] for r in bare):.5f} "
        f"({sum(r['steps'] for r in bare)} steps); one-hot passes 1-3 "
        f"{oh[0]['ms']:.5f} + {oh[1]['ms']:.5f} + "
        f"{oh[2]['ms']:.5f} = {sum(r['ms'] for r in oh):.5f} "
        f"({sum(r['steps'] for r in oh)} steps)  [{card}]")
    log(f"[sweep] phase 9 took {time.perf_counter() - t0:.1f} s")
    wide = res[True, p5, True]
    return {"launches": launches, "launches64": launches64,
            "sweep_extend": one[0], "seed_strategy_merged": one[2],
            "sweep_extend_int64": wide[0],
            "seed_strategy_merged_int64": wide[2], "trips": trips}


# phase 10, the long-read regime: (reads, shortest, longest) of run (a),
# default options, and of run (b), -x pacbio
LONG_A = (2000, 800, 2500)
LONG_B = (300, 3000, 6000)
# integer operations a DP cell of the seed-SW scorer (csrc/seedsw.cu):
# the score lookup 2, M 1, the F key 3, the scan's share 2, F 3, H 3, E 4
SEEDSW_OPS_PER_CELL = 18


def write_long_reads(path, fwd, n, lo, hi, seed):
    """n reads of lo-hi bp (uniform) from the forward genome `fwd`, 1%
    substitutions, every second one reverse-complemented, as FASTQ.
    Returns (true leftmost positions, is_rev, the reads' codes)."""
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    lens = rng.randint(lo, hi + 1, n)
    pos = np.array([rng.randint(0, len(fwd) - ln) for ln in lens])
    is_rev = np.arange(n) % 2 == 1
    reads = []
    with open(path, "w") as f:
        for i in range(n):
            s = fwd[pos[i]: pos[i] + lens[i]].copy()
            m = rng.rand(lens[i]) < 0.01
            s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
            if is_rev[i]:
                s = comp[s[::-1]]
            reads.append(s)
            f.write(f"@r{i}\n{decode_bases(s)}\n+\n{'I' * lens[i]}\n")
    return pos, is_rev, reads


def check_long_sam(path, n, pos, is_rev, tag):
    """Every read once, in input order; primaries within 5 bp of the true
    position and strand. Returns the placed share."""
    order, ok = [], 0
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
            if (not flag & 0x4 and abs(int(t[3]) - 1 - pos[i]) <= 5
                    and bool(flag & 0x10) == bool(is_rev[i])):
                ok += 1
    if order != list(range(n)):
        raise SystemExit(f"longread ({tag}): reads not emitted once each in "
                         f"input order")
    frac = ok / n
    log(f"[longread {tag}] {ok}/{n} primaries within 5 bp of the true "
        f"position and strand ({100 * frac:.2f}%)")
    if frac < 0.95:
        raise SystemExit(f"longread ({tag}): fewer than 95% of primaries "
                         f"placed")
    return frac


def seedsw_launch(dev, card, args):
    """The seed-SW scorer's launch of one batch, as made: the kernel
    against the plain version (max_abs_err 0); its live jobs, DP cells and
    the longest job's rows; the bound (the windows read once, the scores
    written once; SEEDSW_OPS_PER_CELL a cell); the latency floor (the
    longest job alone); the kernel's device time (mean of 2, around the
    plain version's)."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import seedsw_cuda
    from bwa_mem_scale_tpu_torch.ops.seedsw import local_sw_score_batch
    q, ql, t, tl = args[:4]
    got = seedsw_cuda.local_sw_score_cuda(*args)
    want = local_sw_score_batch(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if len(got) else 0
    if err:
        raise SystemExit(f"longread: the seed-SW kernel != plain "
                         f"(max_abs_err {err})")
    qc = ql.long().clamp(0, q.shape[1])
    tc = tl.long().clamp(0, t.shape[1])
    live = (qc > 0) & (tc > 0)
    cells = int((qc * tc)[live].sum())
    rows = torch.where(live, tc, 0)
    longest = int(rows.argmax())
    nbytes = 4 * (q.numel() + t.numel() + 3 * len(ql))
    cont = [a.contiguous() for a in args[:4]]
    one = [a[longest:longest + 1] for a in cont]
    ms = [device_ms(lambda: seedsw_cuda.launch(*cont, *args[4:]), 20, dev)]
    plain_ms = time_ms(lambda: local_sw_score_batch(*args), 2, dev)
    ms.append(device_ms(lambda: seedsw_cuda.launch(*cont, *args[4:]), 20,
                        dev))
    alone = device_ms(lambda: seedsw_cuda.launch(*one, *args[4:]), 20, dev)
    r = dict(err=err, ms=sum(ms) / 2, plain_ms=plain_ms, jobs=int(live.sum()),
             P=len(ql), cells=cells, rows=int(rows[longest]), floor=alone,
             bound=bound(nbytes, SEEDSW_OPS_PER_CELL * cells))
    log(f"[longread] seed-SW launch of the batch (P={r['P']}, windows "
        f"{q.shape[1]} x {t.shape[1]}): equal to the plain version "
        f"(max_abs_err {err}); {r['jobs']} live jobs, {cells} DP cells, the "
        f"longest job {r['rows']} rows; bound {r['bound'][0]:.6f} ms by "
        f"{r['bound'][1]}; latency floor (the longest job alone) "
        f"{alone:.5f} ms = {1e3 * alone / max(r['rows'], 1):.4f} us a row; "
        f"kernel device time {r['ms']:.5f} ms (mean of 2), plain "
        f"{plain_ms:.2f} ms  [{card}]")
    return r


def phase_longread(dev, card, tmp):
    """Phase 10: SE `mem --device cuda` on long reads of phase 4's genome,
    index and EMF table, (a) at default options and (b) under -x pacbio,
    each run a second time with `-v 4` for its stage seconds;
    then one batch of (a) through seed_chain_extend with the seed-SW
    launch captured and held against its plain version, and its BSW calls
    (the tiled instantiation) too."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.ops import seedsw_cuda
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    t_phase = time.perf_counter()
    g = os.path.join(tmp, "g")
    idx = load_index(g)
    fwd = np.asarray(idx.ref_string[: idx.bns.l_pac], np.uint8)
    runs, als = {}, {}
    for tag, (n, lo, hi), opts, seed in (("a", LONG_A, [], 31),
                                         ("b", LONG_B, ["-x", "pacbio"], 32)):
        t0 = time.perf_counter()
        fq, sam = (os.path.join(tmp, f"long_{tag}.{x}") for x in ("fq", "sam"))
        pos, is_rev, reads = write_long_reads(fq, fwd, n, lo, hi, seed)
        argv = [g, fq, "-o", sam, "--device", "cuda", "--batch-reads",
                str(BATCH), *opts]
        PROFILER.totals.clear()
        torch.cuda.reset_peak_memory_stats()
        real_filter, filters = align.seed_sw_filter, []

        def count_filter(*args, **kw):
            filters.append(1)
            return real_filter(*args, **kw)
        align.seed_sw_filter = count_filter
        try:
            seedsw_cuda.local_sw_score_cuda.launches = 0  # path starts here
            banded_swa_batch_cuda.launches = 0
            t1 = time.perf_counter()
            al = cli.mem(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = seedsw_cuda.local_sw_score_cuda.launches
            bsw = banded_swa_batch_cuda.launches           # path ends here
        finally:
            align.seed_sw_filter = real_filter
        check_long_sam(sam, n, pos, is_rev, tag)
        if len(filters) < al.batches or launches != len(filters):
            raise SystemExit(f"longread ({tag}): the seed-SW kernel launched "
                             f"{launches} times over {len(filters)} calls "
                             f"of the filter ({al.batches} device batches "
                             f"and the retry tiers' calls); expected one a "
                             f"call and a call a batch")
        log(f"[longread {tag}] {n} reads of {lo}-{hi} bp "
            f"({' '.join(opts) or 'default options'}) in {wall:.2f} s = "
            f"{n / wall:.1f} reads/s end to end (index load included)  "
            f"[{card}]")
        log(f"[longread {tag}] device batches {al.batches}; seed-SW launches "
            f"{launches} (one a filter call, the retry tiers' included), BSW "
            f"launches {bsw}; overflow tiers: tier 1 "
            f"{al.overflow_retried} reads, tier 2 {al.overflow_tier2}, oracle "
            f"{al.overflow_oracle}; the retry ladder "
            f"{PROFILER.totals['overflow_retry']:.3f} s (host clock); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
            f" GiB")
        sec = cli.mem(argv + ["-v", "4"]).prof.seconds
        log(f"[longread {tag} -v 4] synchronised stage seconds of the main "
            f"batches (a second run): " + ", ".join(f"{k} {sec[k]:.3f}"
                                     for k in align.StageProfile.STAGES)
            + f"  [{card}]")
        log(f"[longread {tag}] run took {time.perf_counter() - t0:.1f} s")
        runs[tag] = dict(launches=launches, wall=wall, reads=reads)
        als[tag] = al

    # one batch of (a) as the main path makes it, its seed-SW launch
    # captured (the first BATCH reads at their batch's width)
    al = als["a"]
    batch = runs["a"]["reads"][:BATCH]
    lens = np.array([len(s) for s in batch], np.int32)
    codes = np.full((len(batch), int(lens.max())), 4, np.int32)
    for i, s in enumerate(batch):
        codes[i, :len(s)] = s
    L = codes.shape[1]
    real = seedsw_cuda.local_sw_score_cuda
    captured = []

    def record(*args):
        captured.append(args)
        return real(*args)

    seedsw_cuda.local_sw_score_cuda = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c_dev = torch.as_tensor(codes, device=dev)
    l_dev = torch.as_tensor(lens, device=dev)
    try:
        align.seed_chain_extend(al.fmi, al.dbns, c_dev, l_dev, L, opt=al.opt,
                                cfg=al.cfg)
        torch.cuda.synchronize()
    finally:
        seedsw_cuda.local_sw_score_cuda = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with ext_recorded() as ext_made:    # a second call, past the peak's
        align.seed_chain_extend(al.fmi, al.dbns, c_dev, l_dev, L, opt=al.opt,
                                cfg=al.cfg)
    if len(captured) != 1:
        raise SystemExit(f"longread: {len(captured)} seed-SW calls in one "
                         f"batch, expected 1")
    # the batch's BSW calls at its width (the column-tiled instantiation
    # past 767 columns, with its per-pair scratch), the fused rounds'
    # inputs, through the standalone kernel against the plain BSW (the
    # fused rounds themselves are held below, hold_ext)
    from bwa_mem_scale_tpu_torch.ops import bsw_cuda
    from bwa_mem_scale_tpu_torch.ops.bsw import (BswBatchResult,
                                                 banded_swa_batch)
    bsw_calls = bsw_calls_of([(args, {}) for a, args, _, _ in ext_made
                              if a == "ext_bsw_band_cuda"])
    for i, args in enumerate(bsw_calls):
        got = bsw_cuda.banded_swa_batch_cuda(*args)
        want = banded_swa_batch(*args)
        torch.cuda.synchronize()
        bad = [f for f, x, y in zip(BswBatchResult._fields, got, want)
               if not torch.equal(x, y)]
        if bad:
            raise SystemExit(f"longread: BSW call {i} of the batch != plain "
                             f"in {bad}")
    P, QL = bsw_calls[0][0].shape
    tiled = bsw_cuda.lane_columns(QL) == bsw_cuda.TILED
    scratch = P * 2 * -(-(QL + 1) // bsw_cuda.TILE) * bsw_cuda.TILE * 4
    log(f"[longread] the batch (B={len(lens)}, L={L}) through "
        f"seed_chain_extend: peak device memory {peak:.2f} GiB; its "
        f"{len(bsw_calls)} BSW calls (P={P}, QL={QL}, "
        f"{'the tiled instantiation, scratch' if tiled else 'scratch'} "
        f"{scratch / 2 ** 20 if tiled else 0:.0f} MiB a call) each equal to "
        f"the plain BSW  [{card}]")
    hold_ext(ext_made, "phase 10's long-read batch (the seed-SW filter's "
             "seed_live and seed_score)", card)
    r = seedsw_launch(dev, card, captured[0])
    r["launches"] = runs["a"]["launches"] + runs["b"]["launches"]
    log(f"[longread] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return r


# phase 11, the device EMF probe: the rescue batch's seed length; probe
# B's table for one dependent trip past the 50 MB L2 (2^24 rows of 32
# bytes, 512 MiB; tools/round_cost.py::dependent_trip_us)
RESCUE_SEED = 51
HBM_ROWS = 1 << 24
# integer operations of the probe (csrc/emf.cu): a 32-base word's packing
# and hash 20, a probed slot's index, tests and ballots 8, a checked
# window column's load, compare and clamp 6
EMF_OPS_PER_WORD, EMF_OPS_PER_SLOT, EMF_OPS_PER_COL = 20, 8, 6


def emf_against_plain(args, got, what):
    """max_abs_err of one EMF launch's four arrays against the plain
    version on the same inputs (dtypes equal too); the plain version's
    outputs and per-read work."""
    import torch
    from bwa_mem_scale_tpu_torch.ops.emf import emf_lookup
    st = {}
    want = emf_lookup(*args, stats=st)
    torch.cuda.synchronize()
    bad = [k for k in want if got[k].dtype != want[k].dtype]
    if bad:
        raise SystemExit(f"emf: {what}: the kernel's {bad} dtypes differ "
                         f"from the plain version's")
    err = max(int((got[k].long() - want[k].long()).abs().max())
              for k in want) if len(got["code"]) else 0
    if err:
        raise SystemExit(f"emf: {what}: the kernel != plain (max_abs_err "
                         f"{err})")
    return err, want, st


def emf_launch(dev, card, args, want, st, trip_us, what):
    """One EMF launch's work and bound from the plain version's counts,
    its latency floor from the kernel's twin (emf_lookup_twin, equal to
    the plain version's outputs: the longest read's dependent trips x one
    HBM trip, measured in this run), and its times: the kernel's device
    ms (mean of 2, around the plain version's) and the plain version's."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import emf_cuda
    from bwa_mem_scale_tpu_torch.ops.emf import emf_lookup
    demf, ref, c, ln = args
    tw = emf_cuda.emf_lookup_twin(*args)
    if not all(np.array_equal(tw[k], want[k].cpu().numpy()) for k in want):
        raise SystemExit(f"emf: {what}: the twin differs from the plain "
                         f"version")
    B, L = c.shape
    n = ln.long().clamp(0, L)
    cand = want["n_loc"] > 0
    rescued = st["cands"] > 0
    slots = int(st["slots"].sum())
    ref_bytes = int(st["ref_bytes"].sum())
    cands = int(st["cands"].sum())
    # each read's columns and length, 12 bytes a probed slot, cnt, fwless
    # and mlidx of a candidate, the windows to their first mismatch, a
    # rescue's offsets and nfw and its list entries, the four outputs
    nbytes = (4 * int(n.sum()) + 4 * B + 12 * slots + 9 * int(cand.sum())
              + ref_bytes + 20 * int(rescued.sum()) + 8 * cands + 20 * B)
    words = (demf.seed_len + 31) // 32
    ops = (EMF_OPS_PER_WORD * words * B + EMF_OPS_PER_SLOT * slots
           + EMF_OPS_PER_COL * ref_bytes)
    trips = int(tw["trips"].max())
    r = dict(bound=bound(nbytes, ops), trips=trips,
             floor=trips * trip_us * 1e-3, slots=slots, cands=cands,
             rescued=int(rescued.sum()), ref_bytes=ref_bytes, B=B, L=L,
             max_slots=int(st["slots"].max()))
    cont = [c.contiguous(), ln.contiguous()]
    ms = [device_ms(lambda: emf_cuda.launch(demf, ref, *cont), 20, dev)]
    r["plain_ms"] = time_ms(lambda: emf_lookup(*args), 3, dev)
    ms.append(device_ms(lambda: emf_cuda.launch(demf, ref, *cont), 20, dev))
    r["ms"] = sum(ms) / 2
    log(f"[emf] {what} (B={B}, L={L}): {slots} slots probed (longest "
        f"{r['max_slots']}), {int(cand.sum())} candidates, {ref_bytes} "
        f"reference bytes checked, {r['rescued']} reads through the rescue "
        f"({cands} list entries); bound {r['bound'][0]:.6f} ms by "
        f"{r['bound'][1]}; latency floor {r['floor']:.5f} ms (the longest "
        f"read's {trips} dependent trips by the twin, "
        f"{int(tw['trips'][tw['code'] != 2].max(initial=0))} for a read "
        f"it places, x {trip_us:.4f} us); kernel device "
        f"time {r['ms']:.5f} ms (mean of 2), plain {r['plain_ms']:.3f} ms  "
        f"[{card}]")
    return r


def primary_of(lines, out):
    """Add each primary SAM line's (rname, pos, strand), or ("*",) when
    unmapped, to `out` by read name."""
    for ln in lines:
        if ln.startswith("@"):
            continue
        t = ln.split("\t", 5)
        flag = int(t[1])
        if not flag & 0x900:
            out[t[0]] = (("*",) if flag & 0x4
                         else (t[2], int(t[3]), bool(flag & 0x10)))
    return out


def phase_emf(dev, card, tmp, se):
    """Phase 11: (a) phase 4's reads through the in-process SE API with
    the EMF table probed on the card, (b) the rescue batch, (c) the
    in-memory index store (module docstring)."""
    import shutil
    import torch
    from bwa_mem_scale_tpu_torch import store
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.perfect import (
        build_perfect_table, emf_lookup_host, load_perfect_table)
    from bwa_mem_scale_tpu_torch.io.fastq import Read
    from bwa_mem_scale_tpu_torch.io.sam import aln_to_sam_line
    from bwa_mem_scale_tpu_torch.ops import emf_cuda
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.chain_cuda import (chain_filter_cuda,
                                                        chain_seeds_cuda)
    from bwa_mem_scale_tpu_torch.ops.emf import (DeviceEmf, FW_MATCHED,
                                                 RC_MATCHED)
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.ops.sal_cuda import expand_and_lookup_cuda
    from bwa_mem_scale_tpu_torch.ops.smem_cuda import (
        one_pos_machine_cuda, seed_strategy_machine_cuda)
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.pipeline.driver import run_alignment
    from bwa_mem_scale_tpu_torch.tools.batches import rescue_batch
    t_phase = time.perf_counter()
    g, fq, sam4 = se["argv"][0], se["argv"][1], se["argv"][3]
    codes, lens = se["codes"], se["lens"]
    emf_path = f"{g}.emf{READ_LEN}.npz"
    trip_us = dependent_trip_us(dev, HBM_ROWS)
    log(f"[emf] one dependent HBM trip (probe B, one lane over "
        f"{HBM_ROWS} rows of 32 bytes, {TRIP_TICKS[1] - TRIP_TICKS[0]} "
        f"extra ticks): {trip_us:.4f} us  [{card}]")

    # (a) the in-process API on phase 4's reads
    idx = load_index(g)
    pt = load_perfect_table(emf_path)
    opt = MemOptions()
    al = align.GpuAligner(idx, dev, opt,
                          align.PipelineConfig(seed_engine="onehot"), emf=pt)
    real = align.emf_lookup_cuda
    calls = []

    def record(*args):                   # each batch's launch, as made
        out = real(*args)
        calls.append((args, out))
        return out

    counted = (emf_cuda.emf_lookup_cuda, banded_swa_batch_cuda,
               one_pos_machine_cuda, seed_strategy_machine_cuda,
               expand_and_lookup_cuda, chain_seeds_cuda, chain_filter_cuda)
    align.emf_lookup_cuda = record
    try:
        for fn in counted:                   # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        recs = []
        for b0 in range(0, N_READS, BATCH):
            recs += al.align_and_finalize(codes[b0:b0 + BATCH],
                                          lens[b0:b0 + BATCH], id_offset=b0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:                                 # the main path ends here
        align.emf_lookup_cuda = real
    n_batches = -(-N_READS // BATCH)
    if len(calls) != n_batches or launches["emf_lookup_cuda"] != n_batches:
        raise SystemExit(f"emf: {len(calls)} EMF calls and "
                         f"{launches['emf_lookup_cuda']} kernel launches "
                         f"over {n_batches} batches, expected one a batch")
    for name, n in launches.items():
        if n < n_batches:
            raise SystemExit(f"emf: the {name} kernel launched {n} times "
                             f"over {n_batches} batches, fewer than one a "
                             f"batch")
    err_a, hits, host_ms = 0, 0, None
    for i, (args, out) in enumerate(calls):
        e, want, st = emf_against_plain(args, out, f"batch {i}")
        err_a = max(err_a, e)
        b0 = i * BATCH
        cb, lb = codes[b0:b0 + BATCH], lens[b0:b0 + BATCH]
        host = emf_lookup_host(pt, idx.ref_string, cb, lb)
        if not np.array_equal(host["code"], out["code"].cpu().numpy()):
            raise SystemExit(f"emf: batch {i}: the kernel's codes differ "
                             f"from the host probe's")
        hits += int(((host["code"] == FW_MATCHED)
                     | (host["code"] == RC_MATCHED)).sum())
        if i == 0:
            first = (args, want, st)
            host_ms = time_ms(lambda: emf_lookup_host(pt, idx.ref_string,
                                                      cb, lb), 5,
                              torch.device("cpu"))
    if not hits == al.emf_hits == se["emf_hits"]:
        raise SystemExit(f"emf: {al.emf_hits} hits through the API, "
                         f"{hits} by the host probe, {se['emf_hits']} in "
                         f"phase 4's mem")
    with open(sam4) as f:
        want4 = primary_of(f, {})
    got = {}
    for i, rr in enumerate(recs):
        rr = rr or []
        read = Read(f"r{i}", codes[i, :lens[i]].astype(np.uint8), None)
        primary_of((aln_to_sam_line(opt, idx.bns, read, len(rr), rr, w)
                    for w in range(len(rr))), got)
    if got != want4:
        bad = [k for k in want4 if got.get(k) != want4[k]]
        raise SystemExit(f"emf: {len(bad)} primaries differ from phase 4's "
                         f"SAM (first {bad[:3]}) or are missing")
    demf = al.demf
    log(f"[emf] the API (align_and_finalize, {n_batches} batches of "
        f"{BATCH}): {N_READS} reads in {wall:.2f} s = {N_READS / wall:.1f} "
        f"reads/s (host records included); every batch's EMF launch equal "
        f"to its plain version (max_abs_err {err_a}) and its codes to the "
        f"host probe's; {hits} hits, as phase 4's mem; every primary equal "
        f"to phase 4's; launches {launches}; the table on the card "
        f"{demf.nbytes() / 2 ** 20:.1f} MiB (ncap {demf.ncap}, max_probe "
        f"{demf.max_probe})  [{card}]")
    ra = emf_launch(dev, card, *first, trip_us, "batch 0's launch")
    ra.update(err=err_a, launches=launches["emf_lookup_cuda"],
              host_ms=host_ms)
    log(f"[emf] the host probe (emf_lookup_host) on the same batch: "
        f"{host_ms:.3f} ms (host clock)")

    # (b) the multi-location rescue
    ridx, rc, rl, where = rescue_batch(RESCUE_SEED)
    rpt = build_perfect_table(ridx, seed_len=RESCUE_SEED)
    rargs = (DeviceEmf.from_host(rpt, dev),
             DeviceFMIndex.from_host(ridx, dev).ref,
             torch.as_tensor(rc, device=dev), torch.as_tensor(rl, device=dev))
    out = emf_cuda.emf_lookup_cuda(*rargs)
    err_b, want, st = emf_against_plain(rargs, out, "the rescue batch")
    code, loc = out["code"].cpu().numpy(), out["loc"].cpu().numpy()
    if not (np.isin(code, (FW_MATCHED, RC_MATCHED)).all()
            and (loc == where).all()):
        raise SystemExit("emf: a rescue-batch read is not placed on its "
                         "own copy")
    rb = emf_launch(dev, card, rargs, want, st, trip_us,
                    f"the rescue batch (-l {RESCUE_SEED}, max_probe "
                    f"{rpt.max_probe})")
    if rb["rescued"] < 100:
        raise SystemExit(f"emf: {rb['rescued']} reads reached the rescue, "
                         f"fewer than 100")
    log(f"[emf] rescue batch: every read placed on its own copy (code 3 or "
        f"4), {rb['rescued']} through the rescue, the kernel equal to its "
        f"plain version (max_abs_err {err_b})")

    # (c) the in-memory index store, staged into a temporary directory
    sdir = os.path.join(tmp, "store")
    arts = store.discover_artifacts(g)
    budget = (os.stat(arts["index"]).st_size + os.stat(arts["emf"]).st_size
              + (1 << 20)) / (1 << 30)
    t0 = time.perf_counter()
    root = store.stage(g, budget, store_dir=sdir, log=lambda m: None)
    stage_s = time.perf_counter() - t0
    cfg = align.PipelineConfig(seed_engine="onehot")

    def from_files():
        return align.GpuAligner(load_index(g), dev, opt, cfg,
                                emf=load_perfect_table(emf_path))

    def from_store():
        att = store.attach(g, store_dir=sdir)
        if att is None or sorted(att.pieces) != ["emf", "index"]:
            raise SystemExit(f"emf: the store at {root} did not attach with "
                             f"its index and EMF pieces")
        return align.GpuAligner(store.index_from_store(att.pieces["index"]),
                                dev, opt, cfg,
                                emf=store.emf_from_store(att.pieces["emf"]))

    loads, als = {}, {}
    for how, fn in (("files", from_files), ("store", from_store),
                    ("store", from_store), ("files", from_files)):
        t0 = time.perf_counter()
        als[how] = fn()
        torch.cuda.synchronize()
        loads.setdefault(how, []).append(time.perf_counter() - t0)
    out_sam = os.path.join(tmp, "store.sam")
    with open(out_sam, "w") as f:
        n = run_alignment(als["store"], [fq], f, batch_reads=BATCH,
                          verbosity=3)
    body = lambda p: [ln for ln in open(p) if not ln.startswith("@")]
    if n != N_READS or body(out_sam) != body(sam4):
        raise SystemExit("emf: the SE SAM from the attached store differs "
                         "from phase 4's")
    shm = (f"{shutil.disk_usage('/dev/shm').total / 2 ** 20:.0f} MiB"
           if os.path.isdir("/dev/shm") else "absent")
    log(f"[emf] store: staged index + EMF table (budget {budget:.3f} GB, "
        f"the FMA table left out) in {stage_s:.2f} s at {root}; index load "
        f"with the aligner on the card, files {loads['files']} s, store "
        f"{loads['store']} s (host clock; phase 4's mem index_load "
        f"{se['index_load']:.3f} s); run_alignment SE from the store: SAM "
        f"body byte-equal to phase 4's; /dev/shm {shm}  [{card}]")
    store.remove(g, store_dir=sdir)
    log(f"[emf] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    ra["err"] = max(err_a, err_b)
    return ra


# phase 12, ERT seeding (csrc/ert.cu): the trie's k-mer length and depth
# (ert-index's defaults); probe B's table for one dependent trip in the L2
# (287,501 rows of 32 bytes, 9.2 MB, the 4.6 Mbp checkpoint table's size)
ERT_K, ERT_DEPTH = 12, 320
L2_ROWS = 287_501
# a descent step (csrc/ert.cu's loop): the column, its code and the two
# exit tests 5, the clip 2, the node test 1; on a node the pair's address
# 2, the count and k fields 3, the leaf test and the offset 3, the next
# node's select 2; the merged record's four tests 4, the size test 1, the
# lane's five updates and the step counts 5
ERT_OPS_PER_STEP = 28


def reads_of(run):
    """Each read of a phase 4 or phase 7 run (its codes and lengths) as an
    int32 array, in input order."""
    return [np.asarray(c[:n], np.int32) for c, n in zip(run["codes"],
                                                         run["lens"])]


def ert_wrappers():
    """{kernel name: wrapper} of the ERT engine's kernels: the descent and
    the merged stage it shares with the sweep."""
    from bwa_mem_scale_tpu_torch.ops import ert_cuda, sweep_cuda
    return {"ert_extend": ert_cuda.ert_extend_all_positions_cuda,
            "seed_strategy_merged": sweep_cuda.seed_strategy_merged_cuda}


def ert_launch(dev, card, what, args, kw, trips):
    """One descent launch as made, through walk_launch (each output and
    each lane's node and leaf steps equal to the plain version's); its
    bound (16 bytes a node step, 1 a leaf step, the root's four pairs, the
    codes, lengths and minimum intervals read once, the dict's planes
    written once; ERT_OPS_PER_STEP a step) and latency floors: the longest
    lane's node steps plus its leaf words (16 leaf steps a word, the leaf
    walk's loads) x one dependent trip in the L2, and for reference the
    node steps alone x the L2 trip and x one past it, the trips measured
    in this run. Returns the numbers."""
    from bwa_mem_scale_tpu_torch.ops import ert as ops_ert, ert_cuda
    kernel = ert_cuda.ert_extend_all_positions_cuda
    got, r = walk_launch(dev, what, kernel, ops_ert.ert_extend_all_positions,
                         args, 1, kw)
    steps = kernel.last_steps.long()
    node, leaf = int(steps[0].sum()), int(steps[1].sum())
    lane = steps.sum(0)
    trips_lane = steps[0] + (steps[1] + ert_cuda.WORD - 1) // ert_cuda.WORD
    codes = args[2]
    B, L = codes.shape
    pb = got["k"].element_size()
    lane_out = sum(v.element_size() for v in got.values())
    nbytes = (16 * node + leaf + 64 + 4 * codes.numel() + 8 * B
              + lane_out * B * L)
    r.update(node=node, leaf=leaf, longest=int(lane.max()),
             longest_node=int(steps[0].max()),
             longest_trips=int(trips_lane.max()),
             bound=bound(nbytes, ERT_OPS_PER_STEP * (node + leaf)),
             floor_words=int(trips_lane.max()) * trips[0] * 1e-3,
             floor=int(steps[0].max()) * trips[0] * 1e-3,
             floor_hbm=int(steps[0].max()) * trips[1] * 1e-3, pb=pb)
    log(f"[ert] {what}: equal to the plain version (max_abs_err "
        f"{r['err']}), node and leaf steps too; {node} node steps + {leaf} "
        f"leaf steps over {int((lane > 0).sum())} lanes, the longest lane "
        f"{r['longest']} ({r['longest_node']} node steps); bound "
        f"{r['bound'][0]:.6f} ms by {r['bound'][1]}; latency floor "
        f"{r['floor_words']:.5f} ms (the longest lane's node steps + leaf "
        f"words, {r['longest_trips']} x {trips[0]:.4f} us, an L2 trip); "
        f"the node steps alone {r['floor']:.5f} ms ({r['longest_node']} x "
        f"the L2 trip; x {trips[1]:.4f} us, an HBM trip: "
        f"{r['floor_hbm']:.5f} ms); kernel device time {r['ms']:.5f} ms "
        f"(one wrapper call with its allocation, mean of 2), plain "
        f"{r['plain_ms']:.2f} ms  [{card}]")
    return r


def ert_batch(dev, card, dert, fmi, c, ln, batch, trips, rnd):
    """collect_smems_ert on one batch with the kernels, every descent and
    merged-stage launch recorded, equal to the whole call with the plain
    versions swapped in; then each descent launch as made (passes 1 and
    2) and the merged-stage launch against its plain version; trips: the
    L2 and HBM trips, rnd a warp's round (us). Returns the two descent
    launches' numbers and the merged stage's."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import ert as ops_ert, ert_cuda
    from bwa_mem_scale_tpu_torch.ops import smem, sweep_cuda
    kw = dict(min_seed_len=19, split_len=28, split_width=10,
              max_mem_intv=20, pos_dtype=fmi.pos_dtype,
              seq_len=2 * fmi.l_pac)
    name = "ert_extend_all_positions_cuda"
    real = ert_cuda.ert_extend_all_positions_cuda
    real_merged = sweep_cuda.seed_strategy_merged_cuda
    calls, merged = [], []

    def record(*args, **k):
        calls.append((args, k))
        return real(*args, **k)

    def record_merged(*args, **k):
        merged.append((args, k))
        return real_merged(*args, **k)

    outs = []
    for ext, stage in ((record, record_merged),
                       (ops_ert.ert_extend_all_positions,
                        smem.seed_strategy_merged_plain)):
        setattr(ert_cuda, name, ext)
        sweep_cuda.seed_strategy_merged_cuda = stage
        try:
            outs.append(ops_ert.collect_smems_ert(dert, fmi.ref, c, ln, **kw))
        finally:
            setattr(ert_cuda, name, real)
            sweep_cuda.seed_strategy_merged_cuda = real_merged
    torch.cuda.synchronize()
    bad = [f for f, a, b in zip(outs[0]._fields, *outs)
           if not torch.equal(a, b)]
    if bad or len(calls) != 2 or len(merged) != 1:
        raise SystemExit(f"ert: {batch}: collect_smems_ert differs kernels "
                         f"vs plain in {bad} or made {len(calls)} descent "
                         f"and {len(merged)} merged-stage calls")
    got = outs[0]
    log(f"[ert] {batch}: collect_smems_ert SmemBuf equal with the kernels "
        f"and with the plain versions ({int(got.cnt.sum())} SMEMs, "
        f"{int((got.cnt == got.m.shape[1]).sum())} reads saturated)")
    res = []
    form = "int64" if fmi.pos_dtype == torch.int64 else "int32"
    for n, (args, k) in enumerate(calls):
        B, L = args[2].shape
        what = (f"{batch}, descent launch {n + 1}/2 (pass {n + 1}: B={B}, "
                f"L={L}, {form} form)")
        res.append(ert_launch(dev, card, what, args, k, trips))
    (args, k), = merged
    B, L = args[1].shape
    stage = merged_launch(
        dev, card, f"{batch}, the ERT's merged-stage launch (B={B}, L={L}, "
        f"max_out={args[6]}, {form} form)", real_merged, args, k, trips[0],
        rnd)
    return res, stage


def phase_ert(dev, card, tmp, se, pe, sweep, codes, lens):
    """Phase 12: ERT seeding. Phase 4's genome indexed with the full SA
    (`index -s 0`), `perfect-index -l 101` and `ert-index` (K = 12, depth
    320) through the CLI; SE `mem` with the trie auto-loaded (its main
    path: counts zeroed just before, read just after): phase 4's checks,
    the descent launched twice a device batch and the merged stage once,
    its SAM body equal to `mem --seed-engine sweep` on the same index and
    EMF table without the trie (differing reads only with a cause: the depth cap,
    the count's saturation, a retry tier), and the same at the forced
    int64 layout (the int64 form's main path); PE likewise against the
    sweep; `-v 4` stage seconds of both engines; the descent against its
    plain version on phase 5's batch, a depth-cap batch and phase 5's batch
    at int64; the store with the trie's piece. Returns {kernel name:
    numbers}."""
    import torch
    from bwa_mem_scale_tpu_torch import cli, store
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.ert import build_ert
    from bwa_mem_scale_tpu_torch.ops import ert as ops_ert
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.pipeline import align
    from bwa_mem_scale_tpu_torch.tools.batches import depth_cap_batch
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    t_phase = time.perf_counter()
    g = se["argv"][0]
    e, w = os.path.join(tmp, "e"), os.path.join(tmp, "w")
    secs = {}
    for what, argv in (("index -s 0", ["index", g + ".fa", "-p", e, "-s",
                                       "0"]),
                       ("perfect-index", ["perfect-index", e, "-l",
                                          str(READ_LEN)]),
                       ("ert-index", ["ert-index", e])):
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise SystemExit(f"ert: cli {argv[0]} failed")
        secs[what] = time.perf_counter() - t0
    idx = load_index(e)
    trie = cli.find_ert(e, idx)
    if trie is None or (trie.K, trie.max_depth) != (ERT_K, ERT_DEPTH):
        raise SystemExit("ert: ert-index wrote no readable trie at the "
                         "defaults")
    for ext in (".tpuidx.npz", f".emf{READ_LEN}.npz"):
        os.symlink(e + ext, w + ext)
    log(f"[ert] index -s 0 {secs['index -s 0']:.1f} s, perfect-index "
        f"{secs['perfect-index']:.1f} s, ert-index (K={trie.K}, depth "
        f"{trie.max_depth}) {secs['ert-index']:.1f} s (host); "
        f"{trie.n_nodes} trie nodes, the device record "
        f"{(trie.n_nodes + 1) * 64 / 2 ** 20:.1f} MiB; the file "
        f"{os.path.getsize(f'{e}.ert{ERT_K}.npz') / 2 ** 20:.1f} MiB")

    counted = {**ert_wrappers(), **sweep_wrappers(), **int64_wrappers(),
               "banded_swa_batch": banded_swa_batch_cuda}
    retried = set()
    real_run = align.GpuAligner._run_device

    def run_device(self, fn, codes, lens, L):   # a retry tier's reads
        for i in range(codes.shape[0]):
            retried.add(np.asarray(codes[i, :lens[i]], np.int32).tobytes())
        return real_run(self, fn, codes, lens, L)


    def run(argv, trie_on, wide=False):
        """One `mem` run, its main path's counts: zeroed just before, read
        just after."""
        ctx = forced_int64() if wide else contextlib.nullcontext()
        align.GpuAligner._run_device = run_device
        try:
            with ctx:
                for fn in counted.values():          # ERT path starts here
                    fn.launches = 0
                    if hasattr(fn, "launches64"):
                        fn.launches64 = 0
                PROFILER.totals.clear()
                t0 = time.perf_counter()
                a = cli.mem(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = {k: fn.launches for k, fn in counted.items()}
                n64 = {k: getattr(fn, "launches64", 0)
                       for k, fn in counted.items()}
                # ERT path ends here
        finally:
            align.GpuAligner._run_device = real_run
        hold_route(a, codes, lens, f"phase 12's mem (trie "
                   f"{'on' if trie_on else 'off'}{', int64' if wide else ''})",
                   card)
        a.index_load = PROFILER.totals["index_load"]
        if (a.dert is not None) != trie_on or a.cfg.seed_engine != "sweep":
            raise SystemExit(f"ert: {argv[0]}: the trie {'not ' * trie_on}"
                             f"loaded, or the engine {a.cfg.seed_engine}")
        # (the full SA makes the SA lookup stage's walk one gather)
        want = {"ert_extend": 2, "seed_strategy_merged": 1,
                "expand_and_lookup": 1,
                "chain_seeds": 1, "chain_filter": 1, "banded_swa_batch": 1}
        if not trie_on:
            want.update(ert_extend=0, sweep_extend=2)
        for k, per in want.items():
            if n[k] < per * a.batches:
                raise SystemExit(f"ert: {k} launched {n[k]} times over "
                                 f"{a.batches} batches ({argv[0]})")
        if trie_on and (n["sweep_extend"] or n["one_pos_machine"]
                        or n["seed_strategy_machine"]
                        or n64["ert_extend"] != (n["ert_extend"] if wide
                                                 else 0)):
            raise SystemExit(f"ert: other seeding kernels or forms ran on "
                             f"the ERT path: {n} (int64 forms {n64})")
        return a, wall, n64 if wide else n

    def compare(a_ert, a_sw, p_ert, p_sw, reads, tag):
        """The reads whose SAM lines differ between the engines, each with
        its cause; a read with none fails. reads: each read's codes, in
        input order (r<i> is read i, p<i> reads 2i and 2i + 1)."""
        def by_read(p):
            out = {}
            for ln in sam_body(p):
                if not ln.startswith("@"):
                    out.setdefault(ln.split("\t", 1)[0], []).append(ln)
            return out
        x, y = by_read(p_ert), by_read(p_sw)
        diff = sorted(k for k in set(x) | set(y) if x.get(k) != y.get(k))
        head = [ln for ln in sam_body(p_ert) if ln.startswith("@")]
        if head != [ln for ln in sam_body(p_sw) if ln.startswith("@")]:
            raise SystemExit(f"ert: {tag}: the SAM headers differ")
        causes = []
        for name in diff:
            i = int(name[1:])
            seqs = [reads[j] for j in
                    ((2 * i, 2 * i + 1) if tag == "PE" else (i,))]
            why = []
            if max(len(s) for s in seqs) > trie.max_depth:
                why.append("depth cap")
            if 2 * idx.bns.l_pac + 1 > ops_ert.CNT_MASK:
                why.append("count saturation possible")
            if any(s.tobytes() in retried for s in seqs):
                why.append("retry tier")
            causes.append((name, why))
            log(f"[ert] {tag}: {name} differs between the ERT and the "
                f"sweep: {', '.join(why) or 'no cause'}")
        if any(not why for _, why in causes):
            raise SystemExit(f"ert: {tag}: reads differ for no cause")
        log(f"[ert] {tag} mem with the ERT: SAM body equal to the sweep's "
            f"on the same index and EMF table but for {len(diff)} reads, "
            f"each with its cause; overflow-retried reads ERT "
            f"{a_ert.overflow_retried}, sweep {a_sw.overflow_retried}")

    fq = se["argv"][1]
    common = ["--device", "cuda", "--batch-reads", str(BATCH)]
    ert_sam, sw_sam = os.path.join(tmp, "ert.sam"), os.path.join(tmp,
                                                                  "esw.sam")
    retried.clear()
    al_e, wall_e, n_e = run([e, fq, "-o", ert_sam, *common], True)
    check_sam(ert_sam, se["emf_hit"], se["pos"], se["is_rev"])
    al_s, wall_s, n_s = run([w, fq, "-o", sw_sam, *common, "--seed-engine",
                             "sweep"], False)
    compare(al_e, al_s, ert_sam, sw_sam, reads_of(se), "SE")
    per = {k: float(v) / al_e.batches for k, v in sorted(al_e.stats.items())
           if k.startswith(("ert", "chase"))}
    log(f"[ert] SE mem with the ERT: {N_READS} reads in {wall_e:.2f} s = "
        f"{N_READS / wall_e:.1f} reads/s (the sweep on the same index "
        f"{wall_s:.2f} s = {N_READS / wall_s:.1f}; phase 4, one-hot, "
        f"{se['wall']:.2f} s); index load (the trie's upload and packing "
        f"included) {al_e.index_load:.3f} s (the sweep's "
        f"{al_s.index_load:.3f} s); launches {n_e} over {al_e.batches} "
        f"device batches; per batch: "
        + ", ".join(f"{k} {v:.1f}" for k, v in per.items()) + f"  [{card}]")
    sec = {}
    for tag, argv in (("ERT", [e, fq, "-o", os.path.join(tmp, "e4.sam"),
                               *common]),
                      ("sweep", [w, fq, "-o", os.path.join(tmp, "w4.sam"),
                                 *common, "--seed-engine", "sweep"])):
        sec[tag] = cli.mem(argv + ["-v", "4"]).prof.seconds
    log("[ert -v 4] synchronised stage seconds, ERT (sweep, same index; "
        "phase 4 one-hot): " + ", ".join(
            f"{k} {sec['ERT'][k]:.3f} ({sec['sweep'][k]:.3f}; "
            f"{se['seconds'][k]:.3f})" for k in ("seed", "sal", "chain",
                                                 "bsw")) + f"  [{card}]")
    ert64_sam = os.path.join(tmp, "ert64.sam")
    al64, wall64, n64 = run([e, fq, "-o", ert64_sam, *common], True,
                            wide=True)
    if (al64.fmi.pos_dtype != torch.int64
            or sam_body(ert64_sam) != sam_body(ert_sam)):
        raise SystemExit("ert: the forced int64 SE SAM differs from the "
                         "int32 ERT run's")
    log(f"[ert] SE mem with the ERT at the forced int64 layout: SAM body "
        f"equal to the int32 run's; {wall64:.2f} s = "
        f"{N_READS / wall64:.1f} reads/s; int64-form launches {n64}  "
        f"[{card}]")

    pe_e, pe_w = os.path.join(tmp, "pe_ert.sam"), os.path.join(tmp,
                                                               "pe_esw.sam")
    pe_fq = pe["argv"][1:3]
    retried.clear()
    ap_e, wp_e, np_e = run([e, *pe_fq, "-o", pe_e, *common], True)
    check_pe_sam(pe_e, pe["emf_hit"], pe["pos"], pe["is_rev"])
    ap_s, wp_s, _ = run([w, *pe_fq, "-o", pe_w, *common, "--seed-engine",
                         "sweep"], False)
    compare(ap_e, ap_s, pe_e, pe_w, reads_of(pe), "PE")
    log(f"[ert] PE mem with the ERT: {2 * N_PAIRS} reads in {wp_e:.2f} s = "
        f"{2 * N_PAIRS / wp_e:.1f} reads/s (the sweep {wp_s:.2f} s; phase "
        f"7 {pe['wall']:.2f} s); launches {np_e} over {ap_e.batches} "
        f"batches  [{card}]")

    # the descent against its plain version: (a) phase 5's batch, (b) the
    # depth-cap batch, (c) (a) at the forced int64 layout
    trips = (dependent_trip_us(dev, L2_ROWS),
             dependent_trip_us(dev, HBM_ROWS))
    log(f"[ert] one dependent trip (probe B, chain8_kernel, one lane): "
        f"{trips[0]:.4f} us over {L2_ROWS} rows of 32 bytes (in the L2), "
        f"{trips[1]:.4f} us over {HBM_ROWS} (past it)  [{card}]")
    fmi_e = DeviceFMIndex.from_host(idx, dev)
    dert = ops_ert.DeviceErt.from_host(trie, fmi_e.sa_samples, idx.count,
                                       dev)
    c = torch.as_tensor(codes, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    rnd = sweep["trips"][1]                   # a warp's round, phase 9
    res_a, mg_a = ert_batch(dev, card, dert, fmi_e, c, ln,
                            "(a) phase 5's batch", trips, rnd)
    t0 = time.perf_counter()
    idx_b, codes_b, lens_b = depth_cap_batch(BATCH, 400)
    trie_b = build_ert(idx_b.ref_string, idx_b.sa_samples, K=ERT_K,
                       max_depth=ERT_DEPTH)
    fmi_b = DeviceFMIndex.from_host(idx_b, dev)
    dert_b = ops_ert.DeviceErt.from_host(trie_b, fmi_b.sa_samples,
                                         idx_b.count, dev)
    log(f"[ert] depth-cap batch: 2 Mbp repeat genome at sa_compx 0, its trie "
        f"{trie_b.n_nodes} nodes, built in {time.perf_counter() - t0:.1f} s "
        f"(host)")
    res_b, _ = ert_batch(dev, card, dert_b, fmi_b,
                            torch.as_tensor(codes_b, device=dev),
                            torch.as_tensor(lens_b, device=dev),
                            "(b) depth-cap batch (512 x 400 bp)", trips, rnd)
    if res_b[0]["longest_node"] < ERT_DEPTH - 1:
        raise SystemExit(f"ert: no lane of the depth-cap batch took "
                         f"{ERT_DEPTH - 1} node steps (longest "
                         f"{res_b[0]['longest_node']})")
    del dert_b, fmi_b
    fmi_64 = DeviceFMIndex.from_host(idx, dev, force_int64=True)
    res_c, mg_c = ert_batch(dev, card, dert, fmi_64, c, ln,
                            "(c) phase 5's batch, int64", trips, rnd)
    sw = sweep["sweep_extend"], sweep["seed_strategy_merged"]
    log(f"[ert] engines on phase 5's batch, seeding kernels' device ms: ERT "
        f"{res_a[0]['ms']:.5f} + {res_a[1]['ms']:.5f} + merged stage "
        f"{mg_a['ms']:.5f} ({res_a[0]['node'] + res_a[1]['node']} node, "
        f"{res_a[0]['leaf'] + res_a[1]['leaf']} leaf steps); the sweep with "
        f"the K=11 table (phase 9) {sw[0]['ms']:.5f} (pass 1) + merged "
        f"stage {sw[1]['ms']:.5f}; int64 ERT {res_c[0]['ms']:.5f} + "
        f"{res_c[1]['ms']:.5f} + {mg_c['ms']:.5f}  [{card}]")

    # the store: load-shm stages the trie's piece, mem attaches
    sdir = os.path.join(tmp, "store12")
    real_dir = store.DEFAULT_STORE_DIR
    store.DEFAULT_STORE_DIR = sdir
    try:
        t0 = time.perf_counter()
        if cli.main(["load-shm", e]) != 0:
            raise SystemExit("ert: load-shm failed")
        stage_s = time.perf_counter() - t0
        att = store.attach(e)
        if att is None or not att.has("ert"):
            raise SystemExit("ert: the store has no ert piece")
        st_sam = os.path.join(tmp, "ert_store.sam")
        retried.clear()
        al_st, wall_st, _ = run([e, fq, "-o", st_sam, *common], True)
        if sam_body(st_sam) != sam_body(ert_sam):
            raise SystemExit("ert: mem attached to the store differs from "
                             "the file-loaded ERT run")
        if cli.main(["remove-shm", e]) != 0 or store.attach(e) is not None:
            raise SystemExit("ert: remove-shm left the store")
    finally:
        store.DEFAULT_STORE_DIR = real_dir
    log(f"[ert] store: load-shm staged {sorted(att.pieces)} in "
        f"{stage_s:.2f} s; mem attached to it: SAM body equal to the "
        f"file-loaded ERT run's, {wall_st:.2f} s; remove-shm left no store  "
        f"[{card}]")
    log(f"[ert] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    err = max(r["err"] for r in (*res_a, *res_b))
    return {"launches": n_e["ert_extend"], "launches64": n64["ert_extend"],
            "ert_extend": dict(res_a[0], err=err),
            "ert_extend_int64": dict(res_c[0],
                                     err=max(r["err"] for r in res_c))}


# phase 13, the k-step fold (csrc/fmi_step.cuh ext_kt): its forms, each
# (kernel name in the JSON line, wrapper name, K, source, the TPU loop)
KSTEP_FORMS = (
    ("one_pos_machine_k2", "one_pos_machine", 2, "csrc/smem.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:174"),
    ("one_pos_machine_k3", "one_pos_machine", 3, "csrc/smem.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:174"),
    ("seed_strategy_machine_k2", "seed_strategy_machine", 2, "csrc/smem.cu",
     "bwa_mem_scale_tpu/ops/smem_oh.py:619"),
    ("sweep_extend_k2", "sweep_extend", 2, "csrc/sweep.cu",
     "bwa_mem_scale_tpu/ops/smem.py:109"))
# a block's k-gram row in bytes (index/kstep.py: 40 or 168 int32)
KSTEP_ROW_BYTES = {2: 160, 3: 672}
# how far a dependent trip over a larger table may read below one over
# the 1-step table (beside the turns' spread): both in the L2, one latency
TRIP_SAME = 0.05


def kstep_wrappers():
    """{name: wrapper} of the seeding kernels that take a k-step form."""
    from bwa_mem_scale_tpu_torch.ops import smem_cuda, sweep_cuda
    return {"one_pos_machine": smem_cuda.one_pos_machine_cuda,
            "seed_strategy_machine": smem_cuda.seed_strategy_machine_cuda,
            "sweep_extend": sweep_cuda.sweep_pass_cuda}


def kstep_calls(fmi, dbns, c, ln, opt, cfg, fma):
    """The seeding launches of one batch through seed_chain_extend on fmi
    (one-hot: two passes 1-2 and a pass 3; with `fma`, the sweep: two
    extensions), each as made: {wrapper name: [(args, kwargs)]}."""
    import dataclasses
    from bwa_mem_scale_tpu_torch.ops import smem_oh, sweep_cuda
    from bwa_mem_scale_tpu_torch.pipeline import align
    mods = {"one_pos_machine": (smem_oh, "one_pos_machine_cuda"),
            "seed_strategy_machine": (smem_oh,
                                      "seed_strategy_machine_cuda"),
            "sweep_extend": (sweep_cuda, "sweep_pass_cuda")}
    calls = {name: [] for name in mods}
    real = {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}

    def recorder(name):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return record
    for name, (mod, attr) in mods.items():
        setattr(mod, attr, recorder(name))
    try:
        engine = "sweep" if fma is not None else "onehot"
        align.seed_chain_extend(
            fmi, dbns, c, ln, READ_LEN, opt=opt,
            cfg=dataclasses.replace(cfg, seed_engine=engine), fma=fma)
    finally:
        for name, (mod, attr) in mods.items():
            setattr(mod, attr, real[name])
    return calls


def kstep_launch(dev, card, what, name, args, kw, fmi1, trip, hbm=0.0,
                 twin=False):
    """One k-step launch as made, through walk_launch (every output and
    each lane's steps equal to the plain version's on the same table; the
    sweep's passes through sweep_pass_launch, its floor with one HBM trip
    `hbm` for the FMA start, its bound from the twin with `twin`); then
    the K = 1 form on the same inputs (fmi1): equal outputs and steps,
    its rounds beside. Passes 1-3: floor the longest
    lane's rounds x `trip` (us), one dependent load on the k-gram table's
    footprint; bound the inputs, the outputs and 45 operations a step,
    with `twin` the kernel's twin on the same inputs (each lane's steps
    and rounds equal to the launch's) counting the distinct 32-byte
    k-gram groups the walks read, once each; without, 64 bytes a step.
    Returns the numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem_cuda, smem_oh
    kernel = kstep_wrappers()[name]
    if name == "sweep_extend":
        return kstep_sweep(dev, card, what, args, kw, fmi1, (trip, hbm),
                           twin)
    plain = {"one_pos_machine": smem_oh.one_pos_machine,
             "seed_strategy_machine": smem_oh.seed_strategy_machine}[name]
    n_args = {"one_pos_machine": 11, "seed_strategy_machine": 6}[name]
    args = args[:n_args]
    kw = {k: v for k, v in kw.items() if k != "stats"}
    before = kernel.launches_k
    got, r = walk_launch(dev, what, kernel, plain, args, 1, kw)
    if kernel.launches_k == before:
        raise SystemExit(f"kstep: {what}: no k-step form launched")
    steps, rounds = kernel.last_steps.cpu(), kernel.last_rounds.cpu()
    args1 = (fmi1, *args[1:])
    one = kernel(*args1, **kw)
    steps1 = kernel.last_steps.long()
    rounds1 = kernel.last_rounds.long()
    torch.cuda.synchronize()
    pairs = list(zip(got, one))
    if not all(torch.equal(a, b) for a, b in pairs) or r["steps"] != int(
            steps1.sum()):
        raise SystemExit(f"kstep: {what}: differs from the K = 1 form")
    r.update(rounds1=int(rounds1.sum()), longest_rounds1=int(rounds1.max()),
             floor=r["longest_rounds"] * trip * 1e-3)
    fmi, codes = args[0], args[1]
    B = codes.shape[0]
    pb = fmi.pos_dtype.itemsize
    if name == "one_pos_machine":
        T, M = args[3].shape[0], args[9]
        nbytes = (4 * (codes.numel() + B + 3 * T) + T + (8 + 3 * pb) * T * M
                  + 4 * T)
    else:
        nbytes = 4 * (codes.numel() + B) + (8 + 3 * pb) * B * args[5] + 4 * B
    reads = "64 bytes a step"
    if twin:
        host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                for a in args[1:]]
        fn = (smem_cuda.one_pos_twin if name == "one_pos_machine"
              else smem_cuda.seed_strategy_twin)
        tw = fn(*smem_cuda.twin_tables(fmi)[:3], *host,
                kstep=smem_cuda.kstep_tables(fmi))
        groups = fn.last_reads
        if not (np.array_equal(tw[6], steps.numpy())
                and np.array_equal(tw[7], rounds.numpy())
                and all(isinstance(g, tuple) for g in groups)):
            raise SystemExit(f"kstep: {what}: the twin's steps or rounds "
                             f"differ from the launch's, or it read a "
                             f"1-step row")
        nbytes += 32 * len(groups)
        r["groups"] = len(groups)
        reads = (f"{len(groups)} distinct 32-byte k-gram groups (the twin, "
                 f"its steps and rounds equal)")
    else:
        nbytes += SMEM_BYTES_PER_STEP * r["steps"]
    r["bound"] = bound(nbytes, SMEM_OPS_PER_STEP * r["steps"])
    log(f"[kstep] {what}: equal to the plain version (max_abs_err "
        f"{r['err']}) and to the K = 1 form, steps too; {r['steps']} steps "
        f"(the longest lane {r['longest']}) in {r['rounds']} rounds (the "
        f"longest {r['longest_rounds']}) against K = 1's {r['rounds1']} "
        f"({r['longest_rounds1']}); bound {r['bound'][0]:.6f} ms by "
        f"{r['bound'][1]} (reads: {reads}), latency floor "
        f"{r['floor']:.5f} ms ({r['longest_rounds']} x {trip:.4f} us); "
        f"kernel device time {r['ms']:.5f} ms (mean of 2; the K = 1 form's "
        f"beside it: tools/kstep_before_after.py), plain "
        f"{r['plain_ms']:.2f} ms  [{card}]")
    return r


def kstep_sweep(dev, card, what, args, kw, fmi1, trips, twin):
    """A k-step sweep pass as made, through sweep_pass_launch (every
    SmemBuf field, record and lane's steps equal to the plain version's;
    `trips` = (L2 trip, HBM trip)); then the K = 1 form on the same inputs
    (fmi1): equal outputs and steps, its row fetches beside. Returns the
    numbers."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import sweep_cuda
    kernel = sweep_cuda.sweep_pass_cuda
    args = args[:5]
    kw = {k: v for k, v in kw.items() if k not in ("stats", "stats_key")}
    before = kernel.launches_k
    r = sweep_pass_launch(dev, card, what, args, kw, trips, twin)
    if kernel.launches_k == before:
        raise SystemExit(f"kstep: {what}: no k-step form launched")
    kernel.keep_steps = True
    try:
        got, recs = kernel(*args, **kw)
        one, recs1 = kernel(fmi1, *args[1:], **kw)
    finally:
        kernel.keep_steps = False
    steps1, rounds1 = kernel.last_steps.long(), kernel.last_rounds.long()
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(got, one))
            and all(torch.equal(recs[f], recs1[f]) for f in recs)
            and r["steps"] == int(steps1.sum())):
        raise SystemExit(f"kstep: {what}: differs from the K = 1 form")
    r.update(rounds1=int(rounds1.sum()), longest_rounds1=int(rounds1.max()))
    log(f"[kstep] {what}: equal to the K = 1 form, steps too; "
        f"{r['rounds']} row fetches (the longest {r['longest_rounds']}) "
        f"against K = 1's {r['rounds1']} ({r['longest_rounds1']}); kernel "
        f"device time {r['ms']:.5f} ms  [{card}]")
    return r


def phase_kstep(dev, card, tmp, se, pe, al):
    """Phase 13: the k-step fold. `kstep-table -k 2` and `-k 3` through the
    CLI on phase 4's index (two prefixes linked to its index, EMF and FMA
    tables); SE `mem` with each table (its main path: counts zeroed just
    before, read just after): SAM body byte-equal to phase 4's, every
    passes 1-2 and pass-3 launch a k-step form; PE byte-equal to phase
    7's; SE `--seed-engine sweep` byte-equal to phase 9's, every sweep
    launch a k-step form; `-v 4` stage seconds; then at both tables on
    phase 5's batch collect_smems_oh at the tiers' depths against the
    plain passes, and on it and the repeat batch each k-step launch as
    made against its plain version and the K = 1 form. Returns {form: numbers,
    "launches": {form: main-path launches}, "batches": the two batches,
    "cp2": {(batch, K): k-gram table}, "trips": {batch: {configuration
    ("k1", "int64", "k2", "k3"): a dependent load's us on its table's
    footprint}}, "hbm": one dependent HBM trip's us}."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.index.kstep import build_cp2
    from bwa_mem_scale_tpu_torch.ops import (chain, chain_cuda, sal_cuda,
                                             sweep_cuda)
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.fma import build_fma_table
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.tools.batches import repeat_batch
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    t_phase = time.perf_counter()
    g = se["argv"][0]
    nb = al.fmi.cp_fused.shape[0]
    prefixes = {}
    for K in (2, 3):
        p = os.path.join(tmp, f"k{K}")
        for ext in (".tpuidx.npz", f".emf{READ_LEN}.npz", ".fma11.npz"):
            os.symlink(g + ext, p + ext)
        t0 = time.perf_counter()
        if cli.main(["kstep-table", p, "-k", str(K)]) != 0:
            raise SystemExit(f"kstep: kstep-table -k {K} failed")
        secs = time.perf_counter() - t0
        fmi_k = DeviceFMIndex.from_host(al.idx, dev, cp2=cli.find_cp2(p))
        dbytes = fmi_k.cp_kstep.numel() * 4
        if fmi_k.kstep != K or dbytes != nb * KSTEP_ROW_BYTES[K]:
            raise SystemExit(f"kstep: the K={K} table on the card is "
                             f"{dbytes} bytes, K {fmi_k.kstep}")
        log(f"[kstep] kstep-table -k {K} through the CLI: {secs:.2f} s "
            f"(host: build and write, {os.path.getsize(p + f'.cp{K}.npz')} "
            f"bytes); on the card {dbytes} bytes ({dbytes / 1e6:.1f} MB; "
            f"reckoned {nb} blocks x {KSTEP_ROW_BYTES[K]} B = "
            f"{nb * KSTEP_ROW_BYTES[K] / 1e6:.1f} MB) beside the 1-step "
            f"table's {al.fmi.cp_fused.numel() * 4} bytes  [{card}]")
        prefixes[K] = p
        del fmi_k

    ks = kstep_wrappers()
    counted = {**ks, "expand_and_lookup": sal_cuda.expand_and_lookup_cuda,
               "seed_strategy_merged": sweep_cuda.seed_strategy_merged_cuda,
               "chain_seeds": chain_cuda.chain_seeds_cuda,
               "chain_filter": chain_cuda.chain_filter_cuda,
               "banded_swa_batch": banded_swa_batch_cuda}

    def run(argv, K, sweep):
        """One `mem` run with the K table: its main path's counts (all,
        k-step forms), zeroed just before, read just after; every launch
        of the engine's FM walks a k-step form."""
        for w in counted.values():               # k-step path starts here
            w.launches = w.launches64 = 0
            if hasattr(w, "launches_k"):
                w.launches_k = 0
        PROFILER.totals.clear()
        t1 = time.perf_counter()
        a = cli.mem(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {k: (w.launches, getattr(w, "launches_k", 0))
             for k, w in counted.items()}
        # k-step path ends here
        miss = ~se["emf_hit"]
        hold_route(a, se["codes"][miss], se["lens"][miss], f"phase 13's "
                   f"mem (K = {K}{', sweep' if sweep else ''})", card)
        if a.fmi.kstep != K:
            raise SystemExit(f"kstep: mem did not load the K={K} table")
        walks = ({"sweep_extend": 2, "seed_strategy_merged": 1} if sweep else
                 {"one_pos_machine": 2, "seed_strategy_machine": 1})
        for name, per in walks.items():
            all_, kform = n[name]
            if all_ < per * a.batches or (name in ks and kform != all_):
                raise SystemExit(f"kstep: {name} launched {n[name]} times "
                                 f"(all, k-step form) over {a.batches} "
                                 f"batches")
        idle = ("one_pos_machine", "seed_strategy_machine") if sweep else (
            "sweep_extend",)
        if any(n[name][0] for name in idle):
            raise SystemExit(f"kstep: the other engine's kernels ran: {n}")
        for name in ("expand_and_lookup", "chain_seeds", "chain_filter",
                     "banded_swa_batch"):
            if n[name][0] < a.batches:
                raise SystemExit(f"kstep: {name} launched {n[name][0]} "
                                 f"times over {a.batches} batches")
        return a, wall, {k: v[0] for k, v in n.items()}

    launches, s1 = {}, se["seconds"]
    sweep_sam = os.path.join(tmp, "sweep.sam")
    for K in (2, 3):
        p = prefixes[K]
        argv = [p, se["argv"][1], "-o", os.path.join(tmp, f"k{K}.sam"),
                *se["argv"][4:]]
        a, wall, n = run(argv, K, False)
        if sam_body(argv[3]) != sam_body(se["argv"][3]):
            raise SystemExit(f"kstep: the K={K} SE SAM differs from phase "
                             f"4's")
        launches[f"one_pos_machine_k{K}"] = n["one_pos_machine"]
        if K == 2:
            launches["seed_strategy_machine_k2"] = n["seed_strategy_machine"]
        per = {k: float(v) / a.batches for k, v in sorted(a.stats.items())
               if k.startswith("seed_")}
        log(f"[kstep] SE mem with the K={K} table: SAM body byte-equal to "
            f"phase 4's; {N_READS} reads in {wall:.2f} s = "
            f"{N_READS / wall:.1f} reads/s (phase 4: "
            f"{N_READS / se['wall']:.1f}); launches {n} over {a.batches} "
            f"device batches, every FM-walk launch a k-step form; index load "
            f"{PROFILER.totals['index_load']:.3f} s (phase 4: "
            f"{se['index_load']:.3f}); per batch "
            + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
            + f"  [{card}]")
        a4 = cli.mem(argv + ["-v", "4"])
        sec = a4.prof.seconds
        log(f"[kstep -v 4] K={K}, synchronised stage seconds (phase 4): "
            + ", ".join(f"{k} {sec[k]:.3f} ({s1[k]:.3f})"
                        for k in ("seed", "sal", "chain", "bsw"))
            + f"  [{card}]")
        pe_sam = os.path.join(tmp, f"k{K}_pe.sam")
        pe_argv = [p, *pe["argv"][1:3], "-o", pe_sam, *pe["argv"][5:]]
        a, wall, n = run(pe_argv, K, False)
        if sam_body(pe_sam) != sam_body(pe["argv"][4]):
            raise SystemExit(f"kstep: the K={K} PE SAM differs from phase "
                             f"7's")
        log(f"[kstep] PE mem with the K={K} table: SAM body byte-equal to "
            f"phase 7's; {2 * N_PAIRS} reads in {wall:.2f} s = "
            f"{2 * N_PAIRS / wall:.1f} reads/s (phase 7: "
            f"{2 * N_PAIRS / pe['wall']:.1f}); launches {n}  [{card}]")
        sw_argv = [p, se["argv"][1], "-o", os.path.join(tmp, f"k{K}_sw.sam"),
                   *se["argv"][4:], "--seed-engine", "sweep"]
        a, wall, n = run(sw_argv, K, True)
        if a.dfma is None or sam_body(sw_argv[3]) != sam_body(sweep_sam):
            raise SystemExit(f"kstep: the K={K} sweep SAM differs from "
                             f"phase 9's (or ran without the FMA table)")
        if K == 2:
            launches["sweep_extend_k2"] = n["sweep_extend"]
        log(f"[kstep] SE mem --seed-engine sweep with the K={K} table and "
            f"the K=11 FMA table: SAM body byte-equal to phase 9's; "
            f"{N_READS / wall:.1f} reads/s; launches {n}  [{card}]")

    # each k-step launch of phase 5's batch and the repeat batch, as made,
    # at both tables, held against the K = 1 form on the same inputs; the
    # floors
    # from one dependent load on each table's own footprint (the median of
    # its turns), which may not read below the smaller 1-step table's by
    # more than the turns' spread and TRIP_SAME (two footprints that both
    # fit the L2 read one latency)
    l2s = trip_turns(dev, L2_ROWS)
    l2, hbm = float(np.median(l2s)), dependent_trip_us(dev, HBM_ROWS)
    log(f"[kstep] one dependent trip (probe B, one lane, median of "
        f"{len(l2s)} turns): {l2:.4f} us over {L2_ROWS} rows of 32 bytes "
        f"(the 1-step table; turns {', '.join(f'{t:.4f}' for t in l2s)}), "
        f"{hbm:.4f} us over {HBM_ROWS} (past the L2)  [{card}]")
    first = np.flatnonzero(~se["emf_hit"])[:BATCH]
    idx_r, codes_r, lens_r = repeat_batch(BATCH, READ_LEN)
    fma = cli.find_fma(g)
    batches = (("phase 5's batch", al.idx, al.dbns, se["codes"][first],
                se["lens"][first], fma),
               ("repeat batch", idx_r,
                chain.DeviceBns.from_host(idx_r.bns, dev), codes_r, lens_r,
                None))
    res, cp2s, p5 = {}, {}, "phase 5's batch"
    trips = {}
    for batch, idx, dbns, cc, ll, table in batches:
        c = torch.as_tensor(cc, device=dev)
        ln = torch.as_tensor(ll, device=dev)
        fmi1 = DeviceFMIndex.from_host(idx, dev)
        if table is None:
            table = build_fma_table(fmi1, K=11)
        dtab = table.to_device(torch.int32, dev)
        trips[batch] = {"k1": l2, "int64": l2}
        for K in (2, 3):
            cp2s[batch, K] = build_cp2(idx, K)
            fmi = DeviceFMIndex.from_host(idx, dev, cp2=cp2s[batch, K])
            rows = fmi.cp_kstep.numel() * 4 // 32
            tt = trip_turns(dev, rows)
            trip = trips[batch][f"k{K}"] = float(np.median(tt))
            turns = ", ".join(f"{t:.4f}" for t in tt)
            spread = max(max(tt) - min(tt), max(l2s) - min(l2s))
            if trip < l2 * (1 - TRIP_SAME) - spread:
                raise SystemExit(f"kstep: {batch}, K={K}: a dependent trip "
                                 f"over {rows * 32 / 1e6:.1f} MB (turns "
                                 f"{turns} us) reads below the 1-step "
                                 f"table's {l2:.4f} us over "
                                 f"{L2_ROWS * 32 / 1e6:.1f} MB by more than "
                                 f"the turns' spread and {TRIP_SAME:.0%}")
            log(f"[kstep] {batch}, K={K}: one dependent trip over the "
                f"k-gram table's footprint ({rows} rows of 32 bytes, "
                f"{rows * 32 / 1e6:.1f} MB): {trip:.4f} us (median; turns "
                f"{turns})  [{card}]")
            for depth, rf in ((24, 2), (48, 8), (None, 256)) * (batch == p5):
                before = [w.launches_k for w in ks.values()]
                got, _ = tier_against_plain(fmi, c, ln, al.opt, depth, rf,
                                            dev, card, f"{batch}, K={K}")
                if any(w.launches_k == n
                       for w, n in zip(ks.values(), before[:2])):
                    raise SystemExit(f"kstep: {batch}, K={K}, depth {depth}:"
                                     f" no k-step form launched")
                log(f"[kstep] {batch}, K={K}: collect_smems_oh at depth "
                    f"{depth}, reseed factor {rf}: SmemBuf equal kernels "
                    f"(k-step forms) vs plain passes 1-3 and glue "
                    f"({int(got.cnt.clamp(max=got.m.shape[1]).sum())} SMEMs)")
            for fma_k in (None, dtab):
                calls = kstep_calls(fmi, dbns, c, ln, al.opt, al.cfg,
                                    fma_k)
                for name, made in calls.items():
                    for n, (args, kw) in enumerate(made):
                        what = (f"{batch}, K={K} table, {name} launch "
                                f"{n + 1}/{len(made)}"
                                + (", FMA K=11" if fma_k is not None
                                   else ""))
                        sweep_twin = (batch == p5 and K == 2 and n == 0
                                      and fma_k is not None)
                        r = kstep_launch(
                            dev, card, what, name, args, kw, fmi1, trip,
                            hbm, twin=sweep_twin or (
                                batch == p5 and name != "sweep_extend"))
                        res.setdefault((batch, K, name, fma_k is not None),
                                       []).append(r)
            del fmi
            torch.cuda.empty_cache()
    # the batches, their k-gram tables and the trips, for phase 14
    out = {"launches": launches, "batches": batches, "cp2": cp2s,
           "trips": trips, "hbm": hbm}
    for form, name, K, _, _ in KSTEP_FORMS:
        rs = res[p5, K, name, name == "sweep_extend"]
        out[form] = dict(rs[0], err=max(r["err"] for key, v in res.items()
                                        for r in v if key[2] == name))
    log(f"[kstep] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 14, the readlane engine (csrc/readlane.cu): its forms, each (kernel
# name in the JSON line, wrapper, configuration, the JAX loop it replaces)
READLANE_FORMS = (
    ("readlane_one_pos", "one_pos", "k1",
     "bwa_mem_scale_tpu/ops/smem_rl.py:55"),
    ("readlane_one_pos_int64", "one_pos", "int64",
     "bwa_mem_scale_tpu/ops/smem_rl.py:55"),
    ("readlane_one_pos_k2", "one_pos", "k2",
     "bwa_mem_scale_tpu/ops/smem_rl.py:55"),
    ("readlane_one_pos_k3", "one_pos", "k3",
     "bwa_mem_scale_tpu/ops/smem_rl.py:55"),
    ("readlane_strategy", "strategy", "k1",
     "bwa_mem_scale_tpu/ops/smem_rl.py:603"),
    ("readlane_strategy_int64", "strategy", "int64",
     "bwa_mem_scale_tpu/ops/smem_rl.py:603"),
    ("readlane_strategy_k2", "strategy", "k2",
     "bwa_mem_scale_tpu/ops/smem_rl.py:603"))
# the worker-lane pools held (None: one lane a task)
READLANE_LANES = (None, 256, 64)


def readlane_calls(fmi, c, ln, opt, lanes):
    """collect_smems_rl on one batch with `lanes` worker lanes, its three
    readlane launches recorded as made: (its SmemBuf, [(wrapper name,
    args, kwargs without stats, output, per-lane steps, per-lane
    ticks)])."""
    from bwa_mem_scale_tpu_torch.ops import smem_rl
    real = {"one_pos": smem_rl.readlane_one_pos_cuda,
            "strategy": smem_rl.readlane_strategy_cuda}
    calls = []

    def recorder(name):
        def record(*args, **kw):
            w = real[name]
            out = w(*args, **kw)
            calls.append((name, args,
                          {k: v for k, v in kw.items()
                           if k not in ("stats", "stats_key")},
                          out, w.last_steps, w.last_ticks))
            return out
        return record
    smem_rl.readlane_one_pos_cuda = recorder("one_pos")
    smem_rl.readlane_strategy_cuda = recorder("strategy")
    try:
        bufs = smem_rl.collect_smems_rl(
            fmi, c, ln, min_seed_len=opt.min_seed_len,
            split_len=opt.split_len, split_width=opt.split_width,
            max_mem_intv=opt.max_mem_intv, lanes=lanes)
    finally:
        smem_rl.readlane_one_pos_cuda = real["one_pos"]
        smem_rl.readlane_strategy_cuda = real["strategy"]
    return bufs, calls


def readlane_twin_ticks(name, args, kw):
    """The total ticks of a readlane launch's twin (ops/smem_rl_cuda.py)
    on the launch's inputs: wrapper `name`'s positional `args` and keyword
    `kw` without lanes. The total is the same for every pull order."""
    from bwa_mem_scale_tpu_torch.ops import smem_cuda, smem_rl_cuda
    tb = smem_cuda.twin_tables(args[0])
    host = [a.cpu().numpy() if hasattr(a, "cpu") else a for a in args[1:]]
    kw = {k: v.cpu().numpy() if hasattr(v, "cpu") else v
          for k, v in kw.items()}
    twin = (smem_rl_cuda.readlane_twin if name == "one_pos"
            else smem_rl_cuda.readlane_strategy_twin)
    return int(twin(*tb[:3], *host, **kw, hi_steps=tb[3])[7].sum())


def readlane_batch(dev, card, batch, cfg, fmi, c, ln, opt, trip,
                   twin_ticks):
    """Phase 5's batch or the repeat batch through collect_smems_rl on
    `fmi` (a configuration: K = 1, int64, K = 2 or 3) at each pool of
    READLANE_LANES: the SmemBuf equal to collect_smems_oh at full depth
    and to the same call with the plain glue (plain_glue); each of the
    three launches as made equal to its plain machine on the same inputs (max_abs_err 0; the plain machine's arrays do not depend
    on the pool, tests/test_torch_smem_rl.py, so it runs once, on one lane
    a task) with equal total steps, and at K = 1 total ticks equal to the
    kernels' twins' on the same tasks (a task's rounds do not depend on the
    lane that pulls it, so the total is the same for every pull order; the
    twins run on the first K = 1 configuration of the batch and their
    totals, kept in `twin_ticks` by pass, hold the int64 form too: its
    rounds are the int32 form's);
    its bound (the inputs, 64 bytes and 45 operations a step, the
    outputs), latency floor (the longest lane's ticks, its dependent occ
    trips: passes 1-2 forward row fetches plus backward chunks, pass 3 row
    fetches, x `trip` us) and device ms (mean of 2). Returns {(lanes,
    pass): numbers}."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import smem_rl, smem_rl_cuda
    from bwa_mem_scale_tpu_torch.ops.smem_oh import collect_smems_oh
    fields = ("m", "n", "k", "l", "s", "cnt")
    oh = collect_smems_oh(fmi, c, ln, min_seed_len=opt.min_seed_len,
                          split_len=opt.split_len,
                          split_width=opt.split_width,
                          max_mem_intv=opt.max_mem_intv)
    wrappers = {"one_pos": smem_rl_cuda.readlane_one_pos_cuda,
                "strategy": smem_rl_cuda.readlane_strategy_cuda}
    plains = {"one_pos": smem_rl.one_pos_machine,
              "strategy": smem_rl.seed_strategy_machine}
    pb = fmi.pos_dtype.itemsize
    B, L = c.shape
    plain, res = {}, {}
    for lanes in READLANE_LANES:
        bufs, calls = readlane_calls(fmi, c, ln, opt, lanes)
        torch.cuda.synchronize()
        if not all(torch.equal(getattr(bufs, f), getattr(oh, f))
                   for f in fields):
            raise SystemExit(f"readlane: {batch}, {cfg}, lanes {lanes}: "
                             f"collect_smems_rl differs from "
                             f"collect_smems_oh at full depth")
        with plain_glue(smem_rl):
            glue_want = smem_rl.collect_smems_rl(
                fmi, c, ln, min_seed_len=opt.min_seed_len,
                split_len=opt.split_len, split_width=opt.split_width,
                max_mem_intv=opt.max_mem_intv, lanes=lanes)
        torch.cuda.synchronize()
        if not all(torch.equal(getattr(bufs, f), getattr(glue_want, f))
                   for f in fields):
            raise SystemExit(f"readlane: {batch}, {cfg}, lanes {lanes}: "
                             f"collect_smems_rl differs from the same call "
                             f"with the plain glue")
        if [name for name, *_ in calls] != ["one_pos", "one_pos",
                                            "strategy"]:
            raise SystemExit(f"readlane: {batch}: launches {calls}")
        for p, (name, args, kw, got, steps, ticks) in zip(("p1", "p2", "p3"),
                                                          calls):
            what = f"{batch}, {cfg}, lanes {lanes}, pass {p[1]}"
            if p not in plain:
                one = {k: v for k, v in kw.items() if k != "lanes"}
                fn = plains[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = fn(*args, **one)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                if fmi.kstep == 1 and p not in twin_ticks:
                    twin_ticks[p] = readlane_twin_ticks(name, args, one)
                plain[p] = (args, want, int(fn.last_steps.sum()),
                            twin_ticks[p] if fmi.kstep == 1 else None,
                            plain_ms)
            args0, want, want_steps, want_ticks, plain_ms = plain[p]
            if not all(a is b or not isinstance(a, torch.Tensor)
                       or torch.equal(a, b) for a, b in zip(args, args0)):
                raise SystemExit(f"readlane: {what}: inputs differ from "
                                 f"the one-lane-a-task run's")
            err = max(float((getattr(got, f).double()
                             - getattr(want, f).double()).abs().max())
                      if getattr(got, f).numel() else 0.0 for f in fields)
            if err or not all(torch.equal(getattr(got, f), getattr(want, f))
                              for f in fields):
                raise SystemExit(f"readlane: {what} != plain (max_abs_err "
                                 f"{err})")
            if int(steps.sum()) != want_steps or (
                    fmi.kstep == 1 and want_ticks is not None
                    and int(ticks.sum()) != want_ticks):
                raise SystemExit(f"readlane: {what}: total steps or ticks "
                                 f"differ from the plain machine's or the "
                                 f"twin's")
            w = wrappers[name]
            ms = [device_ms(lambda: w(*args, **kw), 20, dev)
                  for _ in range(2)]
            if name == "one_pos":
                n_tasks, M = args[3].shape[0], args[9]
                R = kw.get("n_rows") or (B if kw.get("out_rows") is None
                                         else n_tasks)
                nbytes = (4 * (c.numel() + B + 4 * n_tasks) + n_tasks
                          + (8 + 3 * pb) * R * M + 4 * R)
            else:
                n_tasks, M = B, args[5]
                nbytes = 4 * (c.numel() + B) + (8 + 3 * pb) * B * M + 4 * B
            total = int(steps.sum())
            longest = int(steps.max())
            rounds = int(ticks.max())
            r = dict(err=err, ms=sum(ms) / 2, plain_ms=plain_ms,
                     steps=total, longest=longest,
                     ticks=int(ticks.sum()), longest_ticks=rounds,
                     lanes=lanes or n_tasks, tasks=n_tasks,
                     bound=bound(nbytes + SMEM_BYTES_PER_STEP * total,
                                 SMEM_OPS_PER_STEP * total),
                     floor=rounds * trip * 1e-3)
            res[lanes, p] = r
            log(f"[readlane] {what} ({r['tasks']} tasks on {r['lanes']} "
                f"lanes): equal to the plain machine (max_abs_err {err}), "
                f"steps {total} (the longest lane {longest}), ticks "
                f"{r['ticks']} (longest {rounds}"
                + ("" if want_ticks is None else ", the twins' total too")
                + f"); bound {r['bound'][0]:.6f} ms by {r['bound'][1]}, "
                f"latency floor {r['floor']:.5f} ms ({rounds} trips x "
                f"{trip:.4f} us); kernel device time {r['ms']:.5f} ms (mean "
                f"of 2), plain {plain_ms:.2f} ms  [{card}]")
    return res


def phase_readlane(dev, card, tmp, se, pe, al, kst):
    """Phase 14: the readlane engine. SE `mem --seed-engine readlane` on
    phase 4's reads (its main path: counts zeroed just before, read just
    after) with the SAM body byte-equal to phase 4's (the one-hot
    engine's), both readlane kernels launched every device batch (passes
    1-2 twice), no one-hot seeding kernel; `-v 4` (the stage table of the
    first batch and the stage seconds); PE byte-equal to phase 7's; SE at
    the forced int64 layout and with phase 13's K = 2 and K = 3 tables,
    each byte-equal to phase 4's and every readlane launch its form's;
    then phase 5's batch and the repeat batch through every form at each
    pool (readlane_batch). Returns {form: numbers, "launches": {form:
    main-path launches}}."""
    import io
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.ops import (chain_cuda, sal_cuda, smem_cuda,
                                             smem_rl_cuda)
    from bwa_mem_scale_tpu_torch.ops.bsw_cuda import banded_swa_batch_cuda
    from bwa_mem_scale_tpu_torch.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu_torch.utils.profiling import PROFILER
    t_phase = time.perf_counter()
    rl = {"one_pos": smem_rl_cuda.readlane_one_pos_cuda,
          "strategy": smem_rl_cuda.readlane_strategy_cuda}
    counted = {**rl, "one_pos_machine": smem_cuda.one_pos_machine_cuda,
               "seed_strategy_machine": smem_cuda.seed_strategy_machine_cuda,
               "expand_and_lookup": sal_cuda.expand_and_lookup_cuda,
               "chain_seeds": chain_cuda.chain_seeds_cuda,
               "chain_filter": chain_cuda.chain_filter_cuda,
               "banded_swa_batch": banded_swa_batch_cuda}


    def run(argv, form, want_sam):
        """One `mem --seed-engine readlane` run, its main path's counts
        (all, int64 form, k-step forms) zeroed just before and read just
        after; every readlane launch the form's."""
        for w in counted.values():          # readlane path starts here
            w.launches = w.launches64 = 0
            if hasattr(w, "launches_k"):
                w.launches_k = 0
        PROFILER.totals.clear()
        t1 = time.perf_counter()
        a = cli.mem(argv + ["--seed-engine", "readlane"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {k: (w.launches, w.launches64, getattr(w, "launches_k", 0))
             for k, w in counted.items()}
        # readlane path ends here
        miss = ~se["emf_hit"]
        hold_route(a, se["codes"][miss], se["lens"][miss],
                   f"phase 14's readlane mem ({form})", card)
        if sam_body(argv[argv.index("-o") + 1]) != sam_body(want_sam):
            raise SystemExit(f"readlane: the {form} SAM differs from the "
                             f"one-hot engine's")
        for name, per in (("one_pos", 2), ("strategy", 1)):
            all_, wide, kform = n[name]
            if all_ < per * a.batches or (
                    (wide, kform) != {"int64": (all_, 0), "k2": (0, all_),
                                      "k3": (0, all_)}.get(form, (0, 0))):
                raise SystemExit(f"readlane: {form}: {name} launched "
                                 f"{n[name]} times (all, int64, k-step) "
                                 f"over {a.batches} batches")
        if n["one_pos_machine"][0] or n["seed_strategy_machine"][0]:
            raise SystemExit(f"readlane: the one-hot kernels ran: {n}")
        for name in ("expand_and_lookup", "chain_seeds", "chain_filter",
                     "banded_swa_batch"):
            if n[name][0] < a.batches:
                raise SystemExit(f"readlane: {name} launched {n[name][0]} "
                                 f"times over {a.batches} batches")
        return a, wall, {k: v[0] for k, v in n.items()}

    g = se["argv"][0]
    se_argv = [g, se["argv"][1], "-o", os.path.join(tmp, "rl.sam"),
               *se["argv"][4:]]
    a, wall, n = run(se_argv, "k1", se["argv"][3])
    launches = {"readlane_one_pos": n["one_pos"],
                "readlane_strategy": n["strategy"]}
    per = {k: float(v) / a.batches for k, v in sorted(a.stats.items())
           if k.startswith("rl_")}
    log(f"[readlane] SE mem --seed-engine readlane: SAM body byte-equal to "
        f"phase 4's (one-hot); {N_READS} reads in {wall:.2f} s = "
        f"{N_READS / wall:.1f} reads/s (phase 4: {N_READS / se['wall']:.1f}); "
        f"launches {n} over {a.batches} device batches; index load "
        f"{PROFILER.totals['index_load']:.3f} s; per batch, the longest "
        f"lane's "
        + ", ".join(f"{k} {v:.1f}" for k, v in per.items()) + f"  [{card}]")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        a4 = cli.mem(se_argv + ["--seed-engine", "readlane", "-v", "4"])
    table = err.getvalue().split("\nDevice stage profile")
    if len(table) != 2:
        raise SystemExit("readlane: -v 4 printed no stage table")
    for ln in ("Device stage profile" + table[1]).splitlines()[:5]:
        log(f"[readlane -v 4] {ln}")
    sec = a4.prof.seconds
    log("[readlane -v 4] synchronised stage seconds, readlane (phase 4, "
        "one-hot): " + ", ".join(f"{k} {sec[k]:.3f} ({se['seconds'][k]:.3f})"
                                 for k in ("seed", "sal", "chain", "bsw"))
        + f"  [{card}]")
    pe_argv = [g, *pe["argv"][1:3], "-o", os.path.join(tmp, "rl_pe.sam"),
               *pe["argv"][5:]]
    a, wall, n = run(pe_argv, "k1", pe["argv"][4])
    log(f"[readlane] PE mem --seed-engine readlane: SAM body byte-equal to "
        f"phase 7's; {2 * N_PAIRS} reads in {wall:.2f} s = "
        f"{2 * N_PAIRS / wall:.1f} reads/s (phase 7: "
        f"{2 * N_PAIRS / pe['wall']:.1f}); launches {n}  [{card}]")
    with forced_int64():
        a, wall, n = run(se_argv, "int64", se["argv"][3])
    launches["readlane_one_pos_int64"] = n["one_pos"]
    launches["readlane_strategy_int64"] = n["strategy"]
    log(f"[readlane] SE at the forced int64 layout: SAM body byte-equal to "
        f"phase 4's; {N_READS / wall:.1f} reads/s; launches {n}  [{card}]")
    for K in (2, 3):
        argv = [os.path.join(tmp, f"k{K}"), *se_argv[1:]]
        a, wall, n = run(argv, f"k{K}", se["argv"][3])
        launches[f"readlane_one_pos_k{K}"] = n["one_pos"]
        if K == 2:
            launches["readlane_strategy_k2"] = n["strategy"]
        log(f"[readlane] SE with the K={K} table: SAM body byte-equal to "
            f"phase 4's; {N_READS / wall:.1f} reads/s; launches {n}  "
            f"[{card}]")

    res = {}
    for batch, idx, _, cc, ll, _ in kst["batches"]:
        c = torch.as_tensor(cc, device=dev)
        ln = torch.as_tensor(ll, device=dev)
        fmis = {"k1": DeviceFMIndex.from_host(idx, dev),
                "int64": DeviceFMIndex.from_host(idx, dev, force_int64=True),
                **{f"k{K}": DeviceFMIndex.from_host(
                    idx, dev, cp2=kst["cp2"][batch, K]) for K in (2, 3)}}
        twin_ticks = {}
        for cfg, fmi in fmis.items():
            trip = kst["trips"][batch][cfg]
            res[batch, cfg] = readlane_batch(dev, card, batch, cfg, fmi, c,
                                             ln, al.opt, trip, twin_ticks)
        del fmis
        torch.cuda.empty_cache()
    p5 = "phase 5's batch"
    out = {"launches": launches}
    for form, name, cfg, _ in READLANE_FORMS:
        passes = ("p1", "p2") if name == "one_pos" else ("p3",)
        r = res[p5, cfg][None, passes[0]]
        out[form] = dict(r, err=max(v["err"] for (b, c_), rs in res.items()
                                    if c_ == cfg for (_, p), v in rs.items()
                                    if p in passes))
        pools = ", ".join(
            f"lanes {lanes}: {res[p5, cfg][lanes, passes[0]]['ms']:.5f} ms"
            for lanes in READLANE_LANES)
        log(f"[readlane] {form} on phase 5's batch, pass "
            f"{passes[0][1]}: {pools}; the repeat batch at one lane a task "
            f"{res['repeat batch', cfg][None, passes[0]]['ms']:.5f} ms  "
            f"[{card}]")
    log(f"[readlane] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 15, several devices and hosts, and the device DP loops of the CIGAR
# DP (csrc/kswg.cu) and mate rescue (csrc/kswa.cu): phase 4's reads and
# phase 7's pairs on the mesh (SE batches, PE batches, stream feeds), the
# long reads of the CIGAR jobs
MESH_SE, MESH_PE, MESH_STREAM = 2048, 512, 1536
RESCUE_PAIRS = 512
LONG_JOBS = (16, 800, 2500)
# integer operations a band cell of the CIGAR DP (csrc/kswg.cu): the
# profile 4, M / pre / direction 6, the F key and the scan's share 4, F 3,
# H / E / the bits 8
KSWG_OPS_PER_CELL = 25
# a DP cell of the rescue SW (csrc/kswa.cu): the score lookup 2, M 1, H'
# 3, the F key 2, the scans' share 2, F 2, H 3, E 4, the row maximum 1
KSWA_OPS_PER_CELL = 20
# the switches that send PE mem down the Python PE path, the device CIGAR
# DP and the device rescue SW (the JAX package's)
SWITCHES = ("BWA_TPU_NO_NATIVE_PE", "BWA_TPU_NO_NATIVE_KSWG",
            "BWA_TPU_NO_NATIVE_KSWA")


def write_rescue_pairs(tmp, bns):
    """RESCUE_PAIRS FR pairs as write_pairs makes them (r1.fq, r2.fq in
    `tmp`), every fourth read 2 with every tenth base changed: no 19-mer
    seed, so only mate rescue places it (tools/batches.py::
    rescue_pairs)."""
    from bwa_mem_scale_tpu_torch.index.bntseq import decode_bases
    from bwa_mem_scale_tpu_torch.tools.batches import rescue_pairs
    codes = rescue_pairs(bns, RESCUE_PAIRS, READ_LEN, INSERT, INSERT_SD)
    for mate in (0, 1):
        with open(os.path.join(tmp, f"r{mate + 1}.fq"), "w") as f:
            for i in range(mate, 2 * RESCUE_PAIRS, 2):
                f.write(f"@p{i // 2}\n{decode_bases(codes[i])}\n+\n"
                        f"{'I' * READ_LEN}\n")


def mesh_sites():
    """The main path's kernel call sites a mesh shard goes through:
    {(module, attribute): kernel name}."""
    from bwa_mem_scale_tpu_torch.ops import sal, smem_oh
    from bwa_mem_scale_tpu_torch.pipeline import align
    return {(smem_oh, "one_pos_machine_cuda"): "one_pos_machine",
            (smem_oh, "seed_strategy_machine_cuda"): "seed_strategy_machine",
            (sal, "expand_and_lookup_cuda"): "expand_and_lookup",
            (align, "chain_seeds_cuda"): "chain_seeds",
            (align, "chain_filter_cuda"): "chain_filter",
            (align, "emf_lookup_cuda"): "emf_lookup",
            (smem_oh, "reseed_tasks_cuda"): "reseed_tasks",
            (smem_oh, "merge_smems_cuda"): "merge_smems",
            **{(align, attr): name for name, attr, _ in EXT_KERNELS}}


@contextlib.contextmanager
def shard_counts():
    """Counts each main-path kernel's calls by the mesh shard that makes
    them ({(kernel, shard): calls}; shard None outside a mesh worker)."""
    import collections
    import threading
    from bwa_mem_scale_tpu_torch.parallel.mesh import current_shard
    counts, lock = collections.Counter(), threading.Lock()
    real = {site: getattr(*site) for site in mesh_sites()}

    def recorder(name, fn):
        def record(*args, **kw):
            with lock:
                counts[name, current_shard()] += 1
            return fn(*args, **kw)
        return record

    for (mod, attr), name in mesh_sites().items():
        setattr(mod, attr, recorder(name, real[mod, attr]))
    try:
        yield counts
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)


def rec_key(recs):
    return [[(r.rid, r.pos, r.flag, r.mapq, tuple(r.cigar or ()), r.NM, r.MD)
             for r in rr] for rr in recs]


@contextlib.contextmanager
def recording(mod, attr, calls):
    """mod.attr records each call's arguments in `calls`."""
    real = getattr(mod, attr)

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    setattr(mod, attr, record)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def row_step_us(dev, kind):
    """One row step of a pair alone, from two lengths (1,024 and 2,048
    rows) of one synthetic job: the difference of the device times over
    the difference of the rows. kswg: a band of 31 positions (a strip of
    one a lane) and its traceback step; kswa: a 128-column query (its
    score reaching minsc: the reverse scan the same at both lengths),
    whose rows add a wavefront step each ROWS."""
    import torch
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.ops import kswa_cuda, kswg_cuda
    opt = MemOptions()
    rng = np.random.RandomState(5)
    t = {}
    for n in (1024, 2048):
        s = rng.randint(0, 4, n).astype(np.int32)
        if kind == "kswg":
            args = [torch.as_tensor(x, device=dev) for x in (
                s[None], np.array([n], np.int32), s[None],
                np.array([n], np.int32), np.array([15], np.int32))]
            t[n] = device_ms(lambda: kswg_cuda.launch(
                *args, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.mat,
                15), 20, dev)
        else:
            q = s[:128][None].copy()
            args = [torch.as_tensor(x, device=dev) for x in (
                q, np.array([128], np.int32), s[None],
                np.array([n], np.int32))]
            t[n] = device_ms(lambda: kswa_cuda.launch(
                *args, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                opt.min_seed_len * opt.a, int(opt.mat.max())), 20, dev)
    return (t[2048] - t[1024]) * 1e3 / 1024


def kswg_launch(dev, card, args, what):
    """One captured CIGAR-DP call against its plain version, with its
    jobs, DP cells, bound, latency floors and times. Floors: the longest
    pair's rows x a row step measured here (this design's), and (the
    longest pair's rows + its traceback steps) x one dependent round of a
    warp in shared memory (tools/round_cost.py, same run), which no design
    of the DP goes below."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import kswg_cuda
    from bwa_mem_scale_tpu_torch.ops.kswg import ksw_global_batch
    from bwa_mem_scale_tpu_torch.tools.round_cost import round_us
    got = kswg_cuda.ksw_global_batch_cuda(*args)
    t0 = time.perf_counter()
    want = ksw_global_batch(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
              for x, y in zip(got, want))
    if err:
        raise SystemExit(f"kswg: {what}: the kernel != plain (max_abs_err "
                         f"{err})")
    qs, ql, ts, tl, wp = (x.cpu().numpy() for x in args[:5])
    cells = kswg_cuda.band_cells(ql, tl, wp)
    live = int(((ql > 0) & (tl > 0)).sum())
    nbytes = sum(x.numel() * x.element_size() for x in args[:5]) + sum(
        x.numel() * x.element_size() for x in got)
    b = bound(nbytes, int(cells.sum()) * KSWG_OPS_PER_CELL)
    w_max = int(wp.max())
    R, S = kswg_cuda.strip(w_max, qs.shape[1], ts.shape[1])
    rest, zrb, zsb = kswg_cuda.launch_plan(dev, *qs.shape, ts.shape[1],
                                           w_max)
    ms = device_ms(lambda: kswg_cuda.launch(*args[:5], *args[5:], w_max),
                   10, dev)
    step = row_step_us(dev, "kswg")
    floor_ms = int(tl.max()) * step / 1e3
    chain = np.clip(tl, 0, ts.shape[1]) + want.n_ops.cpu().numpy()
    per_round = round_us(dev)
    floor_round = int(chain.max()) * per_round / 1e3
    state = ", the segments' state in global memory" if zsb else ""
    log(f"[kswg] {what}: {live} jobs (P={qs.shape[0]}, QL={qs.shape[1]}, "
        f"TL={ts.shape[1]}), {int(cells.sum())} band cells, the widest "
        f"band's strip {R} positions a lane x {S} segment(s), its rows of "
        f"directions {'in tiles' if zrb else 'in shared memory'} ("
        f"{rest} bytes past the codes{state}); bound {b[0]:.5f} ms ({b[1]}); "
        f"latency floor {floor_round:.5f} "
        f"ms (the longest pair's rows + traceback steps, {int(chain.max())}"
        f", x {per_round:.4f} us, a warp's dependent round, measured); "
        f"this design's {floor_ms:.5f} ms (the longest pair's "
        f"{int(tl.max())} rows x a row step of {step:.4f} us, a 31-position "
        f"row and its traceback step, measured); kernel {ms:.5f} ms, plain "
        f"{plain_ms:.1f} ms; max_abs_err {err}  [{card}]")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=b, floor=floor_ms,
                floor_round=floor_round, step_us=step)


def kswa_launch(dev, card, args, what):
    """One captured rescue-SW call against its plain version, with its
    jobs, DP cells, bound, latency floor and times. Floor: the longest
    job's wavefront steps (both scans: rows + the pipeline's depth each,
    the kernel's count) x a step measured here (row_step_us)."""
    import torch
    from bwa_mem_scale_tpu_torch.ops import kswa_cuda
    from bwa_mem_scale_tpu_torch.ops.kswa import ksw_align_batch
    got = kswa_cuda.ksw_align_batch_cuda(*args)
    steps = kswa_cuda.ksw_align_batch_cuda.last_steps
    t0 = time.perf_counter()
    want = ksw_align_batch(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
              for x, y in zip(got, want))
    if err:
        raise SystemExit(f"kswa: {what}: the kernel != plain (max_abs_err "
                         f"{err})")
    q, ql, t, tl = (x.cpu().numpy() for x in args[:4])
    r = {f: getattr(want, f).cpu().numpy() for f in want._fields}
    # the forward scan's cells, and the reverse scan's rows (to the row
    # that reaches the score) over its qe + 1 columns
    ok = (r["score"] > 0) & (r["score"] >= args[9])
    rev_rows = np.where(ok & (r["tb"] >= 0), r["te"] - r["tb"] + 1,
                        np.where(ok, r["te"] + 1, 0))
    cells = (ql.astype(np.int64) * tl + rev_rows * (r["qe"] + 1)).sum()
    nbytes = sum(x.numel() * x.element_size() for x in args[:4]) + 7 * 4 * \
        q.shape[0]
    b = bound(nbytes, int(cells) * KSWA_OPS_PER_CELL)
    ms = device_ms(lambda: kswa_cuda.launch(*args), 10, dev)
    longest = int(steps.max())
    row_us = row_step_us(dev, "kswa")
    step = row_us * kswa_cuda.ROWS          # a step: ROWS rows a lane
    floor_ms = longest * step / 1e3
    log(f"[kswa] {what}: {q.shape[0]} jobs (L={q.shape[1]}, T={t.shape[1]}, "
        f"K={kswa_cuda.k_for(q.shape[1])} columns a lane), {int(cells)} DP "
        f"cells, the longest job {int((tl + rev_rows).max())} rows (both "
        f"scans) and {longest} wavefront steps; bound {b[0]:.5f} ms "
        f"({b[1]}); latency floor {floor_ms:.5f} ms (the longest job's "
        f"{longest} steps x a wavefront step of {step:.4f} us, "
        f"{kswa_cuda.ROWS} rows of {row_us:.4f} us, measured); "
        f"kernel {ms:.5f} ms, plain {plain_ms:.1f} ms; max_abs_err {err}  "
        f"[{card}]")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=b, floor=floor_ms,
                steps=longest, step_us=step, row_us=row_us)


def phase_mesh(dev, card, tmp, se, pe):
    """Phase 15: (a) phase 4's reads and phase 7's pairs on a mesh of two
    devices (two cards, or the one card twice), records equal to one
    device's, each main-path kernel and the sharded EMF probe launched on
    every shard; (b) `mem` on two hosts joined by --coordinator, and
    `mem --devices 2`; (c) the CIGAR DP and rescue SW kernels against
    their plain versions on jobs the path made; (d) PE `mem` under the
    JAX package's switches; (e) tools/multichip.py on the mesh."""
    import socket
    import subprocess
    import torch
    from bwa_mem_scale_tpu_torch import cli
    from bwa_mem_scale_tpu_torch.config import MemOptions
    from bwa_mem_scale_tpu_torch.index.artifacts import load_index
    from bwa_mem_scale_tpu_torch.index.perfect import load_perfect_table
    from bwa_mem_scale_tpu_torch.ops import kswa_cuda, kswg_cuda
    from bwa_mem_scale_tpu_torch.parallel.mesh import Mesh
    from bwa_mem_scale_tpu_torch.pipeline.align import (GpuAligner,
                                                        PipelineConfig)
    from bwa_mem_scale_tpu_torch.pipeline.stream import SeStream
    from bwa_mem_scale_tpu_torch.tools.multichip import dryrun_multichip
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    mesh = Mesh(["cuda:0", "cuda:1"] if n_cards >= 2 else ["cuda:0"] * 2)
    g = os.path.join(tmp, "g")
    idx = load_index(g)
    emf = load_perfect_table(g + ".emf101.npz")
    cfg = PipelineConfig(seed_engine="onehot")

    # (a) the mesh against one device
    se_c, se_l = se["codes"][:MESH_SE], se["lens"][:MESH_SE]
    pe_c, pe_l = pe["codes"][:2 * MESH_PE], pe["lens"][:2 * MESH_PE]
    st_c, st_l = se["codes"][-MESH_STREAM:], se["lens"][-MESH_STREAM:]
    outs, walls = {}, {}
    for key, m in (("one", None), ("mesh", mesh)):
        al = GpuAligner(idx, dev, MemOptions(), cfg, emf=emf, mesh=m)
        with shard_counts() as counts:        # the mesh's path starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = []
            for b in range(0, MESH_SE, BATCH):
                recs += al.align_and_finalize(se_c[b: b + BATCH],
                                              se_l[b: b + BATCH], b)
            pe_recs, mates = [], []
            for b in range(0, 2 * MESH_PE, BATCH):
                r, mt = al.align_pairs_and_finalize(pe_c[b: b + BATCH],
                                                    pe_l[b: b + BATCH], b)
                pe_recs += r
                mates += [None if x is None else (x.rid, x.pos, x.is_rev)
                          for x in mt]
            st = SeStream(al, BATCH, READ_LEN)
            for b in range(0, MESH_STREAM, BATCH):
                st.feed(st_c[b: b + BATCH], st_l[b: b + BATCH], b)
            st.flush()
            got = dict(st.ready())
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            shard_calls = dict(counts)       # the mesh's path ends here
        outs[key] = (rec_key(recs), rec_key(pe_recs), mates,
                     rec_key([got[i] for i in range(MESH_STREAM)]))
        if key == "mesh":
            hold_route(al, se_c, se_l, "phase 15's mesh", card)
    for i, what in enumerate(("SE align_and_finalize", "PE "
                              "align_pairs_and_finalize", "PE mates",
                              "SeStream")):
        if outs["mesh"][i] != outs["one"][i]:
            raise SystemExit(f"mesh: {what} records differ from one "
                             f"device's")
    names = sorted(set(mesh_sites().values()))
    missing = [(n, s) for n in names for s in range(mesh.size)
               if not shard_calls.get((n, s))]
    if missing:
        raise SystemExit(f"mesh: kernels not launched on every shard: "
                         f"{missing}")
    for s, d in enumerate(mesh):
        log(f"[mesh] shard {s} on {d}: launches "
            + ", ".join(f"{n} {shard_calls[n, s]}" for n in names))
    log(f"[mesh] {MESH_SE} SE reads (align_and_finalize, the device EMF "
        f"probe sharded), {MESH_PE} pairs and {MESH_STREAM} streamed reads "
        f"on {mesh}: records equal to one device's; wall {walls['mesh']:.2f}"
        f" s on the mesh, {walls['one']:.2f} s on one device (host clock; "
        f"no scaling claimed)  [{card}]")

    # (b) two hosts, and --devices 2
    with open(se["argv"][3]) as f:
        body4 = [ln for ln in f if not ln.startswith("@")]
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwa_mem_scale_tpu_torch.cli", "mem",
         *se["argv"][:2], "-o", os.path.join(tmp, f"host{i}.sam"),
         *se["argv"][4:], "--num-hosts", "2", "--host-id", str(i),
         "--coordinator", f"localhost:{port}"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0 or f"* torch.distributed: host {i}/2" not in err:
            raise SystemExit(f"hosts: host {i} failed ({p.returncode}):\n"
                             f"{err[-2000:]}")
    parts = []
    for i in range(2):
        with open(os.path.join(tmp, f"host{i}.sam")) as f:
            parts.append([ln for ln in f if not ln.startswith("@")])
    if sorted(parts[0] + parts[1]) != sorted(body4):
        raise SystemExit("hosts: the two parts' union != phase 4's SAM body")
    log(f"[hosts] mem --num-hosts 2 --coordinator localhost:{port}, two "
        f"processes on the card: parts of {len(parts[0])} and "
        f"{len(parts[1])} lines, their union byte-equal to phase 4's SAM "
        f"body; {time.perf_counter() - t0:.1f} s")
    dev_argv = [*se["argv"][:2], "-o", os.path.join(tmp, "devices.sam"),
                *se["argv"][4:], "--devices", "2"]
    if n_cards < 2:
        try:
            cli.mem(dev_argv)
        except SystemExit as e:
            if str(e) != f"--devices 2 but only {n_cards} available":
                raise
            log(f"[hosts] mem --devices 2 on one card fails with the JAX "
                f"CLI's message: {e}")
        else:
            raise SystemExit("hosts: mem --devices 2 ran on one card")
    else:
        cli.mem(dev_argv)
        with open(os.path.join(tmp, "devices.sam")) as f:
            if [ln for ln in f if not ln.startswith("@")] != body4:
                raise SystemExit("hosts: mem --devices 2 SAM body != phase "
                                 "4's")
        log("[hosts] mem --devices 2: SAM body byte-equal to phase 4's")

    # (d) PE mem under the switches, the CIGAR and rescue calls recorded:
    # phase 7's pairs, then RESCUE_PAIRS whose read 2 has no seed in every
    # fourth pair (few of phase 7's mates need rescue)
    cigar_calls, rescue_calls = [], []
    sw_sam = os.path.join(tmp, "pe_sw.sam")
    rs_dir = os.path.join(tmp, "rescue")
    os.mkdir(rs_dir)
    write_rescue_pairs(rs_dir, idx.bns)
    runs = ([*pe["argv"][:4], sw_sam, *pe["argv"][5:]],
            [g, os.path.join(rs_dir, "r1.fq"), os.path.join(rs_dir, "r2.fq"),
             "-o", os.path.join(rs_dir, "pe_sw.sam"), *pe["argv"][5:]])
    os.environ.update({k: "1" for k in SWITCHES})
    kswg_cuda.ksw_global_batch_cuda.launches = 0    # the path starts here
    kswa_cuda.ksw_align_batch_cuda.launches = 0
    try:
        with recording(kswg_cuda, "ksw_global_batch_cuda", cigar_calls), \
                recording(kswa_cuda, "ksw_align_batch_cuda", rescue_calls):
            walls = []
            for argv in runs:
                t0 = time.perf_counter()
                cli.mem(argv)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if argv is runs[0]:
                    n7 = (len(cigar_calls), len(rescue_calls))
    finally:
        for k in SWITCHES:
            del os.environ[k]
    launches = {"kswg": kswg_cuda.ksw_global_batch_cuda.launches,
                "kswa": kswa_cuda.ksw_align_batch_cuda.launches}
    # the path ends here
    check_pe_sam(sw_sam, pe["emf_hit"], pe["pos"], pe["is_rev"])
    if not launches["kswg"] or not launches["kswa"]:
        raise SystemExit(f"switches: a device DP kernel was never launched "
                         f"({launches})")
    with open(pe["argv"][4]) as f1, open(sw_sam) as f2:
        a7 = [ln for ln in f1 if not ln.startswith("@")]
        b7 = [ln for ln in f2 if not ln.startswith("@")]
    n_diff = sum(x != y for x, y in zip(a7, b7)) + abs(len(a7) - len(b7))
    log(f"[switches] PE mem with {', '.join(SWITCHES)} on phase 7's pairs: "
        f"the phase 7 gate passed; {n_diff} of {len(a7)} SAM lines differ "
        f"from phase 7's; {2 * N_PAIRS / walls[0]:.1f} reads/s; "
        f"{n7[0]} CIGAR DP and {n7[1]} rescue calls; on {RESCUE_PAIRS} "
        f"pairs with seedless mates {2 * RESCUE_PAIRS / walls[1]:.1f} "
        f"reads/s, {len(cigar_calls) - n7[0]} CIGAR DP and "
        f"{len(rescue_calls) - n7[1]} rescue calls; launches {launches}  "
        f"[{card}]")

    # (c) the two kernels against their plain versions on the path's jobs
    rl_fq = os.path.join(tmp, "cigar_long.fq")
    fwd = np.asarray(idx.ref_string[: idx.bns.l_pac], np.uint8)
    _, _, reads = write_long_reads(rl_fq, fwd, *LONG_JOBS, seed=33)
    L = max(len(r) for r in reads)
    c = np.full((len(reads), L), 4, np.int32)
    for i, r in enumerate(reads):
        c[i, : len(r)] = r
    ln = np.array([len(r) for r in reads], np.int32)
    al = GpuAligner(idx, dev, MemOptions(), cfg)
    regs = al.align_batch(c, ln)
    long_calls = []
    os.environ["BWA_TPU_NO_NATIVE_KSWG"] = "1"
    try:
        with recording(kswg_cuda, "ksw_global_batch_cuda", long_calls):
            al._records_from_regs(c, ln, np.ones(len(reads), bool), regs,
                                  np.arange(len(reads)))
    finally:
        del os.environ["BWA_TPU_NO_NATIVE_KSWG"]
    g_pe = kswg_launch(dev, card, max(cigar_calls, key=lambda a: a[0].shape[0]),
                       "phase 7's Python PE path, its largest call")
    g_long = kswg_launch(dev, card, long_calls[0],
                         f"{LONG_JOBS[0]} long reads of phase 10's kind "
                         f"({LONG_JOBS[1]}-{LONG_JOBS[2]} bp)")
    biggest = max(range(len(rescue_calls)),
                  key=lambda i: rescue_calls[i][0].shape[0])
    a_pe = kswa_launch(dev, card, rescue_calls[biggest],
                       "the largest rescue batch, of "
                       + ("phase 7's pairs" if biggest < n7[1] else
                          "the pairs with seedless mates"))

    # (e) the multichip twin on the mesh
    log(f"[multichip] {dryrun_multichip(mesh)}")
    log(f"[mesh] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches,
                kswg=dict(g_pe, err=max(g_pe["err"], g_long["err"])),
                kswa=a_pe)


# phase 16's switches: the Python finalize path, alone and with the CIGAR
# DP on the card
FINALIZE_RUNS = ({"BWA_TPU_NO_NATIVE_FINALIZE": "1"},
                 {"BWA_TPU_NO_NATIVE_FINALIZE": "1",
                  "BWA_TPU_NO_NATIVE_KSWG": "1"})


def phase_finalize(dev, card, tmp, se, pe):
    """Phase 16: phase 4's reads and phase 7's pairs through `mem` under
    BWA_TPU_NO_NATIVE_FINALIZE (the Python record path and SAM writer),
    alone and with BWA_TPU_NO_NATIVE_KSWG: each run's main path (counts
    zeroed just before, read just after), phase 4's or phase 7's gate,
    each main-path kernel launched at least once a device batch (passes
    1-2 twice), the bare SA walk never, the CIGAR DP kernel exactly when
    _KSWG is set; reads/s beside the native run's and the SAM lines that
    differ from it. Returns {run: numbers}."""
    import torch
    from bwa_mem_scale_tpu_torch import cli
    t0 = time.perf_counter()
    wrappers = main_path_wrappers()
    res = {}
    for env in FINALIZE_RUNS:
        tag = "+_KSWG" if len(env) > 1 else ""
        for kind, run in (("SE", se), ("PE", pe)):
            n_in = 1 if kind == "SE" else 2       # FASTQ files
            out = os.path.join(tmp, f"fin_{kind}{len(env)}.sam")
            argv = [*run["argv"][:1 + n_in], "-o", out,
                    *run["argv"][3 + n_in:]]
            os.environ.update(env)
            try:
                for w in wrappers.values():      # the path starts here
                    w.launches = 0
                t1 = time.perf_counter()
                al = cli.mem(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches = {n: w.launches for n, w in wrappers.items()}
                # the path ends here
            finally:
                for k in env:
                    del os.environ[k]
            if kind == "SE":
                check_sam(out, se["emf_hit"], se["pos"], se["is_rev"])
            else:
                check_pe_sam(out, pe["emf_hit"], pe["pos"], pe["is_rev"])
            for name, n in launches.items():
                want = {"one_pos_machine": 2 * al.batches, "sa_walk": 0,
                        "ksw_global_batch": 1 if tag else 0}.get(
                    name, al.batches)
                if n < want or (want == 0 and n):
                    raise SystemExit(
                        f"finalize{tag}: {kind} {name} launched {n} times "
                        f"over {al.batches} device batches")
            a, b = (sam_body(run["argv"][2 + n_in]), sam_body(out))
            n_diff = (sum(x != y for x, y in zip(a, b))
                      + abs(len(a) - len(b)))
            n_reads = N_READS if kind == "SE" else 2 * N_PAIRS
            log(f"[finalize{tag}] {kind} mem under "
                f"{', '.join(env)}: phase {4 if kind == 'SE' else 7}'s gate "
                f"passed; {n_reads / wall:.1f} reads/s ({wall:.2f} s; the "
                f"native run, phase {4 if kind == 'SE' else 7}: "
                f"{n_reads / run['wall']:.1f}); {n_diff} of {len(a)} SAM "
                f"lines differ from it; launches {launches} over "
                f"{al.batches} device batches; overflow-retried reads "
                f"{al.overflow_retried}  [{card}]")
            res[kind + tag] = dict(wall=wall, n_diff=n_diff,
                                   launches=launches)
    log(f"[finalize] phase 16 took {time.perf_counter() - t0:.1f} s")
    return res


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    card = card_line(dev)
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name} x{torch.cuda.device_count()}")

    from bwa_mem_scale_tpu_torch.ops import bsw_cuda, chain_cuda, nvcc_build
    from bwa_mem_scale_tpu_torch.ops import probe_kernels, smem_cuda
    from bwa_mem_scale_tpu_torch.ops import emf_cuda, seedsw_cuda, sweep_cuda
    from bwa_mem_scale_tpu_torch.ops import ert_cuda, smem_rl_cuda
    from bwa_mem_scale_tpu_torch.ops import kswa_cuda, kswg_cuda, sal_cuda
    from bwa_mem_scale_tpu_torch.ops import extend_cuda
    from bwa_mem_scale_tpu_torch.tools import round_cost
    with ThreadPoolExecutor(15) as ex:          # one nvcc a source, at once
        builds = [ex.submit(bsw_cuda.build, force=True),
                  ex.submit(probe_kernels.build, force=True, verbose=True),
                  ex.submit(smem_cuda.build, force=True),
                  ex.submit(chain_cuda.build, force=True),
                  ex.submit(round_cost.build, force=True),
                  ex.submit(sweep_cuda.build, force=True),
                  ex.submit(seedsw_cuda.build, force=True),
                  ex.submit(emf_cuda.build, force=True),
                  ex.submit(ert_cuda.build, force=True),
                  ex.submit(smem_rl_cuda.build, force=True),
                  ex.submit(kswg_cuda.build, force=True),
                  ex.submit(kswa_cuda.build, force=True),
                  ex.submit(sal_cuda.build, force=True),
                  ex.submit(smem_cuda.build_glue, force=True),
                  ex.submit(extend_cuda.build, force=True)]
        probes_seconds = builds[1].result()[1]
        for b in builds:
            b.result()
    log(f"[build] csrc/bsw.cu -> {os.path.relpath(bsw_cuda.LIB.path, REPO)}"
        f" in {bsw_cuda.LIB.build_seconds:.2f} s; csrc/probes.cu -> "
        f"{os.path.relpath(probe_kernels.LIB_PATH, REPO)} in "
        f"{probes_seconds:.2f} s; csrc/smem.cu -> "
        f"{os.path.relpath(smem_cuda.LIB.path, REPO)} in "
        f"{smem_cuda.LIB.build_seconds:.2f} s; csrc/chain.cu -> "
        f"{os.path.relpath(chain_cuda.LIB.path, REPO)} in "
        f"{chain_cuda.LIB.build_seconds:.2f} s; csrc/round_probe.cu -> "
        f"{os.path.relpath(round_cost.LIB.path, REPO)} in "
        f"{round_cost.LIB.build_seconds:.2f} s; csrc/sweep.cu -> "
        f"{os.path.relpath(sweep_cuda.LIB.path, REPO)} in "
        f"{sweep_cuda.LIB.build_seconds:.2f} s; csrc/seedsw.cu -> "
        f"{os.path.relpath(seedsw_cuda.LIB.path, REPO)} in "
        f"{seedsw_cuda.LIB.build_seconds:.2f} s; csrc/emf.cu -> "
        f"{os.path.relpath(emf_cuda.LIB.path, REPO)} in "
        f"{emf_cuda.LIB.build_seconds:.2f} s; csrc/ert.cu -> "
        f"{os.path.relpath(ert_cuda.LIB.path, REPO)} in "
        f"{ert_cuda.LIB.build_seconds:.2f} s; csrc/readlane.cu -> "
        f"{os.path.relpath(smem_rl_cuda.LIB.path, REPO)} in "
        f"{smem_rl_cuda.LIB.build_seconds:.2f} s; csrc/kswg.cu -> "
        f"{os.path.relpath(kswg_cuda.LIB.path, REPO)} in "
        f"{kswg_cuda.LIB.build_seconds:.2f} s; csrc/kswa.cu -> "
        f"{os.path.relpath(kswa_cuda.LIB.path, REPO)} in "
        f"{kswa_cuda.LIB.build_seconds:.2f} s; csrc/sal.cu -> "
        f"{os.path.relpath(sal_cuda.LIB.path, REPO)} in "
        f"{sal_cuda.LIB.build_seconds:.2f} s; csrc/smem_glue.cu -> "
        f"{os.path.relpath(smem_cuda.GLUE.path, REPO)} in "
        f"{smem_cuda.GLUE.build_seconds:.2f} s; csrc/extend.cu -> "
        f"{os.path.relpath(extend_cuda.LIB.path, REPO)} in "
        f"{extend_cuda.LIB.build_seconds:.2f} s (in parallel)")
    log(f"[build] one warp's dependent round (tools/round_cost.py: a "
        f"shared-memory load, a shuffle, a ballot), equal to its plain "
        f"model: {round_cost.round_us(dev):.5f} us, the chaining floors' "
        f"cost of a round  [{card}]")
    kernels = {lib: nvcc_build.ptxas_kernels(nvcc_build.REPORTS[lib])
               for lib in ("smem_cuda", "bsw_cuda", "chain_cuda",
                           "sweep_cuda", "seedsw_cuda", "emf_cuda",
                           "ert_cuda", "readlane_cuda", "kswg_cuda",
                           "kswa_cuda", "sal_cuda", "smem_glue_cuda",
                           "extend_cuda")}
    # each FM-walk and chaining kernel in its int32 (P = int, mangled i)
    # and int64 (P = long long, x) forms; the FM walks' 1-step forms (KS =
    # 1, mangled Li1E) and their k-step forms (int32 only)
    for lib, kernel, label in (
            ("smem_cuda", "one_pos_kernelILb1E{}E", "one_pos_kernel<"
             "stacks in shared memory, {}>"),
            ("smem_cuda", "one_pos_kernelILb0E{}E", "one_pos_kernel<"
             "stacks in a device scratch, {}>"),
            ("smem_cuda", "one_pos_k_kernelILb1ELi2E", "one_pos_k_kernel<"
             "stacks in shared memory, K = 2>"),
            ("smem_cuda", "one_pos_k_kernelILb1ELi3E", "one_pos_k_kernel<"
             "stacks in shared memory, K = 3>"),
            ("smem_cuda", "one_pos_k_kernelILb0ELi3E", "one_pos_k_kernel<"
             "stacks in a device scratch, K = 3>"),
            ("smem_cuda", "seed_strategy_kernelILi1E{}",
             "seed_strategy_kernel<{}>"),
            ("smem_cuda", "seed_strategy_kernelILi2Ei",
             "seed_strategy_kernel<K = 2, int32>"),
            ("smem_cuda", "sa_walk_kernelI{}", "sa_walk_kernel<{}>"),
            ("smem_glue_cuda", "reseed_tasks_kernelI{}",
             "reseed_tasks_kernel<{}>"),
            ("smem_glue_cuda", "merge_smems_kernelI{}",
             "merge_smems_kernel<{}>"),
            ("extend_cuda", "ext_select_kernelI{}", "ext_select_kernel<{}>"),
            ("extend_cuda", "ext_pairs_kernel", "ext_pairs_kernel"),
            ("extend_cuda", "ext_stage_kernelI{}", "ext_stage_kernel<{}>"),
            ("extend_cuda", "bsw_band_tiled_kernel", "bsw_band_tiled_kernel"),
            ("sal_cuda", "sal_count_kernelI{}", "sal_count_kernel<{}>"),
            ("sal_cuda", "sal_walk_kernelI{}", "sal_walk_kernel<{}>"),
            ("chain_cuda", "chain_seeds_kernelI{}", "chain_seeds_kernel<{}>"),
            ("chain_cuda", "chain_filter_kernelI{}", "chain_filter_kernel<{}>"),
            ("sweep_cuda", "sweep_extend_kernelILi1E{}Li1E",
             "sweep_extend_kernel<{}, pass 1>"),
            ("sweep_cuda", "sweep_extend_kernelILi1E{}Li2E",
             "sweep_extend_kernel<{}, pass 2>"),
            ("sweep_cuda", "sweep_extend_kernelILi2EiLi1E",
             "sweep_extend_kernel<K = 2, int32, pass 1>"),
            ("sweep_cuda", "seed_strategy_merged_kernelI{}",
             "seed_strategy_merged_kernel<{}>"),
            ("ert_cuda", "ert_extend_kernelI{}", "ert_extend_kernel<{}>"),
            ("readlane_cuda", "readlane_one_pos_kernelILb1ELi1E{}",
             "readlane_one_pos_kernel<stacks in shared memory, {}>"),
            ("readlane_cuda", "readlane_one_pos_kernelILb0ELi1E{}",
             "readlane_one_pos_kernel<stacks in a device scratch, {}>"),
            ("readlane_cuda", "readlane_one_pos_kernelILb1ELi2Ei",
             "readlane_one_pos_kernel<stacks in shared memory, K = 2, "
             "int32>"),
            ("readlane_cuda", "readlane_one_pos_kernelILb1ELi3Ei",
             "readlane_one_pos_kernel<stacks in shared memory, K = 3, "
             "int32>"),
            ("readlane_cuda", "readlane_strategy_kernelILi1E{}",
             "readlane_strategy_kernel<{}>"),
            ("readlane_cuda", "readlane_strategy_kernelILi2Ei",
             "readlane_strategy_kernel<K = 2, int32>"),
            ("bsw_cuda", "bsw_tiled_kernel", "bsw_tiled_kernel"),
            ("seedsw_cuda", "local_sw_kernel", "local_sw_kernel"),
            ("emf_cuda", "emf_lookup_kernel", "emf_lookup_kernel"),
            ("kswg_cuda", "kswg_kernel", "kswg_kernel")):
        for code, pos in (("i", "int32"), ("x", "int64")):
            (r, s), = [v for fn, v in kernels[lib].items()
                       if kernel.format(code) in fn]
            log(f"[build] {label.format(pos)}: {r} registers, {s} bytes "
                f"spilled")
            if "{}" not in kernel:
                break
    # the BSW instantiations, {(K, shared): (registers, spill bytes)}
    regs = {(int(k.group(1)), k.group(2) == "1"): v
            for fn, v in kernels["bsw_cuda"].items()
            if (k := re.search(r"bsw_warp_kernelILi(\d+)ELb([01])E", fn))}
    if len(regs) != len(bsw_cuda.K_VALUES):
        raise SystemExit(f"build: ptxas reported {sorted(regs)}, expected "
                         f"K = {bsw_cuda.K_VALUES}")
    log("[build] bsw_warp_kernel<K, shared>: " + "; ".join(
        f"K={k}{' (shared memory)' if sh else ''} {r} registers, {s} "
        f"bytes spilled" for (k, sh), (r, s) in sorted(regs.items())))
    # the same body with the extension's band epilogue (csrc/extend.cu)
    fused = {(int(k.group(1)), k.group(2) == "1"): v
             for fn, v in kernels["extend_cuda"].items()
             if (k := re.search(r"bsw_band_kernelILi(\d+)ELb([01])E", fn))}
    if sorted(fused) != sorted(regs):
        raise SystemExit(f"build: ptxas reported bsw_band_kernel for "
                         f"{sorted(fused)}, expected {sorted(regs)}")
    log("[build] bsw_band_kernel<K, shared> (BSW with the band epilogue): "
        + "; ".join(f"K={k}{' (shared memory)' if sh else ''} {r} "
                    f"registers, {s} bytes spilled"
                    for (k, sh), (r, s) in sorted(fused.items())))
    if any(s for (k, _), (_, s) in (*regs.items(), *fused.items())
           if k in (4, 5)):
        raise SystemExit("build: the BSW kernel spills at K = 4 or 5")
    kswa_regs = {int(k.group(1)): v
                 for fn, v in kernels["kswa_cuda"].items()
                 if (k := re.search(r"kswa_kernelILi(\d+)E", fn))}
    if sorted(kswa_regs) != sorted(kswa_cuda.K_VALUES):
        raise SystemExit(f"build: ptxas reported kswa_kernel<K> for "
                         f"{sorted(kswa_regs)}, expected {kswa_cuda.K_VALUES}")
    log("[build] kswa_kernel<K columns a lane>: " + "; ".join(
        f"K={k} {r} registers, {s} bytes spilled"
        for k, (r, s) in sorted(kswa_regs.items())))

    k = phase_kernel(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches, al, codes, lens, se = phase_mem(dev, card, tmp)
        _, smem, p3, walk, seeds, flt, glue, ext = phase_slice(
            dev, card, al, codes, lens)
        probes = phase_probes(dev, card)
        _, pe = phase_pe(dev, card, tmp)
        wide = phase_int64(dev, card, tmp, se, al, codes, lens,
                           {"one_pos_machine": smem[0],
                            "seed_strategy_machine": p3,
                            "expand_and_lookup": walk,
                            "chain_seeds": seeds, "chain_filter": flt,
                            **glue})
        sweep = phase_sweep(dev, card, tmp, se, pe, al, codes, lens,
                            {"one_pos_machine": smem,
                             "seed_strategy_machine": p3})
        sw = phase_longread(dev, card, tmp)
        emf = phase_emf(dev, card, tmp, se)
        ert = phase_ert(dev, card, tmp, se, pe, sweep, codes, lens)
        kst = phase_kstep(dev, card, tmp, se, pe, al)
        rl = phase_readlane(dev, card, tmp, se, pe, al, kst)
        dp = phase_mesh(dev, card, tmp, se, pe)
        phase_finalize(dev, card, tmp, se, pe)
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s, the "
        f"builds included")

    log(json.dumps({"kernels": [{
        "name": "banded_swa_batch", "route": "cuda",
        "source": "csrc/bsw.cu",
        "replaces": "bwa_mem_scale_tpu/ops/bsw_pallas.py:56",
        "launches": launches["banded_swa_batch"], "max_abs_err": k["err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
        "library_ms": None}] + probes + [{
        "name": "one_pos_machine", "route": "cuda",
        "source": "csrc/smem.cu",
        "replaces": "bwa_mem_scale_tpu/ops/smem_oh.py:174",
        "launches": launches["one_pos_machine"],
        "max_abs_err": max(r["err"] for r in smem),
        "ms": smem[0]["ms"], "plain_ms": smem[0]["plain_ms"],
        "bound_ms": smem[0]["bound"][0], "bound_by": smem[0]["bound"][1],
        "library_ms": None}] + [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None}
        for name, source, replaces, r in (
            ("seed_strategy_machine", "csrc/smem.cu",
             "bwa_mem_scale_tpu/ops/smem_oh.py:619", p3),
            ("expand_and_lookup", "csrc/sal.cu",
             "bwa_mem_scale_tpu/ops/sal.py:23", walk))] + [{
        "name": name, "route": "cuda", "source": "csrc/chain.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None}
        for name, replaces, r in (
            ("chain_seeds", "bwa_mem_scale_tpu/ops/chain.py:78", seeds),
            ("chain_filter", "bwa_mem_scale_tpu/ops/chain.py:299", flt))] + [{
        "name": name, "route": "cuda", "source": "csrc/smem_glue.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": GLUE_ERR[name], "ms": glue[name]["ms"],
        "plain_ms": glue[name]["plain_ms"],
        "bound_ms": glue[name]["bound"][0],
        "bound_by": glue[name]["bound"][1], "library_ms": None}
        for name, _, replaces in GLUE_KERNELS] + [{
        "name": name, "route": "cuda", "source": "csrc/extend.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": EXT_ERR[name], "ms": ext[name]["ms"],
        "plain_ms": ext[name]["plain_ms"], "bound_ms": ext[name]["bound"][0],
        "bound_by": ext[name]["bound"][1], "library_ms": None}
        for name, _, replaces in EXT_KERNELS] + [{
        "name": f"{name}_int64", "route": "cuda", "source": source,
        "replaces": replaces, "launches": wide["launches"][name],
        "max_abs_err": wide[name]["err"], "ms": wide[name]["ms"],
        "plain_ms": wide[name]["plain_ms"],
        "bound_ms": wide[name]["bound"][0],
        "bound_by": wide[name]["bound"][1], "library_ms": None}
        for name, source, replaces in INT64_FORMS] + [{
        "name": f"{name}{sfx}", "route": "cuda", "source": "csrc/sweep.cu",
        "replaces": replaces,
        "launches": sweep["launches64" if sfx else "launches"][name],
        "max_abs_err": sweep[name + sfx]["err"],
        "ms": sweep[name + sfx]["ms"],
        "plain_ms": sweep[name + sfx]["plain_ms"],
        "bound_ms": sweep[name + sfx]["bound"][0],
        "bound_by": sweep[name + sfx]["bound"][1], "library_ms": None}
        for sfx in ("", "_int64") for name, _, replaces in SWEEP_KERNELS] + [{
        "name": "local_sw_score", "route": "cuda", "source": "csrc/seedsw.cu",
        "replaces": "bwa_mem_scale_tpu/ops/seedsw.py:28",
        "launches": sw["launches"], "max_abs_err": sw["err"], "ms": sw["ms"],
        "plain_ms": sw["plain_ms"], "bound_ms": sw["bound"][0],
        "bound_by": sw["bound"][1], "library_ms": None}, {
        "name": "emf_lookup", "route": "cuda", "source": "csrc/emf.cu",
        "replaces": "bwa_mem_scale_tpu/ops/emf.py:89",
        "launches": emf["launches"], "max_abs_err": emf["err"],
        "ms": emf["ms"], "plain_ms": emf["plain_ms"],
        "bound_ms": emf["bound"][0], "bound_by": emf["bound"][1],
        "library_ms": None}] + [{
        "name": name, "route": "cuda", "source": "csrc/ert.cu",
        "replaces": "bwa_mem_scale_tpu/ops/ert.py:107",
        "launches": ert["launches64" if name.endswith("int64")
                       else "launches"],
        "max_abs_err": ert[name]["err"], "ms": ert[name]["ms"],
        "plain_ms": ert[name]["plain_ms"], "bound_ms": ert[name]["bound"][0],
        "bound_by": ert[name]["bound"][1], "library_ms": None}
        for name in ("ert_extend", "ert_extend_int64")] + [{
        "name": form, "route": "cuda", "source": source,
        "replaces": replaces, "launches": kst["launches"][form],
        "max_abs_err": kst[form]["err"], "ms": kst[form]["ms"],
        "plain_ms": kst[form]["plain_ms"], "bound_ms": kst[form]["bound"][0],
        "bound_by": kst[form]["bound"][1], "library_ms": None}
        for form, _, _, source, replaces in KSTEP_FORMS] + [{
        "name": form, "route": "cuda", "source": "csrc/readlane.cu",
        "replaces": replaces, "launches": rl["launches"][form],
        "max_abs_err": rl[form]["err"], "ms": rl[form]["ms"],
        "plain_ms": rl[form]["plain_ms"], "bound_ms": rl[form]["bound"][0],
        "bound_by": rl[form]["bound"][1], "library_ms": None}
        for form, _, _, replaces in READLANE_FORMS] + [{
        "name": name, "route": "cuda", "source": f"csrc/{key}.cu",
        "replaces": replaces, "launches": dp["launches"][key],
        "max_abs_err": dp[key]["err"], "ms": dp[key]["ms"],
        "plain_ms": dp[key]["plain_ms"], "bound_ms": dp[key]["bound"][0],
        "bound_by": dp[key]["bound"][1], "library_ms": None}
        for name, key, replaces in (
            ("ksw_global_batch", "kswg", "bwa_mem_scale_tpu/ops/kswg.py:33"),
            ("ksw_align_batch", "kswa",
             "bwa_mem_scale_tpu/ops/kswa.py:81"))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
