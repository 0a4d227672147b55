"""Streaming driver: FASTQ -> batches -> device -> SAM.

Counterpart of ``bwa_mem_scale_tpu/pipeline/driver.py``: a reader
thread prefetches read batches (fixed read count, or the -K base
count). Single-end: ``SeStream`` probes the EMF table on the host,
re-batches the misses for the device and re-emits records in input
order. Paired-end (mates interleaved, from two files or one): one
device batch in flight; the in-flight batch is fetched, the next one
dispatched, and the fetched one's host PE stage runs under it.
Multi-host sharding (``host_shard``): every host reads the whole stream
and aligns only its batches, keeping global read ordinals.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from ..io.fastq import iter_fastx, Read, ReadBatch
from ..io.sam import aln_to_sam_line
from ..pipeline import native_finalize
from ..utils.profiling import PROFILER
from .stream import SeStream


def _iter_reads(paths: List[str], paired: bool):
    """Yield reads; for two input files, interleave mates 2i/2i+1
    (bseq_read's smart pairing, src/bwa.cpp:266-362)."""
    if paired and len(paths) == 2:
        it0, it1 = iter_fastx(paths[0]), iter_fastx(paths[1])
        while True:
            r0 = next(it0, None)
            r1 = next(it1, None)
            if r0 is None and r1 is None:
                return
            if r0 is None or r1 is None:
                raise ValueError("paired FASTQ files differ in length")
            yield r0
            yield r1
    else:
        for path in paths:
            yield from iter_fastx(path)


def _reader(paths: List[str], batch_reads: int, chunk_bp: Optional[int],
            q: "queue.Queue", paired: bool = False, skip_reads: int = 0):
    """Batches onto q, then None (or the exception that stopped it).
    Paired batches hold whole pairs."""
    try:
        batch: List[Read] = []
        bp = 0
        step = 2 if paired else 1
        skipped = 0
        for r in _iter_reads(paths, paired):
            if skipped < skip_reads:
                skipped += 1
                continue
            batch.append(r)
            bp += len(r.seq)
            full = (len(batch) >= batch_reads if chunk_bp is None
                    else bp >= chunk_bp)
            if full and len(batch) % step == 0:
                q.put(ReadBatch(batch))
                batch, bp = [], 0
        if batch:
            if paired and len(batch) % 2:
                raise ValueError("odd number of reads in paired input")
            q.put(ReadBatch(batch))
        q.put(None)
    except BaseException as e:  # surface reader errors to the driver
        q.put(e)


def run_alignment(aligner, fastq_paths: List[str], out,
                  batch_reads: int = 512, chunk_bp: Optional[int] = None,
                  rg_id: Optional[str] = None, paired: bool = False,
                  skip_reads: int = 0,
                  checkpoint_path: Optional[str] = None,
                  host_shard: Optional[tuple] = None,
                  verbosity: int = 2) -> int:
    """Stream-align FASTQ to SAM; returns the read count. paired: mates
    interleaved from two files, or in turn in one (-p). With
    checkpoint_path, a sidecar JSON records how many input reads have
    been emitted (written atomically after each write), and a rerun
    resumes by skipping that many reads.

    host_shard=(num_hosts, host_id) is the multi-host FASTQ-sharding mode
    of the JAX package (SURVEY section 5.8): every host parses the full
    stream but aligns only batches with index % num_hosts == host_id,
    writing its own SAM part. Global read ordinals are kept (the hash_64
    MAPQ tiebreaks see a single-host run's ids, so each part byte-matches
    the single-host run's records of its batches); the reference's
    analogue is several processes against one shm index store
    (src/bwa_shm.cpp), one output each. It needs a fixed batch_reads
    (chunk_bp batching would make batch boundaries host-dependent)."""
    if host_shard is not None:
        n_hosts, host_id = host_shard
        if chunk_bp is not None:
            raise ValueError("host_shard requires fixed batch_reads, "
                             "not chunk_bp batching")
        if checkpoint_path is not None:
            raise ValueError("checkpoint/resume is per-host-stream; "
                             "not supported with host_shard")
        if not (0 <= host_id < n_hosts):
            raise ValueError(f"host_id {host_id} out of range")
    else:
        n_hosts, host_id = 1, 0
    t_start = time.time()
    q: "queue.Queue" = queue.Queue(maxsize=4)
    t = threading.Thread(target=_reader,
                         args=(fastq_paths, batch_reads, chunk_bp, q,
                               paired, skip_reads), daemon=True)
    t.start()
    n_reads = 0
    id_offset = skip_reads          # global input ordinals
    n_emitted = skip_reads
    opt = aligner.opt
    bns = aligner.idx.bns
    stream = None
    reads_by_id = {}
    holes = []   # skipped [lo, hi) id ranges (other hosts' batches)

    def write_checkpoint():
        if checkpoint_path is None:
            return
        tmp = checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"reads_emitted": n_emitted, "inputs": fastq_paths},
                      f)
        os.replace(tmp, checkpoint_path)

    def emit_ready():
        nonlocal n_emitted
        wrote = False
        while True:
            drained = True
            for rid, records in stream.ready():
                with PROFILER.phase("sam_write"):
                    if isinstance(records, bytes):   # native SAM text
                        out.write(records.decode("ascii"))
                    else:
                        read = reads_by_id.pop(rid)
                        for which in range(len(records)):
                            out.write(aln_to_sam_line(
                                opt, bns, read, len(records), records,
                                which, rg_id=rg_id))
                n_emitted += 1
                wrote = True
            # jump the emit cursor over another host's batch
            if holes and stream.next_emit >= holes[0][0]:
                stream.next_emit = max(stream.next_emit, holes.pop(0)[1])
                drained = False
            if drained:
                break
        if wrote:
            out.flush()
            write_checkpoint()

    def emit(batch, records_per_read, mates):
        """One PE batch: native SAM bytes, or Aln records and mates."""
        nonlocal n_emitted
        with PROFILER.phase("sam_write"):
            for read, records, mate in zip(batch.reads, records_per_read,
                                           mates):
                if isinstance(records, bytes):
                    out.write(records.decode("ascii"))
                else:
                    for which in range(len(records)):
                        out.write(aln_to_sam_line(
                            opt, bns, read, len(records), records, which,
                            mate=mate, rg_id=rg_id))
                n_emitted += 1
        write_checkpoint()

    def pe_sam_ctx(batch):
        """Native SAM text unless -C needs FASTQ comments appended."""
        if getattr(opt, "copy_comment", False):
            return None
        return dict(names=[r.name.encode() for r in batch.reads],
                    quals=[r.qual.encode() if r.qual else b""
                           for r in batch.reads],
                    rg_id=rg_id)

    pe_pending = None   # (batch, dispatched pairs, id_offset)
    batch_idx = -1
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        batch = item
        batch_idx += 1
        if batch_idx % n_hosts != host_id:   # another host's batch
            holes.append((id_offset, id_offset + len(batch)))
            n_reads += len(batch)
            id_offset += len(batch)
            continue
        codes, lens = batch.padded_codes()
        if paired:
            # one batch in flight: fetch it (the sync point), dispatch
            # the next, then run the fetched one's host stage under it
            with PROFILER.phase("align_batch"):
                if pe_pending is not None:
                    b0, ph0, off0 = pe_pending
                    fetched0 = aligner.fetch_pairs(ph0)
                ph = aligner.dispatch_pairs(codes.astype(np.int32), lens)
                if pe_pending is not None:
                    emit(b0, *aligner.pe_post(fetched0, off0,
                                              sam_ctx=pe_sam_ctx(b0)))
                pe_pending = (batch, ph, id_offset)
        else:
            if stream is None:
                # SAM text composed natively unless -C needs FASTQ comments
                sam_mode = (native_finalize.available()
                            and not getattr(opt, "copy_comment", False))
                stream = SeStream(aligner, batch_reads, int(codes.shape[1]),
                                  sam=sam_mode, rg_id=rg_id)
                stream.next_emit = id_offset
            if not stream.sam:
                for ri, read in enumerate(batch.reads):
                    reads_by_id[id_offset + ri] = read
            with PROFILER.phase("align_batch"):
                if stream.sam:
                    stream.feed(
                        codes.astype(np.int32), lens, id_offset,
                        names=[r.name.encode() for r in batch.reads],
                        quals=[r.qual.encode() if r.qual else b""
                               for r in batch.reads])
                else:
                    stream.feed(codes.astype(np.int32), lens, id_offset)
            emit_ready()
        n_reads += len(batch)
        id_offset += len(batch)
        if verbosity >= 3:
            dt = time.time() - t_start
            print(f"[M::mem] processed {n_reads} reads ({dt:.1f} s, "
                  f"{n_reads / max(dt, 1e-9):.0f} reads/s cumulative)",
                  file=sys.stderr)
    if pe_pending is not None:
        b0, ph0, off0 = pe_pending
        with PROFILER.phase("align_batch"):
            emit(b0, *aligner.pe_post(aligner.fetch_pairs(ph0), off0,
                                      sam_ctx=pe_sam_ctx(b0)))
    if stream is not None:
        with PROFILER.phase("align_batch"):
            stream.flush()
        emit_ready()
        if reads_by_id:
            raise RuntimeError(f"{len(reads_by_id)} reads were not emitted")
    t.join()
    if aligner.emf_checked:
        print(f"* EMF perfect-match hits: {aligner.emf_hits}/"
              f"{aligner.emf_checked} reads short-circuited",
              file=sys.stderr)
    return n_reads
