"""ctypes binding for the native SE finalizer (native/finalize.cpp).

Takes the fetched device-region arrays and produces finished per-read
SAM records (dedup/patch, primary marking, selection, CIGAR+NM/MD,
XA) in one C call — the host-side record pipeline the reference runs
native (mem_sort_dedup_patch / mem_mark_primary_se / mem_reg2aln,
src/bwamem.cpp). The Python path (ref/finalize.py +
pipeline/finalize.py) remains the oracle and fallback; equality is
asserted by tests/test_native_finalize.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfinalize.so")

_lib = None
_bns_cache = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F32P = ctypes.POINTER(ctypes.c_float)
_CP = ctypes.c_char_p


def switched_off() -> bool:
    """BWA_TPU_NO_NATIVE_FINALIZE is set: records and SAM text take the
    Python path (the JAX package's switch)."""
    return bool(os.environ.get("BWA_TPU_NO_NATIVE_FINALIZE"))


def available() -> bool:
    if switched_off():
        return False
    try:
        _load()
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR, "libfinalize.so"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.finalize_se_batch.restype = ctypes.c_int64
    lib.compose_sam_se.restype = ctypes.c_int64
    lib.finalize_pe_batch.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _bns_arrays(bns):
    """Cached flat annotation arrays for a bns object."""
    key = id(bns)
    if key in _bns_cache:
        return _bns_cache[key]
    n = len(bns.anns)
    off = np.asarray([a.offset for a in bns.anns], dtype=np.int64)
    lng = np.asarray([a.length for a in bns.anns], dtype=np.int64)
    alt = np.asarray(bns.is_alt, dtype=np.uint8)
    name_off = np.zeros(n, dtype=np.int64)
    parts = []
    pos = 0
    for i, a in enumerate(bns.anns):
        name_off[i] = pos
        nb = a.name.encode() + b"\0"
        parts.append(nb)
        pos += len(nb)
    names = b"".join(parts)
    out = (off, lng, alt, names, name_off)
    _bns_cache[key] = out
    return out


def finalize_se_rows(opt, idx, rows, proc_reads, frac_rep, read_ids,
                     codes, lens, extra_flag: int = 0,
                     want: str = "aln"):
    """Run the native finalizer.

    rows: dict of column arrays (read, rb, re, qb, qe, rid, score,
    truesc, w, seedcov, seedlen0) in read-major order.
    proc_reads: ascending int32 array of read indices to process.
    Returns records_by_read dict {read_idx: [Aln, ...]} or None if the
    native path declined (capacity overflow -> caller falls back).
    """
    from ..ref.finalize import Aln
    lib = _load()
    bns = idx.bns
    ref = idx.ref_string
    if not isinstance(ref, np.ndarray) or ref.dtype != np.uint8:
        ref = np.asarray(ref, dtype=np.uint8)
    ann_off, ann_len, ann_alt, names, name_off = _bns_arrays(bns)

    n_rows = len(rows["read"])
    n_proc = len(proc_reads)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    frac_rep = np.ascontiguousarray(frac_rep, dtype=np.float32)
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    proc_reads = np.ascontiguousarray(proc_reads, dtype=np.int32)

    cols = {k: np.ascontiguousarray(
        rows[k], dtype=np.int64 if k in ("rb", "re") else np.int32)
        for k in ("read", "rb", "re", "qb", "qe", "rid", "score",
                  "truesc", "w", "seedcov", "seedlen0")}

    rec_cap = n_rows + n_proc + 8
    CIG_STRIDE = 256
    rd_nrec = np.zeros(n_proc, dtype=np.int32)
    rec_read = np.zeros(rec_cap, dtype=np.int32)
    rec_rid = np.zeros(rec_cap, dtype=np.int32)
    rec_pos = np.zeros(rec_cap, dtype=np.int64)
    rec_flag = np.zeros(rec_cap, dtype=np.int32)
    rec_mapq = np.zeros(rec_cap, dtype=np.int32)
    rec_score = np.zeros(rec_cap, dtype=np.int32)
    rec_sub = np.zeros(rec_cap, dtype=np.int32)
    rec_nm = np.zeros(rec_cap, dtype=np.int32)
    rec_alt_sc = np.zeros(rec_cap, dtype=np.int32)
    rec_is_rev = np.zeros(rec_cap, dtype=np.uint8)
    rec_is_alt = np.zeros(rec_cap, dtype=np.uint8)
    rec_ncig = np.zeros(rec_cap, dtype=np.int32)
    cig_out = np.zeros((rec_cap, CIG_STRIDE), dtype=np.uint32)
    md_cap = max(1 << 16, n_rows * 512)
    xa_cap = max(1 << 16, n_rows * 256)
    md_arena = np.zeros(md_cap, dtype=np.uint8)
    xa_arena = np.zeros(xa_cap, dtype=np.uint8)
    rec_md_off = np.zeros(rec_cap, dtype=np.int64)
    rec_md_len = np.zeros(rec_cap, dtype=np.int32)
    rec_xa_off = np.zeros(rec_cap, dtype=np.int64)
    rec_xa_len = np.zeros(rec_cap, dtype=np.int32)

    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    from ..utils.profiling import PROFILER
    with PROFILER.phase("native_c_call"):
        rc = lib.finalize_se_batch(
        ctypes.c_int64(n_rows),
        _ptr(cols["read"], ctypes.c_int32),
        _ptr(cols["rb"], ctypes.c_int64),
        _ptr(cols["re"], ctypes.c_int64),
        _ptr(cols["qb"], ctypes.c_int32),
        _ptr(cols["qe"], ctypes.c_int32),
        _ptr(cols["rid"], ctypes.c_int32),
        _ptr(cols["score"], ctypes.c_int32),
        _ptr(cols["truesc"], ctypes.c_int32),
        _ptr(cols["w"], ctypes.c_int32),
        _ptr(cols["seedcov"], ctypes.c_int32),
        _ptr(cols["seedlen0"], ctypes.c_int32),
        ctypes.c_int64(n_proc),
        _ptr(proc_reads, ctypes.c_int32),
        _ptr(frac_rep, ctypes.c_float),
        _ptr(read_ids, ctypes.c_int64),
        _ptr(codes, ctypes.c_int32),
        ctypes.c_int64(codes.shape[1]),
        _ptr(lens, ctypes.c_int32),
        _ptr(ref, ctypes.c_uint8),
        ctypes.c_int64(bns.l_pac),
        ctypes.c_int64(len(bns.anns)),
        _ptr(ann_off, ctypes.c_int64),
        _ptr(ann_len, ctypes.c_int64),
        _ptr(ann_alt, ctypes.c_uint8),
        ctypes.c_char_p(names),
        _ptr(name_off, ctypes.c_int64),
        _ptr(mat, ctypes.c_int8),
        ctypes.c_int32(opt.a), ctypes.c_int32(opt.b),
        ctypes.c_int32(opt.o_del), ctypes.c_int32(opt.e_del),
        ctypes.c_int32(opt.o_ins), ctypes.c_int32(opt.e_ins),
        ctypes.c_int32(opt.w), ctypes.c_int32(opt.T),
        ctypes.c_int32(opt.min_seed_len),
        ctypes.c_int32(opt.max_chain_gap),
        ctypes.c_double(opt.mask_level),
        ctypes.c_double(opt.drop_ratio),
        ctypes.c_double(opt.XA_drop_ratio),
        ctypes.c_double(opt.mask_level_redun),
        ctypes.c_int32(opt.max_XA_hits),
        ctypes.c_int32(opt.max_XA_hits_alt),
        ctypes.c_int32(opt.mapQ_coef_len),
        ctypes.c_double(opt.mapQ_coef_fac),
        ctypes.c_int32(opt.flag),
        ctypes.c_int32(extra_flag),
        _ptr(rd_nrec, ctypes.c_int32),
        ctypes.c_int64(rec_cap),
        _ptr(rec_read, ctypes.c_int32),
        _ptr(rec_rid, ctypes.c_int32),
        _ptr(rec_pos, ctypes.c_int64),
        _ptr(rec_flag, ctypes.c_int32),
        _ptr(rec_mapq, ctypes.c_int32),
        _ptr(rec_score, ctypes.c_int32),
        _ptr(rec_sub, ctypes.c_int32),
        _ptr(rec_nm, ctypes.c_int32),
        _ptr(rec_alt_sc, ctypes.c_int32),
        _ptr(rec_is_rev, ctypes.c_uint8),
        _ptr(rec_is_alt, ctypes.c_uint8),
        _ptr(rec_ncig, ctypes.c_int32),
        _ptr(cig_out.reshape(-1), ctypes.c_uint32),
        ctypes.c_int32(CIG_STRIDE),
        md_arena.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(md_cap),
        _ptr(rec_md_off, ctypes.c_int64),
        _ptr(rec_md_len, ctypes.c_int32),
        xa_arena.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(xa_cap),
        _ptr(rec_xa_off, ctypes.c_int64),
        _ptr(rec_xa_len, ctypes.c_int32),
    )
    if rc == -1:
        return None          # capacity: fall back to the Python path
    if rc == -2:
        raise RuntimeError("native finalize: rid consistency failure")
    n_rec = int(rc)

    if want == "raw":
        return dict(
            n_rec=n_rec, rd_nrec=rd_nrec,
            read=rec_read, rid=rec_rid, pos=rec_pos, flag=rec_flag,
            mapq=rec_mapq, score=rec_score, sub=rec_sub, nm=rec_nm,
            alt_sc=rec_alt_sc, is_rev=rec_is_rev, is_alt=rec_is_alt,
            ncig=rec_ncig, cig=cig_out, cig_stride=CIG_STRIDE,
            md_arena=md_arena, md_off=rec_md_off, md_len=rec_md_len,
            xa_arena=xa_arena, xa_off=rec_xa_off, xa_len=rec_xa_len)

    return records_from_raw(dict(
        n_rec=n_rec, read=rec_read, rid=rec_rid, pos=rec_pos,
        flag=rec_flag, mapq=rec_mapq, score=rec_score,
        sub=rec_sub, nm=rec_nm, alt_sc=rec_alt_sc,
        is_rev=rec_is_rev, is_alt=rec_is_alt, ncig=rec_ncig,
        cig=cig_out, cig_stride=CIG_STRIDE, md_arena=md_arena,
        md_off=rec_md_off, md_len=rec_md_len,
        xa_arena=xa_arena, xa_off=rec_xa_off,
        xa_len=rec_xa_len))


def records_from_raw(raw):
    """Bulk-convert a raw record-array dict into {read_idx: [Aln]}
    (tolist is a C loop; per-element np scalar access costs more than
    the native call itself at batch scale)."""
    from ..ref.finalize import Aln
    from ..utils.profiling import PROFILER
    n_rec = raw["n_rec"]
    with PROFILER.phase("native_conv"):
        md_bytes = raw["md_arena"].tobytes()
        xa_bytes = raw["xa_arena"].tobytes()
        meta = np.stack([raw["read"][:n_rec], raw["rid"][:n_rec],
                         raw["flag"][:n_rec], raw["mapq"][:n_rec],
                         raw["score"][:n_rec], raw["sub"][:n_rec],
                         raw["nm"][:n_rec], raw["alt_sc"][:n_rec],
                         raw["ncig"][:n_rec]], axis=1).tolist()
        pos_l = raw["pos"][:n_rec].tolist()
        isrev_l = raw["is_rev"][:n_rec].tolist()
        isalt_l = raw["is_alt"][:n_rec].tolist()
        mdo = raw["md_off"][:n_rec].tolist()
        mdl = raw["md_len"][:n_rec].tolist()
        xao = raw["xa_off"][:n_rec].tolist()
        xal = raw["xa_len"][:n_rec].tolist()
        w_cig = int(raw["ncig"][:n_rec].max()) if n_rec else 1
        cig_l = raw["cig"][:n_rec, :max(w_cig, 1)].tolist()
        out = {}
        for j in range(n_rec):
            (rd, rid, flag, mapq, score, sub, nm, alt_sc, ncig) = meta[j]
            a = Aln()
            a.rid = rid
            a.pos = pos_l[j]
            a.flag = flag
            a.mapq = mapq
            a.score = score
            a.sub = sub
            a.NM = nm
            a.alt_sc = alt_sc
            a.is_rev = bool(isrev_l[j])
            a.is_alt = bool(isalt_l[j])
            if rid >= 0:
                row = cig_l[j]
                a.cigar = [(row[k] >> 4, row[k] & 0xF)
                           for k in range(ncig)]
                a.MD = md_bytes[mdo[j]: mdo[j] + mdl[j]].decode()
            a.XA = (xa_bytes[xao[j]: xao[j] + xal[j]].decode()
                    if xal[j] else None)
            out.setdefault(rd, []).append(a)
        return out



# ---- native SAM text composition (compose_sam_se) -------------------

def blob_offsets(items, n):
    """(blob bytes, off int64[n+1]) for a length-n list of bytes."""
    off = np.zeros(n + 1, dtype=np.int64)
    if items is None:
        return b"", off
    parts = []
    pos = 0
    for i, it in enumerate(items):
        off[i] = pos
        if it:
            parts.append(it)
            pos += len(it)
    off[n] = pos
    return b"".join(parts), off


def perfect_raw(read_idx, rid, pos, is_rev, is_alt, l_seq: int,
                score: int):
    """Synthetic record-array block for EMF perfect hits (one record
    per read: FLAG 0, MAPQ 60, CIGAR <L>M, NM 0, MD <L>, XS 0 — the
    mem_aln2sam_perfect record, reference src/perfect_map.cpp)."""
    n = len(read_idx)
    md = str(l_seq).encode()
    md_arena = np.frombuffer(md, dtype=np.uint8)
    z = np.zeros(n, dtype=np.int32)
    cig = np.full((n, 1), (l_seq << 4) | 0, dtype=np.uint32)
    return dict(
        n_rec=n, rd_nrec=np.ones(n, np.int32),
        read=np.asarray(read_idx, np.int32),
        rid=np.asarray(rid, np.int32),
        pos=np.asarray(pos, np.int64),
        flag=z, mapq=np.full(n, 60, np.int32),
        score=np.full(n, score, np.int32), sub=z,
        nm=z, alt_sc=z,
        is_rev=np.asarray(is_rev, np.uint8),
        is_alt=np.asarray(is_alt, np.uint8),
        ncig=np.ones(n, np.int32), cig=cig, cig_stride=1,
        md_arena=md_arena, md_off=np.zeros(n, np.int64),
        md_len=np.full(n, len(md), np.int32),
        xa_arena=np.zeros(1, np.uint8), xa_off=np.zeros(n, np.int64),
        xa_len=z)


def compose_sam_raw(raw, opt, bns, codes, lens, names, quals=None,
                    rg_id=None, mate=None):
    """Compose SAM lines for every read present in `raw` (a raw dict
    from finalize_se_rows(want='raw') or perfect_raw). Returns
    {read_idx: bytes} — each value is ALL of that read's lines
    (newline-terminated). None on arena overflow (caller falls back
    to the Python writer)."""
    lib = _load()
    n_rec = raw["n_rec"]
    B = codes.shape[0]
    if n_rec == 0:
        return {}
    ann_off, ann_len, ann_alt, cnames, name_off = _bns_arrays(bns)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    qblob, qoff = blob_offsets(names, B)
    if quals is not None and any(quals):
        ublob, uoff = blob_offsets(quals, B)
    else:
        ublob, uoff = None, np.zeros(B + 1, dtype=np.int64)
    cap = max(1 << 20, n_rec * 520 + int(raw["xa_len"].sum()))
    arena = np.zeros(cap, dtype=np.uint8)
    read_off = np.zeros(B, dtype=np.int64)
    read_len = np.zeros(B, dtype=np.int32)
    c = lambda a, t: np.ascontiguousarray(a).ctypes.data_as(
        ctypes.POINTER(t))
    from ..utils.profiling import PROFILER
    with PROFILER.phase("native_sam"):
        rc = lib.compose_sam_se(
            ctypes.c_int64(n_rec),
            c(raw["read"], ctypes.c_int32), c(raw["rid"], ctypes.c_int32),
            c(raw["pos"], ctypes.c_int64), c(raw["flag"], ctypes.c_int32),
            c(raw["mapq"], ctypes.c_int32),
            c(raw["score"], ctypes.c_int32),
            c(raw["sub"], ctypes.c_int32), c(raw["nm"], ctypes.c_int32),
            c(raw["alt_sc"], ctypes.c_int32),
            c(raw["is_rev"], ctypes.c_uint8),
            c(raw["is_alt"], ctypes.c_uint8),
            c(raw["ncig"], ctypes.c_int32),
            c(raw["cig"].reshape(-1), ctypes.c_uint32),
            ctypes.c_int32(raw["cig_stride"]),
            raw["md_arena"].ctypes.data_as(ctypes.c_char_p),
            c(raw["md_off"], ctypes.c_int64),
            c(raw["md_len"], ctypes.c_int32),
            raw["xa_arena"].ctypes.data_as(ctypes.c_char_p),
            c(raw["xa_off"], ctypes.c_int64),
            c(raw["xa_len"], ctypes.c_int32),
            c(codes, ctypes.c_int32), ctypes.c_int64(codes.shape[1]),
            c(lens, ctypes.c_int32),
            ctypes.c_char_p(qblob), c(qoff, ctypes.c_int64),
            ctypes.c_char_p(ublob), c(uoff, ctypes.c_int64),
            ctypes.c_char_p(cnames), c(name_off, ctypes.c_int64),
            ctypes.c_int32(opt.flag),
            ctypes.c_char_p(rg_id.encode() if rg_id else None),
            (c(mate["rid"], ctypes.c_int32) if mate
             else ctypes.POINTER(ctypes.c_int32)()),
            (c(mate["pos"], ctypes.c_int64) if mate
             else ctypes.POINTER(ctypes.c_int64)()),
            (c(mate["is_rev"], ctypes.c_uint8) if mate
             else ctypes.POINTER(ctypes.c_uint8)()),
            (c(mate["rlen"], ctypes.c_int32) if mate
             else ctypes.POINTER(ctypes.c_int32)()),
            arena.ctypes.data_as(ctypes.c_char_p),
            ctypes.c_int64(cap),
            c(read_off, ctypes.c_int64), c(read_len, ctypes.c_int32))
    if rc < 0:
        return None
    blob = arena[:int(rc)].tobytes()
    out = {}
    reads = raw["read"]
    # unique read indices in order
    seen = -1
    for j in range(n_rec):
        i = int(reads[j])
        if i != seen:
            out[i] = blob[int(read_off[i]): int(read_off[i])
                          + int(read_len[i])]
            seen = i
    return out


# ---- native paired-end pipeline (finalize_pe_batch) -----------------

def finalize_pe_rows(opt, idx, rows, n_pairs, frac_rep, read_ids,
                     skip_dedup, codes, lens, pes_in=None,
                     want: str = "aln"):
    """Native PE post-processing: raw (pre-dedup) region rows for
    2*n_pairs reads -> per-read [Aln] records + mate records + pes.
    Returns (records_by_read, mates list[Aln], pes_out ndarray) or
    None if the native path declined (capacity)."""
    from ..ref.finalize import Aln
    lib = _load()
    bns = idx.bns
    ref = idx.ref_string
    if not isinstance(ref, np.ndarray) or ref.dtype != np.uint8:
        ref = np.asarray(ref, dtype=np.uint8)
    ann_off, ann_len, ann_alt, names, name_off = _bns_arrays(bns)

    n_rows = len(rows["read"])
    n_reads = 2 * n_pairs
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    frac_rep = np.ascontiguousarray(frac_rep, dtype=np.float32)
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    skip_dedup = np.ascontiguousarray(skip_dedup, dtype=np.uint8)

    cols = {k: np.ascontiguousarray(
        rows[k], dtype=np.int64 if k in ("rb", "re") else np.int32)
        for k in ("read", "rb", "re", "qb", "qe", "rid", "score",
                  "truesc", "w", "seedcov", "seedlen0")}

    rec_cap = n_rows + 4 * n_reads + 64
    CIG_STRIDE = 256
    rd_nrec = np.zeros(n_reads, dtype=np.int32)
    rec_read = np.zeros(rec_cap, dtype=np.int32)
    rec_rid = np.zeros(rec_cap, dtype=np.int32)
    rec_pos = np.zeros(rec_cap, dtype=np.int64)
    rec_flag = np.zeros(rec_cap, dtype=np.int32)
    rec_mapq = np.zeros(rec_cap, dtype=np.int32)
    rec_score = np.zeros(rec_cap, dtype=np.int32)
    rec_sub = np.zeros(rec_cap, dtype=np.int32)
    rec_nm = np.zeros(rec_cap, dtype=np.int32)
    rec_alt_sc = np.zeros(rec_cap, dtype=np.int32)
    rec_is_rev = np.zeros(rec_cap, dtype=np.uint8)
    rec_is_alt = np.zeros(rec_cap, dtype=np.uint8)
    rec_ncig = np.zeros(rec_cap, dtype=np.int32)
    cig_out = np.zeros((rec_cap, CIG_STRIDE), dtype=np.uint32)
    md_cap = max(1 << 16, (n_rows + n_reads) * 512)
    xa_cap = max(1 << 16, (n_rows + n_reads) * 256)
    md_arena = np.zeros(md_cap, dtype=np.uint8)
    xa_arena = np.zeros(xa_cap, dtype=np.uint8)
    rec_md_off = np.zeros(rec_cap, dtype=np.int64)
    rec_md_len = np.zeros(rec_cap, dtype=np.int32)
    rec_xa_off = np.zeros(rec_cap, dtype=np.int64)
    rec_xa_len = np.zeros(rec_cap, dtype=np.int32)
    mate_rid = np.zeros(n_reads, dtype=np.int32)
    mate_pos = np.zeros(n_reads, dtype=np.int64)
    mate_is_rev = np.zeros(n_reads, dtype=np.uint8)
    mate_rlen = np.zeros(n_reads, dtype=np.int32)

    pes_io = np.zeros(20, dtype=np.float64)
    use_in = 0
    if pes_in is not None:
        for d, r in enumerate(pes_in):
            pes_io[d * 5: d * 5 + 5] = (r.low, r.high, r.avg, r.std,
                                        1.0 if r.failed else 0.0)
        use_in = 1

    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    from ..utils.profiling import PROFILER
    with PROFILER.phase("native_pe_c"):
        rc = lib.finalize_pe_batch(
            ctypes.c_int64(n_rows),
            _ptr(cols["read"], ctypes.c_int32),
            _ptr(cols["rb"], ctypes.c_int64),
            _ptr(cols["re"], ctypes.c_int64),
            _ptr(cols["qb"], ctypes.c_int32),
            _ptr(cols["qe"], ctypes.c_int32),
            _ptr(cols["rid"], ctypes.c_int32),
            _ptr(cols["score"], ctypes.c_int32),
            _ptr(cols["truesc"], ctypes.c_int32),
            _ptr(cols["w"], ctypes.c_int32),
            _ptr(cols["seedcov"], ctypes.c_int32),
            _ptr(cols["seedlen0"], ctypes.c_int32),
            ctypes.c_int64(n_pairs),
            _ptr(frac_rep, ctypes.c_float),
            _ptr(read_ids, ctypes.c_int64),
            _ptr(skip_dedup, ctypes.c_uint8),
            _ptr(codes, ctypes.c_int32),
            ctypes.c_int64(codes.shape[1]),
            _ptr(lens, ctypes.c_int32),
            _ptr(ref, ctypes.c_uint8),
            ctypes.c_int64(bns.l_pac),
            ctypes.c_int64(len(bns.anns)),
            _ptr(ann_off, ctypes.c_int64),
            _ptr(ann_len, ctypes.c_int64),
            _ptr(ann_alt, ctypes.c_uint8),
            ctypes.c_char_p(names),
            _ptr(name_off, ctypes.c_int64),
            _ptr(mat, ctypes.c_int8),
            ctypes.c_int32(opt.a), ctypes.c_int32(opt.b),
            ctypes.c_int32(opt.o_del), ctypes.c_int32(opt.e_del),
            ctypes.c_int32(opt.o_ins), ctypes.c_int32(opt.e_ins),
            ctypes.c_int32(opt.w), ctypes.c_int32(opt.T),
            ctypes.c_int32(opt.min_seed_len),
            ctypes.c_int32(opt.max_chain_gap),
            ctypes.c_double(opt.mask_level),
            ctypes.c_double(opt.drop_ratio),
            ctypes.c_double(opt.XA_drop_ratio),
            ctypes.c_double(opt.mask_level_redun),
            ctypes.c_int32(opt.max_XA_hits),
            ctypes.c_int32(opt.max_XA_hits_alt),
            ctypes.c_int32(opt.mapQ_coef_len),
            ctypes.c_double(opt.mapQ_coef_fac),
            ctypes.c_int32(opt.flag),
            ctypes.c_int32(opt.max_ins),
            ctypes.c_int32(opt.pen_unpaired),
            ctypes.c_int32(opt.max_matesw),
            _ptr(pes_io, ctypes.c_double),
            ctypes.c_int32(use_in),
            _ptr(rd_nrec, ctypes.c_int32),
            ctypes.c_int64(rec_cap),
            _ptr(rec_read, ctypes.c_int32),
            _ptr(rec_rid, ctypes.c_int32),
            _ptr(rec_pos, ctypes.c_int64),
            _ptr(rec_flag, ctypes.c_int32),
            _ptr(rec_mapq, ctypes.c_int32),
            _ptr(rec_score, ctypes.c_int32),
            _ptr(rec_sub, ctypes.c_int32),
            _ptr(rec_nm, ctypes.c_int32),
            _ptr(rec_alt_sc, ctypes.c_int32),
            _ptr(rec_is_rev, ctypes.c_uint8),
            _ptr(rec_is_alt, ctypes.c_uint8),
            _ptr(rec_ncig, ctypes.c_int32),
            _ptr(cig_out.reshape(-1), ctypes.c_uint32),
            ctypes.c_int32(CIG_STRIDE),
            md_arena.ctypes.data_as(ctypes.c_char_p),
            ctypes.c_int64(md_cap),
            _ptr(rec_md_off, ctypes.c_int64),
            _ptr(rec_md_len, ctypes.c_int32),
            xa_arena.ctypes.data_as(ctypes.c_char_p),
            ctypes.c_int64(xa_cap),
            _ptr(rec_xa_off, ctypes.c_int64),
            _ptr(rec_xa_len, ctypes.c_int32),
            _ptr(mate_rid, ctypes.c_int32),
            _ptr(mate_pos, ctypes.c_int64),
            _ptr(mate_is_rev, ctypes.c_uint8),
            _ptr(mate_rlen, ctypes.c_int32),
        )
    if rc == -1:
        return None
    if rc == -2:
        raise RuntimeError("native PE: rid consistency failure")
    n_rec = int(rc)
    raw = dict(
        n_rec=n_rec, read=rec_read, rid=rec_rid, pos=rec_pos,
        flag=rec_flag, mapq=rec_mapq, score=rec_score, sub=rec_sub,
        nm=rec_nm, alt_sc=rec_alt_sc, is_rev=rec_is_rev,
        is_alt=rec_is_alt, ncig=rec_ncig, cig=cig_out,
        cig_stride=CIG_STRIDE, md_arena=md_arena, md_off=rec_md_off,
        md_len=rec_md_len, xa_arena=xa_arena, xa_off=rec_xa_off,
        xa_len=rec_xa_len)
    if want == "raw":
        return raw, dict(rid=mate_rid, pos=mate_pos,
                         is_rev=mate_is_rev, rlen=mate_rlen), pes_io
    recs = records_from_raw(raw)
    mrid_l = mate_rid.tolist()
    mpos_l = mate_pos.tolist()
    mrev_l = mate_is_rev.tolist()
    mrlen_l = mate_rlen.tolist()
    mates = []
    for i in range(n_reads):
        m = Aln()
        m.rid = mrid_l[i]
        m.pos = mpos_l[i]
        m.is_rev = bool(mrev_l[i])
        m.flag = 0 if m.rid >= 0 else 0x4
        m.cigar = [(mrlen_l[i], 0)] if mrlen_l[i] > 0 else None
        mates.append(m)
    return recs, mates, pes_io
