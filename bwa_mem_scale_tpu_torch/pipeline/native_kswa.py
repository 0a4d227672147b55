"""ctypes binding for the native mate-rescue SW (native/kswa.cpp).

ksw_align2 semantics (reference: src/ksw.cpp:347-381) for the PE
mate-rescue jobs; replaces a device round trip per PE batch with a
sub-millisecond host call. The port's copy of the JAX package's module;
the PE path requires it (no device or pure-Python rescue SW).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libkswa.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_NATIVE_DIR, "kswa.cpp")
        if not os.path.exists(src):
            raise ImportError("native kswa source missing")
        subprocess.check_call(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared",
             "-std=c++17", "-o", _LIB_PATH, src])
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.kswa_batch.argtypes = [
        ctypes.c_int64, u8p, i64p, i32p, u8p, i64p, i32p,
        i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.kswa_batch.restype = None
    _lib = lib
    return lib


def align_batch(seqs, targets, opt, minsc: int):
    """seqs/targets: lists of nt4 uint8 arrays. Returns
    [(score, te, qe, score2, tb, qb)] per job."""
    lib = _load()
    n = len(seqs)
    if n == 0:
        return []
    qlens = np.array([len(s) for s in seqs], np.int32)
    tlens = np.array([len(t) for t in targets], np.int32)
    qoff = np.zeros(n, np.int64)
    toff = np.zeros(n, np.int64)
    np.cumsum(qlens[:-1], out=qoff[1:])
    np.cumsum(tlens[:-1], out=toff[1:])
    qbuf = np.empty(int(qlens.sum()), np.uint8)
    tbuf = np.empty(int(tlens.sum()), np.uint8)
    for k in range(n):
        qbuf[qoff[k]: qoff[k] + qlens[k]] = seqs[k]
        tbuf[toff[k]: toff[k] + tlens[k]] = targets[k]
    mat = np.ascontiguousarray(opt.mat, np.int8)
    out = np.empty((n, 6), np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.kswa_batch(
        n, qbuf.ctypes.data_as(u8p), qoff.ctypes.data_as(i64p),
        qlens.ctypes.data_as(i32p),
        tbuf.ctypes.data_as(u8p), toff.ctypes.data_as(i64p),
        tlens.ctypes.data_as(i32p),
        mat.ctypes.data_as(i8p), opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, minsc, out.ctypes.data_as(i32p))
    return [tuple(int(v) for v in row) for row in out]
