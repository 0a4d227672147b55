"""nvcc into a shared library with a plain C interface, for ctypes.

Every CUDA source of the port (``csrc/*.cu``) is compiled on the machine
with the GPU at first use into ``build/torch_kernels/lib<name>.so`` and
rebuilt when the SHA-256 of the source and the ``csrc`` headers it
includes differs from the stamp written beside the library. ``Library``
builds one source, loads it and calls its C launch functions on a
device's current stream. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# ptxas's register / spill report of the last build of each library
REPORTS: dict[str, str] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the GPU")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def source_digest(source: str) -> str:
    """SHA-256 over `source` and, depth first, each header it includes
    with ``#include "..."`` (paths relative to the including file)."""
    h = hashlib.sha256()
    seen = set()

    def add(path):
        seen.add(path)
        with open(path, "rb") as f:
            data = f.read()
        h.update(data)
        for inc in re.findall(rb'^\s*#include\s+"([^"]+)"', data, re.M):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if dep not in seen:
                add(dep)

    add(os.path.abspath(source))
    return h.hexdigest()


def build(source: str, name: str, force: bool = False,
          verbose: bool = False) -> tuple[str, float | None]:
    """Compile `source` into lib<name>.so unless a library built from the
    same source exists. Returns (library path, seconds nvcc took, or None
    when the existing library was kept). ptxas's register / spill report
    goes to ``REPORTS[name]``; verbose prints it too."""
    path = lib_path(name)
    digest = source_digest(source)
    stamp = path + ".sha256"
    if not force and os.path.exists(path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {os.path.basename(source)} failed "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    REPORTS[name] = proc.stdout + proc.stderr
    if verbose:
        print(REPORTS[name], end="", flush=True)
    os.replace(tmp, path)
    with open(stamp, "w") as f:
        f.write(digest)
    return path, time.perf_counter() - t0


def ptxas_kernels(report: str) -> dict:
    """{kernel's mangled name: (registers, spill bytes)} from ptxas's -v
    report (``REPORTS``)."""
    out, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, (None, 0))
        if fn is None:
            continue
        regs, spill = out[fn]
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if s:
            spill = int(s.group(1)) + int(s.group(2))
        r = re.search(r"Used (\d+) registers", ln)
        if r:
            regs = int(r.group(1))
        out[fn] = (regs, spill)
    return out


class Library:
    """csrc/<source> as lib<name>.so: built at first use, loaded with
    ctypes, its launch functions (each returning a CUDA error code and
    taking the stream last) called on a device's current stream.
    `argtypes` maps each function to its ctypes argument types, the
    stream left out; `host_fns` maps the library's host functions (no
    stream, an int back) the same way, for ``call``."""

    def __init__(self, source: str, name: str, argtypes: dict,
                 host_fns: dict = None):
        self.source = os.path.join(REPO, "csrc", source)
        self.name = name
        self.path = lib_path(name)
        self.argtypes = argtypes
        self.host_fns = host_fns or {}
        self.build_seconds = None   # nvcc's wall time, when this process built
        self._lib = None
        # the shards of a device mesh launch from threads of their own:
        # one of them builds and loads, the others wait
        self._lock = threading.Lock()

    def build(self, force: bool = False, verbose: bool = False) -> str:
        """Compile unless a library built from the same source exists
        (``build``). Returns the library path."""
        path, seconds = build(self.source, self.name, force, verbose)
        if seconds is not None:
            self.build_seconds = seconds
        return path

    def load(self):
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            lib = ctypes.CDLL(self.build())
            for fn, types in self.argtypes.items():
                f = getattr(lib, fn)
                f.argtypes = [*types, ctypes.c_void_p]
                f.restype = ctypes.c_int
            for fn, types in self.host_fns.items():
                f = getattr(lib, fn)
                f.argtypes = types
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> int:
        """lib.<fn>(*args) for a host function of ``host_fns``."""
        return getattr(self.load(), fn)(*args)

    def launch(self, dev, fn: str, *args) -> None:
        """lib.<fn>(*args, stream) on dev's current stream; raises on the
        CUDA error it returns. No synchronisation."""
        import torch
        lib = self.load()
        with torch.cuda.device(dev):
            rc = getattr(lib, fn)(*args,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {rc}")
