"""nvcc into a shared library with a plain C interface, for ctypes.

Every CUDA source of the port (``csrc/*.cu``) is compiled on the machine
with the GPU at first use into ``build/torch_kernels/lib<name>.so`` and
rebuilt when the source's SHA-256 differs from the stamp written beside
the library. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


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


def build(source: str, name: str, force: bool = False,
          verbose: bool = False) -> tuple[str, float | None]:
    """Compile `source` into lib<name>.so unless a library built from the
    same source exists. Returns (library path, seconds nvcc took, or None
    when the existing library was kept). verbose prints ptxas's register
    / spill report."""
    path = lib_path(name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    stamp = path + ".sha256"
    if not force and os.path.exists(path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    proc = subprocess.run([nvcc(), *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {os.path.basename(source)} failed "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="", flush=True)
    os.replace(tmp, path)
    with open(stamp, "w") as f:
        f.write(digest)
    return path, time.perf_counter() - t0
