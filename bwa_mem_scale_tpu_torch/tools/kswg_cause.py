"""What a row of the CIGAR DP kernel (csrc/kswg.cu) costs at each strip
width, measured on one card: the choice of a pair's strip R.

    python -m bwa_mem_scale_tpu_torch.tools.kswg_cause

A pair's band of 2 w + 1 positions is held R positions a lane, R the
least of ``kswg_cuda.STRIPS`` that covers it; a wider strip does more
work a lane and leaves fewer lanes holding positions. This tool builds
csrc/kswg.cu as it is and in variants beside it under ``build/``, each
with the strip raised to at least F positions a lane (F = 2, 4, 8;
``strip_need``'s return line changed, so that the kernel and its launch
check agree; the tool stops if the line is not found exactly once; the
host plans each build's launch with ``kswg_cuda.strip`` raised alike,
inside the tool only), prints
ptxas's registers of each build, and times each build in turns
(``probe_before_after.in_turns``) on one pair of 1,024 and of 2,048 rows
at w = 15, 42 and 100 (a band of 31, 85 and 201 positions): the
difference of the device times over 1,024 rows is a row step with its
traceback step. Every build is first held equal to the plain version.
Each line carries the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import sys

import numpy as np
import torch

from ..config import MemOptions
from ..device import resolve_device
from ..ops import kswg_cuda, nvcc_build
from ..ops.kswg import ksw_global_batch
from .probe_before_after import in_turns
from .timing import card_line

FORCE = (1, 2, 4, 8)             # the least strip of each build (1: as is)
WIDTHS = (15, 42, 100)           # w of the timed pairs
ROWS = (1024, 2048)
_NEED = "  return w >= 0 ? (2 * w + 1 + WARP - 1) / WARP : 1;"


def variant_source(src: str, force: int) -> str:
    """csrc/kswg.cu with each pair's strip at least `force` positions."""
    x = "(2 * w + 1 + WARP - 1) / WARP"
    out, n = re.subn(re.escape(_NEED), lambda _: (
        f"  return w >= 0 ? ({x} > {force} ? {x} : {force}) : {force};"),
        src)
    if n != 1:
        raise SystemExit(f"kswg_cause: {_NEED!r} found {n} times in "
                         f"csrc/kswg.cu")
    return out


def forced_strip(force: int):
    """kswg_cuda.strip with the strip at least `force` positions, as
    variant_source builds the kernel."""
    def strip(w, QL, TL):
        w = min(max(int(w), 0), max(QL, TL))
        need = max(-(-(2 * w + 1) // 32), force)
        R = next((r for r in kswg_cuda.STRIPS if r >= need), None)
        return (R, 1) if R is not None else (
            kswg_cuda.SEG_R, -(-need // kswg_cuda.SEG_R))
    return strip


def pair(dev, n, w, opt):
    """One pair of n rows (a random target, its query equal) at w."""
    s = np.random.RandomState(5).randint(0, 4, max(ROWS)).astype(np.int32)
    s = s[:n]
    return (*(torch.as_tensor(x, device=dev) for x in (
        s[None], np.array([n], np.int32), s[None], np.array([n], np.int32),
        np.array([w], np.int32))), opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, opt.mat)


def main(argv=None) -> int:
    dev = resolve_device("cuda")
    card = card_line(dev)
    with open(kswg_cuda.LIB.source) as f:
        src = f.read()
    out_dir = os.path.join(nvcc_build.BUILD_DIR, "kswg_cause")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for force in FORCE:
        path = os.path.join(out_dir, f"kswg_f{force}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, force) if force > 1 else src)
        libs[f"strip >= {force}"] = nvcc_build.Library(
            path, f"kswg_f{force}", kswg_cuda.LIB.argtypes)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(force=True), libs.values()))
    for label, lib in libs.items():
        for fn, (regs, spill) in nvcc_build.ptxas_kernels(
                nvcc_build.REPORTS[lib.name]).items():
            print(f"[ptxas] {label}: {regs} registers, {spill} bytes "
                  f"spilled", flush=True)
    real = kswg_cuda.LIB, kswg_cuda.strip
    strip_of = {f"kswg_f{force}": forced_strip(force) for force in FORCE}
    opt = MemOptions()

    def call(lib, a):                    # the host plans at the build's strip
        kswg_cuda.LIB, kswg_cuda.strip = lib, strip_of[lib.name]
        try:
            return kswg_cuda.launch(*a, int(a[4].max()))
        finally:
            kswg_cuda.LIB, kswg_cuda.strip = real

    for w in WIDTHS:
        ms = {}
        for n in ROWS:
            a = pair(dev, n, w, opt)
            want = ksw_global_batch(*a)
            for label, lib in libs.items():
                got = call(lib, a)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"w={w}, {n} rows, {label}: != plain")
            ms[n] = in_turns(libs, {"call": lambda lib: lambda: call(
                lib, a)}, dev)
        for label in libs:
            step = (ms[ROWS[1]][label]["call"] - ms[ROWS[0]][label]["call"]
                    ) * 1e3 / (ROWS[1] - ROWS[0])
            print(f"[kswg] w={w} (a band of {2 * w + 1} positions), {label}:"
                  f" {ms[ROWS[0]][label]['call']:.5f} / "
                  f"{ms[ROWS[1]][label]['call']:.5f} ms at {ROWS[0]} / "
                  f"{ROWS[1]} rows, a row step with its traceback step "
                  f"{step:.4f} us (mean of 2 turns)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
