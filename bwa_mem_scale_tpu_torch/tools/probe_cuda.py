"""Do the probe kernels build, launch and compute what the TPU probes
computed? The counterpart of ``tools/probe_pallas.py``:

    python -m bwa_mem_scale_tpu_torch.tools.probe_cuda [--device cuda|cpu]

Prints PROBE_<n>_{OK,FAIL} and exits 1 on any FAIL:
  1. ``x * 2 + 1`` on [8, 128] int32; on a card also the cost of one
     launch through the wrapper (host enqueue, back to back, with a
     synchronise after each, and on the device once queued) beside that
     of one PyTorch op;
  2. a row-gather sum from a table in shared memory, at the TPU's
     [512, 128] table and at the port's occ row: [7,168, 8], the most
     32-byte rows one block's shared memory holds;
  3. the same sum with rows copied from device memory through a
     double-buffered cp.async ring, at the TPU's [4096, 128] table and at
     [287,501, 8], the fused occ table of a 4.6 Mbp genome.
Each result is held against a numpy computation of the same function.
``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..ops import probe_kernels as pk
from .timing import card_line, device_ms, time_ms

OCC_W = 8                  # the port's fused occ row, int32 words
SMEM_OCC_ROWS = 7_168      # 224 KB of 32-byte rows
L2_OCC_ROWS = 287_501      # occ blocks of 4.6 Mbp: ceil((2 * 4.6e6 + 1) / 32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _row_sum(tab: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return tab[idx[:, 0]].sum(0, dtype=np.int32)


def _random_table(rows: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        -2**31, 2**31, (rows, w), dtype=np.int64).astype(np.int32)


def launch_cost(x: torch.Tensor, n: int = 2000) -> str:
    """Microseconds per probe1 wrapper call: host enqueue, CUDA events
    over back-to-back calls, call plus synchronise, and device time per
    launch once all are queued; and, for scale, one PyTorch op (x + 1)
    back to back, the unit of the seeding loop."""
    dev = x.device
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        pk.probe1(x)
    enqueue = (time.perf_counter() - t0) * 1e6 / n
    back_to_back = time_ms(lambda: pk.probe1(x), n, dev) * 1e3
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n // 10):
        pk.probe1(x)
        synchronize(dev)
    with_sync = (time.perf_counter() - t0) * 1e6 / (n // 10)
    # fewer calls: the launch queue holds about a thousand launches
    queued = device_ms(lambda: pk.probe1(x), n // 4, dev) * 1e3
    torch_op = time_ms(lambda: x + 1, n, dev) * 1e3
    return (f"  probe1 launch cost: {enqueue:.2f} us host enqueue, "
            f"{back_to_back:.2f} us back to back (CUDA events), "
            f"{with_sync:.2f} us with a synchronise after each, "
            f"{queued:.2f} us on the device once queued; one torch op back "
            f"to back {torch_op:.2f} us")


def probe1(dev: torch.device, card: str) -> None:
    xn = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    x = torch.as_tensor(xn, device=dev)
    np.testing.assert_array_equal(_np(pk.probe1(x)), xn * 2 + 1)
    if dev.type == "cuda":
        print(f"{launch_cost(x)}  [{card}]", flush=True)


def probe2(dev: torch.device, card: str) -> None:
    T, W, N = 512, 128, 64                     # the TPU probe's shapes
    tab = (np.arange(T * W, dtype=np.int32).reshape(T, W) % 97)
    idx = (np.arange(N, dtype=np.int32).reshape(N, 1) * 7 % T)
    port = (_random_table(SMEM_OCC_ROWS, OCC_W, seed=2),
            np.random.RandomState(3).randint(
                0, SMEM_OCC_ROWS, (N, 1)).astype(np.int32))
    for tab_n, idx_n in ((tab, idx), port):
        out = pk.probe2(torch.as_tensor(tab_n, device=dev),
                        torch.as_tensor(idx_n, device=dev))
        np.testing.assert_array_equal(_np(out)[0], _row_sum(tab_n, idx_n))


def probe3(dev: torch.device, card: str) -> None:
    T, W, N = 4096, 128, 32                    # the TPU probe's shapes
    tab = np.arange(T * W, dtype=np.int32).reshape(T, W) % 89
    idx = (np.arange(N, dtype=np.int32) * 131 % T).reshape(N, 1)
    port = (_random_table(L2_OCC_ROWS, OCC_W, seed=4),
            np.random.RandomState(5).randint(
                0, L2_OCC_ROWS, (N, 1)).astype(np.int32))
    for tab_n, idx_n in ((tab, idx), port):
        out = pk.probe3(torch.as_tensor(idx_n, device=dev),
                        torch.as_tensor(tab_n, device=dev))
        np.testing.assert_array_equal(_np(out)[0], _row_sum(tab_n, idx_n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.probe_cuda",
        description="Check that the probe kernels build, launch and "
                    "compute what the TPU probes computed.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without CUDA) or cpu (the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(f"device: {dev} [{card}]", file=sys.stderr, flush=True)
    ok = True
    for i, fn in enumerate((probe1, probe2, probe3), 1):
        try:
            fn(dev, card)
            synchronize(dev)
            print(f"PROBE_{i}_OK", flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"PROBE_{i}_FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
