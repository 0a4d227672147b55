"""The cost of one dependent round of a warp on the card: the yardstick of
the chaining kernels' latency floor (their longest read's rounds, as
csrc/chain.cu counts them, times this cost).

    python -m bwa_mem_scale_tpu_torch.tools.round_cost

csrc/round_probe.cu runs one warp through n rounds, each a shared-memory
load, a shuffle and a ballot that wait on one another and on the round
before. Its result is first held equal to ``round_probe_plain``; then it
is timed at two round counts (``tools/timing.py::device_ms``), and the
difference of the times over the difference of the rounds is the cost
of a round, with the launch taken out. Prints it beside the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import nvcc_build
from .timing import card_line, device_ms

WARP = 32
LIB = nvcc_build.Library("round_probe.cu", "round_probe", {
    "round_probe_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]})
build = LIB.build            # compile csrc/round_probe.cu
N_WORDS = 512                # the table: 2 KB, as the state of 64 chains
ROUNDS = (1_000, 101_000)    # the two round counts timed
CHECK_ROUNDS = 257           # the round count held against the plain model


def table(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        -2**31, 2**31, N_WORDS, dtype=np.int64).astype(np.int32)


def round_probe_plain(tab: np.ndarray, n_rounds: int) -> np.ndarray:
    """The kernel's 32 lanes in numpy: each lane's last index."""
    tab = np.asarray(tab, np.int64)
    mask = len(tab) - 1
    lanes = np.arange(WARP)
    x = lanes.copy()
    for _ in range(n_rounds):
        v = tab[x]
        u = v[v & (WARP - 1)]
        x = (u + int((u & 1).sum()) + lanes) & mask
    return x.astype(np.int32)


def round_probe(tab: torch.Tensor, n_rounds: int) -> torch.Tensor:
    """One launch of round_probe_kernel over `tab` (int32 on a card, a
    power of 2 long): each lane's last index, [32] int32."""
    out = torch.empty(WARP, dtype=torch.int32, device=tab.device)
    LIB.launch(tab.device, "round_probe_launch", tab.data_ptr(),
               tab.numel(), n_rounds, out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def round_us(dev: torch.device) -> float:
    """Microseconds of one round on `dev`'s card, once a process; raises
    RuntimeError when the kernel disagrees with its plain model."""
    host = table()
    tab = torch.as_tensor(host, device=dev)
    got = round_probe(tab, CHECK_ROUNDS).cpu().numpy()
    if not np.array_equal(got, round_probe_plain(host, CHECK_ROUNDS)):
        raise RuntimeError("round_probe_kernel != its plain model")
    t = [device_ms(lambda: round_probe(tab, n), 5, dev) for n in ROUNDS]
    return (t[1] - t[0]) * 1e3 / (ROUNDS[1] - ROUNDS[0])


def main() -> int:
    dev = resolve_device("cuda")
    build(force=True)
    print(f"[round] one warp's dependent round (a shared-memory load, a "
          f"shuffle, a ballot), equal to its plain model at "
          f"{CHECK_ROUNDS} rounds: {round_us(dev):.5f} us  "
          f"[{card_line(dev)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
