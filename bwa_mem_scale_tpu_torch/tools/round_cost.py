"""The cost of one dependent round of a warp on the card: the yardstick of
the chaining kernels' latency floor (their longest read's rounds, as
csrc/chain.cu counts them, times this cost); and of one dependent load
on a table of a given footprint, the yardstick of the FM walks' floors
(``dependent_trip_us``).

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


TRIP_TICKS = (64, 1088)      # probe B's two tick counts, timed in turns
TRIP_TURNS = 5               # turns of both counts; the trip their median


def cycle_table(dev: torch.device, rows: int, seed: int = 5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A [rows, 8] int32 table on which probe B's chain visits every row
    once before it comes back to one, and the rows in the cycle's order:
    the rows in one random cycle (Sattolo's), each row's eight words
    summing to the value whose wrapped product with LCG_MULT is the next
    row of the cycle (csrc/probes.cu next_index). No chain revisits a
    row, so no load is served by the L1 from an earlier tick. Raises
    RuntimeError where probe B's plain rule does not follow the cycle."""
    from ..ops import probe_kernels as pk
    g = torch.Generator(device=dev).manual_seed(seed)
    order = torch.randperm(rows, device=dev, generator=g)
    nxt = torch.empty_like(order)
    nxt[order] = order.roll(-1)
    want = nxt * pow(pk.LCG_MULT, -1, 2 ** 32) % 2 ** 32
    words = torch.randint(-2 ** 31, 2 ** 31, (rows, 8), dtype=torch.int64,
                          device=dev, generator=g)
    words[:, 7] = (want - words[:, :7].sum(1)) % 2 ** 32
    tab = pk.wrap32(words)
    s = pk.wrap32(tab.long().sum(1)).long()
    if not torch.equal(pk.wrap32(s * pk.LCG_MULT).long() % rows, nxt):
        raise RuntimeError("cycle_table: probe B's rule leaves the cycle")
    return tab, order


def trip_turns(dev: torch.device, rows: int) -> list[float]:
    """One dependent load's latency in us on a table of `rows` rows of 32
    bytes (its footprint rows x 32 bytes: in the 50 MB L2 or past it), in
    each of TRIP_TURNS turns: probe B (csrc/probes.cu chain8_kernel, one
    lane) over ``cycle_table``, each call from another start row, the
    marginal time of the extra ticks; a turn times the two tick counts
    short, long, long, short (one slow run of either alone once gave a
    negative trip). First one warp of one block, as the timed chains run,
    walks the whole cycle (32 lanes from evenly spaced rows of it), so
    that the part of the table the L2 holds for that block is there from
    the first turn (read whole by a reduction instead, a 20 MB table
    still warmed into it turn by turn)."""
    import itertools
    from ..ops import probe_kernels as pk
    tab, order = cycle_table(dev, rows)
    g = torch.Generator(device=dev).manual_seed(6)
    starts = itertools.cycle([s.clone() for s in torch.randint(
        0, rows, (512, 1), dtype=torch.int32, device=dev,
        generator=g)])              # each its own (aligned) allocation
    span = -(-rows // WARP)                    # the cycle in 32 segments
    pk.probe_b(tab, order[::span].int().contiguous(), span)
    lo, hi = TRIP_TICKS
    out = []
    for _ in range(TRIP_TURNS):
        t = {n: 0.0 for n in TRIP_TICKS}
        for n in (lo, hi, hi, lo):
            t[n] += device_ms(lambda: pk.probe_b(tab, next(starts), n), 10,
                              dev) / 2
        out.append((t[hi] - t[lo]) * 1e3 / (hi - lo))
    del tab
    return out


def dependent_trip_us(dev: torch.device, rows: int) -> float:
    """The median of ``trip_turns``: one dependent load's us on a table
    of `rows` rows of 32 bytes."""
    return float(np.median(trip_turns(dev, rows)))


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
