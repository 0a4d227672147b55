"""Where a number was taken, and how long a call takes there."""

from __future__ import annotations

import subprocess
import time

import torch

CPU_LABEL = "cpu: plain PyTorch versions, host clock, not a device time"


def card_line(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card (the first card's
    when `dev` names no index), or CPU_LABEL on the CPU."""
    if dev.type != "cuda":
        return CPU_LABEL
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[dev.index or 0]


def _host_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls after one
    warm-up: CUDA events around the whole run on a card (a call that
    enqueues slower than the card runs it is timed at the host's rate),
    the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        return _host_ms(fn, reps)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls: a
    spin kernel holds the stream for twice the host's enqueue time of the
    run (at 2 GHz), so the events time only the queued work, not the
    host's launch rate. On the CPU, the host clock (as time_ms)."""
    fn()
    if dev.type != "cuda":
        return _host_ms(fn, reps)
    torch.cuda.synchronize(dev)
    enqueue_ms = _host_ms(fn, reps) * reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_ms * 2e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps



def wall_ms(fn, reps: int = 20) -> float:
    """Mean host milliseconds of fn() then a device synchronisation: the
    host wall of a synchronised call, which device time misses where a
    call's cost is host dispatch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps
