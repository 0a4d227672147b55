"""Measure the primitive rates that decide the CUDA seeding kernel's
design. The counterpart of ``tools/probe_pallas_rates.py``:

    python -m bwa_mem_scale_tpu_torch.tools.probe_cuda_rates [ABCDEF]
        [--device cuda|cpu]

  A. Shared memory per block: the largest dynamic allocation that runs
     must equal the card's opt-in limit; larger launches are refused.
  B. Chained dependent row loads, T lanes x NT ticks, from shared memory,
     L2 and HBM: the TPU's [8192, 128] table, and the port's 32-byte occ
     row at 7,168 rows (shared memory), 287,501 (a 4.6 Mbp genome, in
     L2), 2,875,001 (a 46 Mbp, chr21-sized genome, beyond L2) and 2^24
     rows (512 MB). Prints ns/row over NT = 32 ticks, the marginal cost of
     one more tick (the dependent-load latency with T lanes in flight,
     plus the tick's sum, multiply and fastmod, which is what a seeding
     tick pays beyond its load), and beside it the plain version's
     ns/row.
  C. Lane gather within a row, [1024, 128] and [4096, 8].
  D. The handoff of an address vector to one thread, one TMA bulk copy
     into shared memory: T = 1,024, 4,096 and 57,344 lanes (224 KB),
     vectors made from a seed.
  E. Row copies, NT = 8 ticks of T rows, from the same tables as B past
     shared memory (non-zero, made from a seed), the rows spread over
     the card's SMs, each block keeping D (4, 16, 64) row copies in
     flight (cp.async for the 32-byte occ row, one TMA bulk copy for a
     512-byte row); each line prints the copies in flight across the
     card (the sum over blocks of min(D, the block's rows), so D caps at
     a block's rows; from the launch's own rule, ``pk.probe_e_plan``),
     ns/row over the 8 ticks, and the first tick (from
     HBM or a cold L2) apart from the later ones (the same rows again).
  F. B's plain version alone: ``tab[idx]`` in a torch loop, the port's
     current primitive (the TPU's probe_F timed the XLA gather).

Every kernel result is held against its plain version first; a mismatch,
a failed launch or a wrong probe A prints FAIL and the exit code is 1.
Each line ends with the card's name and power limit. ``--device cpu``
runs the plain versions on the host, which says nothing of a card, with
tables capped at 16,384 rows, lanes at 256 and ticks at 4: it checks
the control flow only.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import traceback

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..ops import probe_kernels as pk
from .probe_cuda import L2_OCC_ROWS, OCC_W, SMEM_OCC_ROWS
from .timing import card_line, device_ms, time_ms

CHR21_OCC_ROWS = 2_875_001          # ceil((2 * 46e6 + 1) / 32)
B_TABLES = ((128, 1 << 13), (OCC_W, SMEM_OCC_ROWS), (OCC_W, L2_OCC_ROWS),
            (OCC_W, CHR21_OCC_ROWS), (OCC_W, 1 << 24))
E_TABLES = ((128, 1 << 20),) + B_TABLES[2:]
LANES = (1024, 4096)
D_LANES = (1024, 4096, 57344)    # 57,344 lanes = 224 KB of shared memory
B_TICKS, B_EXTRA_TICKS, E_TICKS = 32, 256, 8
A_ROWS = (2, 8, 16, 32, 64, 96, 128, 192, 256, 320, 384, 448)   # x 512 B


@dataclasses.dataclass
class Run:
    dev: torch.device
    card: str = ""

    @property
    def small(self) -> bool:
        """Off the card the sizes only check the control flow."""
        return self.dev.type != "cuda"

    def rows(self, n: int) -> int:
        return min(n, 1 << 14) if self.small else n

    def lanes(self, n: int) -> int:
        return min(n, 256) if self.small else n

    def ticks(self, n: int) -> int:
        return min(n, 4) if self.small else n

    def reps(self, n: int) -> int:
        return 1 if self.small else n

    @property
    def on(self) -> str:
        return "on the device" if self.dev.type == "cuda" else "on the host"

    def say(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)


def random_table(run: Run, rows: int, w: int, seed: int) -> torch.Tensor:
    """[rows, w] int32 over the whole range, made on the device."""
    g = torch.Generator(device=run.dev).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (rows, w), generator=g,
                         dtype=torch.int32, device=run.dev)


def index_variants(run: Run, T: int, nb: int, mult: int, step: int,
                   n: int) -> list[torch.Tensor]:
    """The TPU probes' lane indices, (arange(T) * mult + r * step) % nb,
    one set a repetition so no run finds the last run's rows cached."""
    return [torch.as_tensor((np.arange(T, dtype=np.int64) * mult + r * step)
                            % nb, dtype=torch.int32, device=run.dev)
            for r in range(n)]


def cycled(fn, variants):
    """A thunk calling fn on the next variant each time."""
    state = {"i": 0}

    def call():
        v = variants[state["i"] % len(variants)]
        state["i"] += 1
        return fn(v)
    return call


def table_label(run: Run, nb: int, w: int) -> str:
    mb = nb * w * 4 / 2**20
    if pk.probe_b_uses_smem(nb, w, run.dev):
        where = "shared memory"
    elif run.dev.type == "cuda":
        l2 = torch.cuda.get_device_properties(run.dev).L2_cache_size
        where = "fits L2" if nb * w * 4 <= l2 else "beyond L2"
    else:
        where = "host memory"
    return f"W={w:3d} NB={nb:>9} ({mb:.2f} MB, {where})"


def require_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version")


def probe_a(run: Run, **_) -> bool:
    print("--- A: dynamic shared memory per block ---", flush=True)
    W = 128
    row = W * 4
    x = torch.ones((1, W), dtype=torch.int32, device=run.dev)
    limit = pk.smem_optin(run.dev)
    sizes = [n * row for n in A_ROWS] + [limit // row * row]
    if run.dev.type == "cuda":
        sizes += [limit // row * row + row, 256 * 1024]
    largest = 0
    for size in sorted(set(sizes)):
        try:
            out = pk.probe_a(x, size // row)
            synchronize(run.dev)
        except pk.ProbeLaunchError as e:
            print(f"  {size:>7} B: refused (CUDA error {e.rc})", flush=True)
            continue
        good = torch.equal(out, 2 * x)
        print(f"  {size:>7} B: {'OK' if good else 'WRONG'}", flush=True)
        if good:
            largest = max(largest, size)
    ok = largest == limit
    run.say(f"  largest that ran {largest} B; opt-in limit {limit} B: "
            f"{'OK' if ok else 'FAIL'}")
    return ok


def timed(run: Run, fn, reps: int) -> tuple[float, float]:
    """(device ms, wall ms) a call of fn over reps back-to-back calls."""
    return (device_ms(fn, run.reps(reps), run.dev),
            time_ms(fn, run.reps(reps), run.dev))


def probe_b(run: Run, kernel: bool = True) -> bool:
    print("--- B: chained dependent row loads"
          + ("" if kernel else " (plain version only: F)") + " ---",
          flush=True)
    nt, nt2 = run.ticks(B_TICKS), run.ticks(B_TICKS) + run.ticks(
        B_EXTRA_TICKS)
    for w, nb0 in B_TABLES:
        nb = run.rows(nb0)
        if w == 128:      # the TPU probe's table
            tab = torch.arange(nb * w, dtype=torch.int32,
                               device=run.dev).reshape(nb, w)
        else:
            tab = random_table(run, nb, w, seed=nb)
        for T0 in LANES:
            T = run.lanes(T0)
            var = index_variants(run, T, nb, 9973, 131, 6)
            line = f"  {table_label(run, nb, w)} T={T:5d}:"
            p_dev, p_wall = timed(run, cycled(
                lambda v: pk.probe_b_plain(tab, v, nt), var), 3)
            plain = (f"plain {p_wall * 1e6 / (nt * T):.2f} ns/row "
                     f"({p_wall:.3f} ms a call of {nt} ticks, {p_dev:.3f} ms"
                     f" of it {run.on})")
            if not kernel:
                run.say(f"{line} {plain}")
                continue
            require_equal(line, pk.probe_b(tab, var[0], nt),
                          pk.probe_b_plain(tab, var[0], nt))
            dev_ms, wall = timed(run, cycled(
                lambda v: pk.probe_b(tab, v, nt), var), 20)
            dev_ms2 = device_ms(cycled(lambda v: pk.probe_b(tab, v, nt2),
                                       var), run.reps(20), run.dev)
            per_tick = (dev_ms2 - dev_ms) * 1e3 / (nt2 - nt)
            run.say(f"{line} kernel {dev_ms * 1e6 / (nt * T):.3f} ns/row "
                    f"({dev_ms:.4f} ms {run.on} for {nt} ticks, "
                    f"{wall:.4f} ms a call back to back), {per_tick:.4f} "
                    f"us/tick marginal; {plain}")
        del tab
    return True


def probe_c(run: Run, **_) -> bool:
    print("--- C: lane gather within a row ---", flush=True)
    for T0, W in ((1024, 128), (4096, OCC_W)):
        T = run.lanes(T0)
        x = torch.arange(T * W, dtype=torch.int32,
                         device=run.dev).reshape(T, W)
        idx = (torch.arange(T * W, dtype=torch.int32, device=run.dev) * 7
               % W).reshape(T, W)
        require_equal(f"C [{T}, {W}]", pk.probe_c(x, idx),
                      pk.probe_c_plain(x, idx))
        dev_ms, wall = timed(run, lambda: pk.probe_c(x, idx), 50)
        p_dev, p_wall = timed(run, lambda: pk.probe_c_plain(x, idx), 50)
        run.say(f"  [{T}, {W}]: kernel {dev_ms * 1e3:.2f} us {run.on} "
                f"({dev_ms * 1e6 / T:.3f} ns/row), {wall * 1e3:.2f} us a "
                f"call; plain {p_dev * 1e3:.2f} us {run.on}, "
                f"{p_wall * 1e3:.2f} us a call")
    return True


def handoff_vector(run: Run, T: int, seed: int) -> torch.Tensor:
    """[T] int32 over the whole range from a seed, so the element read
    back is one the copy had to deliver."""
    return random_table(run, 1, T, seed)[0]


def probe_d(run: Run, **_) -> bool:
    print("--- D: address vector handed to one thread (TMA bulk copy) ---",
          flush=True)
    for T0 in D_LANES:
        T = run.lanes(T0)
        v = handoff_vector(run, T, seed=T)
        require_equal(f"D T={T}", pk.probe_d(v), pk.probe_d_plain(v))
        dev_ms, wall = timed(run, lambda: pk.probe_d(v), 200)
        p_dev, p_wall = timed(run, lambda: pk.probe_d_plain(v), 200)
        run.say(f"  T={T:5d} ({T * 4} B): kernel {dev_ms * 1e3:.2f} us "
                f"{run.on}, {wall * 1e3:.2f} us a call; plain "
                f"{p_dev * 1e3:.2f} us {run.on}, {p_wall * 1e3:.2f} us a "
                f"call")
    return True


def probe_e(run: Run, **_) -> bool:
    print("--- E: row copies, D in flight per block ---", flush=True)
    nt = run.ticks(E_TICKS)
    on_card = run.dev.type == "cuda"
    sms = torch.cuda.get_device_properties(run.dev).multi_processor_count \
        if on_card else 0
    for w, nb0 in E_TABLES:
        nb = run.rows(nb0)
        tab = random_table(run, nb, w, seed=nb + 1)
        for T0 in LANES:
            T = run.lanes(T0)
            var = index_variants(run, T, nb, 999983, 771, 6)
            line = f"  {table_label(run, nb, w)} T={T:5d}"
            p_dev, p_wall = timed(run, cycled(
                lambda v: pk.probe_e_plain(v, tab, nt), var), 3)
            for D in pk.DEPTHS:
                plan = ""
                if on_card:
                    blocks, most, flight = pk.probe_e_plan(T, D, sms)
                    plan = (f" ({flight} copies in flight on {blocks} blocks"
                            f" of <= {most} rows)")
                require_equal(f"{line} D={D}", pk.probe_e(var[0], tab, nt, D),
                              pk.probe_e_plain(var[0], tab, nt))
                dev_ms, wall = timed(run, cycled(
                    lambda v: pk.probe_e(v, tab, nt, D), var), 20)
                first = device_ms(cycled(lambda v: pk.probe_e(v, tab, 1, D),
                                         var), run.reps(20), run.dev)
                later = (dev_ms - first) / (nt - 1)
                run.say(f"{line} D={D:2d}{plan}: kernel "
                        f"{dev_ms * 1e6 / (nt * T):.3f} ns/row over {nt} "
                        f"ticks {run.on} ({wall:.4f} ms a call back to "
                        f"back); first tick "
                        f"{first * 1e6 / T:.3f} ns/row, later ticks "
                        f"{later * 1e6 / T:.3f} ns/row; plain "
                        f"{p_wall * 1e6 / (nt * T):.3f} ns/row ({p_wall:.4f}"
                        f" ms a call, {p_dev:.4f} ms of it {run.on})")
        del tab
    return True


PROBES = {"A": probe_a, "B": probe_b, "C": probe_c, "D": probe_d,
          "E": probe_e}


@dataclasses.dataclass
class KernelCase:
    """A probe kernel at its path's shapes: the kernel and its plain
    version as thunks; the bytes the function must move (each input row
    it needs read once, each output written once) and its integer
    operations, for its bound; and one PyTorch call computing the same
    function, where there is one, as a yardstick (the port never calls
    it)."""
    name: str
    kernel: object
    plain: object
    nbytes: int
    ops: int
    library: object = None


def b_inputs(run: Run) -> tuple[torch.Tensor, torch.Tensor]:
    """probe_b's table and lanes on the path: the 4.6 Mbp occ table
    [287,501, 8] (in L2) and 4,096 lanes."""
    return (random_table(run, L2_OCC_ROWS, OCC_W, seed=4),
            index_variants(run, 4096, L2_OCC_ROWS, 9973, 131, 1)[0])


def e_inputs(run: Run) -> tuple[torch.Tensor, torch.Tensor]:
    """probe_e's table and rows on the path: the chr21-sized occ table
    [2,875,001, 8] and 1,024 rows."""
    return (random_table(run, CHR21_OCC_ROWS, OCC_W, seed=6),
            index_variants(run, 1024, CHR21_OCC_ROWS, 999983, 771, 1)[0])


def kernel_work(dev: torch.device) -> list[KernelCase]:
    """Each probe kernel at the shapes this slice's path gives it: the
    port's occ row where the probe has one, the TPU probe's shapes
    otherwise."""
    run = Run(dev)
    g = np.random.RandomState(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    def nb(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    def rows_read(tab, idx, n=None):
        """Bytes of the distinct rows idx names (n of them when given)."""
        n = len(torch.unique(idx)) if n is None else min(n, tab.shape[0])
        return n * tab.shape[1] * tab.element_size()

    x1 = t(np.arange(8 * 128).reshape(8, 128))
    one = torch.ones(1, dtype=torch.int32, device=dev)
    tab2 = random_table(run, SMEM_OCC_ROWS, OCC_W, seed=2)
    idx2 = t(g.randint(0, SMEM_OCC_ROWS, (64, 1)))
    tab3, idx_b = b_inputs(run)
    idx3 = t(g.randint(0, L2_OCC_ROWS, (32, 1)))
    xa = torch.ones((1, 128), dtype=torch.int32, device=dev)
    rows_a = pk.smem_optin(dev) // (128 * 4)
    xc = t(np.arange(1024 * 128).reshape(1024, 128))
    ic = t(np.arange(1024 * 128).reshape(1024, 128) * 7 % 128)
    ic64 = ic.long()
    vd = handoff_vector(run, 4096, seed=4096)
    tab_e, idx_e = e_inputs(run)
    idx_e64 = idx_e.long()
    row = 4 * OCC_W                                  # bytes of one output

    def index_select_ticks():
        for _ in range(E_TICKS):
            rows = torch.index_select(tab_e, 0, idx_e64)
        return rows[:1]

    return [
        KernelCase("probe1", lambda: pk.probe1(x1),
                   lambda: pk.probe1_plain(x1), 2 * nb(x1), 2 * x1.numel(),
                   lambda: torch.addcmul(one, x1, one, value=2)),
        KernelCase("probe2", lambda: pk.probe2(tab2, idx2),
                   lambda: pk.probe2_plain(tab2, idx2),
                   rows_read(tab2, idx2) + nb(idx2) + row,
                   idx2.numel() * OCC_W),
        KernelCase("probe3", lambda: pk.probe3(idx3, tab3),
                   lambda: pk.probe3_plain(idx3, tab3),
                   rows_read(tab3, idx3) + nb(idx3) + row,
                   idx3.numel() * OCC_W),
        KernelCase("probe_a", lambda: pk.probe_a(xa, rows_a),
                   lambda: pk.probe_a_plain(xa, rows_a), 2 * nb(xa),
                   xa.numel(), lambda: torch.add(xa, xa)),
        # each tick: 8 words summed (7 adds), a multiply and a modulo
        KernelCase("probe_b", lambda: pk.probe_b(tab3, idx_b, B_TICKS),
                   lambda: pk.probe_b_plain(tab3, idx_b, B_TICKS),
                   rows_read(tab3, idx_b, idx_b.numel() * B_TICKS)
                   + nb(idx_b) + row, idx_b.numel() * B_TICKS * 9),
        KernelCase("probe_c", lambda: pk.probe_c(xc, ic),
                   lambda: pk.probe_c_plain(xc, ic), 3 * nb(xc), 0,
                   lambda: torch.gather(xc, 1, ic64)),
        KernelCase("probe_d", lambda: pk.probe_d(vd),
                   lambda: pk.probe_d_plain(vd), nb(vd) + 4, 0,
                   lambda: torch.clone(vd[pk.HANDOFF_INDEX:
                                          pk.HANDOFF_INDEX + 1].view(1, 1))),
        KernelCase("probe_e", lambda: pk.probe_e(idx_e, tab_e, E_TICKS, 16),
                   lambda: pk.probe_e_plain(idx_e, tab_e, E_TICKS),
                   rows_read(tab_e, idx_e) + nb(idx_e) + row, 0,
                   index_select_ticks),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bwa_mem_scale_tpu_torch.tools.probe_cuda_rates",
        description="Measure the primitive rates of the probe kernels.")
    ap.add_argument("which", nargs="?", default="ABCDEF",
                    help="probes to run, letters A-F (default all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without CUDA) or cpu (the "
                         "plain versions on the host at small sizes: checks "
                         "the control flow, measures nothing)")
    args = ap.parse_args(argv)
    which = set(args.which.upper())
    if not which or which - set("ABCDEF"):
        ap.error(f"which: letters A-F, got {args.which!r}")
    dev = resolve_device(args.device)
    run = Run(dev, card_line(dev))
    print(f"device: {run.dev} [{run.card}]", flush=True)
    ok = True
    for ch, fn in PROBES.items():
        kw = {}
        if ch == "B":
            if not which & {"B", "F"}:
                continue
            kw["kernel"] = "B" in which
        elif ch not in which:
            continue
        try:
            ok &= fn(run, **kw)
            synchronize(run.dev)
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"  probe {ch}: FAIL", flush=True)
    print("RATES_OK" if ok else "RATES_FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
