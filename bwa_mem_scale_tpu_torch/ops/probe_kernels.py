"""The eight Pallas TPU design probes as CUDA kernels (``csrc/probes.cu``).

Each TPU probe (``tools/probe_pallas.py``, ``tools/probe_pallas_rates.py``)
measured one primitive that the seeding kernel's design rests on. Each
function here computes what its TPU kernel computed:

=============  ==========================================  ==============
wrapper        computes                                    replaces
=============  ==========================================  ==============
``probe1``     ``x * 2 + 1``                               ``probe1``
``probe2``     ``sum_i tab[idx[i], :]``, table on chip     ``probe2``
``probe3``     the same sum, rows copied from HBM, 2 slots ``probe3``
``probe_a``    a shared-memory scratch of ``n_rows`` rows  ``probe_A``
``probe_b``    NT chained ticks of row loads over T lanes  ``probe_B``
               (the modulo a multiply, Lemire's fastmod)
``probe_c``    ``out[t, j] = x[t, idx[t, j]]``             ``probe_C``
``probe_d``    an address vector handed to one thread      ``probe_D``
               (one TMA bulk copy completing on an mbarrier)
``probe_e``    NT ticks of T row copies, D in flight per   ``probe_E``
               block (an mbarrier ring filled by cp.async or
               TMA bulk copies, the rows spread over the
               card)
=============  ==========================================  ==============

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors
it runs its plain PyTorch version (``<name>_plain``); there is no
fallback from the kernel to the plain version. Each wrapper counts its
launches in ``<wrapper>.launches``. All arrays are int32; sums and
products wrap as JAX's int32 does, and row indices are clamped into the
table as a JAX gather clamps them.

Where a port differs from the TPU kernel, it says so: probe_A's kernel
read a row it never wrote, so here rows 0 and n-1 both receive ``x`` and
the output is ``2 * x``.

The library is built with nvcc at first use (``ops/nvcc_build.py``) and
bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc_build

SOURCE = os.path.join(nvcc_build.REPO, "csrc", "probes.cu")
LIB_NAME = "probes"
LIB_PATH = nvcc_build.lib_path(LIB_NAME)

# TPU kernel each wrapper replaces (file:line of the function that
# reaches pl.pallas_call)
REPLACES = {
    "probe1": "tools/probe_pallas.py:23",
    "probe2": "tools/probe_pallas.py:37",
    "probe3": "tools/probe_pallas.py:62",
    "probe_a": "tools/probe_pallas_rates.py:50",
    "probe_b": "tools/probe_pallas_rates.py:75",
    "probe_c": "tools/probe_pallas_rates.py:132",
    "probe_d": "tools/probe_pallas_rates.py:159",
    "probe_e": "tools/probe_pallas_rates.py:186",
}
HANDOFF_INDEX = 17            # the element probe_D reads back
LCG_MULT = 1103515245         # probe_B's next-index multiplier
# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100; off the card the
# probe_A sweep stops there, having no card to ask
H100_SMEM_OPTIN = 232_448
DEPTHS = (4, 16, 64)          # probe_e's copies in flight per block
LANE_WIDTHS = (4, 8, 16, 32, 64, 128)  # a row spans W/4 <= 32 threads

# launch function -> argument kinds: p = tensor pointer, i = int
_SIGNATURES = {
    "probe1_launch": "ppi",
    "probe2_launch": "pppiii",
    "probe3_launch": "pppiii",
    "probe_a_launch": "ppii",
    "probe_b_launch": "pppiiii",
    "probe_c_launch": "pppii",
    "probe_d_launch": "ppii",
    "probe_e_launch": "pppiiiii",
}

_lib = None


class ProbeLaunchError(RuntimeError):
    """A launch that CUDA refused or that failed (CUDA error code
    in ``rc``). A refused launch never ran."""

    def __init__(self, fn: str, rc: int):
        super().__init__(f"{fn} failed: CUDA error {rc}")
        self.rc = rc


def build(force: bool = False, verbose: bool = False
          ) -> tuple[str, float | None]:
    """Compile csrc/probes.cu (see ``nvcc_build.build``)."""
    return nvcc_build.build(SOURCE, LIB_NAME, force, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        for fn, sig in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = [kinds[k] for k in sig] + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.probe_smem_optin.restype = ctypes.c_int
        lib.probe_e_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.probe_e_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn: str, dev: torch.device, *args) -> None:
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                else a for a in args], stream)
    if rc != 0:
        raise ProbeLaunchError(fn, rc)


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that
    the kernel takes (int32, contiguous, 16-byte aligned, one device);
    raises otherwise."""
    dev = tensors[0].device
    if dev.type == "cpu" and all(t.device == dev for t in tensors):
        return False
    for t in tensors:
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.int32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected contiguous, 16-byte aligned "
                             f"int32 tensors on one CUDA device (or all on "
                             f"the CPU), got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return True


def _need(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as JAX's int32 arithmetic wraps
    (``torch.sum`` of int32 returns int64)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _rows(tab: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    return tab[ix.long().clamp(0, tab.shape[0] - 1)]


def smem_optin(dev: torch.device) -> int:
    """Opt-in shared memory of one block on `dev`, bytes."""
    if dev.type != "cuda":
        return H100_SMEM_OPTIN
    with torch.cuda.device(dev):
        return int(_load().probe_smem_optin())


def probe_b_uses_smem(nb: int, w: int, dev: torch.device) -> bool:
    """Whether probe_b stages an [nb, w] table in shared memory (the rule
    of probe_b_launch in csrc/probes.cu)."""
    return w == 8 and nb * w * 4 <= smem_optin(dev)


def probe_e_plan(T: int, depth: int, sms: int) -> tuple[int, int, int]:
    """probe_e's grid for T rows on a card of `sms` SMs, from the rule
    its launch uses (csrc/probes.cu's probe_e_plan, so the library is
    built): (blocks, rows of the largest block, copies in flight across
    the card)."""
    out = (ctypes.c_int * 3)()
    rc = _load().probe_e_plan(T, depth, sms, out)
    if rc != 0:
        raise ValueError(f"probe_e_plan: T={T}, depth={depth}, sms={sms}")
    return tuple(out)


# ---- probe1 -------------------------------------------------------------

def probe1_plain(x: torch.Tensor) -> torch.Tensor:
    return wrap32(x.long() * 2 + 1)


def probe1(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1, one thread per element."""
    if not _on_cuda("probe1", x):
        return probe1_plain(x)
    out = torch.empty_like(x)
    _launch("probe1_launch", x.device, x, out, x.numel())
    probe1.launches += 1
    return out


# ---- probe2 / probe3 ----------------------------------------------------

def probe2_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return wrap32(_rows(tab, idx[:, 0]).long().sum(0, keepdim=True))


def probe2(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[1, W] = sum over i of tab[idx[i, 0]], the table staged in shared
    memory in column slices that each fit one block."""
    if not _on_cuda("probe2", tab, idx):
        return probe2_plain(tab, idx)
    _need("probe2", tab.dim() == 2 and tab.shape[1] % 4 == 0
          and idx.dim() == 2 and idx.shape[1] == 1,
          "tab [R, W] with W a multiple of 4 and idx [N, 1]")
    R, W = tab.shape
    out = torch.empty((1, W), dtype=torch.int32, device=tab.device)
    _launch("probe2_launch", tab.device, tab, idx, out, R, W, idx.shape[0])
    probe2.launches += 1
    return out


def probe3_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    return probe2_plain(tab, idx)


def probe3(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The same sum with the table left in device memory: one warp
    copies row i + 1 with cp.async while it sums row i."""
    if not _on_cuda("probe3", idx, tab):
        return probe3_plain(idx, tab)
    _need("probe3", tab.dim() == 2 and idx.dim() == 2 and idx.shape[1] == 1
          and tab.shape[1] in LANE_WIDTHS,
          f"tab [R, W] with W in {LANE_WIDTHS} and idx [N, 1]")
    R, W = tab.shape
    out = torch.empty((1, W), dtype=torch.int32, device=tab.device)
    _launch("probe3_launch", tab.device, idx, tab, out, R, W, idx.shape[0])
    probe3.launches += 1
    return out


# ---- probe_A ------------------------------------------------------------

def probe_a_plain(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    scratch = torch.zeros((n_rows, x.shape[1]), dtype=torch.int32,
                          device=x.device)
    scratch[0] = x[0]
    scratch[n_rows - 1] = x[0]
    return wrap32(scratch[n_rows - 1:].long() + scratch[:1].long())


def probe_a(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[1, W] = rows n_rows-1 and 0 of an [n_rows, W] dynamic shared
    memory scratch, both written with x: 2 * x. Past the card's opt-in
    limit the launch is refused and ProbeLaunchError raised."""
    _need("probe_a", x.dim() == 2 and x.shape[0] == 1 and n_rows >= 1,
          "x [1, W] and n_rows >= 1")
    if not _on_cuda("probe_a", x):
        return probe_a_plain(x, n_rows)
    out = torch.empty_like(x)
    _launch("probe_a_launch", x.device, x, out, n_rows, x.shape[1])
    probe_a.launches += 1
    return out


# ---- probe_B ------------------------------------------------------------

def probe_b_plain(tab: torch.Tensor, idx0: torch.Tensor, n_ticks: int
                  ) -> torch.Tensor:
    """The port's current primitive, ``tab[idx]`` in a torch loop (as in
    ops/occ.py), and the counterpart of the TPU's XLA-gather probe_F."""
    nb = tab.shape[0]
    ix = idx0.long().clamp(0, nb - 1)
    for _ in range(n_ticks):
        rows = tab[ix]
        s = wrap32(rows[:, :8].long().sum(1)).long()
        ix = wrap32(s * LCG_MULT).long() % nb
    return rows[:1]


def probe_b(tab: torch.Tensor, idx0: torch.Tensor, n_ticks: int
            ) -> torch.Tensor:
    """n_ticks chained ticks over T = len(idx0) lanes: each lane loads
    row tab[idx], then idx = (sum of the row's first 8 words) *
    1103515245 mod NB. Returns lane 0's last row, [1, W].

    Replaces tools/probe_pallas_rates.py::probe_B. A tick is bound by one
    dependent load's latency: the floored modulo is a multiply (Lemire's
    fastmod of the wrapped product, constants computed once on the
    host), not a division on the chain. W = 8 runs one thread per lane,
    the table staged in shared memory when it fits one block, else read
    from 32-thread blocks spread over the SMs; W = 128 runs one warp per
    lane."""
    _need("probe_b", tab.dim() == 2 and tab.shape[1] in (8, 128)
          and idx0.dim() == 1 and n_ticks >= 1,
          "tab [NB, 8 or 128], idx0 [T] and n_ticks >= 1")
    if not _on_cuda("probe_b", tab, idx0):
        return probe_b_plain(tab, idx0, n_ticks)
    NB, W = tab.shape
    out = torch.empty((1, W), dtype=torch.int32, device=tab.device)
    _launch("probe_b_launch", tab.device, tab, idx0, out, NB, W,
            idx0.shape[0], n_ticks)
    probe_b.launches += 1
    return out


# ---- probe_C ------------------------------------------------------------

def probe_c_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long().clamp(0, x.shape[1] - 1))


def probe_c(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[t, j] = x[t, idx[t, j]]: four warp shuffles a word."""
    _need("probe_c", x.dim() == 2 and idx.shape == x.shape
          and x.shape[1] in LANE_WIDTHS,
          f"x and idx [T, W] with W in {LANE_WIDTHS}")
    if not _on_cuda("probe_c", x, idx):
        return probe_c_plain(x, idx)
    out = torch.empty_like(x)
    T, W = x.shape
    _launch("probe_c_launch", x.device, x, idx, out, T, W)
    probe_c.launches += 1
    return out


# ---- probe_D ------------------------------------------------------------

def probe_d_plain(v: torch.Tensor) -> torch.Tensor:
    return v[HANDOFF_INDEX:HANDOFF_INDEX + 1].reshape(1, 1).clone()


def probe_d(v: torch.Tensor) -> torch.Tensor:
    """[1, 1] = v[17], read by one thread after one TMA bulk copy of the
    whole vector into shared memory completed on an mbarrier (the TPU
    kernel's async copy and DMA semaphore). The copy needs a contiguous,
    16-byte-aligned source: a view such as ``v[1:]`` raises. T is bounded
    by the opt-in shared memory of one block (about 58,100 lanes on an
    H100); past it the launch is refused and ProbeLaunchError raised."""
    _need("probe_d", v.dim() == 1 and v.shape[0] > HANDOFF_INDEX,
          f"v [T] with T > {HANDOFF_INDEX}")
    if not _on_cuda("probe_d", v):
        return probe_d_plain(v)
    out = torch.empty((1, 1), dtype=torch.int32, device=v.device)
    _launch("probe_d_launch", v.device, v, out, v.shape[0], HANDOFF_INDEX)
    probe_d.launches += 1
    return out


# ---- probe_E ------------------------------------------------------------

def probe_e_plain(idx: torch.Tensor, tab: torch.Tensor, n_ticks: int
                  ) -> torch.Tensor:
    for _ in range(n_ticks):
        rows = _rows(tab, idx)
    return rows[:1]


def probe_e(idx: torch.Tensor, tab: torch.Tensor, n_ticks: int,
            depth: int) -> torch.Tensor:
    """n_ticks ticks, each copying the T = len(idx) rows tab[idx] into
    shared memory with `depth` copies in flight per block. Returns row 0
    as it landed in the last tick, [1, W].

    Replaces tools/probe_pallas_rates.py::probe_E (one core, `depth` row
    DMAs in flight on a semaphore array). Here the rows spread over the
    card (``probe_e_plan``: a contiguous run of about T / SMs rows a
    block), and a block keeps min(depth, its rows) row copies in flight,
    issued and waited on by up to 32 lanes side by side, each slot of
    its ring completing on its own mbarrier; a tick drains before the
    next. A row of up to 32 bytes is copied by the lane's 16-byte
    cp.async copies, a longer one by one TMA bulk copy (the launch picks
    the kernel built for one engine by W): each measured the faster at
    its size on an H100. What bounds it is the copies'
    latency, one row's round trip per `depth` rows of a block."""
    _need("probe_e", idx.dim() == 1 and tab.dim() == 2
          and tab.shape[1] in LANE_WIDTHS and depth in DEPTHS
          and n_ticks >= 1,
          f"idx [T], tab [NB, W] with W in {LANE_WIDTHS}, depth in "
          f"{DEPTHS} and n_ticks >= 1")
    if not _on_cuda("probe_e", idx, tab):
        return probe_e_plain(idx, tab, n_ticks)
    NB, W = tab.shape
    out = torch.empty((1, W), dtype=torch.int32, device=tab.device)
    _launch("probe_e_launch", tab.device, idx, tab, out, NB, W,
            idx.shape[0], n_ticks, depth)
    probe_e.launches += 1
    return out


WRAPPERS = (probe1, probe2, probe3, probe_a, probe_b, probe_c, probe_d,
            probe_e)

# kernel launches since the last reset (main-path proof in chip_smoke.py)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
