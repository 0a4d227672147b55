"""The eight TPU design probes and their port (ops/probe_kernels.py).

Each JAX probe of tools/probe_pallas.py and tools/probe_pallas_rates.py
runs as it is, imported by file path, with ``pl.pallas_call`` patched to
run in interpret mode and to record every call's inputs and output. The
port's plain version then runs on the recorded inputs and must give the
same arrays. Two exceptions, each stated where it is tested:

- probe_A's TPU kernel reads scratch row n-1 without writing it, so only
  row 0 is compared: the JAX output minus its output on a zero input (the
  unwritten row's term cancels) must be x, the port's row 0. The port
  writes x to row n-1 too and must return 2 * x.
- probe_E runs on a table of zeros, which checks nothing, so its kernel
  is also run on a non-zero table against a numpy transcription.

probe_B and probe_E time their kernel over several calls; here the
tool's timing helper makes one call per configuration.

What of the kernels the CPU can reach is held here too: a numpy twin of
probe_B's fastmod index arithmetic against ``np.mod``, and probe_E's
refusal of what no kernel was built for.

On a GPU, ``test_cuda_kernels_equal_plain`` holds every CUDA kernel
against its plain version, ``test_cuda_probe_d_bulk_copy_equals_plain``
probe_D's bulk copy over its sweep of T, and ``test_cuda_probe_e_*`` /
``test_cuda_probe_b_*`` probe_E's TMA ring and probe_B's chain over
their edges, and ``test_probe_e_plan_owns_every_row_once`` probe_E's
grid from the library's own rule (they import no JAX):
    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_probes.py
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu_torch.ops import probe_kernels as pk

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
B_TICKS, E_TICKS = 32, 8       # NT of the TPU's probe_B and probe_E
BIG = 64 << 20                 # bytes above which an all-zero input is
                               # recorded by shape only


@dataclasses.dataclass
class Call:
    fn: object                 # the interpret-mode pallas_call callable
    args: list
    out: np.ndarray
    zero_out: np.ndarray = None


def _keep(a):
    a = np.asarray(a)
    if a.nbytes > BIG and not a.any():
        return ("zeros", a.shape, a.dtype)
    return a.copy()          # writable, so torch may share it


def _array(a):
    if isinstance(a, tuple):
        return np.zeros(a[1], a[2])
    return a


@pytest.fixture
def recorder(monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    calls = []
    orig = pl.pallas_call
    opts = {"rerun_zeros": False}

    def pallas_call(kernel, out_shape, **kw):
        kw["interpret"] = True
        f = orig(kernel, out_shape, **kw)

        def call(*args):
            out = f(*args)
            if isinstance(out, jax.core.Tracer):     # under jax.jit
                jax.debug.callback(
                    lambda *v: calls.append(Call(f, [_keep(a) for a in v[:-1]],
                                                 _keep(v[-1]))), *args, out)
                return out
            rec = Call(f, [_keep(a) for a in args], _keep(out))
            if opts["rerun_zeros"]:
                rec.zero_out = np.asarray(f(*[jnp.zeros_like(a)
                                              for a in args]))
            calls.append(rec)
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(sys, "argv", ["probe"])   # the rates tool reads it

    def run(tool, name, rerun_zeros=False):
        spec = importlib.util.spec_from_file_location(
            f"_tpu_{tool}", os.path.join(TOOLS, tool))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "bench"):
            monkeypatch.setattr(mod, "bench", lambda fn, variants, reps=3: (
                mod._sync(fn(*variants[0])), 1.0)[1])
        opts["rerun_zeros"] = rerun_zeros
        calls.clear()
        getattr(mod, name)()
        jax.effects_barrier()
        assert calls, f"{name} reached no pallas_call"
        return list(calls)
    return run


def _t(a):
    return torch.as_tensor(_array(a))


PLAIN_ON_RECORDED = {
    "probe1": ("probe_pallas.py", lambda a: pk.probe1_plain(_t(a[0]))),
    "probe2": ("probe_pallas.py",
               lambda a: pk.probe2_plain(_t(a[0]), _t(a[1]))),
    "probe3": ("probe_pallas.py",
               lambda a: pk.probe3_plain(_t(a[0]), _t(a[1]))),
    "probe_B": ("probe_pallas_rates.py",
                lambda a: pk.probe_b_plain(_t(a[0]), _t(a[1]), B_TICKS)),
    "probe_C": ("probe_pallas_rates.py",
                lambda a: pk.probe_c_plain(_t(a[0]), _t(a[1]))),
    "probe_D": ("probe_pallas_rates.py", lambda a: pk.probe_d_plain(_t(a[0]))),
    "probe_E": ("probe_pallas_rates.py",
                lambda a: pk.probe_e_plain(_t(a[0]), _t(a[1]), E_TICKS)),
}


@pytest.mark.parametrize("name", ["probe1", "probe2", "probe3", "probe_A",
                                  "probe_B", "probe_C", "probe_D",
                                  "probe_E"])
def test_plain_equals_jax_probe(recorder, name):
    if name == "probe_A":
        calls = recorder("probe_pallas_rates.py", name, rerun_zeros=True)
        mbs = (1, 4, 8, 16, 24, 32, 48, 64, 96, 112, 128)   # the tool's
        assert len(calls) == len(mbs)
        for c, mb in zip(calls, mbs):
            x = c.args[0]
            n_rows = mb * (1 << 20) // 4 // 128
            jax_row0 = (c.out.astype(np.int64) - c.zero_out).astype(np.int32)
            port = pk.probe_a_plain(_t(x), n_rows).numpy()
            # the port's row n-1 holds x, so its row 0 is port - x
            np.testing.assert_array_equal(jax_row0, port - x)
            np.testing.assert_array_equal(port, 2 * x)
        return
    tool, plain = PLAIN_ON_RECORDED[name]
    calls = recorder(tool, name)
    for c in calls:
        np.testing.assert_array_equal(plain(c.args).numpy(), c.out)
    if name == "probe_E":
        # a non-zero table: the JAX kernel of the last call (depth 64),
        # the port's plain version and numpy must all give tab[idx[0]]
        idx = c.args[0] % 4096
        tab = np.random.RandomState(1).randint(
            -2**31, 2**31, (4096, 128), dtype=np.int64).astype(np.int32)
        want = tab[idx[:1]]
        np.testing.assert_array_equal(np.asarray(c.fn(idx, tab)), want)
        np.testing.assert_array_equal(
            pk.probe_e_plain(_t(idx), _t(tab), E_TICKS).numpy(), want)


def _np_probe_b(tab, idx, n_ticks):
    """numpy int32 transcription of the TPU probe_B tick loop."""
    nb = tab.shape[0]
    with np.errstate(over="ignore"):
        for _ in range(n_ticks):
            rows = tab[idx]
            s = rows[:, :8].sum(1, dtype=np.int32)
            idx = np.mod(s * np.int32(pk.LCG_MULT), np.int32(nb))
    return rows[:1]


def test_probe_b_plain_wraps_like_int32():
    """Full-range words overflow the row sum too (the JAX probe's arange
    table overflows only the product)."""
    r = np.random.RandomState(7)
    tab = r.randint(-2**31, 2**31, (1000, 8), dtype=np.int64).astype(np.int32)
    idx = r.randint(0, 1000, 64).astype(np.int32)
    np.testing.assert_array_equal(
        pk.probe_b_plain(_t(tab), _t(idx), 9).numpy(),
        _np_probe_b(tab, idx, 9))


def _fastmod_floor_mod(v, nb):
    """numpy twin of csrc/probes.cu's floor_mod(v, fastmod_of(nb)): u =
    v + 2^31 as uint32, u mod nb as the high word of (m * u mod 2^64) *
    nb with m = ceil(2^64 / nb) (0 at nb = 1, where 2^64 wraps), then
    less 2^31 mod nb, plus nb where that went negative."""
    u = (np.asarray(v, np.int32).view(np.uint32)
         ^ np.uint32(0x80000000)).astype(np.uint64)
    m = np.uint64(0 if nb == 1 else (2**64 - 1) // nb + 1)
    low = m * u                                  # wraps mod 2^64
    d = np.uint64(nb)
    # high 64 bits of low * nb, a 64 x 32-bit product, in 32-bit halves
    r = (((low >> np.uint64(32)) * d
          + (((low & np.uint64(0xFFFFFFFF)) * d) >> np.uint64(32)))
         >> np.uint64(32)).astype(np.int64) - (1 << 31) % nb
    return np.where(r < 0, r + nb, r).astype(np.int32)


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 7168, 287_501, 2_875_001,
                                1 << 24, 2**31 - 1])
def test_fastmod_floor_mod_equals_np_mod(nb):
    """The kernel's modulo-free index arithmetic of probe_B, on every
    edge of the int32 range and on seeded wrapped products, equals numpy's
    floored modulo."""
    lo, hi = -2**31, 2**31 - 1
    k = np.arange(-4, 5, dtype=np.int64)
    k = np.concatenate([k, k + hi // nb, k - hi // nb])
    near = (k[:, None] * nb + np.array([-1, 0, 1])).ravel()
    r = np.random.RandomState(nb % 1000)
    sums = r.randint(0, 2**32, 10_000, dtype=np.int64)
    products = (sums * pk.LCG_MULT) % 2**32        # the wrapped product
    v = np.concatenate([[lo, hi, 0, 1, -1, lo + 1, hi - 1],
                        near[(near >= lo) & (near <= hi)],
                        r.randint(lo, hi + 1, 10_000, dtype=np.int64),
                        np.where(products > hi, products - 2**32, products)]
                       ).astype(np.int32)
    np.testing.assert_array_equal(_fastmod_floor_mod(v, nb),
                                  np.mod(v.astype(np.int64), nb))


@pytest.mark.parametrize("bad", [
    {"depth": 8},                 # no ring built for D = 8
    {"depth": 0},
    {"w": 12},                    # a row spans W / 4 <= 32 lanes
    {"n_ticks": 0},
    {"idx_shape": (4, 1)},        # idx [T], not [T, 1]
])
def test_probe_e_rejects_bad_arguments(bad):
    """probe_e takes only what its kernels were built for: D in DEPTHS
    (one ring per D), W in LANE_WIDTHS, n_ticks >= 1 and a 1-D idx. It
    refuses the rest before choosing kernel or plain version, and takes
    the same call with the one argument put right."""
    def call(idx_shape=(4,), w=8, n_ticks=2, depth=4):
        idx = torch.zeros(idx_shape, dtype=torch.int32)
        return pk.probe_e(idx, torch.zeros((10, w), dtype=torch.int32),
                          n_ticks, depth)
    assert call().shape == (1, 8)
    with pytest.raises(ValueError, match="depth in"):
        call(**bad)


def _small_cases():
    r = np.random.RandomState(3)
    tab = torch.as_tensor(r.randint(-50, 50, (300, 8)).astype(np.int32))
    idx = torch.as_tensor(r.randint(0, 300, (20, 1)).astype(np.int32))
    x = torch.as_tensor(r.randint(-9, 9, (16, 8)).astype(np.int32))
    ix = torch.as_tensor(r.randint(0, 8, (16, 8)).astype(np.int32))
    lanes = idx[:, 0].contiguous()
    return {
        "probe1": ((x,), (x,)),
        "probe2": ((tab, idx), (tab, idx)),
        "probe3": ((idx, tab), (idx, tab)),
        "probe_a": ((x[:1], 5), (x[:1], 5)),
        "probe_b": ((tab, lanes, 3), (tab, lanes, 3)),
        "probe_c": ((x, ix), (x, ix)),
        "probe_d": ((lanes,), (lanes,)),
        "probe_e": ((lanes, tab, 2, 4), (lanes, tab, 2)),
    }


@pytest.mark.parametrize("name", [w.__name__ for w in pk.WRAPPERS])
def test_wrapper_on_cpu_tensors_runs_plain(name):
    """On CPU tensors each wrapper is its plain version (no launch)."""
    wrapper = getattr(pk, name)
    args, plain_args = _small_cases()[name]
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before
    assert got.dtype == torch.int32
    assert torch.equal(got, getattr(pk, name + "_plain")(*plain_args))


def test_probe_cuda_entry_point_on_cpu(capsys):
    from bwa_mem_scale_tpu_torch.tools import probe_cuda
    assert probe_cuda.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.split()
    assert out == ["PROBE_1_OK", "PROBE_2_OK", "PROBE_3_OK"]


def test_probe_cuda_rates_entry_point_on_cpu(capsys):
    from bwa_mem_scale_tpu_torch.tools import probe_cuda_rates
    assert probe_cuda_rates.main(["ABCDEF", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "WRONG" not in out
    for head in ("--- A", "--- B", "--- C", "--- D", "--- E"):
        assert head in out
    assert out.rstrip().endswith("RATES_OK")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from bwa_mem_scale_tpu_torch.tools.probe_cuda_rates import kernel_work
    for c in kernel_work(torch.device("cuda")):
        wrapper = getattr(pk, c.name)
        before = wrapper.launches
        got = c.kernel()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, c.name
        assert torch.equal(got, c.plain()), c.name


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1024, 4096, 57344])
def test_cuda_probe_d_bulk_copy_equals_plain(lanes):
    """probe_D's TMA bulk copy on seeded vectors up to 224 KB of shared
    memory, and a tail of fewer than 16 bytes; a misaligned view raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.RandomState(lanes)
    v = torch.as_tensor(rng.randint(-2**31, 2**31, lanes + 4, np.int64)
                        .astype(np.int32), device=dev)
    for t in (lanes, lanes + 3):             # whole 16-byte units, a tail
        before = pk.probe_d.launches
        got = pk.probe_d(v[:t])
        torch.cuda.synchronize()
        assert pk.probe_d.launches == before + 1
        assert torch.equal(got, pk.probe_d_plain(v[:t]))
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.probe_d(v[1:])


def _seeded_table(rows, w, seed):
    return np.random.RandomState(seed).randint(
        -2**31, 2**31, (rows, w), dtype=np.int64).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128])
@pytest.mark.parametrize("lanes", [1, 31, 1024, 4097])
def test_cuda_probe_e_ring_equals_plain(w, lanes):
    """probe_E's TMA ring at every depth, 1 and 3 ticks (slots reused
    across ticks, a partial ring at the end), blocks of one row (T below
    the SM count) and uneven blocks; indices out of range are clamped."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    nb = 5000
    tab = torch.as_tensor(_seeded_table(nb, w, w + lanes), device=dev)
    r = np.random.RandomState(lanes)
    idx = r.randint(-50, nb + 50, lanes).astype(np.int32)
    idx[0] = r.randint(0, nb)
    idx = torch.as_tensor(idx, device=dev)
    for depth in pk.DEPTHS:
        for n_ticks in (1, 3):
            before = pk.probe_e.launches
            got = pk.probe_e(idx, tab, n_ticks, depth)
            torch.cuda.synchronize()
            assert pk.probe_e.launches == before + 1
            assert torch.equal(got, pk.probe_e_plain(idx, tab, n_ticks)), \
                (depth, n_ticks)
    # every row lands: row r of the last tick through lane 0's output
    for row in (0, lanes // 2, lanes - 1):
        one = idx[row:row + 1].clone()           # a 16-byte aligned copy
        assert torch.equal(pk.probe_e(one, tab, 2, 4),
                           pk.probe_e_plain(one, tab, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("w,nb", [(8, 1), (8, 7), (8, 287_501),
                                  (128, 1), (128, 7), (128, 287_501)])
def test_cuda_probe_b_fastmod_equals_plain(w, nb):
    """probe_B's chain with the fastmod index on full-range tables (row
    sums and products of both signs): in shared memory (W = 8, NB 1 and
    7), from global memory (W = 8 at 287,501 rows, and W = 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tab = torch.as_tensor(_seeded_table(nb, w, nb), device=dev)
    assert pk.probe_b_uses_smem(nb, w, dev) == (w == 8 and nb < 1000)
    idx0 = torch.as_tensor(np.random.RandomState(w).randint(
        -9, nb + 9, 4097).astype(np.int32), device=dev)
    for n_ticks in (1, 32):
        before = pk.probe_b.launches
        got = pk.probe_b(tab, idx0, n_ticks)
        torch.cuda.synchronize()
        assert pk.probe_b.launches == before + 1
        assert torch.equal(got, pk.probe_b_plain(tab, idx0, n_ticks)), n_ticks


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, 1024, 4096, 4097])
def test_probe_e_plan_owns_every_row_once(T):
    """probe_e's grid on 132 SMs, from the rule its launch uses
    (csrc/probes.cu's probe_e_plan): as many blocks as SMs where T
    allows, every row owned once (at a depth past any block's rows the
    copies in flight are T), no block empty (at depth 1 they are the
    blocks), the largest block ceil(T / blocks) rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plan is the CUDA library's")
    sms = 132
    blocks, most, _ = pk.probe_e_plan(T, 4, sms)
    assert blocks == min(T, sms)
    assert most == -(-T // blocks)
    assert pk.probe_e_plan(T, T, sms)[2] == T
    assert pk.probe_e_plan(T, 1, sms)[2] == blocks
    for depth in pk.DEPTHS:
        assert pk.probe_e_plan(T, depth, sms)[:2] == (blocks, most)
        assert pk.probe_e_plan(T, depth, sms)[2] <= min(T, depth * blocks)
    assert pk.probe_e_plan(1024, 16, sms)[2] == 1024     # 7-8 rows a block
    big = 132 * 2048 + 1                  # past a block's 2,048-row cap
    blocks, most, flight = pk.probe_e_plan(big, big, sms)
    assert blocks == 133 and most <= 2048 and flight == big
