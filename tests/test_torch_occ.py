"""Port vs JAX: FM-index occ primitives (bwa_mem_scale_tpu_torch.ops.occ
against bwa_mem_scale_tpu.ops.occ) on the 20 kbp test index. Integer
arithmetic throughout, so equality is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwa_mem_scale_tpu.ops import occ as jocc
from bwa_mem_scale_tpu_torch.ops import occ as tocc

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(small_index):
    return (jocc.DeviceFMIndex.from_host(small_index),
            tocc.DeviceFMIndex.from_host(small_index, "cpu"))


def _positions(idx, n, seed):
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, idx.seq_len, size=n).astype(np.int32)
    # block edges and the sentinel row
    pos[:4] = [0, 31, 32, idx.sentinel_index]
    return pos


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_from_host_layout(small_index, both):
    _, t = both
    assert t.cp_fused.shape == (small_index.cp_count.shape[0], 8)
    assert t.cp_fused.dtype == torch.int32
    _eq(small_index.count, t.count)
    _eq(small_index.sa_samples, t.sa_samples)
    _eq(small_index.ref_string, t.ref)


def test_from_host_rejects_int64_layout(small_index):
    """An index of 2^31 positions is no longer refused: it takes the int64
    layout, whose C array and SA samples equal the JAX package's at
    int64 (the JAX package picks its int64 layout there too)."""
    big = dataclasses.replace(small_index, seq_len=1 << 31)
    t = tocc.DeviceFMIndex.from_host(big, "cpu")
    j = jocc.DeviceFMIndex.from_host(big)
    assert t.pos_dtype == torch.int64 and j.pos_dtype == np.int64
    _eq(j.count, t.count)
    _eq(jocc.sa_sample_at(j, jnp.arange(j.sa_ls.shape[0])), t.sa_samples)


@pytest.mark.parametrize("seed", [0, 1])
def test_occ_all4(small_index, both, seed):
    j, t = both
    pos = _positions(small_index, 2048, seed)
    _eq(jocc.occ_all4(j, jnp.asarray(pos)),
        tocc.occ_all4(t, torch.as_tensor(pos)))


@pytest.mark.parametrize("seed", [2, 3])
def test_backward_ext_all4(small_index, both, seed):
    j, t = both
    rng = np.random.RandomState(seed)
    n = 1024
    k = rng.randint(0, small_index.seq_len - 1, size=n).astype(np.int32)
    s = np.minimum(rng.randint(0, 300, size=n),
                   small_index.seq_len - k).astype(np.int32)
    l = rng.randint(0, small_index.seq_len, size=n).astype(np.int32)
    # intervals straddling the sentinel row exercise its correction
    k[:8] = small_index.sentinel_index - np.arange(8)
    s[:8] = 10
    got = tocc.backward_ext_all4(t, *map(torch.as_tensor, (k, l, s)))
    want = jocc.backward_ext_all4(j, *map(jnp.asarray, (k, l, s)))
    for a, b in zip(want, got):
        _eq(a, b)


@pytest.mark.parametrize("seed", [4, 5])
def test_lf_step_primitives(small_index, both, seed):
    j, t = both
    pos = _positions(small_index, 2048, seed)
    ob_j, b_j = jocc.occ_b_and_base(j, jnp.asarray(pos))
    ob_t, b_t = tocc.occ_b_and_base(t, torch.as_tensor(pos))
    _eq(ob_j, ob_t)
    _eq(b_j, b_t)
    _eq(jocc.bwt_base_at(j, jnp.asarray(pos)),
        tocc.bwt_base_at(t, torch.as_tensor(pos)))
    si = pos >> small_index.sa_compx
    _eq(jocc.sa_sample_at(j, jnp.asarray(si)),
        tocc.sa_sample_at(t, torch.as_tensor(si)))


def test_ref_byte(small_index, both):
    j, t = both
    l_pac = small_index.bns.l_pac
    pos = np.concatenate([np.arange(-3, 40), np.arange(2 * l_pac - 40,
                                                       2 * l_pac + 3),
                          np.random.RandomState(6).randint(0, 2 * l_pac,
                                                           500)])
    _eq(jocc.ref_byte(j.ref, jnp.asarray(pos), l_pac),
        tocc.ref_byte(t.ref, torch.as_tensor(pos), l_pac))
