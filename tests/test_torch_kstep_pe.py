"""Port CLI vs JAX CLI with the k-step checkpoint table, paired-end, on the
CPU (the set-up of ``tests/test_torch_kstep_cli.py``: 24 FR pairs of 60 bp
in two FASTQ files): ``mem`` with ``.cp2.npz``, then ``.cp3.npz``, on the
one-hot engine and on ``--seed-engine sweep``; the note and the SAM body
equal the JAX CLI's with the same file, and the body equals the no-table
body (exact: SAM bytes)."""

import pytest
import torch

from test_torch_kstep_cli import ENGINES, check_mem, setup_side

# one intra-op thread a process: the suite runs several test workers on
# the CPU at once, and a thread a core each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    return setup_side(tmp_path_factory, "pe")


@pytest.mark.parametrize("K,engine", [(K, e) for K in (2, 3)
                                      for e in ENGINES],
                         ids=[f"K{K}-{e}" for K in (2, 3) for e in ENGINES])
def test_mem_kstep_pe_cli_equal_to_jax(side, tmp_path, K, engine):
    check_mem(side, tmp_path, K, engine)
