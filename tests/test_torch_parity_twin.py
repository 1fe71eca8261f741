"""The makespan-parity twin (``analysis/torch_parity_table.py``) against the
JAX package's ``analysis/parity_table.py``.

``run_pair`` runs the sequential oracle and the parallel solve of one
instance.  The port's oracle is a copy of the JAX package's and its solve
equals the JAX package's bit for bit, so on the same seed the twin's
(oracle makespan, parallel makespan, oracle completed) equals the
original's, for the smallest row of the table and for the congested
warehouse row.
"""

import numpy as np
import pytest
import torch

from analysis import parity_table, torch_parity_table

CPU = torch.device("cpu")

# (row of the table, seeds): the rows' own grids, fleets and task kinds
ROWS = {"empty 14x14 6a": 3, "warehouse 64x64 40a (congested)": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _row(configs, name):
    (row,) = [c for c in configs(True) if c[0] == name]
    return row


@pytest.mark.parametrize("name,seed", [(name, seed)
                                       for name, n in ROWS.items()
                                       for seed in range(n)])
def test_run_pair_matches_jax(name, seed):
    _, jgf, na, nt, _, distinct = _row(parity_table.configs, name)
    _, tgf, *_ = _row(torch_parity_table.configs, name)
    jgrid, tgrid = jgf(), tgf()
    np.testing.assert_array_equal(tgrid.free, jgrid.free)
    want = parity_table.run_pair(jgrid, na, nt, seed, distinct=distinct)
    got = torch_parity_table.run_pair(tgrid, na, nt, seed,
                                      distinct=distinct, device=CPU)
    assert got == want
    assert 0 < got[1] <= 2000


def test_configs_are_the_originals():
    """The same rows, fleets, task counts and seed counts, quick or not."""
    for quick in (True, False):
        want = [(c[0], c[2], c[3], c[4], c[5])
                for c in parity_table.configs(quick)]
        got = [(c[0], c[2], c[3], c[4], c[5])
               for c in torch_parity_table.configs(quick)]
        assert got == want
