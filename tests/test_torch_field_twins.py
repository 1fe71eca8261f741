"""The field-repair fuzz and field-bench twins (``scripts/torch_field_fuzz.py``,
``analysis/torch_field_bench.py``) against the JAX package's originals.

- ``fuzz_seed``: the same chained toggle sequences, every repair bit-equal
  to a full recompute inside both, and the same count of exact repairs;
  ``edge_cases`` holds on the port as written.
- ``bench_repair`` at a small side: the same walls, fallbacks and
  bit-identity (times excluded).
- ``bench_multi_field`` on the CPU: no time is measured, and both paths'
  plain versions give equal codes at each shape.
"""

import pytest
import torch

from analysis import field_bench, torch_field_bench
from scripts import field_fuzz, torch_field_fuzz

CPU = torch.device("cpu")
TIMES = ("full_resweep_ms", "full_resweep_ms_mean", "repair_ms",
         "repair_ms_mean", "speedup_vs_full")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_seed_matches_jax(seed):
    want = field_fuzz.fuzz_seed(seed, 5)
    assert torch_field_fuzz.fuzz_seed(seed, 5, CPU) == want


def test_edge_cases_hold():
    field_fuzz.edge_cases()
    torch_field_fuzz.edge_cases(CPU)


@pytest.mark.parametrize("kind", ["warehouse", "obstacles"])
def test_bench_repair_matches_jax(kind):
    want = field_bench.bench_repair(64, kind, 4, 3, 1, 1)
    got = torch_field_bench.bench_repair(64, kind, 4, 3, 1, 1, CPU)
    assert set(got) == set(want)
    assert got["bit_identical_to_full_recompute"] is True
    assert len(got["repair_ms"]) == len(want["repair_ms"])
    assert {k: v for k, v in got.items() if k not in TIMES} \
        == {k: v for k, v in want.items() if k not in TIMES}


def test_multi_field_on_the_cpu_records_identity_only():
    out = torch_field_bench.bench_multi_field(1, CPU)
    assert out["codes_equal"] is True
    assert [r["shape"] for r in out["shapes"]] == [[16, 64, 128],
                                                   [4, 256, 256]]
    assert out["verdict"] == "NO-GO (unmeasured)"
    assert not any("ms" in k for r in out["shapes"] for k in r)
