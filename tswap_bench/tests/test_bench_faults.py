"""The correctness check catches a broken timed path: each fault is put
under a whole run (set-up, window, check) on the CPU and ``correct`` has
to come out false; the sound run beside them comes out true."""

import pytest

from conftest import LONG, make_root, run_cpu

from tswap_bench.faults import FAULTS, MAPD


def test_sound_run_is_correct(small_root):
    r = run_cpu(small_root, "small.solve")
    assert r["correct"] is True
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(small_root, fault):
    target, fn, number = FAULTS[fault]
    r = run_cpu(small_root, "small.solve", seconds=2.0,
                patches={target: fn})
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0
    assert r["failed"] >= 1


def test_control_fails(tmp_path):
    """The bfloat16 control in the program's place fails the check where
    distances pass 256."""
    from tswap_bench.reference import control

    root = make_root(tmp_path, configs=(LONG,))
    r = run_cpu(root, "long.solve", seconds=2.0,
                patches={f"{MAPD}:direction_fields":
                         control.direction_fields})
    assert r["correct"] is False
    assert r["checks"]["field_mismatch"]["value"] > 0
