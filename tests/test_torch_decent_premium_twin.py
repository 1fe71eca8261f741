"""The decentralized-premium twin (``analysis/torch_decent_premium.py``)
against the JAX package's ``analysis/decent_premium.py``.

``run_variant`` solves one variant of a rung twice and reports the timed
run.  A tiny congested warehouse stands in for the ``medium`` rung in both
packages' ``scenarios`` (monkeypatched; neither file is edited).  Every
variant's row equals the original's but for the time, ``decent_nomask``
included (``_within_radius`` patched to all-true), and the patch is undone
when the variant returns or raises.
"""

import pytest
import torch

from analysis import decent_premium, torch_decent_premium
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.models import scenarios as jsc
from p2p_distributed_tswap_tpu.solver import step as jstep
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.models import scenarios as tsc
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd
from p2p_distributed_tswap_tpu_torch.solver import step as tstep

WITHIN_RADIUS = (jstep._within_radius, tstep._within_radius)


@pytest.fixture
def tiny_medium(monkeypatch):
    """24 agents on a 32^2 warehouse as the ``medium`` rung of both
    packages, with one intra-op thread for the port's CPU solve."""
    for module, grid_cls in ((jsc, JaxGrid), (tsc, Grid)):
        monkeypatch.setattr(module, "MEDIUM", module.Scenario(
            "tiny-medium", lambda g=grid_cls: g.warehouse(32, 32), 24, 24,
            replan_chunk=8, max_timesteps=400))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("variant", torch_decent_premium.VARIANTS)
def test_run_variant_matches_jax(tiny_medium, variant):
    assert torch_decent_premium.VARIANTS == decent_premium.VARIANTS
    want = decent_premium.run_variant("medium", variant)
    got = torch_decent_premium.run_variant("medium", variant, "cpu")
    launches = got.pop("kernel_launches")
    assert launches == {"sweep_scan": 0, "field_fused_single": 0,
                        "field_fused_multi": 0}  # the CPU runs no kernel
    assert got.pop("ms_per_step") > 0
    want.pop("ms_per_step")
    assert got == want
    assert (jstep._within_radius, tstep._within_radius) == WITHIN_RADIUS


def test_nomask_patch_is_undone_when_the_solve_raises(tiny_medium,
                                                      monkeypatch):
    seen = []

    def boom(*args, **kwargs):
        seen.append(tstep._within_radius)
        raise RuntimeError("solve failed")

    monkeypatch.setattr(tmapd, "run_mapd", boom)
    with pytest.raises(RuntimeError, match="solve failed"):
        torch_decent_premium.run_variant("medium", "decent_nomask", "cpu")
    assert seen and seen[0] is not WITHIN_RADIUS[1]  # patched in the solve
    assert tstep._within_radius is WITHIN_RADIUS[1]


def test_run_variant_without_warm_solves_once(tiny_medium, monkeypatch):
    """``warm=False`` times the variant's first solve: one solve, and the
    row of the warm run but for the time."""
    solves = []
    real = tmapd.run_mapd

    def counting(*args, **kwargs):
        solves.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tmapd, "run_mapd", counting)
    cold = torch_decent_premium.run_variant("medium", "stale", "cpu",
                                            warm=False)
    assert len(solves) == 1
    warm = torch_decent_premium.run_variant("medium", "stale", "cpu")
    assert len(solves) == 3
    assert cold.pop("ms_per_step") > 0 and warm.pop("ms_per_step") > 0
    assert cold == warm
