"""The congestion twin (``analysis/torch_congestion.py``) against the JAX
package's ``analysis/congestion.py``.

``run_one`` solves one (mode, seed) twice and reports the timed run.  On a
tiny congested warehouse in the three modes the original runs
(centralized, fresh radius mask, stale views), the twin's row equals the
original's but for the time: the same makespan and completion.
"""

import pytest
import torch

from analysis import congestion, torch_congestion
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.models import scenarios as jsc
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.models import scenarios as tsc


def tiny(module, grid_cls):
    """24 agents on a 32^2 warehouse: dense enough that the radius mask
    and the stale views change the outcome."""
    return module.Scenario("tiny-congested", lambda: grid_cls.warehouse(32, 32),
                           24, 24, replan_chunk=8, max_timesteps=400)


MODES = {"centralized": lambda s: s, "decent-fresh": lambda s: s.decentralized(),
         "decent-stale": lambda s: s.stale()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_one_matches_jax(mode):
    jscn = MODES[mode](tiny(jsc, JaxGrid))
    tscn = MODES[mode](tiny(tsc, Grid))
    assert tscn.mode == jscn.mode
    want = congestion.run_one(jscn, 1)
    got = torch_congestion.run_one(tscn, 1, "cpu")
    assert set(got) == set(want)
    assert got.pop("ms_per_step") > 0
    want.pop("ms_per_step")
    assert got == want
    assert got["completed"]


def test_run_one_without_warm_solves_once(monkeypatch):
    """``warm=False`` (``chip_smoke.py``'s congestion phase, whose process
    has solved the rung already) times the first solve and reports the
    same row as the warm run but for the time."""
    from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd

    scn = MODES["centralized"](tiny(tsc, Grid))
    solves = []
    real = tmapd.run_mapd

    def counting(*args, **kwargs):
        solves.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tmapd, "run_mapd", counting)
    cold = torch_congestion.run_one(scn, 1, "cpu", warm=False)
    assert len(solves) == 1
    warm = torch_congestion.run_one(scn, 1, "cpu")
    assert len(solves) == 3
    assert cold.pop("ms_per_step") > 0 and warm.pop("ms_per_step") > 0
    assert cold == warm
