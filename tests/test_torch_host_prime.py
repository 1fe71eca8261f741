"""The port's ``solver/mapd.py::host_prime_fields`` and its trace spans
against the JAX package's.

The JAX function is the t=0 field burst as a host-driven loop of per-chunk
programs; the port's ``prime_fields`` is already that loop, so
``host_prime_fields`` is the same loop under the JAX name, with the JAX
module's spans.  On the same seeded inputs, at three ``replan_chunk``
widths (a clipped tail chunk among them), the packed rows and
``need_replan`` are equal to the JAX function's and to the port's
``prime_fields``; the spans ``mapd.host_prime_fields``, ``mapd.prime_chunk``
and ``mapd.solve_offline`` carry the JAX module's names and attributes.
The port's solve records more spans than the JAX package's, its phase
spans (``solver/mapd.py``, ``solver/step.py``), every one nested in
``mapd.solve_offline``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu.obs import trace as jtrace
from p2p_distributed_tswap_tpu.solver import mapd as jmapd
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import trace as ttrace
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd

N = 10
# The port's phase spans, which the JAX package's one device program has
# no host side to record.
PHASES = {"mapd.transitions", "mapd.assign", "mapd.replan", "mapd.tswap",
          "step.swap", "step.cascade", "mapd.record", "mapd.prime"}


def _problem(replan_chunk):
    jgrid = JaxGrid.random_obstacles(24, 24, 0.1, seed=1)
    grid = Grid.random_obstacles(24, 24, 0.1, seed=1)
    assert np.array_equal(np.asarray(grid.free), np.asarray(jgrid.free))
    kw = dict(height=24, width=24, num_agents=N, replan_chunk=replan_chunk)
    starts = start_positions_array(jgrid, N, seed=0)
    tasks = TaskGenerator(jgrid, seed=1).generate_task_arrays(12)
    return grid, jgrid, SolverConfig(**kw), JaxConfig(**kw), starts, tasks


@pytest.fixture
def tracers(monkeypatch):
    """Both packages' tracers switched on for the test, restored after."""
    jt, tt = jtrace.Tracer(enabled=True), ttrace.Tracer(enabled=True)
    monkeypatch.setattr(jtrace, "_tracer", jt)
    monkeypatch.setattr(ttrace, "_tracer", tt)
    return jt, tt


def _spans(tracer) -> list:
    return [(ev["name"], ev["args"]) for ev in tracer._drain()
            if ev.get("ph") == "X"]


@pytest.mark.parametrize("replan_chunk", [3, 4, 10],
                         ids=["tail-1", "tail-2", "one-chunk"])
def test_host_prime_fields_matches_jax(tracers, replan_chunk):
    grid, jgrid, cfg, jcfg, starts, tasks = _problem(replan_chunk)
    js0, _ = jax.jit(functools.partial(jmapd.prepare_state_unprimed, jcfg))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(tasks, jnp.int32))
    s0, _ = tmapd.prepare_state_unprimed(cfg, starts, tasks, "cpu")
    for name in ("pos", "goal", "slot", "need_replan"):
        np.testing.assert_array_equal(np.asarray(getattr(js0, name)),
                                      getattr(s0, name).numpy())
    # the JAX burst donates the state's packed rows
    want = jmapd.host_prime_fields(jcfg, js0, jnp.asarray(jgrid.free))

    free = torch.as_tensor(np.asarray(grid.free))
    plain = tmapd.prime_fields(cfg, s0.replace(dirs=s0.dirs.clone()), free)
    got = tmapd.host_prime_fields(cfg, s0.replace(dirs=s0.dirs.clone()),
                                  free)

    np.testing.assert_array_equal(got.dirs.numpy(),
                                  np.asarray(want.dirs).view(np.int32))
    np.testing.assert_array_equal(got.need_replan.numpy(),
                                  np.asarray(want.need_replan))
    assert torch.equal(got.dirs, plain.dirs)
    assert torch.equal(got.need_replan, plain.need_replan)

    jt, tt = tracers
    spans = _spans(tt)
    assert spans == _spans(jt)
    chunks = -(-N // replan_chunk)
    assert spans[-1] == ("mapd.host_prime_fields",
                         {"agents": N, "chunks": chunks})
    assert [a["chunk"] for name, a in spans[:-1]] == list(range(chunks))
    assert {name for name, _ in spans[:-1]} == {"mapd.prime_chunk"}


def test_prime_fields_records_no_span(tracers):
    """``prime_fields`` is the JAX package's fused burst: no span."""
    grid, _, cfg, _, starts, tasks = _problem(4)
    s0, _ = tmapd.prepare_state_unprimed(cfg, starts, tasks, "cpu")
    tmapd.prime_fields(cfg, s0, torch.as_tensor(np.asarray(grid.free)))
    assert _spans(tracers[1]) == []


def test_solve_offline_span_matches_jax(tracers):
    jgrid = JaxGrid.random_obstacles(12, 12, 0.1, seed=2)
    grid = Grid.random_obstacles(12, 12, 0.1, seed=2)
    starts = start_positions_array(jgrid, 4, seed=0)
    tasks = TaskGenerator(jgrid, seed=1).generate_task_arrays(5)
    _, _, jmk = jmapd.solve_offline(jgrid, starts, tasks)
    _, _, mk = tmapd.solve_offline(grid, starts, tasks, device="cpu")
    assert mk == jmk
    jt, tt = tracers
    want = _spans(jt)
    assert [s for s in want if s[0] == "mapd.solve_offline"] == [
        ("mapd.solve_offline", {"agents": 4, "tasks": 5})]
    got = _spans(tt)
    jax_names = {name for name, _ in want}
    assert [s for s in got if s[0] in jax_names] == want
    # every other span is a phase span, nested in mapd.solve_offline (the
    # step's two through mapd.tswap)
    phases = [(name, args) for name, args in got if name not in jax_names]
    assert {name for name, _ in phases} == PHASES
    for name, args in phases:
        assert args == {"parent": "mapd.tswap" if name.startswith("step.")
                        else "mapd.solve_offline"}
