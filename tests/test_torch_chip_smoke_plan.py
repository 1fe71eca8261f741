"""``chip_smoke.py``'s plan, read from its source without CUDA.

``chip_smoke.py`` runs only on the card, so these tests read it with
``ast`` (the script is not imported for them): every phase it defines is
still called from ``main`` or from the ``--fleet-rungs`` path, the
``kernels`` line still names the three kernels, and the ``phase_seconds``
line comes just before the last line.  The phase clock itself is held on
the CPU through the imported script's ``PhaseClock`` and ``emit``.
"""

import ast
import json
import time
from pathlib import Path

import pytest

import chip_smoke

SOURCE = Path(chip_smoke.__file__).read_text()
TREE = ast.parse(SOURCE)
FUNCS = {n.name: n for n in TREE.body if isinstance(n, ast.FunctionDef)}
KERNELS = {"sweep_scan", "field_fused_multi", "field_fused_single"}


def _called(fn: ast.FunctionDef) -> set:
    """The names of the functions that ``fn`` calls by name."""
    return {n.func.id for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


def _is_call(stmt: ast.stmt, name: str) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Name)
            and stmt.value.func.id == name)


@pytest.mark.parametrize("name", sorted(
    n for n in FUNCS if n.startswith(("phase_", "start_"))))
def test_every_phase_is_driven(name):
    """A phase that neither ``main`` nor ``fleet_rungs_only`` calls would
    drop its path from the smoke without a failing line."""
    assert name in _called(FUNCS["main"]) | _called(
        FUNCS["fleet_rungs_only"])


def test_every_phase_of_main_is_timed():
    """Each call of a ``phase_*`` in ``main`` sits in a ``with timed()``
    block, so every phase line carries ``"s"`` and ``phase_seconds``
    lists it."""
    untimed = []

    def visit(node, in_timed):
        for child in ast.iter_child_nodes(node):
            timed = in_timed or (isinstance(child, ast.With) and any(
                isinstance(i.context_expr, ast.Call)
                and isinstance(i.context_expr.func, ast.Name)
                and i.context_expr.func.id == "timed" for i in child.items))
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Name)
                    and child.func.id.startswith("phase_") and not timed):
                untimed.append(child.func.id)
            visit(child, timed)

    visit(FUNCS["main"], False)
    assert untimed == []


def test_kernels_line_names_the_three_kernels():
    (assign,) = [n for n in ast.walk(FUNCS["main"])
                 if isinstance(n, ast.Assign)
                 and [t.id for t in n.targets if isinstance(t, ast.Name)]
                 == ["kernels"]]
    names = {e.args[0].value for e in assign.value.elts
             if isinstance(e, ast.Call) and e.func.id == "_kernel_entry"}
    assert names == KERNELS
    assert len(assign.value.elts) == len(KERNELS)


def test_phase_seconds_come_before_the_last_line():
    """``main`` ends with the ``phase_seconds`` line, the ``kernels`` line,
    the device line and ``return 0``; the ``--fleet-rungs`` path prints
    ``phase_seconds`` as its last phase, and then the device line."""
    body = FUNCS["main"].body
    assert isinstance(body[-1], ast.Return) and body[-1].value.value == 0
    assert _is_call(body[-2], "print_device_line")
    assert _is_call(body[-4], "emit_phase_seconds")
    rungs = FUNCS["fleet_rungs_only"].body
    assert _is_call(rungs[-2], "emit_phase_seconds")
    (branch,) = [n for n in body if isinstance(n, ast.If)
                 and "fleet_rungs" in ast.unparse(n.test)]
    assert [ast.unparse(s) for s in branch.body] == [
        "fleet_rungs_only(args.fleet_rungs)", "print_device_line()",
        "return 0"]


def test_phase_lines_carry_their_seconds(monkeypatch, capsys):
    """Inside a timed block each line gets ``"s"`` and the first line's
    phase names the entry; a phase started in the background counts from
    its start; outside a block a line has no ``"s"``."""
    clock = chip_smoke.PhaseClock()
    monkeypatch.setattr(chip_smoke, "CLOCK", clock)
    chip_smoke.emit("untimed", x=1)
    with clock.timed():
        chip_smoke.emit("kernel", row=0)
        chip_smoke.emit("kernel", row=1)
    started = time.perf_counter() - 5.0
    with clock.timed(since=started):
        chip_smoke.emit("chaos_live", ok=True)
    with clock.timed():
        pass  # a phase that printed nothing is not listed
    out = chip_smoke.emit_phase_seconds()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert "s" not in lines[0]
    assert lines[1]["s"] <= lines[2]["s"] < 5.0
    assert lines[3]["s"] >= 5.0
    assert list(clock.seconds) == ["kernel", "chaos_live"]
    assert clock.seconds["chaos_live"] >= 5.0
    assert clock.background == ["chaos_live"]
    assert lines[4] == {"phase": "phase_seconds", **out}
    assert out["seconds"] == clock.seconds
    assert 0 < out["total"] < time.monotonic()


def test_waves_beside_the_chaos_gate():
    """The phases of a wave run beside ``THROUGHOUT`` and one another; a
    phase of ``THROUGHOUT`` runs beside every other of them; neither the
    fleet rung that measures rates nor the crossover is in any wave."""
    waves = chip_smoke.WAVES
    assert chip_smoke._beside("audit_live") == [
        "chaos_live", "mesh_bench", "federation_live", "codec_fuzz",
        "parity", "stale_parity", "checkpoint"]
    assert set(chip_smoke._beside("chaos_live")) == {
        "mesh_bench", *sum(waves, ())}
    for alone in ("fleetsim_1k_512", "crossover_sweep", "decent_premium",
                  "congestion", "roofline", "reserved_astar", "kernel",
                  "fused"):
        assert alone not in sum(waves, chip_smoke.THROUGHOUT)
