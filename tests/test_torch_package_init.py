"""The port's packages export what the JAX package's export.

For every ``__init__.py`` of the JAX package, each public name it binds
(an import or an assignment at its top level) is an attribute of the
port's package at the same path, and ``__all__`` is the same where the JAX
module has one.  The port's ``ops`` modules take ``resolve_device`` from
the leaf ``device`` module, not from ``solver.mapd`` (which imports
``ops``): so any of ``ops``, ``ops.field_repair``, ``ops.sector`` and
``solver.mapd`` can be the first module a fresh interpreter imports.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "p2p_distributed_tswap_tpu"
INITS = sorted(str(p.parent.relative_to(JAX_PKG)).replace("/", ".")
               for p in JAX_PKG.rglob("__init__.py"))


def _bound_names(path: pathlib.Path) -> list:
    """The public names an ``__init__`` binds at its top level."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if isinstance(node, ast.ImportFrom) and node.module == \
                    "__future__":
                continue
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_") or n == "__version__"]


def _module(pkg: str, sub: str):
    return importlib.import_module(pkg if sub == "." else f"{pkg}.{sub}")


@pytest.mark.parametrize("sub", INITS)
def test_port_init_exports_the_jax_inits_names(sub):
    jax_mod = _module("p2p_distributed_tswap_tpu", sub)
    port_mod = _module("p2p_distributed_tswap_tpu_torch", sub)
    path = JAX_PKG / sub.replace(".", "/") / "__init__.py" if sub != "." \
        else JAX_PKG / "__init__.py"
    missing = [n for n in _bound_names(path) if not hasattr(port_mod, n)]
    assert missing == []
    if hasattr(jax_mod, "__all__"):
        assert port_mod.__all__ == jax_mod.__all__


def test_top_level_names_are_the_ports_own():
    import p2p_distributed_tswap_tpu_torch as port
    from p2p_distributed_tswap_tpu_torch.core.grid import Grid
    from p2p_distributed_tswap_tpu_torch.core.tasks import Task, TaskGenerator

    assert (port.Grid, port.Task, port.TaskGenerator) == (
        Grid, Task, TaskGenerator)
    assert port.__version__ == "0.1.0"


@pytest.mark.parametrize("first", [
    "ops", "ops.field_repair", "ops.sector", "solver.mapd"])
def test_each_module_imports_first_in_a_fresh_interpreter(first):
    """No import cycle: each of these imported first, then the rest."""
    rest = [m for m in ("ops", "ops.field_repair", "ops.sector",
                        "solver.mapd", "solver.checkpoint",
                        "runtime.solverd") if m != first]
    code = "; ".join(
        f"import p2p_distributed_tswap_tpu_torch.{m}" for m in [first, *rest])
    code += ("; from p2p_distributed_tswap_tpu_torch.solver.mapd import "
             "resolve_device; from p2p_distributed_tswap_tpu_torch.device "
             "import resolve_device as leaf; assert resolve_device is leaf; "
             "from p2p_distributed_tswap_tpu_torch.ops import distance, "
             "direction_fields, repair_field, tiled_direction_fields; "
             "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
