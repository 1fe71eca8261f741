"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the program's own name begins with the JAX
package's), and the plain reference loads nothing of the program."""

import ast
import re
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "tswap_bench"
JAX = {"jax", "jaxlib", "flax", "p2p_distributed_tswap_tpu"}
PROGRAM = "p2p_distributed_tswap_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and re.match(r"^[\w.]+:\w+$", node.value):
            yield node.value.split(":")[0]  # a "module:attr" probe target


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_sources_name_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & JAX
    if path.parent.name == "reference":
        assert PROGRAM not in tops and not any(
            t.startswith("p2p_distributed") for t in tops)


def test_whole_names_are_compared():
    from tswap_bench import harness

    sys.modules.setdefault("p2p_distributed_tswap_tpu_torch_probe", sys)
    try:
        assert "p2p_distributed_tswap_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("p2p_distributed_tswap_tpu_torch_probe", None)


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_nothing_of_the_program():
    p = _fresh(
        "import sys; sys.path.insert(0, '.')\n"
        "import tswap_bench.reference.fields, tswap_bench.reference.assign\n"
        "import tswap_bench.reference.plans, tswap_bench.reference.control\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout))
    assert not any(t.startswith("p2p_distributed") for t in tops)
    assert not tops & JAX


def test_a_whole_run_loads_no_jax(tmp_path):
    p = _fresh(
        "import sys; sys.path.insert(0, 'tswap_bench/tests')\n"
        "from pathlib import Path\n"
        "from conftest import make_root, run_cpu\n"
        f"r = run_cpu(make_root(Path({str(tmp_path)!r})), 'small.solve')\n"
        "from tswap_bench import harness\n"
        "print(r['correct'], harness.forbidden_modules())")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split()[-2:] == ["True", "[]"]
