"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
a configuration, a cell, a traffic mix, a traffic kind and a metric that a
later change adds as new files, with no edit to a file that is there."""

import json
import re
import shutil

from conftest import ROOT, SMALL, make_root, run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_manifest_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_text()
    m = json.loads(raw)
    assert len(raw.encode()) <= 64 * 1024
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32 and all(map(_line, m["command"]))
    for word in m["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"])
            assert (ROOT / word).is_file()
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    assert 1 <= len(m["configs"]) <= 24
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])

    cells, pairs = set(), set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
        bench = ROOT / "tswap_bench"
        work = json.loads((bench / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert (work["config"], work["traffic"]) == (w["config"],
                                                    w["traffic"])
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (bench / "traffic" / f"{mix['kind']}.py").is_file()
    assert len(pairs) == len(cells) == len(m["workloads"])
    assert {c["name"] for c in m["configs"]} == {w["config"]
                                                 for w in m["workloads"]}
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)

    metric_names = set()
    e2e = {}
    for e in m["end_to_end"]:
        assert E2E_KEYS <= set(e) <= E2E_KEYS | {"workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        e2e[e["name"]] = e
    assert e2e["setup_s"]["bound"] <= 0.25
    for p in m["per_layer"]:
        assert LAYER_KEYS <= set(p) <= LAYER_KEYS | {"workloads"}
        assert p["moves"] in e2e and _line(p["layer"])
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert x["name"] not in metric_names
        metric_names.add(x["name"])
        assert (ROOT / "tswap_bench" / "metrics"
                / f"{x['name']}.py").is_file()
        assert set(x.get("workloads", cells)) <= cells
    for cell in cells:
        def has(entries):
            return [x["name"] for x in entries
                    if cell in x.get("workloads", cells)]
        assert "setup_s" in has(m["end_to_end"])
        assert len(has(m["end_to_end"])) >= 2 and has(m["per_layer"])


ADDED_KIND = '''
"""A traffic kind added as a file of its own, on the whole-solves
driver."""
from pathlib import Path
import importlib.util
_spec = importlib.util.spec_from_file_location(
    "added_base", Path(__file__).with_name("whole_solves.py"))
_base = importlib.util.module_from_spec(_spec)
import sys
sys.modules["added_base"] = _base
_spec.loader.exec_module(_base)
ATTRIBUTION = _base.ATTRIBUTION
setup, window, finish, check = (_base.setup, _base.window, _base.finish,
                                _base.check)
'''
ADDED_METRIC = '''
"""steps_in_window: a metric added as a file of its own."""


def read(win):
    return float(len(win.step_s)) if win.step_s else None
'''


def test_added_files_are_found_without_an_edit(tmp_path):
    root = make_root(tmp_path, configs=())
    bench = root / "tswap_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = dict(SMALL, name="added-cfg")
    (bench / "configs" / "added-cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "added-mix.json").write_text(json.dumps(
        {"kind": "added_kind", "tasks_per_agent": 1, "seed_stride": 1000,
         "warmup_steps": 2}))
    (bench / "traffic" / "added_kind.py").write_text(ADDED_KIND)
    (bench / "metrics" / "steps_in_window.py").write_text(ADDED_METRIC)
    (bench / "workloads" / "added-cfg.added-mix.json").write_text(
        json.dumps({"config": "added-cfg", "traffic": "added-mix",
                    "solves_prepared": 1,
                    "check": {"steps": 3, "step_span": 30, "agents": 4,
                              "stayed": 4, "reference_batch": 8}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "added-cfg", "source": "test",
                         "file": "tswap_bench/configs/added-cfg.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "added-cfg.added-mix",
                           "config": "added-cfg", "traffic": "added-mix",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "steps_in_window", "unit": "steps",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    r = run_cpu(root, "added-cfg.added-mix")
    assert r["correct"] is True
    assert r["metrics"]["steps_in_window"]["value"] >= 1
    assert {"solve_step_ms", "step_ms_p95", "setup_s"} <= set(r["metrics"])
    after = {p: p.read_bytes() for p in before}
    assert after == before
    shutil.rmtree(root)
