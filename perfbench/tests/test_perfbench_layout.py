"""The benchmark's files: every cell resolves to its own files by name,
``BENCHMARK.json`` keeps to its format, the configuration files are the
program's configurations, and nothing under ``perfbench/`` imports JAX or
the JAX package (nor the reference the program)."""
from __future__ import annotations

import ast
import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench.tests.support import BENCH, CELLS, ROOT, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_benchmark_json_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(CELLS) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {c for c, _ in pairs}
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(ROOT, name)
    driver = cell.traffic["driver"]
    assert hasattr(importlib.import_module(f"perfbench.drivers.{driver}"),
                   "Driver")
    tests = importlib.import_module(f"perfbench.tests.drivers.{driver}")
    assert tests.FAULTS and isinstance(tests.SMALL_TRAFFIC, dict)
    assert cell.limits and set(cell.limits) <= {
        "loss_gap", "loss1_gap", "grad_gap", "change_gap"}
    assert all(v > 0 for v in cell.limits.values())
    for kind, metrics in (("endtoend", cell.end_to_end),
                          ("metrics", cell.per_layer)):
        assert metrics
        for m in metrics:
            assert callable(harness.reader(kind, m))
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    moved = {m["moves"] for m in BENCH["per_layer"]
             if name in m.get("workloads", CELLS)}
    assert moved <= set(cell.end_to_end)


def test_configuration_files():
    """Each configuration file is what the program runs: ``differences``
    (``perfbench/config_check.py``) finds nothing between the program's
    configuration from the file and its registered one, cut as ``reduced``
    declares, nor between the program's parameter tree and the
    reference's."""
    from perfbench.config_check import differences

    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for entry in BENCH["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert differences(entry, cfg) == [], entry["name"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_jax_and_a_program_free_reference():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    ref_mods = set()
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        ref_mods |= set(_imports(path))
    allowed = {"torch", "__future__", "dataclasses", "typing", "math",
               "contextlib", "importlib", "perfbench"}
    assert {m.split(".")[0] for m in ref_mods} <= allowed, ref_mods
    # what the reference imports from the benchmark imports no program
    for mod in sorted(ref_mods):
        if mod.startswith("perfbench") and not mod.startswith(
                "perfbench.reference"):
            path = ROOT / (mod.replace(".", "/") + ".py")
            if not path.exists():
                continue
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & ({"repro_torch"} | FORBIDDEN), mod


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "2147483651", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    from perfbench.harness import forbidden_modules

    for name in ("repro_torch_probe", "jaxtyping_probe", "repro.probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    bad = forbidden_modules()
    assert "repro.probe" in bad
    assert "repro_torch_probe" not in bad and "jaxtyping_probe" not in bad
