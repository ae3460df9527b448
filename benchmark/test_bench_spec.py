"""BENCHMARK.json against the benchmark's contract, and the harness's
look for JAX: names, units, the cells' files and readers, what each
per-layer metric moves, the chips the cells ask for."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark_file()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "-m", "benchmark.run"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in bench[group]]
        assert len(seen) == len(set(seen)), group
    metric_names = [m["name"]
                    for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds_and_sources(bench):
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}

    def reported(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reported(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        own = [m for m in bench["end_to_end"] if reported(m, cell)]
        assert "setup_s" in [m["name"] for m in own]
        assert len(own) >= 2
        assert [m for m in bench["per_layer"] if reported(m, cell)]


def test_at_most_a_quarter_of_the_cells_take_four_chips(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    assert not four


def test_every_cell_finds_its_files_and_readers(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200
        cell = spec.load_cell(w["name"], bench)
        assert cell.limits["numbers"], w["name"]
        assert cell.work()["ops_per_env"] > 0
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "legged_gym_tpu_torchx", sys)
    assert "legged_gym_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "legged_gym_tpu.physics", sys)
    assert run.forbidden_modules() == ["legged_gym_tpu"]


def test_nothing_the_harness_imports_loads_jax():
    """Every module a run of any cell imports, in a fresh interpreter."""
    code = (
        "import sys, importlib, glob, os\n"
        "from benchmark import run, spec, calibrate, trace\n"
        "from benchmark.work import make_table, flops\n"
        "bench = spec.benchmark_file()\n"
        "for w in bench['workloads']:\n"
        "    cell = spec.load_cell(w['name'], bench)\n"
        "    importlib.import_module('benchmark.kinds.' + cell.kind)\n"
        "    for m in cell.per_layer:\n"
        "        spec.metric_reader(m['name'])\n"
        "from legged_gym_tpu_torch import registry, config\n"
        "from legged_gym_tpu_torch.physics import chain_kernel\n"
        "import benchmark.reference.envs.legged_env\n"
        "import benchmark.reference.rl.ppo\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port_or_jax():
    root = os.path.join(spec.HERE, "reference")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    text = fh.read()
                assert not re.search(
                    r"^\s*(import|from)\s+(jax|jaxlib|flax|legged_gym_tpu)\b",
                    text, re.M), name
