"""BENCHMARK.json against the benchmark's contract, and a cell, a config
and a per-layer metric added as files alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_and_names(man):
    assert set(man) == TOP_KEYS
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200
            assert "\n" not in text and "\t" not in text
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    names = [x["name"] for x in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(man)) <= 64 * 1024


def test_end_to_end(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_should(man):
    cells = {w["name"] for w in man["workloads"]}
    for w in man["workloads"]:
        cell = harness.resolve(w["name"], man)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w["name"]
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            e2e = {x["name"] for x in harness.resolve(c, man)["end_to_end"]}
            assert m["moves"] in e2e, (m["name"], c)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_config_has_a_cell_and_its_file(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))


def test_run_seconds_fits_the_check(man):
    rs = man["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_the_command(man):
    assert man["paths"] == ["portbench"]
    assert man["command"][:3] == ["python3", "-m", "portbench.run"]


def test_files_agree_with_the_manifest(man):
    for w in man["workloads"]:
        f = harness.load_json(harness.HERE / "workloads"
                              / f"{w['name']}.json")
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
    for m in man["per_layer"]:
        assert hasattr(harness.load_reader(m["name"]), "read")


def _copy_tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


DUMMY_LOADER = '''
import numpy as np


def reference(config, seed):
    rng = np.random.default_rng(seed)
    cols = [("int64", rng.integers(-9, 9, config["rows"])),
            ("float64", rng.random(config["rows"]))]
    return {"reference": {"t": cols}}


def prepare(config, seed, device):
    from spark_rapids_jni_tpu_torch.column import Column, Table
    host = reference(config, seed)
    host["tables"] = {"t": Table([Column.from_numpy(v, device=device)
                                  for _, v in host["reference"]["t"]])}
    return host
'''


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A config with a new loader, a new mix, a cell and a per-layer
    metric, as new files and new BENCHMARK.json entries, are found by
    name, run and give their control, with no existing file of the
    benchmark edited."""
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench/data/dummy_loader.py").write_text(DUMMY_LOADER)
    (root / "portbench/configs/dummy_config.json").write_text(json.dumps(
        {"name": "dummy_config", "loader": "dummy_loader", "rows": 999,
         "reduced": []}))
    (root / "portbench/traffic/rows_loop_dummy.json").write_text(json.dumps(
        {"kind": "rows_roundtrip", "warmup_steps": 1, "keep_within": 1,
         "trace_slice_s": 0.5}))
    why = "a dummy cell"
    (root / "portbench/workloads/dummy_cell.json").write_text(json.dumps(
        {"config": "dummy_config", "traffic": "rows_loop_dummy",
         "chips": 1, "why": why, "params": {"table": "t"},
         "limits": {"row_bytes_wrong": 0, "values_back_wrong": 0}}))
    (root / "portbench/metrics/dummy_metric.py").write_text(
        "def read(view):\n    return 42.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_config", "source": "x",
                           "file": "portbench/configs/dummy_config.json",
                           "reduced": [], "why": "a dummy config"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                             "traffic": "rows_loop_dummy", "chips": 1,
                             "why": why})
    man["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "row conversion", "moves": "rows_gbps",
                             "workloads": ["dummy_cell"]})
    man["end_to_end"][0]["workloads"].append("dummy_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench import control, harness;"
        "c = harness.resolve('dummy_cell');"
        "out = harness.run_cell('dummy_cell', 7, 0.3, False, device='cpu');"
        "ctl = control.readings(c, 7);"
        "print(c['config']['rows'], out['correct'], out['attempted'] > 0,"
        " ctl['values_back_wrong'] > 0,"
        " [m['name'] for m in c['per_layer']],"
        " [m['name'] for m in c['end_to_end']],"
        " harness.load_reader('dummy_metric').read(None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[:4] == ["999", "True", "True", "True"]
    assert "'dummy_metric'" in out.stdout and "'rows_gbps'" in out.stdout
    assert out.stdout.strip().endswith("42.0")
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    gives no result and a non-zero exit."""
    root = _copy_tree(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rows_store_sales_sf10", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
