"""The harness is data: BENCHMARK.json's entries find their files by name,
and a configuration, a mix, a cell or a metric is added by adding files and
entries alone."""
from __future__ import annotations

import importlib.util
import json
import re
import shutil

import pytest

from bench.harness import main as M, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return M.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [e["name"] for e in bench[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      M.benchmark()["workloads"]])
def test_every_cell_finds_its_files(bench, workload):
    cell, config, mix = M.cell_files(bench, workload)
    entry = M.find(bench["configs"], cell["config"], "config")
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert (M.BENCH / "drivers" / f"{config['driver']}.py").exists()
    assert mix["kind"] in traffic.KINDS and mix["why"]
    for limit in config["limits"].values():
        assert limit is not None and limit >= 0
    e2e = M.metrics_for(bench, workload, False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert M.metrics_for(bench, workload, True)


def test_every_metric_has_its_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = M.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        assert callable(mod.read) and mod.__doc__
        if m in bench["per_layer"]:
            assert mod.MOVES == m["moves"] in e2e
            assert mod.LAYER == m["layer"]
            for w in m["workloads"]:
                moved = M.find(bench["end_to_end"], m["moves"], "metric")
                assert w in moved.get("workloads", [w])
        assert mod.read({}) is None


def test_a_new_cell_is_files_and_entries(tmp_path, bench):
    """A configuration, a mix, a cell and a metric added to a copy of the
    benchmark as new files and new entries, no file edited, are found."""
    root = tmp_path / "checkout"
    shutil.copytree(M.BENCH, root / "bench")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    b = json.loads(json.dumps(bench))
    cfg = json.loads((root / "bench/configs/paper-dag.json").read_text())
    cfg["name"] = "paper-dag-wide"
    (root / "bench/configs/paper-dag-wide.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/closed-dag-d3.03.json").write_text(json.dumps(
        {"kind": "closed_dag", "n_tasks": 3000, "degree": 3.03,
         "warm_tasks": 300, "drain_s": 60, "trace_seconds": 5,
         "why": "the paper's base"}))
    (root / "bench/metrics/dag.dags_run.py").write_text(
        'UNIT, MOVES, SOURCE, LAYER = "DAGs", "taos_per_s", '
        '"program_counter", "entry"\n\n\ndef read(obs):\n'
        '    return obs.get("dags")\n')
    b["configs"].append({"name": "paper-dag-wide", "source": "x",
                         "file": "bench/configs/paper-dag-wide.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "dag-d3.03", "config": "paper-dag-wide",
                           "traffic": "closed-dag-d3.03", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "taos_per_s":
            m["workloads"].append("dag-d3.03")
    b["per_layer"].append({"name": "dag.dags_run", "unit": "DAGs",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "taos_per_s",
                           "workloads": ["dag-d3.03"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    after = {p: p.read_bytes() for p in before}
    assert after == before                  # no file of the copy edited
    cell, config, mix = M.cell_files(M.benchmark(root), "dag-d3.03", root)
    assert config["name"] == "paper-dag-wide" and mix["degree"] == 3.03
    names = [m["name"] for m in M.metrics_for(b, "dag-d3.03", True)]
    assert names == ["dag.dags_run"]
    got = M.read_metrics(M.metrics_for(b, "dag-d3.03", True), {"dags": 7},
                         root)
    assert got == {"dag.dags_run": {"value": 7.0, "unit": "DAGs"}}
    assert [m["name"] for m in M.metrics_for(b, "dag-d3.03", False)] == \
        ["taos_per_s", "setup_s"]


def test_judge_and_report():
    ok = {"a": (0.0, 0.0), "b": (0.1, 0.2)}
    assert M.judge(ok)
    assert not M.judge(dict(ok, c=(0.3, 0.2)))
    assert not M.judge(dict(ok, c=(float("nan"), 1.0)))
    line = M.report({"checks": ok, "attempted": 3, "failed": 0}, {}, {},
                    False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"]["b"] == {"value": 0.1, "limit": 0.2}


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    assert M.main(0.0, ["--workload", "dag-d8.06", "--seed", "1",
                        "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_metric_modules_load_by_path():
    spec = importlib.util.find_spec("bench.metrics._counts")
    assert spec is not None
    assert M.metric_module("dag.device_idle").read({"trace": None}) is None
