"""The harness on the CPU at a small size: BENCHMARK.json against the
contract's schema, the result line's schema, a configuration, a traffic mix
and a metric added as new files, the import guard, and the check: a sound
run is correct, the control and each fault of the timed path are not."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from ltebench import control, run

ROOT = run.ROOT
BENCH = run.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"scan512_cfo1k5": {"config": {"channels": 4, "steps": 100}}}
CELL = "scan512_cfo1k5"


def cpu_run(workload, seed=11, seconds=1.0, trace=False, fault=None):
    return run.run_cell(BENCH, workload, seed, seconds, trace, device="cpu",
                        overrides=SMALL[workload], fault=fault)


def test_benchmark_json_meets_the_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ltebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ltebench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "ltebench", "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "ltebench", "limits",
                                           w["name"] + ".json"))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(ROOT, "ltebench", "metrics",
                                           m["name"] + ".py"))
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in run.cell_metrics(
                BENCH, w, "end_to_end")}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:      # every cell: setup_s, another e2e, a per-layer
        assert len(run.cell_metrics(BENCH, w, "end_to_end")) >= 2
        assert run.cell_metrics(BENCH, w, "per_layer")


def test_without_a_card_the_run_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "ltebench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct_and_its_line_meets_the_schema(workload):
    r = cpu_run(workload)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0
    want = {m["name"]: m["unit"]
            for m in run.cell_metrics(BENCH, workload, "end_to_end")}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def test_a_traced_run_reports_per_layer_metrics_only():
    r = cpu_run(CELL, trace=True)
    allowed = {m["name"] for m in run.cell_metrics(BENCH, CELL,
                                                   "per_layer")}
    assert r["metrics"] and set(r["metrics"]) <= allowed
    assert {"busy_s", "window_s"} <= set(r["device"])


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(SMALL)
    for f in ("state_unchanged", "half_batch", "answer_altered")])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault):
    r = cpu_run(workload, fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    limits = run.load_json("limits", workload)
    got = control.control_numbers(workload, 21, "fp8_e4m3",
                                  torch.device("cpu"), SMALL[workload])
    assert got["psr_rel_gap"] > limits["psr_rel_gap"] \
        or got["state_mismatch"] > limits["state_mismatch"], got


def test_a_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "ltebench"), copy / "ltebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    lb = copy / "ltebench"
    cfg = json.load(open(lb / "configs" / "capture_scan512.json"))
    (lb / "configs" / "capture_scan4.json").write_text(
        json.dumps(dict(cfg, name="capture_scan4", channels=4, steps=100)))
    mix = json.load(open(lb / "traffic" / "cells_cfo1k5.json"))
    (lb / "traffic" / "sparse.json").write_text(
        json.dumps(dict(mix, occupied=0.5)))
    (lb / "limits" / "scan4_sparse.json").write_text(
        (lb / "limits" / "scan512_cfo1k5.json").read_text())
    (lb / "metrics" / "calls.scan4.py").write_text(
        "def read(rd):\n    return rd['state']['calls']\n")
    bench["configs"].append(dict(bench["configs"][0], name="capture_scan4",
                                 file="ltebench/configs/capture_scan4.json"))
    bench["workloads"].append(dict(name="scan4_sparse",
                                   config="capture_scan4", traffic="sparse",
                                   chips=1, why="a test cell"))
    bench["per_layer"].append(dict(
        name="calls.scan4", unit="calls", better="higher",
        source="program_counter", layer="engine", moves="scan_msps",
        workloads=["scan4_sparse"]))
    bench["end_to_end"][0]["workloads"].append("scan4_sparse")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = __import__("importlib.util").util.spec_from_file_location(
        "copied_run", lb / "run.py")
    copied = __import__("importlib.util").util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    r = copied.run_cell(copied.load_benchmark(str(copy)), "scan4_sparse",
                        5, 1.0, True, device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["calls.scan4"]["value"] >= 1
    assert set(r["metrics"]) == {"calls.scan4"} | {
        m for m in r["metrics"] if m.endswith(".scan")}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "ltetrigger_tpu"}
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ltebench")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & bad, (path, tops & bad)
                if os.sep + "reference" + os.sep in path:
                    assert "ltetrigger_tpu_torch" not in tops, path


def test_a_run_loads_no_jax_by_top_level_name():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from ltebench import run\n"
            "r = run.run_cell(run.load_benchmark(), 'scan512_cfo1k5', 3, 0.5,"
            " False, device='cpu',"
            " overrides={'config': {'channels': 2, 'steps': 100}})\n"
            "assert r['correct'], r['checks']\n"
            "print(run.forbidden_modules())\n") % ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_cell(BENCH, CELL, 4, 2.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
