"""The benchmark's files: every cell, configuration, traffic mix, driver
and per-layer metric that ``BENCHMARK.json`` names loads by name and
agrees with it; a cell and a metric added as files alone run."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_agrees(w):
    cell = harness.Cell.load(w["name"])
    assert cell.spec["config"] == w["config"]
    assert cell.spec["traffic"] == w["traffic"]
    assert cell.spec["chips"] == w["chips"] == 1
    assert cell.spec["why"] == w["why"]
    harness.load_module("drivers", cell.driver)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name, unit in cell.spec["end_to_end"].items():
        assert e2e[name]["unit"] == unit
        assert w["name"] in e2e[name].get("workloads", [w["name"]])
    per = {m["name"]: m for m in SPEC["per_layer"]}
    for name in cell.spec["per_layer"]:
        assert w["name"] in per[name]["workloads"]
        assert per[name]["moves"] in cell.spec["end_to_end"]
        assert harness.load_module("metrics", name).UNIT == per[name]["unit"]
    assert set(cell.spec["limits"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_agrees(c):
    cfg = harness.load_json("configs", c["name"])
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    assert cfg["source"] == c["source"]
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    from rag_snvbert_tpu_torch.config import get_preset

    rc = get_preset(cfg["preset"])
    assert rc.model.dims == cfg["model"]["dims"]


def test_every_metric_is_reported_somewhere():
    reported = set()
    for w in SPEC["workloads"]:
        spec = harness.Cell.load(w["name"]).spec
        reported |= set(spec["per_layer"]) | set(spec["end_to_end"])
    assert reported == ({m["name"] for m in SPEC["per_layer"]}
                        | {m["name"] for m in SPEC["end_to_end"]})


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A copy of the folder gains a cell and a per-layer metric as two
    new files, and a traced run reports the metric."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((copy / "cells" / "tpu_default.train.json")
                      .read_text())
    spec["per_layer"] = ["dummy.steps"]
    (copy / "cells" / "dummy.train.json").write_text(json.dumps(spec))
    (copy / "metrics" / "dummy.steps.py").write_text(
        'UNIT = "steps"\n\n\ndef read(r):\n'
        '    return float(r.counts["micro_steps"])\n')
    monkeypatch.setattr(harness, "HERE", copy)
    res = harness.run_cell(harness.Cell.load("dummy.train"), 7, 0.5, True,
                           "cpu", 0.0, tiny("tpu_default.train",
                                            bf16=False))
    assert res["metrics"]["dummy.steps"]["value"] > 0
    assert res["metrics"]["dummy.steps"]["unit"] == "steps"


def test_frozen_panel_is_the_programs():
    """``panel.make_panel`` gives ``make_calibrated_bundle``'s arrays."""
    import numpy as np

    from benchmark.panel import make_panel
    from rag_snvbert_tpu_torch.io.synthetic import make_calibrated_bundle

    b = make_calibrated_bundle(12, 20, 400, 2, seed=5)
    p = make_panel(12, 20, 400, 2, seed=5, target_cohorts=(3,))
    assert np.array_equal(b.train.gt, p.train_gt)
    assert np.array_equal(b.ref.gt, p.ref_gt)
    assert np.array_equal(b.freq.freq, p.freq)
    assert np.array_equal(b.train.pos, p.positions)
    assert np.array_equal(b.window.window_info, p.window_info)
    assert p.targets[0].shape == (400, 3, 2)


def test_trace_arithmetic():
    from benchmark.trace import Trace, kernel_class, union_length

    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert kernel_class("void attention_fwd_kernel<64, 2>(int)") \
        == "attention_fwd_kernel"
    ev = [{"ph": "X", "cat": "kernel", "name": "k<1>", "ts": 10, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "k<2>", "ts": 12, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "bench.step", "ts": 0,
           "dur": 100}]
    t = Trace.from_events(ev, 0.0, 40.0)
    assert t.busy_s == 7e-6 and t.window_s == 40e-6
    assert t.kernel_seconds("k") == (2, 10e-6)
    assert t.idle_gaps(1) == [["bench.step", 23e-6]]
