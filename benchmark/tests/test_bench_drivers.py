"""Each driver at a tiny size on the CPU (the program's plain kernels):
a run ends in one result line with the contract's keys, the numbers
compared last."""

import io
import json
from contextlib import redirect_stdout, redirect_stderr

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny

CELLS = ["tpu_default.train", "tpu_default.impute", "v17_token_rag.train"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_driver_result_line(cell, trace):
    c = harness.Cell.load(cell)
    res = harness.run_cell(c, 2 ** 31 + 5, 0.5, bool(trace), "cpu", 0.0,
                           tiny(cell))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(res)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(c.spec["limits"])
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= set(c.spec["per_layer"])
    else:
        assert set(line["metrics"]) == set(c.spec["end_to_end"])
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_no_card_no_result(capsys):
    """Without a card the run fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "tpu_default.train", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
