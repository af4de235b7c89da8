"""The port's quality-run tools against the JAX package's:
``tools/run_convergence.py`` (the same split, outputs and ``metrics.csv``
header as the JAX tool, a resume that replays the curriculum and draws
what an uninterrupted run draws) and ``tools/oracle_ceiling.py`` (the same
JSON as the JAX tool at the same flags, timing aside), at the smoke preset
on a two-window calibrated panel."""

import contextlib
import csv
import io
import json
import os

import numpy as np
import pytest

from rag_snvbert_tpu.io.synthetic import make_calibrated_bundle as jmake
from rag_snvbert_tpu_torch.tools import oracle_ceiling, run_convergence
from test_torch_modules import torch_one_thread  # noqa: F401

R5 = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                  "convergence_r5")
TINY = ["--preset", "smoke", "--windows", "2", "--samples", "24",
        "--ref-samples", "16", "--val-fraction", "0.25"]
RUN = TINY + ["--ref-pad-haps", "32", "--log-freq", "2", "--warmup-steps",
              "5", "--device", "cpu"]


def _run(out, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return run_convergence.main(RUN + ["--out", str(out), *extra])


def _rows(out):
    with open(os.path.join(out, "metrics.csv"), newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    return out, _run(out, "--epochs", "2")


def test_metrics_csv_has_the_jax_header(straight):
    out, summary = straight
    with open(os.path.join(R5, "metrics.csv")) as f:
        jax_header = f.readline().strip().split(",")
    rows = _rows(out)
    assert rows[0] == jax_header and len(rows) == 3
    assert [r[:2] for r in rows[1:]] == [["0", "0"], ["1", "1"]]
    assert summary["epochs_run"] == 2 and summary["val_samples"] == 6
    assert summary["train_samples"] == 18 and summary["windows"] == 2
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary


def test_resume_replays_the_curriculum_and_draws_the_same(straight,
                                                          tmp_path):
    """Epoch 0 with --profile, then --resume to epoch 1: the rows equal the
    uninterrupted run's but for the seconds; summary_history keeps both
    invocations; the trace is written."""
    out = tmp_path / "resumed"
    _run(out, "--epochs", "1", "--profile")
    assert os.listdir(out / "profile")
    summary = _run(out, "--epochs", "2", "--resume")
    assert summary["resumed_from"] == 1 and summary["epochs_run"] == 1
    with open(out / "summary_history.jsonl") as f:
        hist = [json.loads(line) for line in f]
    assert [h["resumed_from"] for h in hist] == [0, 1]
    want, got = _rows(straight[0]), _rows(out)
    header = want[0]
    keep = [i for i, c in enumerate(header) if not c.endswith("_seconds")]
    assert got[0] == header
    for a, b in zip(want[1:], got[1:]):
        assert [a[i] for i in keep] == [b[i] for i in keep]


@pytest.mark.parametrize("subsample", [0, 10])
def test_split_and_subsample_are_the_jax_tools(subsample):
    """The JAX tool's inline split (tools/run_convergence.py:104-113) on
    the JAX bundle gives the port's ids."""
    from rag_snvbert_tpu_torch.io.synthetic import make_calibrated_bundle

    kw = dict(n_train_samples=40, n_ref_samples=8, n_sites=60, n_windows=1,
              seed=21)
    jb = jmake(**kw)
    tr, va = jb.panel.split_stratified(0.25, seed=21)
    if subsample:
        keep = np.random.default_rng(21).choice(len(tr), subsample,
                                                replace=False)
        tr = np.sort(np.asarray(tr)[keep])
    got_tr, got_va = run_convergence.split_samples(
        make_calibrated_bundle(**kw), 0.25, 21, subsample)
    np.testing.assert_array_equal(got_tr, tr)
    np.testing.assert_array_equal(got_va, va)


@pytest.mark.parametrize("extra", [[], ["--skip-ls-panel", "--val-level",
                                        "2", "--limit-windows", "1"]],
                         ids=["all-oracles", "truth-and-nn-one-window"])
def test_oracle_ceiling_json_equals_jax(extra, monkeypatch):
    from tools import oracle_ceiling as joracle

    argv = TINY + extra
    monkeypatch.setattr("sys.argv", ["oracle_ceiling", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        joracle.main()
    want = json.loads(buf.getvalue())
    with contextlib.redirect_stdout(io.StringIO()):
        got = json.loads(json.dumps(oracle_ceiling.main(argv)))
    for d in (want, got):
        d.pop("wall_seconds")
    assert got == want
    assert ("ls_panel" in got["oracles"]) == (not extra)
