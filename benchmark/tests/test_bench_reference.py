"""The reference against the program at a small size on the CPU: with the
program computing in float32 (``bf16: False``) they agree to rounding,
which shows that the reference reproduces the batches, masks, window
contexts, retrieval, dropout draws, forward, backward and update, and
the imputations."""

import numpy as np
import pytest
import torch

from benchmark import harness, program, weights
from benchmark.reference import model as ref_model
from benchmark.tests.conftest import tiny


def _run(cell, tmp, **extra):
    c = harness.Cell.load(cell)
    return harness.Run(c, 2 ** 31 + 9, 0.5, False, "cpu", str(tmp),
                       tiny(cell, **extra))


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_same_parameters_and_weights(cell, tmp_path):
    run = _run(cell, tmp_path)
    rc = program.preset(run)
    prog = program.build_model(rc, 10, 3, "cpu")
    ref = weights.fill(ref_model.from_config(program.model_block(run), 10),
                       3)
    a, b = prog.state_dict(), ref.state_dict()
    assert list(sorted(a)) == list(sorted(b))
    for k in a:
        assert torch.equal(a[k].float(), b[k]), k


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_training_matches(cell, tmp_path):
    run = _run(cell, tmp_path, bf16=False)
    drv = harness.load_module("drivers", "train")
    state = drv.setup(run)
    checks = {c["name"]: c["value"] for c in drv.check(run, state)}
    assert checks["loss"] < 1e-5
    assert checks["grad"] < 1e-4
    assert checks["update"] < 1e-3


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_training_matches_one_step_a_dispatch(cell, tmp_path):
    """The driver's path for a mix of one micro-step a dispatch (no chunk
    runner: each step dispatched from the host); two windows, so epoch 0
    holds two micro-steps to compare."""
    run = _run(cell, tmp_path, bf16=False, steps_per_dispatch=1,
               check_micro_steps=2)
    drv = harness.load_module("drivers", "train")
    state = drv.setup(run)
    assert state["trainer"].runner is None
    checks = {c["name"]: c["value"] for c in drv.check(run, state)}
    assert checks["loss"] < 1e-5
    assert checks["grad"] < 1e-4
    assert checks["update"] < 1e-3


def test_imputation_matches(tmp_path):
    run = _run("tpu_default.impute", tmp_path, bf16=False)
    drv = harness.load_module("drivers", "impute")
    state = drv.setup(run)
    drv.window(run, state, 0.1)
    checks = {c["name"]: c["value"] for c in drv.check(run, state)}
    assert checks["answer"] < 1e-5


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in pathlib.Path(harness.HERE, "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("rag_snvbert_tpu_torch",
                                               "rag_snvbert_tpu", "jax",
                                               "benchmark"), (path, n)


def test_numerics_controls_round():
    x = torch.randn(1000)
    from benchmark.reference import numerics

    t = numerics.round_operand(x, "tf32")
    assert 0 < (t - x).abs().max() <= x.abs().max() * 2 ** -11
    f = numerics.round_operand(x, "fp8")
    assert (f - x).abs().max() > (t - x).abs().max()
    assert torch.equal(numerics.round_operand(x, None), x)
