"""The comparison fails what it must: the control (the reference one
precision below the configuration's, in the program's place) and a run
whose timed path is broken underneath, for each fault the cell can have.
Tiny sizes; the program in float32, so sound runs read rounding.  (No
cell spans chips, so none can leave out an exchange between them.)"""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny

CONTROL = {"tpu_default": "fp8", "v17_token_rag": "tf32"}


def _checks(cell, device="cpu", **extra):
    res = harness.run_cell(harness.Cell.load(cell), 2 ** 31 + 21, 0.3,
                           False, device, 0.0, tiny(cell, **extra))
    return res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tpu_default.train", "tpu_default.impute",
                                  "v17_token_rag.train"])
def test_sound_run_is_correct(cell):
    ok, checks = _checks(cell, bf16=False)
    assert ok, checks


@pytest.mark.parametrize("cell", ["tpu_default.train", "tpu_default.impute",
                                  "v17_token_rag.train"])
def test_control_fails(cell):
    """The control's readings, against the cell's limits."""
    c = harness.Cell.load(cell)
    drv = harness.load_module("drivers", c.driver)
    run = harness.Run(c, 2 ** 31 + 23, 0.3, False, "cpu", None,
                      tiny(cell, bf16=False))
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        run.tmp = tmp
        state = drv.setup(run)
        out = drv.calibrate(run, state, CONTROL[c.spec["config"]], False)
    limits = c.spec["limits"]
    assert any(out["control"][k] > limits[k] for k in limits), out


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_unchanged_state_fails(cell, monkeypatch):
    from rag_snvbert_tpu_torch.train import schedule

    monkeypatch.setattr(schedule.Optimizer, "apply",
                        lambda self, n, row: None)
    ok, checks = _checks(cell, bf16=False)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_half_batch_fails(cell, monkeypatch):
    """Half of each batch left out, the loss the mean over the rest
    (its sum scaled to the whole batch)."""
    from rag_snvbert_tpu_torch.train import losses, step

    total = losses.total_loss

    def half(outputs, labels, mask, *a, **kw):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1
        loss, aux = total(outputs, labels, mask * keep, *a, **kw)
        return loss * 2.0, aux

    monkeypatch.setattr(step.losses, "total_loss", half)
    ok, checks = _checks(cell, bf16=False)
    assert not ok, checks


def test_altered_answer_fails(monkeypatch):
    """One haplotype's probabilities altered where they are produced."""
    from rag_snvbert_tpu_torch.infer import imputer

    forward = imputer.Imputer._forward

    def altered(self, batch, ctx):
        p1, p2, pg = forward(self, batch, ctx)
        p1 = p1.clone()
        p1[0] = 1.0 - p1[0]
        return p1, p2, pg

    monkeypatch.setattr(imputer.Imputer, "_forward", altered)
    ok, checks = _checks("tpu_default.impute", bf16=False)
    assert not ok, checks
