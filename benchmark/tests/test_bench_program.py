"""The benchmark drives the program as the program drives itself: the
model ``program.build_model`` makes is the one ``config.build_model``
makes (the same classes, modules, parameters and constructor settings;
only the weights' source differs), and the train driver's epochs, each
``Trainer._run_epoch`` and then the curriculum step, leave the trainer
where ``Trainer.fit`` over the same epochs leaves it.  A change to either
entry of the program that the benchmark would not follow fails here."""

import dataclasses
import json

import pytest
import torch

from benchmark import harness, program
from benchmark.tests.conftest import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
# One cell of each configuration.
CELL_OF = {}
for _w in SPEC["workloads"]:
    CELL_OF.setdefault(_w["config"], _w["name"])

PLAIN = (bool, int, float, str, tuple, torch.dtype, type(None))


def _settings(model) -> list:
    """Each module's name, class and plain attributes (what its
    constructor's keyword arguments set), and each parameter's and
    buffer's name, shape and type."""
    out = []
    for name, mod in model.named_modules():
        attrs = {k: v for k, v in vars(mod).items()
                 if not k.startswith("_") and isinstance(v, PLAIN)}
        out.append((name, type(mod).__qualname__, sorted(attrs.items(),
                                                         key=str)))
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        out.append((name, tuple(t.shape), t.dtype))
    return out


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_model_is_config_build_models(config, tmp_path):
    from rag_snvbert_tpu_torch.config import build_model

    run = harness.Run(harness.Cell.load(CELL_OF[config]), 3, 0.0, False,
                      "cpu", str(tmp_path))
    rc = program.preset(run)
    ours = program.build_model(rc, 11, 3, "cpu")
    theirs = build_model(rc, 11, device="cpu", seed=3)
    assert type(ours) is type(theirs)
    assert _settings(ours) == _settings(theirs)


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_epochs_are_fits(cell, tmp_path):
    """Three of the window's epochs (one curriculum step among them)
    against ``Trainer.fit`` from the same set-up over the same epochs."""
    drv = harness.load_module("drivers", "train")
    over = tiny(cell, bf16=False)
    states = []
    for side in ("window", "fit"):
        run = harness.Run(harness.Cell.load(cell), 2 ** 31 + 41, 0.0, False,
                          "cpu", str(tmp_path / side), over)
        states.append(drv.setup(run))
    window, fit = states
    for _ in range(3):
        drv._epoch(window["trainer"], window)
    t = fit["trainer"]
    t.start_epoch = fit["epoch"]
    t.cfg = dataclasses.replace(t.cfg, epochs=fit["epoch"] + 3)
    t.fit()
    a, b = window["trainer"], t
    assert (a.step, a.level) == (b.step, b.level)
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    for x, y in zip(a.optimizer.mu, b.optimizer.mu):
        assert torch.equal(x, y)
