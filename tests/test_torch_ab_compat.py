"""The port's ``tools/ab_compat.py`` against the JAX tool's: the JAX
``main`` runs with its ``Trainer`` replaced by a stub that records what it
was given (no JAX training), and the port's panel, split, per-variant model
fields and ``TrainerConfig`` must equal what the stub saw; then each
variant trains one epoch through the port's ``run_variant`` on the CPU at a
small width."""

import argparse
import contextlib
import dataclasses
import io
import json
import math

import numpy as np
import pytest

from rag_snvbert_tpu_torch.config import PRESETS
from rag_snvbert_tpu_torch.tools import ab_compat
from test_torch_modules import torch_one_thread  # noqa: F401

ARGV = ["--windows", "1", "--train-samples", "16", "--ref-samples", "24",
        "--epochs", "3"]
KEYS = ["variant", "epochs", "best_val_hap_f1", "best_epoch",
        "final_val_hap_f1", "final_val_rare_f1", "final_train_loss",
        "wall_min"]
# ModelConfig fields the JAX tool hands to the flax modules by name
BERT_FIELDS = ("dims", "n_layers", "attn_heads", "dropout", "pre_ln", "remat",
               "attn_dropout", "scan_layers", "flash_attention",
               "dropout_broadcast", "fused_qkv", "int8_matmuls", "pos_norm")


# what the stub trainers' fit returns: the best epoch is not the last
HISTORY = [{"epoch": 0, "val_hap_f1": 0.51234, "val_rare_f1": 0.25,
            "train_loss": 1.0},
           {"epoch": 1, "val_hap_f1": 0.612345, "val_rare_f1": 0.3,
            "train_loss": 0.9},
           {"epoch": 2, "val_hap_f1": 0.598765, "val_rare_f1": 0.123456,
            "train_loss": 0.876543}]


def _jax_calls(argv, printed=None):
    """Run the JAX tool's ``main`` under ``argv`` with a recording stub
    ``Trainer``: ``[(model, ds, cfg, train_ids, val_ids)]`` a variant;
    its JSON lines go into ``printed``."""
    from tools import ab_compat as jtool

    calls = []

    class StubTrainer:
        def __init__(self, model, embed_fn, ds, cfg, train_sample_ids=None,
                     val_sample_ids=None):
            calls.append((model, ds, cfg, train_sample_ids, val_sample_ids))

        def fit(self):
            return {"history": HISTORY}

    mp = pytest.MonkeyPatch()
    mp.setattr(jtool, "Trainer", StubTrainer)
    mp.setattr("sys.argv", ["ab_compat", *argv])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            jtool.main()
    finally:
        mp.undo()
    if printed is not None:
        printed.extend(json.loads(line) for line in out.getvalue().splitlines())
    return calls


JAX_ROWS: list = []


@pytest.fixture(scope="module")
def recorded():
    return _jax_calls(ARGV, JAX_ROWS)


@pytest.fixture(scope="module")
def port_panel():
    with contextlib.redirect_stderr(io.StringIO()):
        return ab_compat.build_panel(ab_compat.build_parser().parse_args(ARGV))


def test_panel_equals_the_jax_tools(recorded, port_panel):
    _, tds = port_panel
    jds = recorded[0][1]
    for part in ("vcf", "ref_vcf"):
        j, t = getattr(jds, part), getattr(tds, part)
        np.testing.assert_array_equal(t.gt, j.gt, err_msg=part)
        np.testing.assert_array_equal(t.pos, j.pos, err_msg=part)
        assert t.samples == j.samples
    np.testing.assert_array_equal(tds.freq.freq, jds.freq.freq)
    np.testing.assert_array_equal(tds.pop_class, jds.pop_class)
    assert tds.seq_len == jds.seq_len == 1030
    assert tds.vocab.size == jds.vocab.size
    assert len(tds.windows) == len(jds.windows) == 1
    for tw, jw in zip(tds.windows, jds.windows):
        for f in dataclasses.fields(jw):
            np.testing.assert_array_equal(getattr(tw, f.name),
                                          getattr(jw, f.name), err_msg=f.name)


def test_split_equals_the_jax_tools(recorded):
    train, val = ab_compat.split_ids(16, 0.25)
    for _, _, _, jtrain, jval in recorded:
        np.testing.assert_array_equal(train, jtrain)
        np.testing.assert_array_equal(val, jval)
    assert len(val) == 4 and len(train) == 12


@pytest.mark.parametrize("flash", [None, "splash:384f"])
@pytest.mark.parametrize("i,name", list(enumerate(ab_compat.VARIANTS)))
def test_variant_model_equals_the_jax_tools(recorded, i, name, flash):
    calls = recorded if flash is None else _jax_calls(
        ARGV + ["--variants", name, "--flash", flash])
    jm = calls[i if flash is None else 0][0]
    m = ab_compat.variant_run(PRESETS["tpu_default"], name, flash).model
    for field in BERT_FIELDS:
        assert getattr(m, field) == getattr(jm.bert, field), field
    assert m.compat_double_softmax == jm.compat_double_softmax
    assert m.bf16 == (jm.bert.dtype.__name__ == "bfloat16")
    assert m.score_bf16 == (jm.bert.score_dtype.__name__ == "bfloat16")
    assert m.rag_mode == "embedding" and \
        type(jm.bert).__name__ == "BERTWithEmbeddingRAG"


@pytest.mark.parametrize("i,name", list(enumerate(ab_compat.VARIANTS)))
def test_trainer_config_equals_the_jax_tools(recorded, i, name):
    args = ab_compat.build_parser().parse_args(ARGV)
    run = ab_compat.variant_run(PRESETS["tpu_default"], name)
    got = dataclasses.asdict(ab_compat.trainer_config(run, args, name))
    want = dataclasses.asdict(recorded[i][2])
    shared = sorted(set(got) & set(want))
    assert len(shared) > 30
    # the JAX tool writes under /tmp; the port inside its checkout
    assert got.pop("output_dir") == f"runs/ab_compat/{name}"
    assert want.pop("output_dir") == f"/tmp/ab_compat/{name}"
    assert {f: got[f] for f in shared if f != "output_dir"} == \
        {f: want[f] for f in shared if f != "output_dir"}


def test_rows_equal_the_jax_tools(recorded, port_panel, monkeypatch):
    """The same history gives the JAX tool's JSON rows (but the minutes),
    in the same variant order, through the port's ``main``."""
    from tools import ab_compat as jtool

    from rag_snvbert_tpu_torch import config
    from rag_snvbert_tpu_torch.train import trainer

    class StubTrainer:
        def __init__(self, model, ds, cfg, train_sample_ids=None,
                     val_sample_ids=None):
            assert model == "model" and ds is port_panel[1]

        def fit(self):
            return {"history": HISTORY}

    assert ab_compat.VARIANTS == jtool.VARIANTS
    monkeypatch.setattr(trainer, "Trainer", StubTrainer)
    monkeypatch.setattr(config, "build_model", lambda *a, **k: "model")
    monkeypatch.setattr(ab_compat, "build_panel", lambda *a: port_panel)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = ab_compat.main(ARGV + ["--device", "cpu"])
    assert len(recorded) == len(rows) == len(JAX_ROWS) == 3
    for got, want in zip(rows, JAX_ROWS):
        assert list(got) == list(want) == KEYS
        assert {**got, "wall_min": 0} == {**want, "wall_min": 0}
    assert rows[0]["best_epoch"] == 1 and rows[0]["epochs"] == 3


SMALL = dataclasses.replace(
    PRESETS["tpu_default"],
    model=dataclasses.replace(PRESETS["tpu_default"].model, dims=32,
                              n_layers=2, attn_heads=2, seq_len=74))


@pytest.fixture(scope="module")
def small_panel():
    args = ab_compat.build_parser().parse_args(ARGV)
    with contextlib.redirect_stderr(io.StringIO()):
        return ab_compat.build_panel(args, SMALL.model.seq_len)[1]


@pytest.mark.parametrize("name", list(ab_compat.VARIANTS))
def test_run_variant_trains_one_epoch_on_the_cpu(small_panel, name,
                                                 tmp_path):
    args = ab_compat.build_parser().parse_args(
        ARGV[:-2] + ["--epochs", "1", "--outdir", str(tmp_path),
                     "--device", "cpu"])
    row = ab_compat.run_variant(SMALL, small_panel,
                                ab_compat.split_ids(16, 0.25), args, name)
    assert list(row) == KEYS
    assert row["variant"] == name and row["epochs"] == 1
    assert row["best_epoch"] == 0
    for key in ("best_val_hap_f1", "final_val_hap_f1", "final_val_rare_f1"):
        assert 0.0 <= row[key] <= 1.0, key
    assert math.isfinite(row["final_train_loss"]) and row["wall_min"] >= 0
    assert json.loads(json.dumps(row)) == row
    assert (tmp_path / name / "metrics.csv").exists()


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_compat.main(["--epochs", "1"])
    assert isinstance(ab_compat.build_parser().parse_args([]),
                      argparse.Namespace)
