"""The cell ``v18_embedding_rag.train`` at tiny sizes on the CPU (the
program's plain versions, float32): the blocked reference
(``reference/blocked.py``) equals the whole-batch one
(``reference/train.py``) to rounding; the program matches the blocked
reference; the control and the faults of ``test_bench_faults.py`` fail
the check of ``drivers/train_blocked.py``; a run ends in the contract's
result line; the float32 attention kernels' roofline readers and bounds.
On the card (``cuda`` marker): a small run through the kernels against
the blocked reference, and the control failing."""

import io
import json
import tempfile
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import flops, flops_f32, harness, program, weights
from benchmark.drivers import train as train_driver
from benchmark.reference import blocked
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref_model
from benchmark.reference import retrieval as ref_retrieval
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import tiny
from benchmark.tests.test_bench_card import SMALL

CELL = "v18_embedding_rag.train"
SEED = 2 ** 31 + 41
# the tiny default (2 heads of 16) and upstream V18's 12 heads, of 4
HEADS = {"2x16": {}, "12x4": {"dims": 48, "attn_heads": 12}}


def _run(cell, tmp, seed=SEED, **extra):
    return harness.Run(harness.Cell.load(cell), seed, 0.3, False, "cpu",
                       str(tmp), tiny(cell, **extra))


def _first_micro_step(run):
    """The reference model with the seed's weights, and the first
    micro-step's batch and window context, as ``drivers/train.py``'s
    check makes them."""
    rc, panel = program.preset(run), train_driver.make_panel(run)
    mb = program.model_block(run)
    model = weights.fill(ref_model.from_config(mb, program.vocab_of(panel)
                                               .size), run.seed)
    L = rc.model.seq_len
    wins = ref_data.Windows(panel, L)
    warm = rc.batch_size * int(run.param("steps_per_dispatch"))
    w, ids = ref_data.epoch_order(len(panel.window_info), warm,
                                  rc.batch_size, epoch=0)[0]
    batch = wins.train_batch(w, ids, level=0, seed=0)
    toks, valid = wins.ref_tokens(w, int(run.param("ref_pad_haps")))
    toks, valid = torch.as_tensor(toks), torch.as_tensor(valid)
    wmask = torch.as_tensor(batch["window_mask"])
    if mb["rag_mode"] == "token":
        ctx = (toks, wmask, valid)
    else:
        af = torch.as_tensor(ref_data.pad(wins.af(w), L)).float()
        ctx = ref_retrieval.embedding_context(model, toks, wmask, af, valid)
    return model, batch, ctx, mb["rag_mode"]


@pytest.mark.parametrize("keep_rows", [None, [0, 1]], ids=["whole", "half"])
@pytest.mark.parametrize("cell", [CELL, "v17_token_rag.train"])
def test_blocked_step_is_the_whole_batch_step(cell, keep_rows, tmp_path):
    run = _run(cell, tmp_path)
    model, batch, ctx, mode = _first_micro_step(run)
    (la, ga), (lb, gb) = (
        step_fn(model, batch, ctx, run.seed, 3, mode, "cpu", keep_rows)
        for step_fn in (ref_train.micro_step, blocked.micro_step))
    # the same products and draws; the blocks' recompute repeats the
    # forward's float32 arithmetic, so only summation order can differ
    assert abs(la - lb) <= 1e-6 * abs(la)
    assert ga.keys() == gb.keys()
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=1e-5, atol=1e-7)
    assert any(g.abs().max() > 0 for g in gb.values())


@pytest.mark.parametrize("heads", list(HEADS))
def test_program_matches_the_blocked_reference(heads, tmp_path):
    run = _run(CELL, tmp_path, **HEADS[heads])
    drv = harness.load_module("drivers", "train_blocked")
    state = drv.setup(run)
    checks = {c["name"]: c["value"] for c in drv.check(run, state)}
    assert checks["loss"] < 1e-5
    assert checks["grad"] < 1e-4
    assert checks["update"] < 1e-3


def _checks(**extra):
    res = harness.run_cell(harness.Cell.load(CELL), SEED, 0.3, False, "cpu",
                           0.0, tiny(CELL, **extra))
    return res["correct"], res["checks"]


def test_sound_run_is_correct():
    ok, checks = _checks()
    assert ok, checks


def test_control_fails():
    """The reference in TF32 in the program's place, against the cell's
    limits."""
    c = harness.Cell.load(CELL)
    drv = harness.load_module("drivers", c.driver)
    with tempfile.TemporaryDirectory() as tmp:
        run = harness.Run(c, SEED + 2, 0.3, False, "cpu", tmp, tiny(CELL))
        out = drv.calibrate(run, drv.setup(run), "tf32", True)
    limits = c.spec["limits"]
    assert any(out["control"][k] > limits[k] for k in limits), out
    assert any(out["half_batch"][k] > limits[k] for k in limits), out


def test_unchanged_state_fails(monkeypatch):
    from rag_snvbert_tpu_torch.train import schedule

    monkeypatch.setattr(schedule.Optimizer, "apply",
                        lambda self, n, row: None)
    ok, checks = _checks()
    assert not ok, checks


def test_half_batch_fails(monkeypatch):
    """Half of each batch left out, the loss the mean over the rest (its
    sum scaled to the whole batch)."""
    from rag_snvbert_tpu_torch.train import losses, step

    total = losses.total_loss

    def half(outputs, labels, mask, *a, **kw):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1
        loss, aux = total(outputs, labels, mask * keep, *a, **kw)
        return loss * 2.0, aux

    monkeypatch.setattr(step.losses, "total_loss", half)
    ok, checks = _checks()
    assert not ok, checks


def test_the_check_leaves_the_whole_batch_reference_in_place(tmp_path):
    run = _run(CELL, tmp_path)
    drv = harness.load_module("drivers", "train_blocked")
    whole = ref_train.micro_step
    drv.check(run, drv.setup(run))
    assert ref_train.micro_step is whole


@pytest.mark.parametrize("trace", [0, 1])
def test_driver_result_line(trace):
    c = harness.Cell.load(CELL)
    res = harness.run_cell(c, SEED + 4, 0.5, bool(trace), "cpu", 0.0,
                           tiny(CELL))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(res)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(c.spec["limits"])
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    if trace:
        # the CPU runs the plain versions: no kernel to read
        assert set(line["metrics"]) <= set(c.spec["per_layer"])
        assert "attention_f32_fwd_roofline.train" not in line["metrics"]
    else:
        assert set(line["metrics"]) == set(c.spec["end_to_end"])


def _reading(events, batch=24, seq_len=1030, trace=True):
    from benchmark.trace import Trace

    cell = harness.Cell.load(CELL)
    return harness.Reading({"batch_size": batch, "seq_len": seq_len,
                            "micro_steps": 1}, 1.0, cell.config,
                           cell.traffic,
                           Trace.from_events(events) if trace else None)


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"void {name}<32, true>(int)",
            "ts": ts, "dur": dur}


def test_roofline_readers():
    fwd = harness.load_module("metrics", "attention_f32_fwd_roofline.train")
    bwd = harness.load_module("metrics", "attention_f32_bwd_roofline.train")
    assert fwd.UNIT == bwd.UNIT == "%"
    events = [_kernel("attn_f32_pack_kernel", 0, 500),
              _kernel("attn_f32_fwd_kernel", 500, 2500),
              _kernel("attn_f32_pack_kernel", 3000, 500),
              _kernel("attn_f32_fwd_kernel", 3500, 2500),
              _kernel("attn_f32_dsum_kernel", 6000, 100),
              _kernel("attn_f32_bwd_dkv_kernel", 6100, 4000),
              _kernel("attn_f32_bwd_dq_kernel", 10100, 3900)]
    r = _reading(events)
    b_fwd = flops_f32.attention_f32_fwd_bound_s(48, 12, 1030, 32, True)
    b_bwd = flops_f32.attention_f32_bwd_bound_s(48, 12, 1030, 32, True)
    assert fwd.read(r) == pytest.approx(100 * 2 * b_fwd / 6000e-6)
    assert bwd.read(r) == pytest.approx(100 * b_bwd / 8000e-6)
    # nothing to read: no trace, or no kernel (the einsum path)
    assert fwd.read(_reading(events, trace=False)) is None
    other = [_kernel("attention_fwd_kernel", 0, 100)]
    assert fwd.read(_reading(other)) is None
    assert bwd.read(_reading(other)) is None


def test_bounds_at_the_training_shape():
    # operations bound both halves at 12 heads of 32 (about a tenth of the
    # time is bytes): 4 and 10 S H L^2 hd at 67 TFLOP/s
    ops = 48 * 12 * 1030 ** 2 * 32
    assert flops_f32.attention_f32_fwd_bound_s(48, 12, 1030, 32, True) == \
        pytest.approx(4 * ops / flops.PEAK_FLOP_PER_S["fp32"])
    assert flops_f32.attention_f32_bwd_bound_s(48, 12, 1030, 32, True) == \
        pytest.approx(10 * ops / flops.PEAK_FLOP_PER_S["fp32"])
    # a short sequence is bound by bytes, the mask's bits among them
    rows = 2 * 12 * 8
    want = (4 * 4 * rows * 32 + 4 * rows + rows * 8 / 8) \
        / flops.HBM_BYTES_PER_S
    assert flops_f32.attention_f32_fwd_bound_s(2, 12, 8, 32, True) == \
        pytest.approx(want)
    assert flops_f32.attention_f32_fwd_bound_s(2, 12, 8, 32, False) < want


def test_configuration_is_the_published_v18():
    cfg = harness.Cell.load(CELL).config
    from rag_snvbert_tpu_torch.config import get_preset

    rc = get_preset(cfg["preset"])
    m = rc.model
    assert (m.dims, m.n_layers, m.attn_heads, m.pre_ln, m.bf16) == \
        (384, 12, 12, False, False)
    assert (rc.batch_size, rc.grad_accum_steps, rc.rag_k) == (24, 2, 1)
    assert cfg["model"]["attn_dropout"] == 0.1 and cfg["peak"] == "fp32"
    traffic = harness.Cell.load(CELL).traffic
    plain = harness.load_json("traffic", "train_epochs")
    assert {k: v for k, v in traffic.items() if k != "driver"} == \
        {k: v for k, v in plain.items() if k != "driver"}


@pytest.mark.cuda
def test_cell_on_card(cuda_device):
    res = harness.run_cell(harness.Cell.load(CELL), SEED + 6, 2.0, True,
                           cuda_device, 0.0, SMALL)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "attention_f32_fwd_roofline.train" in res["metrics"]
    assert "attention_f32_bwd_roofline.train" in res["metrics"]
    assert res["metrics"]["attention_f32_bwd_roofline.train"]["value"] <= 100


@pytest.mark.cuda
def test_control_on_card(cuda_device, tmp_path):
    c = harness.Cell.load(CELL)
    drv = harness.load_module("drivers", c.driver)
    run = harness.Run(c, SEED + 8, 1.0, False, cuda_device, str(tmp_path),
                      SMALL)
    out = drv.calibrate(run, drv.setup(run), "tf32", False)
    limits = c.spec["limits"]
    assert any(out["control"][k] > limits[k] for k in limits), out

