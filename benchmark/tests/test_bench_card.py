"""On the card (``cuda`` marker; skipped without one): a small training
run and imputation through the kernels, against the reference, and the
control failing.  ``python -m pytest benchmark/tests -m cuda -q``."""

import pytest

from benchmark import harness

SMALL = {"n_layers": 2, "sites_per_window": 126, "n_windows": 2,
         "n_ref_samples": 200, "ref_pad_haps": 512, "samples_per_window": 96,
         "cohort_samples": 64, "check_samples": 8, "seq_len": 1030,
         "trace_seconds": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tpu_default.train", "tpu_default.impute",
                                  "v17_token_rag.train"])
def test_cell_on_card(cell, cuda_device):
    c = harness.Cell.load(cell)
    res = harness.run_cell(c, 2 ** 31 + 31, 2.0, True, cuda_device, 0.0,
                           SMALL)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [("tpu_default.train", "fp8"),
                                          ("tpu_default.impute", "fp8"),
                                          ("v17_token_rag.train", "tf32")])
def test_control_on_card(cell, control, cuda_device, tmp_path):
    c = harness.Cell.load(cell)
    drv = harness.load_module("drivers", c.driver)
    run = harness.Run(c, 2 ** 31 + 33, 1.0, False, cuda_device,
                      str(tmp_path), SMALL)
    out = drv.calibrate(run, drv.setup(run), control, False)
    limits = c.spec["limits"]
    assert any(out["control"][k] > limits[k] for k in limits), out
