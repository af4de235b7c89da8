"""The port's verbs over several CPU ranks (gloo; the verb starts its own
local ranks): ``query --index-shards 2`` gives the single-process query's
results and the JAX command line's ``--index-shards 2`` results, ``train
--data-parallel 2 --index-shards 2 --dist-backend gloo`` and ``train
--tensor-parallel 2`` of a 3-head model the single-process run's losses
and weights, and ``infer``/``serve --data-parallel 2`` the
single-process probabilities; ``tools/mesh_check.py`` passes under
torchrun.  Each multi-rank run is a subprocess, so a failing rank cannot
take the test process with it.

Tolerances: genotype distances are exact integers, so query results are
equal; training as in tests/test_torch_mesh_trainer.py (loss relative
1e-3, weights rtol 2e-3 / atol 2e-4); probabilities within 1e-5 (float32
on both sides, rows batched differently).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.cli.main import main
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.io.vcf import write_simple_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--dims", "32", "--layers", "1", "--attn-heads", "4",
         "--seq-len", "64"]
TOL = 1e-5


def _run(argv, stdin=None):
    """The verb in a fresh process (the multi-rank runs)."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "rag_snvbert_tpu_torch.cli.main", *argv],
        cwd=REPO, env=env, input=stdin, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    b = make_bundle(n_train_samples=8, n_ref_samples=10, n_sites=80,
                    n_windows=2, seed=5)
    root = tmp_path_factory.mktemp("cli_mesh")
    f = {k: str(root / v) for k, v in (
        ("ref", "ref.vcf"), ("train", "train.vcf"), ("panel", "train.panel"),
        ("prep", "prep"), ("target", "target.vcf"), ("db", "db"))}
    write_simple_vcf(f["ref"], b.ref)
    write_simple_vcf(f["train"], b.train)
    with open(f["panel"], "w") as fh:
        fh.write("sample\tpop\n")
        for s, pop in zip(b.panel.samples, b.panel.pop_list):
            fh.write(f"{s}\t{pop}\n")
    keep = np.random.default_rng(4).random(b.train.n_variants) > 0.4
    t = b.train
    write_simple_vcf(f["target"], dataclasses.replace(
        t, gt=t.gt[keep], pos=t.pos[keep], chrom=t.chrom[keep],
        ref=t.ref[keep], alt=t.alt[keep], ids=t.ids[keep]))
    main(["prepare-data", "--vcf", f["train"], "--panel", f["panel"],
          "--out", f["prep"], "--window-len", "40"])
    main(["build-index", "--vcf", f["ref"], "--out", f["db"],
          "--window-len", "40", "--dtype", "int8", "--device", "cpu"])
    return dict(f, root=str(root), bundle=b)


def _results(d, windows=2):
    return [(np.load(os.path.join(d, f"window_{w}_ids.npy")),
             np.load(os.path.join(d, f"window_{w}_vals.npy")))
            for w in range(windows)]


@pytest.mark.parametrize("mode", ["flat", "intersect"])
def test_query_index_shards_matches_single_and_jax(files, mode):
    from rag_snvbert_tpu.cli.main import main as jmain

    res = {}
    for name, extra in (("single", []), ("sharded", ["--index-shards", "2"])):
        res[name] = os.path.join(files["root"], f"q_{mode}_{name}")
        argv = ["query", "--vcf", files["target"], "--db", files["db"],
                "--k", "7", "--mode", mode, "--save-results", res[name],
                "--device", "cpu", *extra]
        if extra:
            out = _run(argv)
            assert "backend=gloo" in out.stderr
        else:
            main(argv)
    res["jax"] = os.path.join(files["root"], f"q_{mode}_jax")
    jmain(["query", "--vcf", files["target"], "--db", files["db"], "--k", "7",
           "--mode", mode, "--save-results", res["jax"],
           "--index-shards", "2"])
    for other in ("single", "jax"):
        for (i, v), (wi, wv) in zip(_results(res["sharded"]),
                                    _results(res[other])):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_array_equal(v, wv)


def _train_argv(f, out, *extra, model=MODEL):
    return ["train", "--train_dataset", f["train"], "--train_panel",
            f["panel"], "--refpanel_path", f["ref"],
            "--freq_path", os.path.join(f["prep"], "freq"),
            "--window_path", os.path.join(f["prep"], "windows.csv"),
            "--output_path", out, "--epochs", "1",
            "--train_batch_size", "4", "--val_batch_size", "4",
            "--warmup_steps", "5", "--grad_accum_steps", "1",
            "--device", "cpu", *model, *extra]


@pytest.fixture(scope="module")
def trained(files):
    runs = {"single": os.path.join(files["root"], "train_single"),
            "mesh": os.path.join(files["root"], "train_mesh")}
    main(_train_argv(files, runs["single"]))
    _run(_train_argv(files, runs["mesh"], "--data-parallel", "2",
                     "--index-shards", "2", "--dist-backend", "gloo"))
    return runs


def _assert_same_training(runs):
    """The mesh run's first-epoch loss and checkpointed weights against the
    single-process run's."""
    import csv

    rows = {k: list(csv.DictReader(open(os.path.join(v, "metrics.csv"))))
            for k, v in runs.items()}
    a, b = (float(rows[k][0]["train_loss"]) for k in ("mesh", "single"))
    assert abs(a - b) / max(abs(b), 1.0) < 1e-3
    sd = {k: torch.load(os.path.join(v, "ckpt_ep0", "state.pt"),
                        weights_only=True)["params"]
          for k, v in runs.items()}
    for name, want in sd["single"].items():
        np.testing.assert_allclose(sd["mesh"][name].numpy(), want.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_train_data_parallel_index_shards_matches_single(trained):
    _assert_same_training(trained)


def test_train_tensor_parallel_splits_a_head(files):
    """``train --tensor-parallel 2`` of a 3-head model (dims 48): each
    rank's 24 columns split head 1, as the JAX command line runs it."""
    model = ["--dims", "48", "--layers", "1", "--attn-heads", "3",
             "--seq-len", "64"]
    runs = {k: os.path.join(files["root"], f"train_tp2_{k}")
            for k in ("single", "mesh")}
    main(_train_argv(files, runs["single"], model=model))
    out = _run(_train_argv(files, runs["mesh"], "--tensor-parallel", "2",
                           "--dist-backend", "gloo", model=model))
    assert "model=2" in out.stderr
    _assert_same_training(runs)


def _model_argv(f, model_path, *extra):
    return ["--refpanel_path", f["ref"],
            "--freq_path", os.path.join(f["prep"], "freq"),
            "--model_path", model_path, "--panel", f["panel"],
            "--infer_window_len", "40", "--batch_size", "4",
            "--device", "cpu", *MODEL, *extra]


def test_infer_and_serve_data_parallel_match_single(files, trained):
    ckpt = os.path.join(trained["single"], "ckpt_ep0")
    pre = {k: os.path.join(files["root"], f"infer_{k}")
           for k in ("single", "mesh", "served")}
    main(["infer", "--target", files["target"], "--output_vcf",
          pre["single"] + ".vcf", "--npy_prefix", pre["single"],
          *_model_argv(files, ckpt)])
    out = _run(["infer", "--target", files["target"], "--output_vcf",
                pre["mesh"] + ".vcf", "--npy_prefix", pre["mesh"],
                *_model_argv(files, ckpt, "--data-parallel", "2")])
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["samples"] == files["bundle"].train.n_samples
    req = {"target": files["target"], "npy_prefix": pre["served"],
           "output_vcf": pre["served"] + ".vcf"}
    out = _run(["serve", *_model_argv(files, ckpt, "--data-parallel", "2")],
               stdin=json.dumps(req) + "\n")
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert lines[0]["ready"] and lines[1]["ok"] and len(lines) == 2
    for key in ("HAP1", "HAP2", "GT"):
        want = np.load(f"{pre['single']}.{key}.npy")
        for k in ("mesh", "served"):
            np.testing.assert_allclose(np.load(f"{pre[k]}.{key}.npy"), want,
                                       rtol=TOL, atol=TOL, err_msg=k + key)


def test_mesh_check_under_torchrun(tmp_path):
    """``tools/mesh_check.py`` (the multi-card check) as torchrun starts it,
    four gloo ranks at its small size: its training (dp2 x idx2; dp2 x
    tp2, where each rank's columns split a head, in bf16 and with
    ``int8_matmuls``) and index parts agree with one process, and its
    controls (without the gradient sum; without a split head's gradient
    sum) fail the training checks."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m",
         "rag_snvbert_tpu_torch.tools.mesh_check", "--device", "cpu",
         "--small", "--out", str(tmp_path / "runs")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["world"] == 4 and report["failures"] == []
    train = report["train"]
    assert train["loss_rel"] <= 1e-3 and train["norm_rel"] <= 1e-3
    assert train["delta_rel"] <= 0.05 and len(train["norm_rels"]) == 4
    control = train["control_without_gradient_sum"]
    assert control["norm_rel"] > 0.1 and control["delta_rel"] > 0.05
    tp = report["tp"]
    assert tp["mesh"] == "2x1x2" and [h[0] for h in tp["heads"]] == [2] * 4
    assert tp["loss_rel"] <= 1e-3 and tp["delta_rel"] <= tp["tol"]["delta"]
    assert tp["int8"]["loss_rel"] <= 1e-3
    assert tp["control_split_head_without_sum"]["delta_rel"] \
        > tp["tol"]["delta"]
    assert set(report["index"]) >= {"packed", "int8", "bf16", "f32"}
