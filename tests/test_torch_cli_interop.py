"""The port's ``convert-ckpt``, ``export-ckpt``, ``analyze`` and ``train
--init-from`` verbs on the CPU against the JAX command line on the same
files: a reference state_dict (``fake_state_dict``'s recipe, saved with
``torch.save``) converted by each package and served by its ``infer``;
exports compared key by key; ``analyze`` on the JAX package's round-5 run
directory (read only).

Tolerances: both converted models compute the same float32 graph, so
their probabilities agree to ``TOL``; a VCF prints HDS to three decimals,
so the port's HDS lie within ``HDS_TOL`` of the JAX package's
probabilities; GT is compared away from the 0.5 threshold.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rag_snvbert_tpu.cli.main import main as jmain
from rag_snvbert_tpu.utils.analyze import epoch_summary as j_epoch_summary
from rag_snvbert_tpu_torch.cli.main import main
from rag_snvbert_tpu_torch.interop import export_state_dict
from rag_snvbert_tpu_torch.utils import analyze
from test_torch_cli_serve import _last_json, _model_argv, _train_argv
from test_torch_cli_serve import files  # noqa: F401
from test_torch_interop import fake_state_dict
from test_torch_modules import torch_one_thread  # noqa: F401
from test_torch_serve_surface import TOL, _parse_vcf

HDS_TOL = 5e-4 + TOL
R5 = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                  "convergence_r5")


@pytest.fixture(scope="module")
def ref_ckpt(files):
    """A raw reference state_dict at the files' vocabulary, 1 layer of 32
    dims, saved as torch tensors."""
    sd = fake_state_dict(seed=11, layers=1, dims=32,
                         vocab=files["bundle"].vocab.size)
    path = os.path.join(files["root"], "rag_bert.sd.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    return path, sd


@pytest.fixture(scope="module")
def converted(files, ref_ckpt):
    """The same file through each package's convert-ckpt."""
    out = {}
    for name, fn in (("jax", jmain), ("port", main)):
        d = os.path.join(files["root"], f"conv_{name}")
        fn(["convert-ckpt", "--torch_ckpt", ref_ckpt[0], "--out", d,
            "--attn-heads", "4"])
        out[name] = d
    return out


INFER = ["--seq-len", "64"]


def test_convert_then_infer_matches_jax(files, converted, capsys, tmp_path):
    capsys.readouterr()
    reps = {}
    for name, fn in (("jax", jmain), ("port", main)):
        argv = ["infer", "--target", files["target"], "--output_vcf",
                str(tmp_path / f"{name}.vcf"), "--npy_prefix",
                str(tmp_path / name), *_model_argv(files, converted[name]),
                *INFER]
        if name == "jax":           # the JAX command line has no --device
            argv = argv[:argv.index("--device")] + argv[
                argv.index("--device") + 2:]
        fn(argv)
        reps[name] = _last_json(capsys)
    assert reps["port"] == reps["jax"]
    p = {n: [np.load(str(tmp_path / f"{n}.{h}.npy")) for h in
             ("HAP1", "HAP2", "GT")] for n in ("jax", "port")}
    for a, b in zip(p["jax"], p["port"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    prefix_j, gt_j, nums_j = _parse_vcf(str(tmp_path / "jax.vcf"))
    prefix_t, gt_t, nums_t = _parse_vcf(str(tmp_path / "port.vcf"))
    assert prefix_t == prefix_j
    hap1, hap2 = p["jax"][0], p["jax"][1]
    clear = (np.abs(hap1 - 0.5) > TOL) & (np.abs(hap2 - 0.5) > TOL)
    np.testing.assert_array_equal(gt_t[clear], gt_j[clear])
    # the port's HDS against the JAX package's probabilities
    hds = np.stack([hap1, hap2], -1)
    np.testing.assert_allclose(nums_t[..., :2], hds, rtol=0, atol=HDS_TOL)


def test_convert_ckpt_writes_the_ports_checkpoint(converted, ref_ckpt,
                                                  capsys):
    meta = json.load(open(os.path.join(converted["port"],
                                       "convert_meta.json")))
    jmeta = json.load(open(os.path.join(converted["jax"],
                                        "convert_meta.json")))
    assert meta == jmeta and meta["attn_heads"] == 4
    assert os.path.exists(os.path.join(converted["port"], "state.pt"))
    with pytest.raises(SystemExit, match="--attn-heads"):
        main(["convert-ckpt", "--torch_ckpt", ref_ckpt[0], "--out",
              os.path.join(os.path.dirname(ref_ckpt[0]), "noheads")])


def test_export_ckpt_equals_jax(files, converted, ref_ckpt, capsys):
    outs = {}
    for name, fn in (("jax", jmain), ("port", main)):
        outs[name] = os.path.join(files["root"], f"export_{name}.pt")
        fn(["export-ckpt", "--ckpt", converted[name], "--out", outs[name]])
        assert _last_json(capsys)["keys"] == len(ref_ckpt[1])
    a = torch.load(outs["jax"], weights_only=True)
    b = torch.load(outs["port"], weights_only=True)
    assert sorted(a) == sorted(b) == sorted(ref_ckpt[1])
    for k, v in a.items():
        # the reference's shapes; the JAX export writes the two 0-d
        # res_scale tensors as [1] (np.ascontiguousarray), the port keeps
        # them 0-d, so the values are compared flat
        assert b[k].shape == np.asarray(ref_ckpt[1][k]).shape, k
        assert b[k].dtype == v.dtype and torch.equal(b[k].reshape(v.shape),
                                                     v), k
        if not k.endswith(("num_batches_tracked", "position.pe")):
            np.testing.assert_array_equal(b[k].numpy(), ref_ckpt[1][k])


def test_train_init_from_a_converted_checkpoint(files, converted, ref_ckpt,
                                                capsys, tmp_path):
    """train --init-from: the architecture from convert_meta.json, the
    weights warm-started, a fresh optimizer; the fine-tuned checkpoint
    exports back to the reference's keys."""
    run = str(tmp_path / "run")
    main(_train_argv(files, run, "--seq-len", "64", "--init-from",
                     converted["port"], "--log_freq", "1"))
    assert "best" in _last_json(capsys)
    state = torch.load(os.path.join(run, "ckpt_ep0", "state.pt"),
                       weights_only=True)
    steps = state["step"]
    assert steps > 0 and state["opt_state"]["count"] == steps
    tok = state["params"]["bert.embedding.Embed_0.weight"]
    src = ref_ckpt[1]["bert.embedding.tokenizer.weight"]
    # warm-started: near the converted weights after a few Adam steps
    assert tok.shape == src.shape
    assert 0 < float((tok - torch.from_numpy(src)).abs().max()) < 1e-2
    out = str(tmp_path / "ft.pt")
    main(["export-ckpt", "--ckpt", os.path.join(run, "ckpt_ep0"), "--out",
          out])
    assert set(torch.load(out, weights_only=True)) == set(ref_ckpt[1])


def test_analyze_reads_the_jax_run(capsys):
    """analyze --no-plot on artifacts/convergence_r5 (read only): the
    table's rows hold the JAX package's epoch_summary values (pandas'
    default float parser is within one ulp of Python's)."""
    png = os.stat(os.path.join(R5, "metrics.png")).st_mtime_ns
    want = j_epoch_summary(R5).to_dict("records")
    got = analyze.epoch_summary(R5)
    assert [list(r) for r in got] == [list(r) for r in want]
    for a, b in zip(got, want):
        for k in a:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=2 ** -52,
                                           atol=0, err_msg=k)
            else:
                assert a[k] == b[k] and type(a[k]) is type(b[k]), k
    main(["analyze", "--run_dir", R5, "--no-plot"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:3] == ["epoch", "level", "train_hap_acc"]
    assert len(lines) == 1 + len(want)
    assert lines[5].split()[:2] == ["4", "4"]
    assert f"{want[9]['val_rare_f1']:.6f}" in lines[10]
    assert os.stat(os.path.join(R5, "metrics.png")).st_mtime_ns == png


def test_analyze_plot_and_freq_audit(files, capsys, tmp_path,
                                     monkeypatch):
    pytest.importorskip("matplotlib")
    run = str(tmp_path / "run")
    os.makedirs(run)
    with open(os.path.join(R5, "metrics.csv")) as src, \
            open(os.path.join(run, "metrics.csv"), "w") as dst:
        dst.write(src.read())
    main(["analyze", "--run_dir", run, "--freq_path",
          os.path.join(files["prep"], "freq")])
    out = capsys.readouterr().out
    assert f"plot: {os.path.join(run, 'metrics.png')}" in out
    assert os.path.getsize(os.path.join(run, "metrics.png")) > 0
    audit = json.loads(out[out.index("{"):])
    assert audit["nan_count"] == 0 and audit["gt_layers_sum_to_1"]
    # without matplotlib: the table first, then an error naming it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        main(["analyze", "--run_dir", run])
    assert capsys.readouterr().out.startswith("epoch")


def test_compare_checkpoints_ranks_the_drift(files, converted, capsys,
                                            tmp_path):
    run = str(tmp_path / "run")
    main(_train_argv(files, run, "--seq-len", "64", "--init-from",
                     converted["port"]))
    rows = analyze.compare_checkpoints(converted["port"],
                                       os.path.join(run, "ckpt_ep0"), top=3)
    assert len(rows) == 3
    assert rows[0]["delta_l2"] >= rows[1]["delta_l2"] >= rows[2]["delta_l2"]
    assert all(r["delta_l2"] > 0 and r["rel_change"] > 0 for r in rows)
    same = analyze.compare_checkpoints(converted["port"], converted["port"],
                                       top=0)
    assert same and all(r["delta_l2"] == 0 for r in same)
