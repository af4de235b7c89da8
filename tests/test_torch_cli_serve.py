"""The port's ``train``, ``infer``, ``serve`` and ``emit-vcf`` verbs on the
CPU (``--device cpu``), with the JAX command line's flags
(``tests/test_io_and_cli.py::test_cli_train_then_infer``), against the JAX
package's ``Imputer`` on the same flax weights, and the flags that wait
for a module not ported yet.

Tolerances: float32 models on both sides differ only in summation order,
so probabilities agree to ``TOL``; a VCF float is printed to three
decimals, so fields of values within ``TOL`` may differ by one unit of the
third decimal (``VCF_TOL``); GT is compared away from the 0.5 threshold.
"""

import dataclasses
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.infer.imputer import Imputer as JImputer
from rag_snvbert_tpu.io import vcf as jvcf
from rag_snvbert_tpu.io.freq import FreqTable as JFreqTable
from rag_snvbert_tpu.models import BERTFoundationModel as JFoundation
from rag_snvbert_tpu.models import BERTWithEmbeddingRAG as JRAG
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu_torch.cli.main import main
from rag_snvbert_tpu_torch.config import ModelConfig, RunConfig, build_model
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.io.vcf import read_vcf, write_simple_vcf
from test_torch_modules import _perturb, torch_one_thread  # noqa: F401
from test_torch_serve_surface import TOL, assert_vcfs_match

MODEL = ["--dims", "32", "--layers", "1", "--attn-heads", "4",
         "--seq-len", "64"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference and training VCFs, a panel, prepare-data's outputs, and a
    target that lacks 40% of the sites."""
    b = make_bundle(n_train_samples=6, n_ref_samples=10, n_sites=80,
                    n_windows=2)
    root = tmp_path_factory.mktemp("cli")
    f = {k: str(root / v) for k, v in (
        ("ref", "ref.vcf"), ("train", "train.vcf"), ("panel", "train.panel"),
        ("prep", "prep"), ("target", "target.vcf"), ("root", ""))}
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
          "--out", f["prep"], "--window-len", "40",
          "--split-test-fraction", "0.25"])
    return dict(f, bundle=b, keep=keep)


def _train_argv(f, out, *extra):
    return ["train", "--train_dataset", f["train"], "--train_panel",
            f["panel"], "--refpanel_path", f["ref"],
            "--freq_path", os.path.join(f["prep"], "freq"),
            "--window_path", os.path.join(f["prep"], "windows.csv"),
            "--output_path", out, "--epochs", "1",
            "--train_batch_size", "4", "--val_batch_size", "4",
            "--warmup_steps", "5", "--grad_accum_steps", "1",
            "--device", "cpu", *extra]


def _model_argv(f, model_path, *extra):
    return ["--refpanel_path", f["ref"],
            "--freq_path", os.path.join(f["prep"], "freq"),
            "--model_path", model_path, "--panel", f["panel"],
            "--infer_window_len", "40", "--batch_size", "4",
            "--device", "cpu", *extra]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(files):
    """One epoch of ``train`` with the JAX test's flags."""
    run = os.path.join(files["root"], "run")
    main(_train_argv(files, run, *MODEL, "--train-samples",
                     os.path.join(files["prep"], "train_samples.npy"),
                     "--val-samples",
                     os.path.join(files["prep"], "test_samples.npy")))
    return run


def test_train_then_infer_then_emit_vcf(files, trained, capsys, tmp_path):
    ckpt = os.path.join(trained, "ckpt_ep0")
    assert os.path.exists(os.path.join(ckpt, "state.pt"))
    assert os.path.exists(os.path.join(trained, "metrics.csv"))
    out_vcf, prefix = str(tmp_path / "imputed.vcf"), str(tmp_path / "imp")
    main(["infer", "--target", files["target"], "--output_vcf", out_vcf,
          "--npy_prefix", prefix, *_model_argv(files, ckpt, *MODEL)])
    stats = _last_json(capsys)
    b, keep = files["bundle"], files["keep"]
    assert stats == {"sites": b.ref.n_variants, "samples": b.train.n_samples,
                     "imputed_sites": int((~keep).sum())}
    # known sites keep the target's alleles; IMPUTED marks the others
    back = read_vcf(out_vcf)
    np.testing.assert_array_equal(back.gt[keep], b.train.gt[keep])
    info = [line.split("\t")[7] for line in open(out_vcf)
            if not line.startswith("#")]
    assert info == ["IMPUTED" if m else "." for m in ~keep]
    emitted = str(tmp_path / "emitted.vcf")
    main(["emit-vcf", "--npy_prefix", prefix, "--refpanel_path", files["ref"],
          "--output_vcf", emitted, "--samples", ",".join(b.train.samples)])
    assert _last_json(capsys) == {"sites": b.ref.n_variants,
                                  "samples": b.train.n_samples}
    assert open(emitted, "rb").read() == open(out_vcf, "rb").read()


def test_infer_matches_the_jax_imputer_on_the_same_weights(files, capsys,
                                                           tmp_path):
    """A port checkpoint holding a JAX model's (perturbed) flax weights:
    ``infer`` gives the JAX ``Imputer``'s probabilities and VCF."""
    b = files["bundle"]
    jm = JFoundation(bert=JRAG(vocab_size=b.vocab.size, dims=32, n_layers=1,
                               attn_heads=4))
    params = _perturb(jax.jit(jm.init)(jax.random.key(0),
                                       init_batch(1, 64, 32))["params"])

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    jref = jvcf.read_vcf(files["ref"], use_native=False)
    jtgt = jvcf.read_vcf(files["target"], use_native=False)
    jres = JImputer(jm, embed_fn, params, jref,
                    JFreqTable.load(os.path.join(files["prep"], "freq")),
                    window_len=40, seq_len=64, batch_size=4,
                    use_pallas=False).impute(jtgt)
    jres.write_vcf(str(tmp_path / "jax.vcf"), jref, jtgt.samples)

    tm = build_model(RunConfig(model=ModelConfig(dims=32, n_layers=1,
                                                 attn_heads=4)),
                     b.vocab.size, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"params": tm.state_dict()}, ckpt / "state.pt")
    main(["infer", "--target", files["target"],
          "--output_vcf", str(tmp_path / "port.vcf"),
          "--npy_prefix", str(tmp_path / "port"),
          *_model_argv(files, str(ckpt), *MODEL)])
    capsys.readouterr()
    for f, want in (("HAP1", jres.hap1_prob), ("HAP2", jres.hap2_prob),
                    ("GT", jres.gt_prob)):
        np.testing.assert_allclose(np.load(tmp_path / f"port.{f}.npy"), want,
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(np.load(tmp_path / "port.POS_Flag.npy"),
                                  jres.imputed_flag)
    assert_vcfs_match(tmp_path / "port.vcf", tmp_path / "jax.vcf",
                      jres.hap1_prob, jres.hap2_prob)


def test_serve_answers_json_lines(files, trained, capsys, monkeypatch,
                                  tmp_path):
    ckpt = os.path.join(trained, "ckpt_ep0")
    main(["infer", "--target", files["target"],
          "--output_vcf", str(tmp_path / "infer.vcf"),
          *_model_argv(files, ckpt, *MODEL)])
    capsys.readouterr()
    reqs = [{"target": files["target"],
             "output_vcf": str(tmp_path / "served.vcf")},
            {"target": files["target"],
             "output_vcf": str(tmp_path / "served2.vcf.gz"),
             "progressive_rounds": 2}]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)))
    main(["serve", *_model_argv(files, ckpt, *MODEL)])
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.strip().splitlines()]
    assert lines[0] == {"ready": True,
                        "ref_sites": files["bundle"].ref.n_variants}
    assert [r["ok"] for r in lines[1:]] == [True, True]
    assert all(r["seconds"] >= 0 for r in lines[1:])
    tail = json.loads(err.strip().splitlines()[-1])
    assert tail["served"] == 2
    assert not any(tail["launches"].values())      # the CPU: plain versions
    assert (tmp_path / "served.vcf").read_bytes() == \
        (tmp_path / "infer.vcf").read_bytes()
    assert read_vcf(str(tmp_path / "served2.vcf.gz")).n_variants == \
        files["bundle"].ref.n_variants


def test_no_rag_preset_trains_and_infers(files, capsys, tmp_path):
    """A11 through the verbs: ``v10_baseline`` (rag_mode "none", the
    reconstruction loss, gamma 5)."""
    run = str(tmp_path / "run")
    main(_train_argv(files, run, "--preset", "v10_baseline", "--seq-len",
                     "64"))
    assert "best" in _last_json(capsys)
    out = str(tmp_path / "none.vcf")
    main(["infer", "--target", files["target"], "--output_vcf", out,
          "--preset", "v10_baseline", "--seq-len", "64",
          *_model_argv(files, os.path.join(run, "ckpt_ep0"))])
    assert _last_json(capsys)["imputed_sites"] == int((~files["keep"]).sum())
    assert read_vcf(out).n_variants == files["bundle"].ref.n_variants


def _orbax(tmp_path):
    d = tmp_path / "orbax"
    d.mkdir()
    return str(d)


# Numbered as the cases were before --init-from, --profile-dir and
# converted checkpoints were ported (cases 0, 5, 8 and 9), so each case
# keeps its id.  An orbax checkpoint of the JAX package stays refused: its
# message names the route through the JAX package's export-ckpt.  The A7
# cases (the mesh flags) are ported: each now starts a world of local
# ranks (gloo, since --device cpu), recorded here instead of run (the
# mesh runs themselves are tests/test_torch_cli_mesh.py's); --shard-ctx on
# without an index axis raises as the JAX trainer's assertion does.
REFUSED = [
    (1, "train", ["--data-parallel", "2"], "A7"),
    (2, "train", ["--index-shards", "2"], "A7"),
    (3, "train", ["--tensor-parallel", "2"], "A7"),
    (4, "train", ["--shard-ctx", "on"], "A7"),
    (6, "infer", ["--data-parallel", "2"], "A7"),
    (7, "serve", ["--data-parallel", "2"], "A7"),
    (10, "infer", _orbax, "A9"),
]


@pytest.mark.parametrize("verb,extra,item", [r[1:] for r in REFUSED],
                         ids=[f"{v}-{i}-{n}" for n, v, _, i in REFUSED])
def test_flags_not_ported_name_their_roadmap_item(files, tmp_path, verb,
                                                  extra, item, monkeypatch):
    if verb == "train":
        argv = _train_argv(files, str(tmp_path / "run"), *extra)
    else:
        model_path = extra(tmp_path) if callable(extra) else "unused"
        argv = [verb, *(["--target", files["target"], "--output_vcf",
                         str(tmp_path / "x.vcf")] if verb == "infer" else []),
                *_model_argv(files, model_path,
                             *(() if callable(extra) else extra))]
    if item == "A7":
        from rag_snvbert_tpu_torch.parallel import launch

        started = []
        monkeypatch.setattr(launch, "run_with_local_ranks",
                            lambda fn, world, args, backend:
                            started.append((world, backend, args)))
        if "--shard-ctx" in extra:
            with pytest.raises(ValueError, match="shard_ctx requires a mesh"):
                main(argv)
            assert not started
        else:
            main(argv)
            assert started == [(2, "gloo", (argv,))]
        assert not os.path.exists(tmp_path / "x.vcf")
        return
    with pytest.raises(SystemExit, match=f"Queue A, item {item}\\)"):
        main(argv)
    if callable(extra):           # the orbax case names its route
        with pytest.raises(SystemExit, match="export-ckpt, then convert"):
            main(argv)
    assert not os.path.exists(tmp_path / "x.vcf")


def test_serve_http_needs_a_port(files, tmp_path):
    with pytest.raises(SystemExit, match="HOST:"):
        main(["serve", "--http", "localhost:http",
              *_model_argv(files, str(tmp_path))])


def test_verbs_run_on_the_card_unless_told_otherwise(files, trained,
                                                     monkeypatch, tmp_path):
    def without_device(argv):
        i = argv.index("--device")
        return argv[:i] + argv[i + 2:]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (
            _train_argv(files, str(tmp_path / "run"), *MODEL),
            ["infer", "--target", files["target"], "--output_vcf",
             str(tmp_path / "x.vcf"),
             *_model_argv(files, os.path.join(trained, "ckpt_ep0"), *MODEL)],
            ["serve", *_model_argv(files, os.path.join(trained, "ckpt_ep0"),
                                   *MODEL)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(without_device(argv))
    assert not os.path.exists(tmp_path / "run")
