"""Persisted per-window embedding indexes: ``Imputer.save_window_indexes``
writes the JAX package's files, ``Imputer(index_dir=...)`` serves them, and
either package's files serve the other.

Tolerances: the two packages' float32 embeddings differ by summation order
(~1e-6 relative), then each is rounded to bf16 once: stored vectors agree
to one bf16 step (2^-7 relative, 1e-6 absolute), norms to 1e-5 relative;
the imputed probabilities of the same loaded context agree to 1e-5 (the
serving tests' tolerance).  A context loaded from the port's own files is
bit for bit the encoded one, so its probabilities are equal.
"""

import json
import os

import numpy as np
import pytest

from rag_snvbert_tpu.infer.imputer import Imputer as JImputer
from rag_snvbert_tpu_torch.index import FlatL2Index
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from test_torch_serve import KW, TOL, _drop, setup  # noqa: F401  (fixture)
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def written(setup, tmp_path_factory):
    s = setup
    root = tmp_path_factory.mktemp("indexes")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jman = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                    s["jb"].freq, use_pallas=False, **KW
                    ).save_window_indexes(jdir, _drop(s["jb"].train,
                                                      s["keep"]))
    tman = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu", **KW
                   ).save_window_indexes(tdir, _drop(s["tb"].train,
                                                     s["keep"]))
    return dict(jdir=jdir, tdir=tdir, jman=jman, tman=tman)


def test_manifest_and_files_match_jax(written):
    w = written
    assert w["tman"] == w["jman"]
    with open(os.path.join(w["tdir"], "manifest.json")) as f:
        assert json.load(f) == w["jman"]
    assert sorted(os.listdir(w["tdir"])) == sorted(os.listdir(w["jdir"]))
    for i in range(w["jman"]["windows"]):
        zj = np.load(os.path.join(w["jdir"], f"index_{i}.npz"))
        zt = np.load(os.path.join(w["tdir"], f"index_{i}.npz"))
        assert sorted(zt.files) == sorted(zj.files)
        for key in ("dtype", "n_real", "d_real", "pack"):
            assert zt[key] == zj[key], key
        assert str(zt["dtype"]) == "bfloat16"
        assert zt["vectors"].dtype == zj["vectors"].dtype == np.float32
        np.testing.assert_allclose(zt["vectors"], zj["vectors"],
                                   rtol=2 ** -7, atol=1e-6)
        fin = np.isfinite(zj["norms"])
        np.testing.assert_array_equal(np.isfinite(zt["norms"]), fin)
        np.testing.assert_allclose(zt["norms"][fin], zj["norms"][fin],
                                   rtol=1e-5)


def test_index_dir_serves_exactly_what_encoding_serves(setup, written):
    s = setup
    target = _drop(s["tb"].train, s["keep"])
    enc = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                  **KW).impute(target)
    imp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                  index_dir=written["tdir"], **KW)
    ctx = imp._window_ctx(*imp.windows[0], ~s["keep"][:imp.windows[0][1]], 0)
    assert ctx.ref_emb_search.shape == (KW["ref_pad_haps"], KW["seq_len"], 32)
    got = imp.impute(target)
    for f in ("hap1_prob", "hap2_prob", "gt_prob", "imputed_flag", "pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(enc, f),
                                      err_msg=f)


def test_either_packages_files_serve_the_other(setup, written):
    s = setup
    for src in ("jdir", "tdir"):
        jres = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                        s["jb"].freq, use_pallas=False,
                        index_dir=written[src], **KW).impute(
            _drop(s["jb"].train, s["keep"]))
        tres = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                       index_dir=written[src], **KW).impute(
            _drop(s["tb"].train, s["keep"]))
        for f in ("hap1_prob", "hap2_prob", "gt_prob"):
            np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{src} {f}")


def test_loaded_window_index_is_a_flat_index(written):
    idx = FlatL2Index.load(os.path.join(written["tdir"], "index_1"),
                           device="cpu")
    assert idx.vectors.shape == (KW["ref_pad_haps"], written["tman"]["d"])
    assert str(idx.vectors.dtype) == "torch.bfloat16"
    assert np.isinf(idx.norms.numpy()[48:]).all()


def test_index_dir_paths_that_do_not_exist_raise(setup, written, tmp_path):
    s = setup
    with pytest.raises(ValueError, match="embedding-space RAG"):
        Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                rag_mode="token", index_dir=written["tdir"], **KW)
    imp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                  index_dir=written["tdir"], **KW)
    with pytest.raises(ValueError, match="without index_dir"):
        imp.save_window_indexes(str(tmp_path / "again"), s["tb"].train)
