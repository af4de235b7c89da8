"""The port's serving path against the JAX package on a small synthetic
panel: same weights (``load_flax_params``), same probabilities, same
retrieved ids, the same ``make_bundle`` arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.infer.imputer import Imputer as JImputer
from rag_snvbert_tpu.io.synthetic import make_bundle as jmake_bundle
from rag_snvbert_tpu.models import BERTFoundationModel as JFoundation
from rag_snvbert_tpu.models import BERTWithEmbeddingRAG as JRAG
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu.train.retrieval import _search as jsearch
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.infer.serve import ImputationService
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.models import (BERTFoundationModel,
                                          BERTWithEmbeddingRAG)
from rag_snvbert_tpu_torch.train.retrieval import search
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

DIMS, SEQ = 32, 96
KW = dict(window_len=SEQ - 10, seq_len=SEQ, ref_pad_haps=64, batch_size=8)
# float32 models on both sides; the frameworks differ only in summation
# order (observed 3e-7 on probabilities)
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_train_samples=8, n_ref_samples=24, n_sites=120, n_windows=2,
              seed=3)
    jb, tb = jmake_bundle(**kw), make_bundle(**kw)
    jm = JFoundation(bert=JRAG(vocab_size=jb.vocab.size, dims=DIMS,
                               n_layers=2, attn_heads=4))
    params = jax.jit(jm.init)(jax.random.key(0),
                              init_batch(1, SEQ, DIMS))["params"]

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    tm = BERTFoundationModel(BERTWithEmbeddingRAG(
        tb.vocab.size, DIMS, n_layers=2, attn_heads=4))
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    keep = np.random.default_rng(0).random(tb.train.n_variants) > 0.4
    return dict(jb=jb, tb=tb, jm=jm, params=params, embed_fn=embed_fn,
                tm=tm, keep=keep)


def _drop(vcf, keep):
    return dataclasses.replace(vcf, gt=vcf.gt[keep], pos=vcf.pos[keep],
                               chrom=vcf.chrom[keep], ref=vcf.ref[keep],
                               alt=vcf.alt[keep], ids=vcf.ids[keep])


@pytest.mark.parametrize("kw", [
    dict(n_train_samples=8, n_ref_samples=24, n_sites=120, n_windows=2,
         seed=3),
    dict(n_train_samples=2, n_ref_samples=5, n_sites=61, n_windows=3,
         n_pops=4, seed=11),
])
def test_make_bundle_matches_jax(kw):
    jb, tb = jmake_bundle(**kw), make_bundle(**kw)
    for part in ("train", "ref"):
        j, t = getattr(jb, part), getattr(tb, part)
        np.testing.assert_array_equal(j.gt, t.gt)
        np.testing.assert_array_equal(j.pos, t.pos)
        assert j.samples == t.samples
    np.testing.assert_array_equal(jb.freq.freq, tb.freq.freq)
    np.testing.assert_array_equal(jb.window.window_info, tb.window.window_info)
    assert jb.vocab.pops == tb.vocab.pops
    assert jb.panel.pop_to_class == tb.panel.pop_to_class


def test_impute_matches_jax(setup):
    s = setup
    jres = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                    s["jb"].freq, use_pallas=False,
                    **KW).impute(_drop(s["jb"].train, s["keep"]))
    tres = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                   **KW).impute(_drop(s["tb"].train, s["keep"]))
    for f in ("hap1_prob", "hap2_prob", "gt_prob"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(tres.imputed_flag, jres.imputed_flag)
    np.testing.assert_array_equal(tres.pos, jres.pos)


@pytest.mark.parametrize("k", [1, 4])
def test_retrieved_ids_identical(setup, k):
    s = setup
    jimp = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                    s["jb"].freq, use_pallas=False, **KW)
    timp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu", **KW)
    start, end = jimp.windows[0]
    mask = ~s["keep"][start:end]
    jctx = jimp._window_ctx(0, start, end, mask)
    tctx = timp._window_ctx(start, end, mask)
    # bf16 search context from float32 embeddings: one bf16 rounding each
    np.testing.assert_allclose(tctx.ref_norms.numpy(),
                               np.asarray(jctx.ref_norms), rtol=1e-5)
    assert np.isinf(tctx.ref_norms.numpy()[48:]).all()
    toks = np.array(jctx.ref_tokens)[::3][:16]            # complete haps
    af = np.broadcast_to(np.asarray(jctx.ref_af), toks.shape).copy()
    jq = s["embed_fn"](s["params"], jnp.asarray(toks), jnp.asarray(af), True)
    with torch.no_grad():
        tq = s["tm"].embed(torch.from_numpy(toks).long(),
                           torch.from_numpy(af))
    jids = np.asarray(jsearch(jq, jctx, k, use_pallas=False))
    tids = search(tq, tctx, k).numpy()
    np.testing.assert_array_equal(tids, jids)


def test_known_sites_pass_through(setup):
    s = setup
    keep = s["keep"]
    res = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                  **KW).impute(_drop(s["tb"].train, keep))
    gt = s["tb"].train.gt
    np.testing.assert_array_equal(res.hap1_prob[keep],
                                  gt[keep, :, 0].astype(np.float32))
    np.testing.assert_array_equal(res.hap2_prob[keep],
                                  gt[keep, :, 1].astype(np.float32))
    miss = res.imputed_flag
    assert ((res.hap1_prob[miss] >= 0) & (res.hap1_prob[miss] <= 1)).all()
    np.testing.assert_allclose(res.gt_prob.sum(-1), 1.0, atol=1e-5)


def test_progressive_two_rounds_keep_observed_sites(setup):
    s = setup
    keep = np.random.default_rng(2).random(s["tb"].train.n_variants) > 0.5
    imp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu", **KW)
    res = imp.impute_progressive(_drop(s["tb"].train, keep), rounds=2,
                                 fill_fraction=0.5)
    assert (res.imputed_flag == ~keep).all()
    np.testing.assert_array_equal(
        res.hap1_prob[keep], s["tb"].train.gt[keep, :, 0].astype(np.float32))
    assert res.hap1_prob.shape == (s["tb"].ref.n_variants,
                                   s["tb"].train.n_samples)


def test_service_answers_two_requests(setup):
    s = setup
    svc = ImputationService.create(s["tm"], s["tb"].ref, s["tb"].freq,
                                   device="cpu", **KW)
    for seed in (4, 5):
        keep = np.random.default_rng(seed).random(
            s["tb"].train.n_variants) > 0.3
        res = svc.handle_target(_drop(s["tb"].train, keep))
        assert res.gt_prob.shape == (s["tb"].ref.n_variants,
                                     s["tb"].train.n_samples, 4)
        assert (res.imputed_flag == ~keep).all()


def test_pipeline_depth_invariant(setup):
    """The output pipeline's depth bounds device-resident outputs only:
    results are identical at depth 1 and the default."""
    s = setup
    target = _drop(s["tb"].train, s["keep"])
    kw = dict(KW, batch_size=4)
    r1 = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                 pipeline_depth=1, **kw).impute(target)
    r8 = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                 **kw).impute(target)
    np.testing.assert_array_equal(r1.hap1_prob, r8.hap1_prob)
    np.testing.assert_array_equal(r1.gt_prob, r8.gt_prob)
