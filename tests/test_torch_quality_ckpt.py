"""The stored trained checkpoint (tests/assets/quality_ckpt.npz, a JAX
model trained by tests/make_quality_ckpt.py) as the port's quality gate:
loaded without JAX (its ``keystr`` paths parsed into
``load_flax_params``), it imputes the calibrated panel's held-back sites
through ``Imputer(..., device="cpu")`` with
tests/test_quality_regression.py's arguments and passes that test's four
gates unchanged (accuracy >= 0.95 and >= the AF prior + 0.10, rare F1 >=
0.70, common F1 >= 0.93); its probabilities are within 1e-6 of the JAX
imputer's, with no call different."""

import dataclasses
import os

import numpy as np
import pytest

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                           params_from_keystr_npz)
from rag_snvbert_tpu_torch.io.freq import AF
from rag_snvbert_tpu_torch.io.synthetic import make_calibrated_bundle
from tests.make_quality_ckpt import (BUNDLE_KW, DIMS, HEADS, LAYERS,
                                     SEQ_LEN)

CKPT = os.path.join(os.path.dirname(__file__), "assets", "quality_ckpt.npz")
PROB_TOL = 1e-6
IMPUTER_KW = dict(window_len=SEQ_LEN - 8, seq_len=SEQ_LEN, ref_pad_haps=96,
                  batch_size=16)


def _target(b):
    keep = np.random.default_rng(123).random(b.train.n_variants) > 0.4
    return keep, dataclasses.replace(
        b.train, gt=b.train.gt[keep], pos=b.train.pos[keep],
        chrom=b.train.chrom[keep], ref=b.train.ref[keep],
        alt=b.train.alt[keep], ids=b.train.ids[keep])


@pytest.fixture(scope="module")
def imputed():
    b = make_calibrated_bundle(**BUNDLE_KW)
    model = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=DIMS, n_layers=LAYERS, attn_heads=HEADS, seq_len=SEQ_LEN)),
        b.vocab.size, device="cpu")
    load_flax_params(model, params_from_keystr_npz(CKPT))
    keep, target = _target(b)
    r = Imputer(model, b.ref, b.freq, device="cpu", **IMPUTER_KW).impute(
        target)
    miss = ~keep
    truth = np.stack([b.train.gt[miss, :, 0], b.train.gt[miss, :, 1]])
    calls = np.stack([(r.hap1_prob[miss] >= 0.5),
                      (r.hap2_prob[miss] >= 0.5)]).astype(np.int8)
    return b, miss, truth, calls, r


def _hap_f1(calls, truth):
    tp = int(((calls == 1) & (truth == 1)).sum())
    fp = int(((calls == 1) & (truth == 0)).sum())
    fn = int(((calls == 0) & (truth == 1)).sum())
    p, r = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    return 2 * p * r / max(p + r, 1e-9)


def test_imputation_beats_af_prior(imputed):
    b, miss, truth, calls, _ = imputed
    acc = (calls == truth).mean()
    af = b.freq.lookup(AF, b.freq.global_idx, b.train.pos[miss])
    prior = (af >= 0.5).astype(np.int8)[None, :, None]
    prior_acc = (np.broadcast_to(prior, truth.shape) == truth).mean()
    assert acc >= 0.95, f"imputation accuracy regressed: {acc:.4f}"
    assert acc >= prior_acc + 0.10, (
        f"model {acc:.4f} does not clearly beat AF prior {prior_acc:.4f}")


def test_rare_and_common_f1_gates(imputed):
    b, miss, truth, calls, _ = imputed
    af = b.freq.lookup(AF, b.freq.global_idx, b.train.pos[miss])
    rare = np.minimum(af, 1 - af) < 0.05
    assert rare.sum() >= 15 and (~rare).sum() >= 30
    rare_f1 = _hap_f1(calls[:, rare], truth[:, rare])
    common_f1 = _hap_f1(calls[:, ~rare], truth[:, ~rare])
    assert rare_f1 >= 0.70, f"rare-variant F1 regressed: {rare_f1:.4f}"
    assert common_f1 >= 0.93, f"common-variant F1 regressed: {common_f1:.4f}"


def test_probabilities_match_the_jax_imputer(imputed):
    import jax

    from rag_snvbert_tpu.infer.imputer import Imputer as JaxImputer
    from tests.make_quality_ckpt import build_model_and_ds

    b, miss, truth, calls, r = imputed
    jb, _, jm, embed_fn = build_model_and_ds()
    np.testing.assert_array_equal(jb.train.gt, b.train.gt)
    np.testing.assert_array_equal(jb.ref.gt, b.ref.gt)
    params = jax.tree.map(np.asarray, params_from_keystr_npz(CKPT))
    _, target = _target(jb)
    jr = JaxImputer(jm, embed_fn, params, jb.ref, jb.freq, use_pallas=False,
                    **IMPUTER_KW).impute(target)
    for name in ("hap1_prob", "hap2_prob", "gt_prob"):
        np.testing.assert_allclose(getattr(r, name), getattr(jr, name),
                                   rtol=0, atol=PROB_TOL, err_msg=name)
    for a, j in ((r.hap1_prob, jr.hap1_prob), (r.hap2_prob, jr.hap2_prob)):
        np.testing.assert_array_equal(a[miss] >= 0.5, j[miss] >= 0.5)
    np.testing.assert_array_equal(r.imputed_flag, jr.imputed_flag)
