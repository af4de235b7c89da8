"""Reference-checkpoint interop of the port (``interop/torch_ckpt.py``)
against the JAX package's converter, and ``Trainer.init_params_from``.

State_dicts follow ``tests/test_torch_interop.py::fake_state_dict``'s
recipe (the reference key/shape contract with seeded random values), so no
reference source tree is needed.  Trees are compared bit for bit; the
converted model's probabilities within 1e-5 of the flax model's on the
same inputs in float32 (both compute the same float32 graph; observed
differences are a few ulp of the logits).
"""

import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import interop as jinterop
from rag_snvbert_tpu import models as jmodels
from rag_snvbert_tpu_torch import interop as tinterop
from rag_snvbert_tpu_torch.cli.main import _converted_arch
from rag_snvbert_tpu_torch.config import ModelConfig, RunConfig, build_model
from rag_snvbert_tpu_torch.interop.flax_params import _leaves
from test_torch_interop import (DIMS, HEADS, LAYERS, VOCAB,
                                fake_state_dict, sample_inputs)
from test_torch_modules import _torch_in, torch_one_thread  # noqa: F401

PROB_TOL = 1e-5


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        y = lb[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg="/".join(path))


def _port_model(meta, compat=False, heads=HEADS):
    meta = {**meta, "attn_heads": heads,
            "compat_double_softmax": compat}
    return build_model(RunConfig(model=ModelConfig(**_converted_arch(meta))),
                       meta["vocab_size"], device="cpu")


CONVERT_CASES = {"embedding": {}, "token": {"rag_mode": "token"},
                 "headless": {"with_heads": False, "with_rag": False}}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_state_dict_equals_jax(case):
    kw = dict(CONVERT_CASES[case])
    rag_mode = kw.pop("rag_mode", None)
    sd = fake_state_dict(seed=4, **kw)
    jp, jmeta = jinterop.convert_state_dict(sd, rag_mode=rag_mode)
    tp, tmeta = tinterop.convert_state_dict(sd, rag_mode=rag_mode)
    assert tmeta == jmeta
    _assert_trees_equal(tp, jinterop.torch_ckpt.jax_tree_to_numpy(jp))
    if case == "headless":
        assert tmeta["rag_mode"] == "none" and not tmeta["with_heads"]
        assert "encoder" in tp and "hap_classifier" not in tp


@pytest.mark.parametrize("with_rag", [True, False])
@pytest.mark.parametrize("with_heads", [True, False])
def test_expected_reference_keys_equal_jax(with_rag, with_heads):
    args = (3, 48, 17)
    assert (tinterop.expected_reference_keys(
        *args, with_rag=with_rag, with_heads=with_heads)
        == jinterop.expected_reference_keys(
            *args, with_rag=with_rag, with_heads=with_heads))


@pytest.mark.parametrize("compat", [False, True])
def test_converted_model_matches_flax(compat):
    """The same converted reference weights through the flax model and the
    port's model (load_flax_params): probabilities within PROB_TOL."""
    sd = fake_state_dict(seed=0)
    jp, meta = jinterop.convert_state_dict(sd)
    tp, _ = tinterop.convert_state_dict(sd)
    jm = jmodels.BERTFoundationModel(
        bert=jmodels.BERTWithEmbeddingRAG(
            vocab_size=VOCAB, dims=DIMS, n_layers=LAYERS, attn_heads=HEADS,
            pos_norm="frozen_batch"), compat_double_softmax=compat)
    x = sample_inputs()
    jout = jm.apply({"params": jax.tree.map(jnp.asarray, jp)},
                    {k: jnp.asarray(v) for k, v in x.items()},
                    deterministic=True)
    tm = tinterop.load_flax_params(_port_model(meta, compat), tp)
    with torch.no_grad():
        tout = tm({k: _torch_in(v) for k, v in x.items()})
    for i in range(3):                      # hap_1, hap_2, gt
        j = np.asarray(jout[i], np.float64)
        t = tout[i].double().numpy()
        if not compat:                      # logits: compare probabilities
            j = np.exp(j - j.max(-1, keepdims=True))
            j /= j.sum(-1, keepdims=True)
            t = torch.softmax(tout[i].double(), -1).numpy()
        err = np.abs(j - t).max()
        assert err <= PROB_TOL, (i, err)


def test_export_equals_jax_bit_for_bit():
    params, _ = tinterop.convert_state_dict(fake_state_dict(seed=3))
    jsd = jinterop.export_state_dict(params)
    tsd = tinterop.export_state_dict(params)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tsd[k], v, err_msg=k)


def test_convert_export_convert_through_the_model_is_exact(tmp_path):
    """reference sd -> convert -> save_converted -> a port model ->
    flax_params_of -> export -> convert: the same tree bit for bit, and the
    export equal to the source tensors (pe regenerated, counters reset)."""
    sd = fake_state_dict(seed=5)
    params, meta = tinterop.convert_state_dict(sd)
    meta["attn_heads"] = HEADS
    tinterop.save_converted(params, meta, str(tmp_path / "conv"))
    assert tinterop.load_convert_meta(str(tmp_path / "conv")) == meta
    model = _port_model(meta)
    tinterop.load_flax_params(
        model, tinterop.load_params_checkpoint(str(tmp_path / "conv")))
    back = tinterop.flax_params_of(model)
    _assert_trees_equal(back, params)
    out = tinterop.export_state_dict(back)
    assert set(out) == set(sd)
    for k, v in sd.items():
        if k.endswith(("num_batches_tracked", "position.pe")):
            continue
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    again, meta2 = tinterop.convert_state_dict(out)
    _assert_trees_equal(again, params)
    assert meta2 == {**meta, "attn_heads": None}


def test_unknown_keys_fail_loudly():
    sd = fake_state_dict()
    sd["bert.rag_fusion.mystery.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        tinterop.convert_state_dict(sd)


def test_rag_mode_mismatch_rejected():
    with pytest.raises(ValueError, match="rag_mode"):
        tinterop.convert_state_dict(fake_state_dict(), rag_mode="none")


def test_export_of_a_group_norm_model_needs_the_opt_in():
    """A model trained with GroupNorm position statistics refuses a silent
    lossy export; approx_pos_norm gives identity-statistics BatchNorm."""
    model = build_model(RunConfig(model=ModelConfig(
        dims=DIMS, n_layers=LAYERS, attn_heads=HEADS)), VOCAB, device="cpu")
    params = tinterop.flax_params_of(model)
    with pytest.raises(ValueError, match="frozen_batch"):
        tinterop.export_state_dict(params)
    sd = tinterop.export_state_dict(params, approx_pos_norm=True)
    assert set(sd) == set(tinterop.expected_reference_keys(LAYERS, DIMS,
                                                           VOCAB))
    np.testing.assert_array_equal(
        sd["bert.emb_fusion.pos_feat.norm1.running_var"], np.ones(4))


REF_MODULE = """
    import allel  # noqa: F401  a heavy dependency of the reference package
    import torch


    class FoundationModel(torch.nn.Module):
        def __init__(self, sd):
            super().__init__()
            self.attn_heads = {heads}
            for i, (k, v) in enumerate(sd.items()):
                self.register_buffer(f"t{{i}}", torch.from_numpy(v))
            self.names = list(sd)

        def state_dict(self, *a, **kw):
            return {{n: getattr(self, f"t{{i}}")
                    for i, n in enumerate(self.names)}}
"""


def test_whole_module_pickle_loads_through_the_stubs(tmp_path):
    """A whole-module pickle needs its classes, whose package imports a
    dependency that is not installed (``allel``): with ``ref_src`` the
    missing module is stubbed for the load and removed again; the heads
    come from the module.  Without ``ref_src`` the file is refused, since
    loading it runs its code."""
    import importlib.util

    assert importlib.util.find_spec("allel") is None, \
        "this check needs a stubbed dependency that is not installed"
    src = tmp_path / "refsrc"
    (src / "refpkg").mkdir(parents=True)
    (src / "refpkg" / "__init__.py").write_text("")
    (src / "refpkg" / "model.py").write_text(
        textwrap.dedent(REF_MODULE.format(heads=HEADS)))
    sd = fake_state_dict(seed=7)
    path = str(tmp_path / "rag_bert.model.ep0")
    sys.path.insert(0, str(src))
    stubbed = tinterop.torch_ckpt._stub_missing_modules(("allel",))
    try:
        from refpkg.model import FoundationModel
        torch.save(FoundationModel(sd), path)
    finally:
        sys.path.remove(str(src))
        for mod in stubbed + ["refpkg", "refpkg.model"]:
            sys.modules.pop(mod, None)
    with pytest.raises(ValueError, match="ref_src"):
        tinterop.load_torch_checkpoint(path)
    got, heads = tinterop.load_torch_checkpoint(path, ref_src=str(src))
    assert heads == HEADS and "allel" not in sys.modules
    assert str(src) not in sys.path
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)
    sys.modules.pop("refpkg", None)
    sys.modules.pop("refpkg.model", None)


def test_raw_state_dict_loads_without_code(tmp_path):
    sd = fake_state_dict(seed=8)
    path = str(tmp_path / "sd.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    got, heads = tinterop.load_torch_checkpoint(path)
    assert heads is None and sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)


# ---------------------------------------------------------------------------
# Trainer.init_params_from
# ---------------------------------------------------------------------------

def _trainer(tmp, meta, vocab=None):
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    b = make_bundle(n_train_samples=6, n_ref_samples=8, n_sites=128,
                    n_windows=1, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)
    model = _port_model({**meta, "vocab_size": vocab or b.vocab.size},
                        heads=4)
    cfg = TrainerConfig(epochs=1, batch_size=6, warmup_steps=5,
                        ref_pad_haps=16, output_dir=str(tmp / "run"),
                        rag_mode=meta["rag_mode"])
    return Trainer(model, ds, cfg), b.vocab.size


def _converted_dir(tmp, vocab, **kw):
    sd = fake_state_dict(seed=12, layers=1, dims=32, vocab=vocab, **kw)
    params, meta = tinterop.convert_state_dict(sd)
    meta["attn_heads"] = 4
    out = str(tmp / "conv")
    tinterop.save_converted(params, meta, out)
    return out, params, meta


def test_init_params_from_loads_weights_and_keeps_a_fresh_optimizer(
        tmp_path):
    base = {"dims": 32, "n_layers": 1, "rag_mode": "embedding"}
    tr, vocab = _trainer(tmp_path, base)
    conv, params, meta = _converted_dir(tmp_path, vocab)
    tr.init_params_from(conv)
    _assert_trees_equal(tinterop.flax_params_of(tr.model), params)
    bn = tr.model.bert.emb_fusion.pos_feat.FrozenBatchNorm_0
    np.testing.assert_array_equal(
        bn.var.numpy(), params["bert"]["emb_fusion"]["pos_feat"]
        ["FrozenBatchNorm_0"]["var"])
    opt = tr.optimizer.state_dict()
    assert opt["count"] == 0 and opt["mini_step"] == 0
    assert all(not v.any() for v in opt["mu"].values())
    assert (tr.step, tr.start_epoch, tr.level) == (0, 0, 0)
    # the optimizer still steps the loaded tensors
    assert all(p is q for p, q in zip(tr.optimizer.params,
                                      tr.model.parameters()))
    out = tr.fit()
    assert np.isfinite(out["history"][0]["train_loss"])


MISMATCHES = {
    "missing": ({"dims": 32, "n_layers": 2, "rag_mode": "embedding"}, {},
                "missing=\\['bert/encoder/block_1"),
    "extra": ({"dims": 32, "n_layers": 1, "rag_mode": "none"}, {},
              "extra=\\['bert/rag_fusion"),
    "shape": ({"dims": 32, "n_layers": 1, "rag_mode": "embedding"},
              {"vocab": 3}, "shape_mismatch=\\['bert/embedding/Embed_0"),
}


@pytest.mark.parametrize("case", list(MISMATCHES))
def test_init_params_from_a_mismatch_lists_what_differs(tmp_path, case):
    arch, ck, pattern = MISMATCHES[case]
    tr, vocab = _trainer(tmp_path, arch)
    conv, _, _ = _converted_dir(tmp_path, ck.get("vocab", vocab))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(ValueError, match=pattern):
        tr.init_params_from(conv)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_load_params_checkpoint_reads_a_trainer_checkpoint(tmp_path):
    base = {"dims": 32, "n_layers": 1, "rag_mode": "embedding"}
    tr, _ = _trainer(tmp_path, base)
    tr.save_checkpoint(0, is_best=False)
    got = tinterop.load_params_checkpoint(str(tmp_path / "run" / "ckpt_ep0"))
    _assert_trees_equal(got, tinterop.flax_params_of(tr.model))
    assert os.path.exists(tmp_path / "run" / "ckpt_ep0" / "state.pt")
