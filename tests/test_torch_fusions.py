"""The four alternative RAG fusions and ``pos_norm="none"`` of the port
match their flax twins given the same weights, and the cross attention's
``DenseGeneral`` leaves go through ``load_flax_params`` and
``flax_params_of`` and back unchanged.

Tolerances are tests/test_torch_modules.py's: 1e-4 in float32, 3% of the
output's scale with bf16.  The alternative fusions take no dtype (flax
computes them in the promotion of input and float32 parameters), so their
bf16 case feeds bf16 inputs; ``EmbeddingFusionModule`` takes the dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.models import fusion as jfusion
from rag_snvbert_tpu_torch.interop import flax_params_of, load_flax_params
from rag_snvbert_tpu_torch.interop.flax_params import _flatten
from rag_snvbert_tpu_torch.models import fusion as tfusion
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    DTYPES, _assert_close, _perturb, torch_one_thread)

B, K, L, D = 2, 3, 24, 32


def _inputs(name, rng):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    f = lambda *s: rng.uniform(0.01, 0.99, s).astype(np.float32)  # noqa: E731
    return {
        "RareVariantAwareFusion": [n(B, L, D), n(B, K, L, D), f(B, L)],
        "PositionFeatModule-none": [f(B, L)],
        "EmbeddingFusionModule-none": [n(B, L, D), f(B, L), f(B, L)],
    }.get(name, [n(B, L, D), n(B, K, L, D)])


def _pair(name, jdt, tdt):
    return {
        "RareVariantAwareFusion": (jfusion.RareVariantAwareFusion(D),
                                   tfusion.RareVariantAwareFusion(D)),
        "FixedConcatFusion": (jfusion.FixedConcatFusion(D),
                              tfusion.FixedConcatFusion(D)),
        "ConcatFusion": (jfusion.ConcatFusion(D), tfusion.ConcatFusion(D)),
        "CrossAttentionFusion": (jfusion.CrossAttentionFusion(D),
                                 tfusion.CrossAttentionFusion(D)),
        "PositionFeatModule-none": (jfusion.PositionFeatModule(norm="none"),
                                    tfusion.PositionFeatModule(norm="none")),
        "EmbeddingFusionModule-none": (
            jfusion.EmbeddingFusionModule(D, pos_norm="none", dtype=jdt),
            tfusion.EmbeddingFusionModule(D, pos_norm="none", dtype=tdt)),
    }[name]


# PositionFeatModule is float32 whatever the model's dtype: one case
CASES = [(name, kind) for name in ("RareVariantAwareFusion",
                                   "FixedConcatFusion", "ConcatFusion",
                                   "CrossAttentionFusion",
                                   "EmbeddingFusionModule-none")
         for kind in DTYPES] + [("PositionFeatModule-none", "f32")]


@pytest.mark.parametrize("name,kind", CASES)
def test_fusion_matches_flax(name, kind):
    jdt, tdt = DTYPES[kind]
    jmod, tmod = _pair(name, jdt, tdt)
    args = _inputs(name, np.random.default_rng(0))
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if kind == "bf16":   # the sequences in bf16; positions and AF float32
        jargs = [a.astype(jnp.bfloat16) if a.ndim > 2 else a for a in jargs]
        targs = [a.bfloat16() if a.dim() > 2 else a for a in targs]
    params = _perturb(jax.jit(jmod.init)(jax.random.key(0), *jargs)["params"])
    load_flax_params(tmod, params)
    with torch.no_grad():
        tout = tmod(*targs)
    jout = jax.jit(jmod.apply)({"params": params}, *jargs)
    assert tout.dtype == {jnp.float32: torch.float32,
                          jnp.bfloat16: torch.bfloat16}[jout.dtype.type]
    _assert_close(jout, tout, kind, name)


def test_cross_attention_dense_general_leaves_round_trip():
    """Flax's ``DenseGeneral`` kernels ``query/key/value [D, H, hd]`` and
    ``out [H, hd, D]`` land as ``[H, hd, D]`` and ``[D, H, hd]`` (output
    axes first), their ``[H, hd]`` biases as they are, and
    ``flax_params_of`` gives back every leaf bit for bit."""
    jmod = jfusion.CrossAttentionFusion(D)
    args = [jnp.asarray(a) for a in _inputs("CrossAttentionFusion",
                                            np.random.default_rng(1))]
    params = _perturb(jax.jit(jmod.init)(jax.random.key(0), *args)["params"])
    tmod = load_flax_params(tfusion.CrossAttentionFusion(D), params)
    mha = params["MultiHeadDotProductAttention_0"]
    heads, hd = 8, D // 8
    tm = tmod.MultiHeadDotProductAttention_0
    q = np.asarray(mha["query"]["kernel"])
    assert q.shape == (D, heads, hd)
    np.testing.assert_array_equal(tm.query.weight.detach().numpy(),
                                  q.transpose(1, 2, 0))
    np.testing.assert_array_equal(tm.query.bias.detach().numpy(),
                                  np.asarray(mha["query"]["bias"]))
    o = np.asarray(mha["out"]["kernel"])
    assert o.shape == (heads, hd, D)
    np.testing.assert_array_equal(tm.out.weight.detach().numpy(),
                                  o.transpose(2, 0, 1))
    back, want = _flatten(flax_params_of(tmod)), _flatten(params)
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=str(path))
        assert back[path].shape == arr.shape


def test_a_transposed_dense_general_leaf_is_refused():
    """A ``query`` kernel in the Conv rule's layout has the wrong shape
    for the DenseGeneral module and is refused, not loaded transposed."""
    jmod = jfusion.CrossAttentionFusion(D, heads=4)
    args = [jnp.asarray(a) for a in _inputs("CrossAttentionFusion",
                                            np.random.default_rng(1))]
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.key(0), *args)["params"])
    node = params["MultiHeadDotProductAttention_0"]["query"]
    node["kernel"] = node["kernel"].transpose(2, 1, 0)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(tfusion.CrossAttentionFusion(D, heads=4), params)
