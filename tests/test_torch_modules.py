"""Each torch module matches its flax twin given the same weights
(``load_flax_params``), in float32 and in the bf16 dtype path.

Tolerances: float32 runs hold to 1e-4 (the two frameworks sum in other
orders; observed error is ~1e-6).  bf16 runs hold to 3% of the output's
scale: bf16 keeps 8 mantissa bits (spacing 2^-8 ~ 0.4% relative) and the
two frameworks round to bf16 at slightly different places (GELU, softmax
and LayerNorm internals), a few roundings deep.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.models import embeddings as jemb
from rag_snvbert_tpu.models import fusion as jfusion
from rag_snvbert_tpu.models import transformer as jtr
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.models import embeddings as temb
from rag_snvbert_tpu_torch.models import fusion as tfusion
from rag_snvbert_tpu_torch.models import transformer as ttr

B, L, D, H, V = 2, 24, 32, 4, 9


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """The suite runs several pytest workers on one host: one torch thread
    each keeps them from oversubscribing the cores at these tiny sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _perturb(params, seed=1):
    """Flax inits leave biases at constants and norms at one; add noise so
    every leaf matters (FrozenBatchNorm variances stay positive)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(a + noise) + 0.5
        return a + noise

    return jax.tree_util.tree_map_with_path(f, params)


def _assert_close(jout, tout, kind, what="", bf16_rel=0.03):
    a = np.asarray(jnp.asarray(jout, jnp.float32))
    b = tout.float().detach().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    tol = 1e-4 if kind == "f32" else \
        bf16_rel * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=tol, err_msg=what)


def _inputs(name, rng):
    f = lambda *s: rng.random(s).astype(np.float32)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    toks = rng.integers(0, V, (B, L)).astype(np.int32)
    return {
        "BERTEmbedding": [toks, f(B, L)],
        "PositionFeatModule-group": [f(B, L)],
        "PositionFeatModule-frozen_batch": [f(B, L)],
        "EmbeddingFusionModule": [n(B, L, D), f(B, L), f(B, L)],
        "CrossAFInteraction": [f(B, L), f(B, L)],
        "EnhancedRareVariantFusion": [n(B, L, D), n(B, 2, L, D), f(B, L),
                                      f(B, L)],
    }.get(name, [n(B, L, D)])


def _pair(name, jdt, tdt):
    """(flax module, torch module) of one case."""
    attn = dict(attn_dropout=0.0)
    return {
        "BERTEmbedding": (jemb.BERTEmbedding(V, D, dtype=jdt),
                          temb.BERTEmbedding(V, D, dtype=tdt)),
        "PositionFeatModule-group": (
            jfusion.PositionFeatModule(norm="group"),
            tfusion.PositionFeatModule(norm="group")),
        "PositionFeatModule-frozen_batch": (
            jfusion.PositionFeatModule(norm="frozen_batch"),
            tfusion.PositionFeatModule(norm="frozen_batch")),
        "EmbeddingFusionModule": (jfusion.EmbeddingFusionModule(D, dtype=jdt),
                                  tfusion.EmbeddingFusionModule(D, dtype=tdt)),
        "CrossAFInteraction": (jfusion.CrossAFInteraction(D, dtype=jdt),
                               tfusion.CrossAFInteraction(D, dtype=tdt)),
        "EnhancedRareVariantFusion": (
            jfusion.EnhancedRareVariantFusion(D, dtype=jdt),
            tfusion.EnhancedRareVariantFusion(D, dtype=tdt)),
        "MultiHeadAttention": (jtr.MultiHeadAttention(H, D, dtype=jdt, **attn),
                               ttr.MultiHeadAttention(H, D, dtype=tdt, **attn)),
        "MultiHeadAttention-fused_qkv": (
            jtr.MultiHeadAttention(H, D, dtype=jdt, fused_qkv=True, **attn),
            ttr.MultiHeadAttention(H, D, dtype=tdt, fused_qkv=True, **attn)),
        "MultiHeadAttention-flash": (
            jtr.MultiHeadAttention(H, D, dtype=jdt, flash="splash", **attn),
            ttr.MultiHeadAttention(H, D, dtype=tdt, flash=True, **attn)),
        "FeedForward": (jtr.FeedForward(D, 4 * D, dtype=jdt),
                        ttr.FeedForward(D, 4 * D, dtype=tdt)),
        "TransformerBlock-post_ln": (
            jtr.TransformerBlock(D, H, 4 * D, dtype=jdt),
            ttr.TransformerBlock(D, H, 4 * D, dtype=tdt)),
        "TransformerBlock-pre_ln": (
            jtr.TransformerBlock(D, H, 4 * D, pre_ln=True, dtype=jdt),
            ttr.TransformerBlock(D, H, 4 * D, pre_ln=True, dtype=tdt)),
        "Encoder": (jtr.Encoder(2, D, H, dtype=jdt, **attn),
                    ttr.Encoder(2, D, H, dtype=tdt, **attn)),
    }[name]


CASES = ["BERTEmbedding", "PositionFeatModule-group",
         "PositionFeatModule-frozen_batch", "EmbeddingFusionModule",
         "CrossAFInteraction", "EnhancedRareVariantFusion",
         "MultiHeadAttention", "MultiHeadAttention-fused_qkv",
         "MultiHeadAttention-flash", "FeedForward",
         "TransformerBlock-post_ln", "TransformerBlock-pre_ln", "Encoder"]


def _torch_in(a):
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_module_matches_flax(name, kind):
    jdt, tdt = DTYPES[kind]
    jmod, tmod = _pair(name, jdt, tdt)
    args = _inputs(name, np.random.default_rng(0))
    jargs = [jnp.asarray(a) for a in args]
    params = _perturb(jax.jit(jmod.init)(jax.random.key(0), *jargs)["params"])
    load_flax_params(tmod, params)
    tmod.eval()
    with torch.no_grad():
        tout = tmod(*[_torch_in(a) for a in args])
    jout = jax.jit(jmod.apply)({"params": params}, *jargs)
    _assert_close(jout, tout, kind, name)


@pytest.mark.parametrize("broadcast", [False, True])
def test_residual_dropout_mask_layout(broadcast):
    """Training-mode residual dropout (the JAX ``dropout_broadcast``):
    broadcast masks are shared along the sequence axis, others are not;
    the draws come from the given generator, not the global RNG; eval mode
    is the identity."""
    from rag_snvbert_tpu_torch.models.layers import Dropout, dropout

    x = torch.ones(3, 50, 16)
    state = torch.get_rng_state()
    y = dropout(x, 0.5, torch.Generator().manual_seed(0), broadcast)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(0),
                                  broadcast))
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    same_along_seq = bool((y == y[:, :1]).all())
    assert same_along_seq == broadcast
    assert torch.equal(Dropout(0.5, broadcast).eval()(x), x)


def test_dropout_in_train_mode_without_a_generator_raises():
    from rag_snvbert_tpu_torch.models.layers import (Dropout,
                                                     set_dropout_generator)

    mod = Dropout(0.1).train()
    with pytest.raises(RuntimeError, match="generator"):
        mod(torch.ones(2, 3, 4))
    set_dropout_generator(mod, torch.Generator().manual_seed(1))
    assert mod(torch.ones(2, 3, 4)).shape == (2, 3, 4)
    assert torch.equal(Dropout(0.0).train()(torch.ones(2)), torch.ones(2))
