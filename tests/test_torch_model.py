"""The whole torch model matches its flax twin given the same weights
(``load_flax_params``), and the loader round-trips every leaf.

Tolerances as in tests/test_torch_modules.py; the whole bf16 model holds
to 6% of each output's scale: its errors compound through embedding,
fusion, two blocks and the heads (observed 3.3% on the genotype logits).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.interop.flax_params import _flatten
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    V, _assert_close, _perturb, _torch_in, torch_one_thread)


def _config(name):
    if name == "smoke-bf16":
        return jconfig.PRESETS["smoke"], "bf16"
    if name == "smoke-f32":
        c = jconfig.PRESETS["smoke"]
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, bf16=False)), "f32"
    # v18-shaped (post-LN, 12 heads, float32, dropout in the tree), narrow
    return jconfig.RunConfig(model=jconfig.ModelConfig(
        dims=48, n_layers=2, attn_heads=12, seq_len=40)), "f32"


def _model_batch(cfg, rng):
    b, l, d = 2, cfg.model.seq_len, cfg.model.dims
    f = lambda *s: rng.random(s).astype(np.float32)
    return {"hap_1": rng.integers(0, V, (b, l)).astype(np.int32),
            "hap_2": rng.integers(0, V, (b, l)).astype(np.int32),
            "pos": f(b, l), "af": f(b, l), "af_p": f(b, l), "ref": f(b, l),
            "het": f(b, l), "hom": f(b, l),
            "rag_emb_h1": rng.standard_normal((b, 1, l, d), np.float32),
            "rag_emb_h2": rng.standard_normal((b, 1, l, d), np.float32)}


@functools.lru_cache(maxsize=None)
def _model_params(cfg_name):
    """Perturbed flax params of a config (the tree does not depend on
    compat_double_softmax); a jitted init compiles once, where an eager
    one compiles every op."""
    cfg, _ = _config(cfg_name)
    x = _model_batch(cfg, np.random.default_rng(2))
    params = jax.jit(cfg.build_model(V).init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in x.items()})
    return _perturb(params["params"])


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("cfg_name", ["smoke-bf16", "smoke-f32", "v18-tiny"])
def test_foundation_model_matches_flax(cfg_name, compat):
    cfg, kind = _config(cfg_name)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compat_double_softmax=compat))
    x = _model_batch(cfg, np.random.default_rng(2))
    jm = cfg.build_model(V)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = _model_params(cfg_name)
    tm = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(cfg.model))), V, device="cpu")
    load_flax_params(tm, params)
    with torch.no_grad():
        touts = tm({k: _torch_in(v) for k, v in x.items()})
    jouts = jax.jit(jm.apply)({"params": params}, jx)
    assert len(touts) == len(jouts) == 7
    for i, (a, b) in enumerate(zip(jouts, touts)):
        _assert_close(a, b, kind, f"output {i}", bf16_rel=0.06)
    if compat:
        np.testing.assert_allclose(touts[2].sum(-1).numpy(), 1.0, atol=1e-5)


def test_load_flax_params_round_trips_every_leaf():
    cfg, params = jconfig.PRESETS["smoke"], _model_params("smoke-bf16")
    tm = tconfig.build_model(cfg, V, device="cpu")
    load_flax_params(tm, params)
    state = tm.state_dict()
    leaves = _flatten(params)
    assert len(leaves) == len(state)
    rename = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    for path, arr in leaves.items():
        t = state[".".join(path[:-1] + (rename.get(path[-1], path[-1]),))]
        t = t.numpy()
        if path[-1] == "kernel":   # back to flax layout
            t = t.T if t.ndim == 2 else t.transpose(2, 1, 0)
        assert t.shape == arr.shape, path
        np.testing.assert_array_equal(t, arr, err_msg="/".join(path))


def test_load_flax_params_raises_on_missing_and_extra_leaves():
    cfg, params = jconfig.PRESETS["smoke"], _model_params("smoke-bf16")
    tm = tconfig.build_model(cfg, V, device="cpu")
    params = jax.tree.map(np.asarray, params)
    missing = jax.tree.map(lambda a: a, params)
    del missing["hap_classifier"]["Dense_3"]["bias"]
    with pytest.raises(KeyError, match="hap_classifier.Dense_3.bias"):
        load_flax_params(tm, missing)
    extra = jax.tree.map(lambda a: a, params)
    extra["bert"]["encoder"]["block_9"] = {"LayerNorm_0": {
        "scale": np.ones(64, np.float32)}}
    with pytest.raises(KeyError, match="block_9"):
        load_flax_params(tm, extra)
