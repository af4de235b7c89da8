"""The flax loaders take every tree the JAX package writes: a
``scan_layers=True`` model's stacked encoder blocks and the optax state of
a ``pos_norm="frozen_batch"`` model, whose BatchNorm statistics flax keeps
as parameters and the port as buffers.

Tolerances as in tests/test_torch_model.py (float32: 1e-4; bf16: 6% of each
output's scale) and tests/test_torch_train.py (one optax update: 2^-22
relative, 1e-9 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.train.schedule import make_optimizer as jmake_optimizer
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                           load_optax_adam_state)
from rag_snvbert_tpu_torch.train.schedule import make_optimizer
from test_torch_model import _model_batch
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    V, _assert_close, _perturb, _torch_in, torch_one_thread)
from test_torch_train import _assert_params_equal, _grads_like, _set_grads


def _config(name):
    """Two layers, 48 wide: scanned post-LN float32, scanned bf16 pre-LN
    (the tpu_scan flags), and a frozen-batch float32 model."""
    model = jconfig.ModelConfig(dims=48, n_layers=2, attn_heads=4,
                                seq_len=40)
    if name == "scan-f32":
        return jconfig.RunConfig(model=dataclasses.replace(
            model, scan_layers=True)), "f32"
    if name == "scan-bf16":
        return jconfig.RunConfig(model=dataclasses.replace(
            model, scan_layers=True, pre_ln=True, bf16=True,
            score_bf16=True, attn_dropout=0.0)), "bf16"
    return jconfig.RunConfig(model=dataclasses.replace(
        model, pos_norm="frozen_batch")), "f32"


def _params(cfg, x):
    params = jax.jit(cfg.build_model(V).init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in x.items()})
    return jax.tree.map(np.asarray, _perturb(params["params"]))


def _torch_model(cfg):
    return tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(cfg.model))), V, device="cpu")


@pytest.mark.parametrize("name", ["scan-f32", "scan-bf16"])
def test_scanned_tree_loads_and_matches_the_jax_model(name):
    import torch

    cfg, kind = _config(name)
    x = _model_batch(cfg, np.random.default_rng(2))
    params = _params(cfg, x)
    blocks = params["bert"]["encoder"]["blocks"]
    assert "block_0" not in params["bert"]["encoder"]
    assert all(a.shape[0] == 2 for a in jax.tree.leaves(blocks))
    tm = load_flax_params(_torch_model(cfg), params)
    with torch.no_grad():
        touts = tm({k: _torch_in(v) for k, v in x.items()})
    jouts = jax.jit(cfg.build_model(V).apply)(
        {"params": params}, {k: jnp.asarray(v) for k, v in x.items()})
    for i, (a, b) in enumerate(zip(jouts, touts)):
        _assert_close(a, b, kind, f"output {i}", bf16_rel=0.06)
    # layer i of the stack is block_i
    got = tm.bert.encoder.block_1.state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(blocks):
        keys = [p.key for p in path]
        if keys[-1] == "bias" and keys[-2] == "LayerNorm_0":
            np.testing.assert_array_equal(
                got[".".join(keys)].float().numpy(), leaf[1])


def _optax_case(cfg, accum=1):
    """Perturbed params and an optax state one update in."""
    import optax

    x = _model_batch(cfg, np.random.default_rng(2))
    params = _params(cfg, x)
    rng = np.random.default_rng(5)
    tx = jmake_optimizer(1e-3, 2e-3, 10, accum_steps=accum)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for _ in range(accum):
        grads = _grads_like(params, rng, 1e-3)
        grads = _stop_frozen(grads)
        upd, state = update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
    return params, state, update, rng


def _stop_frozen(grads):
    """What jax.grad gives a FrozenBatchNorm's mean/var: zeros."""
    return jax.tree_util.tree_map_with_path(
        lambda p, g: np.zeros_like(g) if p[-1].key in ("mean", "var")
        and "FrozenBatchNorm" in p[-2].key else g, grads)


@pytest.mark.parametrize("name", ["frozen", "scan-f32"])
@pytest.mark.parametrize("accum", [1, 2])
def test_optax_state_loads_and_steps_like_optax(name, accum):
    import optax

    cfg, _ = _config(name)
    params, state, update, rng = _optax_case(cfg, accum)
    tm = load_flax_params(_torch_model(cfg), params)
    opt = make_optimizer(tm, 1e-3, 2e-3, 10, accum_steps=accum)
    load_optax_adam_state(opt, state, model=tm)
    assert opt.count == 1 and opt.mini_step == 0
    for micro in range(accum):
        grads = _stop_frozen(_grads_like(params, rng, 0.3))
        upd, state = update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
        _set_grads(tm, {k: v for k, v in _flat_scanless(grads).items()})
        assert opt.step() == (micro == accum - 1)
        opt.zero_grad()
    _assert_params_equal(tm, _flat_scanless(params))


def _flat_scanless(tree):
    """A nested dict without the scanned stack and without the frozen
    statistics (buffers: no gradient, no update), for the helpers of
    tests/test_torch_train.py that walk parameters."""
    from rag_snvbert_tpu_torch.interop.flax_params import _leaves

    out = {}
    for path, arr in _leaves(tree).items():
        if path[-1] in ("mean", "var") and "FrozenBatchNorm" in path[-2]:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out


def test_frozen_batch_state_needs_the_model_and_zero_moments():
    cfg, _ = _config("frozen")
    params, state, _, _ = _optax_case(cfg)
    tm = load_flax_params(_torch_model(cfg), params)
    opt = make_optimizer(tm, 1e-3, 2e-3, 10)
    with pytest.raises(KeyError, match="FrozenBatchNorm_0/mean"):
        load_optax_adam_state(opt, state)
    adam = state[1][0]
    mu = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 1.0 if p[-1].key == "var" else a, adam.mu)
    bad = (state[0], (adam._replace(mu=mu),) + tuple(state[1][1:])) \
        + tuple(state[2:])
    with pytest.raises(ValueError, match="non-zero"):
        load_optax_adam_state(opt, bad, model=tm)
