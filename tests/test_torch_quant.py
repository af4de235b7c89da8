"""The port's int8 matmuls (``ops.quant``) against the JAX package's
(rag_snvbert_tpu/ops/quant.py) on the CPU.

Quantization codes and scales, the int8 forward and the quantized
(``"fwd_bwd"``) gradients are bit-identical: the same float operations in
the same order around exact integer products.  The exact (``"fwd"``)
backward is a float product on both sides, summed in other orders: float32
to 1e-5 relative, bf16 to one bf16 rounding (2^-7 of the output's scale).
An ``Int8Dense`` loads a flax ``Int8Dense`` tree and gives its output bit
for bit.  A small int8 model (2 layers, 48d: every K and N a multiple of
8) holds to the JAX model's outputs and to one loss's gradients with the
tolerances stated in its test.  Inputs come from numpy with fixed seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.ops import quant as jquant
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.ops import quant as tquant
from test_torch_model import _model_batch
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    V, _perturb, _torch_in, torch_one_thread)

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, kind):
    jdt, tdt = DT[kind]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.detach().float().numpy()


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("kind", list(DT))
def test_quant_codes_and_scales_are_bit_identical(kind, axis):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((33, 7, 40)) * 3).astype(np.float32)
    a[:, 3] = 0.0                       # all-zero rows: the 1e-8 floor
    a[0, 0, :8] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 63.5]
    ja, ta = _pair(a, kind)
    jq, js = jquant._quant(ja, axis)
    tq, ts = tquant._quant(ta, axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(24, 40), (3, 10, 40), (5, 40)])
@pytest.mark.parametrize("kind", list(DT))
def test_int8_dot_forward_is_bit_identical(kind, shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, kind), _pair(w, kind)
    want = jquant.int8_dot(jx, jw)
    for fn in (tquant.int8_dot, tquant.int8_dot_fwdonly):
        got = fn(tx, tw)
        assert got.dtype == DT[kind][1]
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("mode", ["fwd_bwd", "fwd"])
@pytest.mark.parametrize("kind", list(DT))
def test_int8_dot_gradients_match_jax(kind, mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    c = rng.standard_normal((2, 13, 24)).astype(np.float32)
    (jx, tx), (jw, tw), (jc, tc) = _pair(x, kind), _pair(w, kind), \
        _pair(c, kind)
    jfn = jquant.int8_dot if mode == "fwd_bwd" else jquant.int8_dot_fwdonly
    tfn = tquant.int8_dot if mode == "fwd_bwd" else tquant.int8_dot_fwdonly
    jgx, jgw = jax.grad(lambda a, b: (jfn(a, b) * jc).sum(),
                        argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    (tfn(tx, tw) * tc).sum().backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        assert got.dtype == DT[kind][1]
        a, b = _np(got), _np(want)
        if mode == "fwd_bwd":
            np.testing.assert_array_equal(a, b)
        elif kind == "f32":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2 ** -7 * np.abs(b).max())


@pytest.mark.parametrize("kind", list(DT))
def test_int8_dense_loads_a_flax_int8_dense(kind):
    jdt, tdt = DT[kind]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    jm = jquant.Int8Dense(24, dtype=jdt)
    params = _perturb(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    tm = tquant.Int8Dense(40, 24, tdt)
    load_flax_params(tm, params)
    before = tquant.Int8Dense.calls
    got = tm(torch.from_numpy(x))
    assert tquant.Int8Dense.calls == before + 1
    want = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_dense_cls_picks_the_class_and_mode():
    from rag_snvbert_tpu_torch.models.layers import Dense

    assert tquant.dense_cls(False) is Dense
    for quant, mode in ((True, "fwd_bwd"), ("fwd_bwd", "fwd_bwd"),
                        ("fwd", "fwd")):
        layer = tquant.dense_cls(quant)(16, 8, torch.bfloat16)
        assert isinstance(layer, tquant.Int8Dense) and layer.mode == mode
        assert layer.compute_dtype == torch.bfloat16
        assert layer.weight.shape == (8, 16)


def test_int_mm_pads_shapes_it_refuses():
    rng = np.random.default_rng(4)
    for m, k, n in ((3, 5, 7), (17, 24, 8), (40, 13, 9)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        got = tquant._int_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got.long(), a.long() @ b.long())


def _int8_config(quant):
    return jconfig.RunConfig(model=jconfig.ModelConfig(
        dims=48, n_layers=2, attn_heads=12, seq_len=40, int8_matmuls=quant))


@pytest.mark.parametrize("quant", [True, "fwd"])
def test_int8_model_matches_jax(quant):
    """Outputs and one loss's gradients of a 2-layer float32 int8 model.

    Both sides quantize the same activations, but those come from float32
    LayerNorms and softmaxes summed in other orders, so now and then an
    activation sits on the other side of a rounding boundary and its int8
    code moves by one (1/127 of its row's scale) on one side only, and the
    change travels through the later layers.  Outputs: 2e-2 of each
    output's scale (observed <= 7.9e-3); loss: 3e-3 relative (observed
    7.5e-4); gradients: 5e-2 relative L2 per parameter, measured against
    the larger of its own norm and 1e-4 of the whole gradient's (observed
    1.6e-2 with ``True``, whose gradient products are quantized too, and
    7.1e-3 with ``"fwd"``)."""
    cfg = _int8_config(quant)
    x = _model_batch(cfg, np.random.default_rng(5))
    jm = cfg.build_model(V)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = _perturb(jax.jit(jm.init)(jax.random.key(0), jx)["params"])
    tm = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(cfg.model))), V, device="cpu")
    assert sum(isinstance(m, tquant.Int8Dense) for m in tm.modules()) == 12
    load_flax_params(tm, params)
    tx = {k: _torch_in(v) for k, v in x.items()}

    def jloss(p):
        out = jm.apply({"params": p}, jx, deterministic=True)
        return -jax.nn.log_softmax(out[0].astype(jnp.float32))[..., 0].mean()

    jouts = jax.jit(jm.apply)({"params": params}, jx)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    before = tquant.Int8Dense.calls
    touts = tm(tx)
    assert tquant.Int8Dense.calls == before + 12
    for i, (a, b) in enumerate(zip(jouts, touts)):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(a).max()),
                                   err_msg=f"output {i}")
    loss = -torch.log_softmax(touts[0].float(), -1)[..., 0].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=3e-3)
    from test_torch_train import _flat, _key, _to_flax

    flat = _flat(jg)
    named = dict(tm.named_parameters())
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in flat.values()))
    for path, g in flat.items():
        p = named[_key(path)]
        mine = _to_flax(path, p.grad if p.grad is not None
                        else torch.zeros_like(p))
        rel = np.linalg.norm(mine - g) / max(np.linalg.norm(g), 1e-4 * total)
        assert rel <= 5e-2, (_key(path), rel)
