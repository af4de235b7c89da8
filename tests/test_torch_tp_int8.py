"""Tensor parallelism of ``int8_matmuls`` models (``ops/quant.py``'s
``Int8Dense.tp``, set by ``parallel/tp.py``'s ``shard_model``) at tp2 and
tp4, in gloo worlds of CPU ranks.

One layer, column- and row-parallel, both modes, float32 and bf16,
against the one-process layer on the same weights and inputs:

  - the forward is equal bit for bit (scales along a split contraction
    are the group's max, the int32 partial products are summed before the
    rescale);
  - with ``"fwd_bwd"`` (``int8_matmuls=True``) the input and weight
    gradients are equal bit for bit too (a column-parallel layer's input
    gradient is summed in int32 before its rescale);
  - with ``"fwd"`` the backward products are float products, and a
    column-parallel layer's input gradient is a sum of rank partials:
    float32 within 1e-5 relative, bf16 within one bf16 rounding (2^-7 of
    the gradient's scale), as tests/test_torch_quant.py holds the exact
    backward to JAX's; so is the bias gradient in both modes (a float sum
    over rows of the loss gradient, which a rank sees in a slice).

The whole model (2 layers, 4 heads of 8, and 3 heads of 16 where the
heads are split too) is held to the one-process int8 model with
test_torch_quant.py's int8 model tolerances: outputs to 2e-2 of each
output's scale, every parameter's gradient to 5e-2 relative L2 against
the larger of its own norm and 1e-4 of the whole gradient's.  It is not
bit for bit: the FFN's LayerNorm under tensor parallelism sums its
statistics over the group in float32, so an activation can land on the
other side of a rounding boundary and its int8 code move by one
(observed 8.3e-7 of an output's scale and 5.2e-3 of a gradient).
Against the JAX package's int8 model under GSPMD (``tp_shardings`` over
the virtual CPU devices) the tolerances are 3e-2 and 0.1 (observed
2.2e-2 and 5.4e-2 on these weights): the port's one-process int8 model
is as far from JAX's one-process one, whose results GSPMD's equal; the
gap is float32 rounding before each quantization, which moves a code
now and then, not tensor parallelism.
"""

import functools

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.ops.quant import Int8Dense
from rag_snvbert_tpu_torch.parallel import tp
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from test_torch_tp_split import (_batch_np, _loss_weights, _torch_batch,
                                 flax_tree)

TP = (2, 4)
K, N = 32, 48                     # one layer's in and out features
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
MODES = ("fwd_bwd", "fwd")
# model case -> (dims, heads, int8_matmuls)
MODELS = {"int8": (32, 4, True), "int8_fwd": (32, 4, "fwd"),
          "int8_split_heads": (48, 3, True)}
JAX_MODELS = ("int8", "int8_fwd")
OUT_TOL, GRAD_TOL = 2e-2, 5e-2
JAX_OUT_TOL, JAX_GRAD_TOL = 3e-2, 0.1


def _model_cfg(case):
    dims, heads, quant = MODELS[case]
    return tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=dims, n_layers=2, attn_heads=heads, seq_len=40,
        int8_matmuls=quant))


# ---- one layer ----

def _layer_case(rank, n, group, mode, dt, split):
    """The tp layer's outputs and gradients beside the one-process
    layer's slices of them: ``{what: (tp, one-process)}``."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 13, K)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 13, N)).astype(np.float32))
    one = Int8Dense(K, N, dt, mode=mode)
    with torch.no_grad():
        one.weight.copy_(torch.from_numpy(
            rng.standard_normal((N, K)).astype(np.float32)))
        one.bias.copy_(torch.from_numpy(
            rng.standard_normal(N).astype(np.float32)))
    xo = x.to(dt).clone().requires_grad_()
    y = one(xo)
    (y.float() * c).sum().backward()
    cols = slice(rank * N // n, (rank + 1) * N // n)
    rows = slice(rank * K // n, (rank + 1) * K // n)
    mine = Int8Dense(K // n if split == "row" else K,
                     N // n if split == "column" else N, dt, mode=mode)
    with torch.no_grad():
        if split == "column":
            mine.weight.copy_(one.weight[cols])
            mine.bias.copy_(one.bias[cols])
        else:
            mine.weight.copy_(one.weight[:, rows])
            mine.bias.copy_(one.bias)
    mine.tp = (split, group)
    xt = (x if split == "column" else x[..., rows]).to(dt).clone() \
        .requires_grad_()
    yt = mine(xt)
    (yt.float() * (c[..., cols] if split == "column" else c)).sum().backward()
    if split == "column":
        return {"y": (yt, y[..., cols]), "dx": (xt.grad, xo.grad),
                "dw": (mine.weight.grad, one.weight.grad[cols]),
                "db": (mine.bias.grad, one.bias.grad[cols])}
    return {"y": (yt, y), "dx": (xt.grad, xo.grad[..., rows]),
            "dw": (mine.weight.grad, one.weight.grad[:, rows]),
            "db": (mine.bias.grad, one.bias.grad)}


def _layer_world(rank, n):
    group = make_mesh(1, 1, n, device="cpu").get_group("model")
    out = {}
    for mode in MODES:
        for kind, dt in DT.items():
            for split in ("column", "row"):
                pairs = _layer_case(rank, n, group, mode, dt, split)
                out[mode, kind, split] = {
                    k: (a.detach().float().numpy(), b.detach().float().numpy())
                    for k, (a, b) in pairs.items()}
    return out


@pytest.fixture(scope="module")
def layer_worlds():
    return {n: spawn(_layer_world, n, (n,), threads=1) for n in TP}


def _int8_only(what, mode):
    """Whether ``what`` comes from int8 products alone: the forward, and
    the input and weight gradients with ``"fwd_bwd"``."""
    return what == "y" or (mode == "fwd_bwd" and what in ("dx", "dw"))


def _assert_layer_close(got, want, what, kind, exact):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif kind == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("kind", list(DT))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", TP)
def test_int8_dense_tp_matches_one_process(layer_worlds, n, mode, kind,
                                           split):
    for r in layer_worlds[n]:
        for what, (got, want) in r[mode, kind, split].items():
            _assert_layer_close(got, want, what, kind, _int8_only(what, mode))


@functools.lru_cache(maxsize=None)
def _jax_layer(n, mode, kind, split):
    """The JAX ``Int8Dense`` on the layer case's weights and inputs, its
    kernel (and, row-parallel, its input) placed over ``n`` virtual CPU
    devices: the full ``y``, ``dx``, ``dw`` (torch layout) and ``db``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_snvbert_tpu.ops import quant as jquant
    from rag_snvbert_tpu.parallel.mesh import make_mesh as jmesh

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, K)).astype(np.float32)
    c = rng.standard_normal((2, 13, N)).astype(np.float32)
    w = rng.standard_normal((N, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[kind]
    layer = jquant.Int8Dense(N, dtype=dt, mode=mode)

    def loss(p, xx):
        y = layer.apply({"params": p}, xx)
        return jnp.sum(y.astype(jnp.float32) * c), y

    mesh = jmesh(n_data=1, n_index=1, n_model=n,
                 devices=jax.devices("cpu")[:n])
    put = lambda a, *spec: jax.device_put(  # noqa: E731
        a, NamedSharding(mesh, P(*spec)))
    col = split == "column"
    params = {"kernel": put(w.T, None, "model") if col
              else put(w.T, "model", None), "bias": put(b, "model")
              if col else put(b)}
    xx = put(jnp.asarray(x, dt), *((None,) * 3 if col
                                   else (None, None, "model")))
    with jax.set_mesh(mesh):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, xx)
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return {"y": f(y), "dx": f(gx), "dw": f(gp["kernel"]).T,
            "db": f(gp["bias"])}


@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("kind", list(DT))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", TP)
def test_int8_dense_tp_matches_jax_gspmd(layer_worlds, n, mode, kind,
                                         split):
    """The JAX layer under GSPMD and each rank's tp layer: in bf16 the
    same bits for what comes from int8 products alone; the float
    tolerances for the float products, summed in other orders, and for
    float32, whose rescales XLA's CPU compiler rounds otherwise under jit
    (GSPMD's results equal the one-device jit's bit for bit here, and
    test_torch_quant.py holds the port's layer to JAX's op-by-op results
    bit for bit)."""
    full = _jax_layer(n, mode, kind, split)
    for rank, r in enumerate(layer_worlds[n]):
        cols = slice(rank * N // n, (rank + 1) * N // n)
        rows = slice(rank * K // n, (rank + 1) * K // n)
        if split == "column":
            want = {"y": full["y"][..., cols], "dx": full["dx"],
                    "dw": full["dw"][cols], "db": full["db"][cols]}
        else:
            want = {"y": full["y"], "dx": full["dx"][..., rows],
                    "dw": full["dw"][:, rows], "db": full["db"]}
        for what, (got, _) in r[mode, kind, split].items():
            _assert_layer_close(got, want[what], what, kind, kind == "bf16"
                                and _int8_only(what, mode))


# ---- the model ----

def _loss(outs):
    return sum((t.float() * torch.from_numpy(w)).sum()
               for t, w in zip(outs, _loss_weights(outs)))


def _model_world(rank, n, trees):
    """Per model case: this rank's tp model's eval outputs and full
    gradients (rank 0 only) beside the one-process model's."""
    mesh = make_mesh(1, 1, n, device="cpu")
    out = {}
    for case in MODELS:
        xs = _torch_batch(MODELS[case][0])
        res = []
        for sharded in (False, True):
            m = load_flax_params(tconfig.build_model(
                _model_cfg(case), 9, device="cpu"), trees[case])
            if sharded:
                m = tp.shard_model(m, mesh)
            y = m(xs)
            _loss(y).backward()
            grads = {k: p.grad for k, p in m.named_parameters()}
            if sharded:
                grads = tp.gather_full(grads, mesh)
            res.append(([t.detach().float().numpy() for t in y],
                        {k: v.numpy() for k, v in grads.items()}))
        out[case] = res if rank == 0 else None
    return out


@functools.lru_cache(maxsize=None)
def _trees():
    return {case: flax_tree(_model_cfg(case)) for case in MODELS}


@pytest.fixture(scope="module")
def model_worlds():
    return {n: spawn(_model_world, n, (n, _trees()), threads=1)[0]
            for n in TP}


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """Per JAX model case and tp size: the GSPMD run's outputs and
    gradients (by torch name, in the torch layout)."""
    import jax
    import jax.numpy as jnp

    from rag_snvbert_tpu import config as jconfig
    from rag_snvbert_tpu.parallel.mesh import make_mesh as jmesh
    from rag_snvbert_tpu.parallel.tp import shard_tree
    from test_torch_tp_split import _jax_loss
    from test_torch_train import _flat, _key

    runs = {}
    for case in JAX_MODELS:
        dims, heads, quant = MODELS[case]
        jm = jconfig.RunConfig(model=jconfig.ModelConfig(
            dims=dims, n_layers=2, attn_heads=heads, seq_len=40,
            int8_matmuls=quant)).build_model(9)
        x = {k: jnp.asarray(v) for k, v in _batch_np(dims=dims).items()}
        fn = jax.jit(jax.value_and_grad(
            functools.partial(_jax_loss, jm), has_aux=True))
        for n in TP:
            mesh = jmesh(n_data=1, n_index=1, n_model=n,
                         devices=jax.devices("cpu")[:n])
            with jax.set_mesh(mesh):
                (_, outs), grads = fn(shard_tree(_trees()[case], mesh), x)
            flat = _flat(jax.tree.map(np.asarray, grads))
            runs[case, n] = ([np.asarray(o, np.float32) for o in outs],
                             {_key(p): (g.T if p[-1] == "kernel" else g)
                              for p, g in flat.items()})
    return runs


def _assert_model_close(got, want, out_tol=OUT_TOL, grad_tol=GRAD_TOL):
    (gy, gg), (wy, wg) = got, want
    for i, (a, b) in enumerate(zip(wy, gy)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=out_tol * max(1.0, np.abs(a).max()),
                                   err_msg=f"output {i}")
    assert sorted(gg) == sorted(wg)
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in wg.values()))
    for k, g in wg.items():
        rel = np.linalg.norm(gg[k] - g) / max(np.linalg.norm(g),
                                              1e-4 * total)
        assert rel <= grad_tol, (k, rel)


@pytest.mark.parametrize("case", list(MODELS))
@pytest.mark.parametrize("n", TP)
def test_int8_model_tp_matches_one_process(model_worlds, n, case):
    one, mine = model_worlds[n][case]
    _assert_model_close(mine, one)


@pytest.mark.parametrize("case", JAX_MODELS)
@pytest.mark.parametrize("n", TP)
def test_int8_model_tp_matches_jax_gspmd(model_worlds, n, case):
    _assert_model_close(model_worlds[n][case][1], _jax_runs()[case, n],
                        JAX_OUT_TOL, JAX_GRAD_TOL)
