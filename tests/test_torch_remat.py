"""``remat`` in the port (``models/transformer.py``, ``layers.checkpoint``)
against the JAX package's ``nn.remat`` and against the port without remat.

At the smoke width (64d, 2 layers, 2 heads, seq_len 138), float32:
  - each of the four modes, on the einsum path (attention dropout set, run
    without dropout) and on the fused-attention route (the plain attention
    on the CPU), against the JAX encoder with the same ``remat`` on the
    same numpy-seeded parameters and input: the forward within rtol 1e-5
    (atol 1e-5 for entries near zero) and every parameter's gradient
    within 1e-4 relative L2 (test_torch_train.py's tolerances; the key
    biases, whose true gradient is zero, near zero on both sides);
  - each mode against ``remat=False`` with residual and attention dropout
    0.1 drawn from a seeded generator: loss, every gradient and the
    generator's state after backward equal bit for bit (V18 and the V17
    token model, whose folded re-encode runs through the same encoder);
  - two ``train_step``s of ``tpu_scan`` cut to this size, bit-identical
    to ``tpu_default``'s;
  - tp2 (two gloo ranks) with each mode equal to tp2 without remat;
  - a ``scan_layers=True, remat=True`` JAX tree (``tpu_scan``'s layout)
    loads into the port and gives the JAX loss (rtol 1e-5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.models import transformer as jtr
from rag_snvbert_tpu.train import losses as jlosses
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.models import transformer as ttr
from rag_snvbert_tpu_torch.models.layers import set_dropout_generator
from rag_snvbert_tpu_torch.parallel import tp
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.train import losses as tlosses
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    _perturb, torch_one_thread)
from test_torch_train import _flat, _key, _to_flax

MODES = [True, "save_ffn", "attention", "save_most"]
ROUTES = {"einsum": dict(attn_dropout=0.1),
          "fused": dict(attn_dropout=0.0, flash="splash")}
B, L, D, LAYERS, HEADS, V = 2, 138, 64, 2, 2, 9


def _assert_grads_match(named, jgrads):
    """Every parameter's gradient within 1e-4 relative L2 of the JAX one,
    against the larger of its own norm and 1e-4 of the whole gradient's
    (test_torch_train.py's rule).  The attention key biases are held
    apart: their gradient is zero in exact arithmetic (softmax is
    invariant to a shift shared by all keys), so both sides hold float32
    rounding noise there (observed ~1e-8 of the whole gradient's norm,
    differing between the remat modes of the JAX package itself); each
    side's must be under 1e-7 of the whole."""
    flat = _flat(jgrads)
    assert sorted(map(_key, flat)) == sorted(named)
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in flat.values()))
    for p, g in flat.items():
        mine = _to_flax(p, named[_key(p)].grad)
        if p[-2:] == ("key", "bias"):
            assert max(np.linalg.norm(mine), np.linalg.norm(g)) \
                <= 1e-7 * total, (_key(p), total)
            continue
        rel = np.linalg.norm(mine - g) / max(np.linalg.norm(g), 1e-4 * total)
        assert rel <= 1e-4, (_key(p), rel)


@functools.lru_cache(maxsize=None)
def _encoder_params(route):
    x = jnp.zeros((B, L, D), jnp.float32)
    jenc = jtr.Encoder(LAYERS, D, HEADS, pre_ln=True, **ROUTES[route])
    return _perturb(jax.jit(jenc.init)(jax.random.key(0), x)["params"])


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mode", MODES)
def test_encoder_remat_matches_jax(mode, route):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    w = rng.standard_normal((B, L, D)).astype(np.float32)
    params = _encoder_params(route)
    jenc = jtr.Encoder(LAYERS, D, HEADS, pre_ln=True, remat=mode,
                       **ROUTES[route])

    @jax.jit
    def fwd_grad(p):
        def f(p_):
            y = jenc.apply({"params": p_}, jnp.asarray(x))
            return jnp.sum(y * w), y
        return jax.value_and_grad(f, has_aux=True)(p)

    (_, jy), jgrads = fwd_grad(params)
    kw = dict(ROUTES[route])
    kw["flash"] = bool(kw.get("flash"))
    tenc = load_flax_params(ttr.Encoder(LAYERS, D, HEADS, pre_ln=True,
                                        remat=mode, **kw), params)
    tenc.eval()                     # no dropout; grad on: the checkpoints run
    ty = tenc(torch.from_numpy(x))
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    _assert_grads_match(dict(tenc.named_parameters()), jgrads)


# ---- the port with remat against the port without ----

def _v18_batch(rng, dims=D, length=L):
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))  # noqa: E731
    toks = lambda *s: torch.from_numpy(rng.integers(1, V, s))  # noqa: E731
    batch = {k: f(B, length) for k in ("pos", "af", "af_p", "ref", "het",
                                       "hom")}
    return {"hap_1": toks(B, length), "hap_2": toks(B, length), **batch,
            "rag_emb_h1": f(B, 1, length, dims),
            "rag_emb_h2": f(B, 1, length, dims)}


def _v17_batch(rng, k=2):
    batch = _v18_batch(rng)
    for h in ("h1", "h2"):
        del batch[f"rag_emb_{h}"]
        batch[f"rag_seg_{h}"] = torch.from_numpy(rng.integers(1, V,
                                                               (B, k, L)))
    return batch


def _model(rag_mode, remat, route, tp_dims=None):
    kw = dict(ROUTES[route])
    dims, heads = tp_dims or (D, HEADS)
    cfg = tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=dims, n_layers=LAYERS, attn_heads=heads, seq_len=L,
        pre_ln=True, rag_mode=rag_mode, remat=remat, dropout=0.1,
        attn_dropout=kw["attn_dropout"],
        flash_attention=kw.get("flash", False)))
    return tconfig.build_model(cfg, V, device="cpu", seed=0).train()


def _loss_grads_state(model, batch):
    gen = torch.Generator().manual_seed(5)
    set_dropout_generator(model, gen)
    outs = model(batch)
    loss = sum(t.float().square().mean() for t in outs)
    loss.backward()
    set_dropout_generator(model, None)
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            gen.get_state())


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("rag_mode", ["embedding", "token"])
def test_remat_changes_no_bit_with_dropout_on(rag_mode, route):
    batch = (_v18_batch if rag_mode == "embedding" else _v17_batch)(
        np.random.default_rng(3))
    loss, grads, state = _loss_grads_state(_model(rag_mode, False, route),
                                           batch)
    assert all(g is not None for g in grads.values())
    for mode in MODES:
        got = _loss_grads_state(_model(rag_mode, mode, route), batch)
        assert torch.equal(got[0], loss), mode
        for name, g in grads.items():
            assert torch.equal(got[1][name], g), (mode, name)
        assert torch.equal(got[2], state), mode


def test_tpu_scan_train_steps_equal_tpu_default():
    """Two train_steps (retrieval, dropout 0.1 broadcast along the
    sequence, bf16, the fused-attention route, an Adam update each) of
    ``tpu_scan`` and ``tpu_default`` cut to the smoke width: every
    parameter bit-identical after each."""
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train import step as tstep
    from rag_snvbert_tpu_torch.train.retrieval import encode_window_refs
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer

    b = make_bundle(n_train_samples=6, n_ref_samples=12, n_sites=128,
                    n_windows=1, seed=7)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=L)
    meta = ds.windows[0]
    batch = {k: torch.from_numpy(v) for k, v in ds.make_batch(
        meta, np.arange(4), 2, 3, packed=True).items()}
    toks, af, valid = ds.window_ref_tokens(meta, pad_haps_to=32)
    runs = []
    for preset in ("tpu_default", "tpu_scan"):
        c = tconfig.PRESETS[preset]
        cfg = dataclasses.replace(c, model=dataclasses.replace(
            c.model, dims=D, n_layers=LAYERS, attn_heads=HEADS, seq_len=L))
        model = tconfig.build_model(cfg, b.vocab.size, device="cpu", seed=0)
        assert [blk.remat for blk in model.bert.encoder.children()] == \
            [c.model.remat] * LAYERS
        opt = make_optimizer(model, 1e-3, 2e-3, 10)
        losses = []
        for i in range(2):
            model.eval()
            ctx = encode_window_refs(
                model.embed, torch.from_numpy(toks).long(),
                torch.from_numpy(af),
                torch.from_numpy(ds.window_mask(meta, 2, 3)),
                valid=torch.from_numpy(valid))
            stats = tstep.train_step(model, opt, batch, ctx,
                                     tstep.StepConfig(),
                                     tstep.step_generator(0, i, "cpu"))
            losses.append(stats["loss"])
        runs.append((losses, [p.detach().clone()
                               for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _tp_remat_world(rank):
    """tp2: each mode against no remat, dropout on, einsum and fused
    routes; returns whether outputs and full gradients are equal."""
    mesh = make_mesh(1, 1, 2, device="cpu")
    batch = _v18_batch(np.random.default_rng(3), dims=32, length=48)
    out = {}
    for route in ROUTES:
        ref = None
        for mode in [False] + MODES:
            model = tp.shard_model(_model("embedding", mode, route,
                                          tp_dims=(32, 4)), mesh)
            gen = torch.Generator().manual_seed(7)
            set_dropout_generator(model, gen)
            outs = model(batch)
            sum(t.float().square().sum() for t in outs).backward()
            grads = tp.gather_full({n: p.grad for n, p in
                                    model.named_parameters()}, mesh)
            got = ([t.detach() for t in outs], grads, gen.get_state())
            if ref is None:
                ref = got
                continue
            out[(route, str(mode))] = (
                all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
                and all(torch.equal(got[1][n], g) for n, g in ref[1].items())
                and torch.equal(got[2], ref[2]))
    return out


def test_tp2_remat_equals_tp2_without():
    """The recompute repeats the forward's row-parallel all-reduces
    inside the backward pass, on both ranks alike."""
    for rank_result in spawn(_tp_remat_world, 2, threads=1):
        assert len(rank_result) == 2 * len(MODES)
        assert all(rank_result.values()), rank_result


def test_scanned_remat_jax_tree_loads_and_gives_the_jax_loss():
    """``tpu_scan``'s tree (``scan_layers=True``: the blocks stacked under
    ``encoder/blocks``), float32, cut to the smoke width: the port's
    ``tpu_scan`` model loads it and its loss, with remat and grad on, is
    the JAX model's."""
    c = jconfig.PRESETS["tpu_scan"]
    jcfg = dataclasses.replace(c, model=dataclasses.replace(
        c.model, dims=D, n_layers=LAYERS, attn_heads=HEADS, seq_len=L,
        bf16=False, score_bf16=False))
    rng = np.random.default_rng(4)
    batch = {k: v.numpy() for k, v in _v18_batch(rng).items()}
    labels = {"hap_1": rng.integers(0, 2, (B, L)),
              "hap_2": rng.integers(0, 2, (B, L)),
              "gt": rng.integers(0, 4, (B, L))}
    mask = rng.integers(0, 2, (B, L))
    jm = jcfg.build_model(V)
    jx = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _perturb(jax.jit(jm.init)(jax.random.key(0), jx)["params"])
    assert "blocks" in params["bert"]["encoder"]
    jouts = jax.jit(jm.apply)({"params": params}, jx)
    jloss, _ = jlosses.total_loss(
        list(jouts), {k: jnp.asarray(v) for k, v in labels.items()},
        jnp.asarray(mask))
    tm = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(jcfg.model))), V, device="cpu")
    load_flax_params(tm, params)
    assert all(blk.remat is True for blk in tm.bert.encoder.children())
    tloss, _ = tlosses.total_loss(
        tm({k: torch.from_numpy(v) for k, v in batch.items()}),
        {k: torch.from_numpy(v) for k, v in labels.items()},
        torch.from_numpy(mask))
    assert tloss.requires_grad
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
