"""Tensor parallelism of the port (``parallel/tp.py``): the JAX package's
Megatron placement rules over the port's parameter names, Adam's moments
split like the parameters, indivisible dims refused (a head count that
the model axis does not divide shards, as in JAX), and a tp4 world (gloo,
four CPU ranks) whose forward and gradients equal the replicated model's
at rtol/atol 1e-5.  Mirrors tests/test_tp.py:29-105."""

import types

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.models.layers import set_dropout_generator
from rag_snvbert_tpu_torch.parallel import tp
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import AXES, make_mesh
from rag_snvbert_tpu_torch.train.schedule import make_optimizer

DIMS, LAYERS, HEADS, VOCAB, L = 32, 2, 4, 9, 48
TOL = 1e-5


def _model(fused_qkv=False, heads=HEADS, dims=DIMS, seed=0):
    cfg = tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=dims, n_layers=LAYERS, attn_heads=heads, seq_len=L,
        fused_qkv=fused_qkv))
    return tconfig.build_model(cfg, VOCAB, device="cpu", seed=seed)


def _batch(b=2, seed=3, dims=DIMS):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))  # noqa: E731
    return {"hap_1": torch.from_numpy(rng.integers(1, VOCAB, (b, L))),
            "hap_2": torch.from_numpy(rng.integers(1, VOCAB, (b, L))),
            "pos": f(b, L), "af": f(b, L), "af_p": f(b, L), "ref": f(b, L),
            "het": f(b, L), "hom": f(b, L),
            "rag_emb_h1": f(b, 1, L, dims), "rag_emb_h2": f(b, 1, L, dims)}


def test_megatron_specs_match_jax_on_port_names():
    """Every leaf: the port's spec on its torch name is the JAX spec on the
    flax path, with a kernel's two dims reversed ([in, out] -> [out, in])."""
    import jax

    from rag_snvbert_tpu.models import (BERTFoundationModel,
                                        BERTWithEmbeddingRAG, init_batch)
    from rag_snvbert_tpu.parallel.tp import spec_for_path

    jm = BERTFoundationModel(bert=BERTWithEmbeddingRAG(
        vocab_size=VOCAB, dims=DIMS, n_layers=LAYERS, attn_heads=HEADS))
    # shapes are all the rules read: no weights are computed
    params = jax.eval_shape(jm.init, jax.random.key(0),
                            init_batch(1, L, DIMS))["params"]
    jspec = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [str(getattr(e, "key", e)) for e in path]
        leafname = {"kernel": "weight", "scale": "weight",
                    "embedding": "weight"}.get(names[-1], names[-1])
        spec = tuple(spec_for_path(path, leaf))
        spec = spec + (None,) * (leaf.ndim - len(spec))
        if names[-1] == "kernel" and leaf.ndim == 2:
            spec = spec[::-1]
        jspec[".".join(names[:-1] + [leafname])] = spec
    tm = _model()
    names = dict(tm.named_parameters())
    assert set(jspec) <= set(tm.state_dict())
    for name, spec in jspec.items():
        if name in names:
            assert tp.spec_for_name(name, names[name].dim()) == spec, name
    s = tp.spec_for_name
    b0 = "bert.encoder.block_0."
    assert s(b0 + "attention.query.weight", 2) == ("model", None)
    assert s(b0 + "attention.query.bias", 1) == ("model",)
    assert s(b0 + "attention.output.weight", 2) == (None, "model")
    assert s(b0 + "attention.output.bias", 1) == (None,)
    assert s(b0 + "feed_forward.w_1.weight", 2) == ("model", None)
    assert s(b0 + "feed_forward.w_2.weight", 2) == (None, "model")
    assert s(b0 + "feed_forward.LayerNorm_0.weight", 1) == ("model",)
    assert s(b0 + "LayerNorm_0.weight", 1) == (None,)
    assert s("bert.embedding.Embed_0.weight", 2) == (None, None)


def _stub_mesh(n_model):
    return types.SimpleNamespace(mesh_dim_names=AXES, shape=(1, 1, n_model))


def test_indivisible_dims_fail_loudly():
    with pytest.raises(ValueError, match="divide"):
        tp.shard_model(_model(), _stub_mesh(3))          # 32 % 3 != 0


def _tp3_heads_world(rank):
    model = tp.shard_model(_model(dims=48), make_mesh(1, 1, 3, device="cpu"))
    with torch.no_grad():
        y = model(_batch(dims=48))
    return model.bert.encoder.block_0.attention.head_split, y


def test_indivisible_heads_fail_loudly():
    """dims 48 and hidden 192 divide by 3; 4 heads do not, and the model
    shards all the same, as the JAX package's does (only indivisible
    parameter dims raise): a rank's 16 columns split a head of 12, and
    the tp3 forward is the replicated model's."""
    with torch.no_grad():
        want = _model(dims=48)(_batch(dims=48))
    runs = spawn(_tp3_heads_world, 3, threads=1)
    assert [r[0] for r in runs] == [(0, 0, 16), (1, 4, 16), (2, 8, 16)]
    for _, y in runs:
        for a, b in zip(want, y):
            assert float((a - b).abs().max() / (1 + a.abs().max())) < TOL


def _tp_world(rank):
    mesh = make_mesh(1, 1, 4, device="cpu")
    return {fused: _tp_case(mesh, fused) for fused in (False, True)}


def _tp_case(mesh, fused):
    """Forward and backward of a tp4 model and of the replicated one (the
    same weights), dropout on and drawn from one seed; returns the largest
    differences and the shapes of Adam's moments."""
    ref = _model(fused)
    model = tp.shard_model(_model(fused), mesh)
    opt = make_optimizer(model)
    moments_ok = all(m.shape == p.shape for m, p in zip(opt.mu, opt.params))
    sharded = dict(zip(opt.names, tp.sharded_flags(model)))
    x = _batch()
    out = {}
    for mode in ("eval", "train"):
        outs = []
        for m in (ref, model):
            m.train(mode == "train")
            m.zero_grad()
            set_dropout_generator(m, torch.Generator().manual_seed(7))
            y = m(x)
            sum(t.float().square().sum() for t in y).backward()
            outs.append(y)
        out[mode] = max(float((a - b).abs().max() / (1 + a.abs().max()))
                        for a, b in zip(*outs))
    full = tp.gather_full({n: p.grad for n, p in model.named_parameters()},
                          mesh)
    out["grad"] = max(float((p.grad - full[n]).abs().max()
                            / (1 + p.grad.abs().max()))
                      for n, p in ref.named_parameters())
    back = tp.gather_full(dict(model.state_dict()), mesh)
    out["gather"] = max(float((v - back[k]).abs().max())
                        for k, v in ref.state_dict().items())
    opt.set_tensor_parallel(mesh.get_group("model"),
                            tp.sharded_flags(model))
    want = float(make_optimizer(ref).grad_norm())
    out["norm"] = abs(float(opt.grad_norm()) - want) / want
    out["moments"] = moments_ok
    out["n_sharded"] = sum(sharded.values())
    return out


@pytest.fixture(scope="module")
def tp_runs():
    return spawn(_tp_world, 4, threads=1)


@pytest.fixture(params=[False, True], ids=["qkv3", "fused"])
def tp_world(tp_runs, request):
    return [r[request.param] for r in tp_runs]


def test_tp4_forward_matches_replicated(tp_world):
    for r in tp_world:
        assert r["eval"] < TOL and r["train"] < TOL, r


def test_tp4_gradients_match_replicated(tp_world):
    for r in tp_world:
        assert r["grad"] < TOL, r


def test_adam_moments_mirror_params(tp_world):
    """Moments are made from the split parameters; gathering the split
    parameters gives the replicated model's back exactly."""
    for r in tp_world:
        assert r["moments"] and r["gather"] == 0.0
        # per block: q/k/v (or qkv) weight+bias, output weight, w_1
        # weight+bias, w_2 weight, the FFN LayerNorm's weight+bias
        assert r["n_sharded"] in (LAYERS * 12, LAYERS * 8)


def test_shard_tensor_splits_fused_qkv_per_head_range():
    full = torch.arange(3 * 8).reshape(24, 1).float()   # [3D, in], D = 8
    got = tp.shard_tensor("bert.encoder.block_0.attention.qkv.weight",
                          full, 1, 2)
    assert got[:, 0].tolist() == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]
    parts = [tp.shard_tensor("x.encoder.block_0.attention.qkv.weight",
                             full, r, 2) for r in range(2)]
    thirds = [p.chunk(3) for p in parts]
    back = torch.cat([torch.cat([t[j] for t in thirds]) for j in range(3)])
    assert torch.equal(back, full)


def test_clip_norm_is_the_full_tensors_norm(tp_world):
    """The split leaves' squares are summed over the model group and the
    replicated ones added once: the replicated model's gradient norm."""
    for r in tp_world:
        assert r["norm"] < TOL, r
