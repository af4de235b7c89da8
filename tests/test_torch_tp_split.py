"""Tensor parallelism that splits a head (``parallel/tp.py``,
``MultiHeadAttention.head_split``): 3 heads of 16 (dims 48, FFN hidden
192, 2 layers) at tp2 and tp4, where a rank's columns cover part of a head
(tp2: heads 0-1 and 1-2; tp4: 0, 0-1, 1-2, 2).

Each rank of a gloo world (``parallel.launch.spawn``) loads the same
flax-layout weights (seeded, every leaf perturbed; ``interop``) and is
held, at rtol 1e-5 (``|a - b|max / (1 + |a|max)``, as
tests/test_torch_tp.py), to:

  - the JAX package's model placed by ``tp_shardings`` over the same
    number of the 8 virtual CPU devices (GSPMD): the eval forward, every
    parameter's gradient of one loss and the gradient's global norm (the
    optimizer's clip norm); the attention key biases, whose gradient is
    zero in exact arithmetic, only to under 1e-5 of the largest gradient
    entry on both sides;
  - the port's replicated model: the forward in eval and in training
    with dropout 0.1 on (one seeded generator each), and the gradients and
    clip norm in training.

Cases: separate query/key/value, fused ``qkv``, the fused-attention route
(the plain version of the kernel on the CPU; JAX takes its einsum path
there) and ``remat=True`` (the recompute repeats the gather).  The
flash and remat cases load the separate-projection tree and are held to
its JAX results (neither changes a number in exact arithmetic).
"""

import functools

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.interop.flax_params import flax_params_of
from rag_snvbert_tpu_torch.models.layers import set_dropout_generator
from rag_snvbert_tpu_torch.parallel import tp
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.train.schedule import make_optimizer

DIMS, LAYERS, HEADS, VOCAB, L, B = 48, 2, 3, 9, 40, 2
TOL = 1e-5
TP = (2, 4)
# case -> (flax tree, ModelConfig fields)
CASES = {"qkv3": ("qkv3", {}),
         "fused": ("fused", dict(fused_qkv=True)),
         "flash": ("qkv3", dict(flash_attention=True, attn_dropout=0.0)),
         "remat": ("qkv3", dict(remat=True))}
# (first head, own columns' offset in it, own columns) of each rank
SPLITS = {2: [(0, 0, 24), (1, 8, 24)],
          4: [(0, 0, 12), (0, 12, 12), (1, 8, 12), (2, 4, 12)]}


def _batch_np(dims=DIMS, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    return {"hap_1": rng.integers(1, VOCAB, (B, L)).astype(np.int32),
            "hap_2": rng.integers(1, VOCAB, (B, L)).astype(np.int32),
            "pos": f(B, L), "af": f(B, L), "af_p": f(B, L), "ref": f(B, L),
            "het": f(B, L), "hom": f(B, L),
            "rag_emb_h1": f(B, 1, L, dims), "rag_emb_h2": f(B, 1, L, dims)}


def _loss_weights(outs):
    """The loss is ``sum_i sum(out_i * w_i)``: a linear functional, whose
    gradients stay at the scale of the weights (a sum of squares would
    square the outputs' scale into them)."""
    return [np.random.default_rng(100 + i).standard_normal(
        tuple(o.shape)).astype(np.float32) for i, o in enumerate(outs)]


def _model_kw(tree):
    return dict(dims=DIMS, n_layers=LAYERS, attn_heads=HEADS, seq_len=L,
                fused_qkv=tree == "fused")


# ---- the JAX side (main process only: the ranks never import JAX) ----

def _jax_loss(model, params, x):
    import jax.numpy as jnp

    outs = model.apply({"params": params}, x, deterministic=True)
    return sum(jnp.sum(o.astype(jnp.float32) * w)
               for o, w in zip(outs, _loss_weights(outs))), outs


def flax_tree(cfg, seed=0):
    """Flax-layout weights of ``cfg``: the port's seeded model with 0.1
    normal noise on every float tensor (biases and norms included), so
    that every leaf matters; no JAX init to compile."""
    model = tconfig.build_model(cfg, VOCAB, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.is_floating_point():
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            if name.endswith(".var"):           # FrozenBatchNorm: > 0
                t.abs_().add_(0.5)
    return flax_params_of(model)


def _global_norm(flat: dict) -> float:
    """optax's ``global_norm`` (the clip norm), in float64 on the host."""
    return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in flat.values())))


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """Per flax tree: its weights (numpy) and, per tp size, the GSPMD
    run's outputs, gradients (flat, by flax path) and their global
    norm."""
    import jax
    import jax.numpy as jnp

    from rag_snvbert_tpu import config as jconfig
    from rag_snvbert_tpu.parallel.mesh import make_mesh as jmesh
    from rag_snvbert_tpu.parallel.tp import shard_tree
    from test_torch_train import _flat

    x = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    runs = {}
    for tree in ("qkv3", "fused"):
        params = flax_tree(tconfig.RunConfig(model=tconfig.ModelConfig(
            **_model_kw(tree))))
        jm = jconfig.RunConfig(model=jconfig.ModelConfig(
            **_model_kw(tree))).build_model(VOCAB)
        fn = jax.jit(jax.value_and_grad(
            functools.partial(_jax_loss, jm), has_aux=True))
        runs[tree] = {"params": params}
        for n in TP:
            mesh = jmesh(n_data=1, n_index=1, n_model=n,
                         devices=jax.devices("cpu")[:n])
            with jax.set_mesh(mesh):
                (_, outs), grads = fn(shard_tree(params, mesh), x)
            flat = _flat(jax.tree.map(np.asarray, grads))
            runs[tree][n] = {
                "outs": [np.asarray(o, np.float32) for o in outs],
                "grads": flat, "norm": _global_norm(flat)}
    return runs


# ---- the port's ranks ----

def _torch_batch(dims=DIMS):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in _batch_np(dims).items()}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / (1 + a.abs().max()))


def _world(rank, n, trees):
    mesh = make_mesh(1, 1, n, device="cpu")
    x = _torch_batch()
    return {case: _case(rank, mesh, trees[tree], x, kw)
            for case, (tree, kw) in CASES.items()}


def _case(rank, mesh, params, x, kw):
    """This rank's tp model against the replicated one (same weights), eval
    and train; rank 0 also returns the eval outputs and the full
    gradients of the eval loss for the JAX comparison."""
    cfg = tconfig.RunConfig(model=tconfig.ModelConfig(
        **{**_model_kw("fused" if kw.get("fused_qkv") else "qkv3"), **kw}))

    def build():
        return load_flax_params(tconfig.build_model(cfg, VOCAB, device="cpu"),
                                params)

    ref, model = build(), tp.shard_model(build(), mesh)
    att = model.bert.encoder.block_0.attention
    out = {"split": att.head_split, "heads": att.local_heads,
           "drop_heads": att.attn_drop.heads}
    for mode in ("eval", "train"):
        ys = []
        for m in (ref, model):
            m.train(mode == "train")
            m.zero_grad()
            set_dropout_generator(m, torch.Generator().manual_seed(7))
            y = m(x)
            sum((t.float() * torch.from_numpy(w)).sum()
                for t, w in zip(y, _loss_weights(y))).backward()
            ys.append([t.detach() for t in y])
        out[mode] = max(_rel(a, b) for a, b in zip(*ys))
        full = tp.gather_full({k: p.grad for k, p in
                               model.named_parameters()}, mesh)
        out[mode + "_grad"] = max(_rel(p.grad, full[k])
                                  for k, p in ref.named_parameters())
        opt = make_optimizer(model)
        opt.set_tensor_parallel(mesh.get_group("model"),
                                tp.sharded_flags(model))
        out[mode + "_norm"] = float(opt.grad_norm())
        out[mode + "_ref_norm"] = float(make_optimizer(ref).grad_norm())
        if mode == "eval" and rank == 0:
            out["outs"] = [t.float().numpy() for t in ys[1]]
            out["grads"] = {k: v.numpy() for k, v in full.items()}
    return out


@pytest.fixture(scope="module")
def worlds():
    trees = {t: r["params"] for t, r in _jax_runs().items()}
    return {n: spawn(_world, n, (n, trees), threads=1) for n in TP}


@pytest.fixture(params=[(n, c) for n in TP for c in CASES],
                ids=[f"tp{n}-{c}" for n in TP for c in CASES])
def run(worlds, request):
    n, case = request.param
    return n, CASES[case][0], [r[case] for r in worlds[n]]


def test_ranks_run_the_heads_their_columns_touch(run):
    n, _, ranks = run
    for r, (h0, off, cols) in zip(ranks, SPLITS[n]):
        h1 = -(-(h0 * 16 + off + cols) // 16)
        assert r["split"] == (h0, off, cols)
        assert r["heads"] == h1 - h0 and r["drop_heads"] == (h0, h1, HEADS)


def test_forward_matches_jax_gspmd(run):
    n, tree, ranks = run
    want = _jax_runs()[tree][n]["outs"]
    for a, b in zip(want, ranks[0]["outs"]):
        assert _rel(torch.from_numpy(a), torch.from_numpy(b)) < TOL


def test_forward_matches_replicated_eval_and_dropout_on(run):
    for r in run[2]:
        assert r["eval"] < TOL and r["train"] < TOL, r


def test_gradients_match_jax_gspmd_and_replicated(run):
    from test_torch_train import _key, _to_flax

    n, tree, ranks = run
    want = _jax_runs()[tree][n]["grads"]
    got = ranks[0]["grads"]
    assert sorted(map(_key, want)) == sorted(got)
    top = max(float(np.abs(g).max()) for g in want.values())
    for path, g in want.items():
        mine = _to_flax(path, torch.from_numpy(got[_key(path)]))
        if path[-2:] == ("key", "bias"):
            # zero in exact arithmetic (softmax ignores a shift shared by
            # all keys): float32 noise on both sides
            assert max(np.abs(mine).max(), np.abs(g).max()) < TOL * top
            continue
        assert _rel(torch.from_numpy(g), torch.from_numpy(mine)) < TOL, path
    for r in ranks:
        assert r["eval_grad"] < TOL and r["train_grad"] < TOL, r


def test_clip_norm_matches_jax_gspmd_and_replicated(run):
    n, tree, ranks = run
    want = _jax_runs()[tree][n]["norm"]
    for r in ranks:
        assert abs(r["eval_norm"] - want) / want < TOL
        for mode in ("eval", "train"):
            assert abs(r[mode + "_norm"] - r[mode + "_ref_norm"]) \
                / r[mode + "_ref_norm"] < TOL, r
