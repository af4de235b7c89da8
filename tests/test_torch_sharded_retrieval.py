"""Sharded in-training retrieval of the port (``train/sharded_retrieval.py``)
in a gloo world of four CPU ranks: the sharded context equals the
replicated one, the retrieved embeddings equal the single-process
``retrieve``'s and the JAX package's (rtol/atol 1e-5), both merges agree,
the gradients flow and equal the single-process ones, and a dp2 x idx2
mesh retrieves each data rank's rows.  Mirrors
tests/test_sharded_retrieval.py at its shapes (N = 37 rows, not a multiple
of the shard count)."""

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.train.retrieval import encode_window_refs, retrieve
from rag_snvbert_tpu_torch.train.sharded_retrieval import (
    encode_window_refs_sharded, retrieve_sharded)

B, L, D, N, V = 4, 48, 16, 37, 9
TOL = 1e-5


def _data():
    rng = np.random.default_rng(0)
    return {"ref_tokens": rng.integers(5, 7, (N, L)).astype(np.int64),
            "ref_af": rng.random(L, dtype=np.float32),
            "wmask": np.r_[0, rng.integers(0, 2, L - 1)].astype(np.int64),
            "hap_1": rng.integers(0, V, (B, L)).astype(np.int64),
            "hap_2": rng.integers(0, V, (B, L)).astype(np.int64),
            "af": rng.random((B, L), dtype=np.float32)}


def _jax_model_and_params():
    import jax

    from rag_snvbert_tpu.models import (BERTFoundationModel,
                                        BERTWithEmbeddingRAG, init_batch)

    model = BERTFoundationModel(bert=BERTWithEmbeddingRAG(
        vocab_size=V, dims=D, n_layers=1, attn_heads=2))
    params = jax.jit(model.init)(jax.random.key(0),
                                 init_batch(1, L, D))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port_model(params):
    m = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=D, n_layers=1, attn_heads=2, seq_len=L)), V, device="cpu")
    return load_flax_params(m, params).eval()


def _err(a, b):
    return float((a - b).abs().max())


def _world(rank, params):
    x = {k: torch.from_numpy(v) for k, v in _data().items()}
    model = _port_model(params)
    batch = {k: x[k] for k in ("hap_1", "hap_2", "af")}
    out = {}
    mesh = make_mesh(1, 4, 1, device="cpu")
    sctx = encode_window_refs_sharded(model.embed, x["ref_tokens"],
                                      x["ref_af"], x["wmask"], mesh,
                                      dtype=torch.float32)
    ctx = encode_window_refs(model.embed, x["ref_tokens"], x["ref_af"],
                             x["wmask"], dtype=torch.float32)
    lo = rank * sctx.rows_per_shard
    n_mine = max(0, min(N - lo, sctx.rows_per_shard))
    out["ctx"] = _err(sctx.ref_emb_search[:n_mine],
                      ctx.ref_emb_search[lo: lo + n_mine])
    out["pad_inf"] = bool(torch.isinf(sctx.ref_norms[n_mine:]).all())
    want = retrieve(model.embed, batch, ctx, k=2, use_kernel=False)
    for merge in ("all_gather", "ring"):
        got = retrieve_sharded(model.embed, batch, sctx, k=2, merge=merge)
        out[merge] = max(_err(got[h], want[h])
                         for h in ("rag_emb_h1", "rag_emb_h2", "query_emb"))
    out["rag_emb_h1"] = got["rag_emb_h1"].detach().numpy()
    # gradients through the query embedding and the re-embedding
    grads = []
    for fn, c in ((retrieve_sharded, sctx), (retrieve, ctx)):
        model.zero_grad()
        o = fn(model.embed, batch, c, k=1)
        (o["rag_emb_h1"].sum() + o["rag_emb_h2"].sum()
         + o["query_emb"].square().sum()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    out["grad_total"] = sum(float(g.abs().sum()) for g in grads[0].values())
    out["grad"] = max(_err(grads[0][n], grads[1][n]) for n in grads[1])
    out["grad_names"] = sorted(grads[0]) == sorted(grads[1])
    # dp2 x idx2: each data rank searches its own rows against both shards
    mesh2 = make_mesh(2, 2, 1, device="cpu")
    d = mesh2.get_local_rank("data")
    sctx2 = encode_window_refs_sharded(model.embed, x["ref_tokens"],
                                       x["ref_af"], x["wmask"], mesh2,
                                       dtype=torch.float32)
    rows = slice(d * B // 2, (d + 1) * B // 2)
    mine = {k: v[rows] for k, v in batch.items()}
    with torch.no_grad():
        got = retrieve_sharded(model.embed, mine, sctx2, k=2)
        ref = retrieve(model.embed, mine, ctx, k=2, use_kernel=False)
    out["dp_idx"] = _err(got["rag_emb_h1"], ref["rag_emb_h1"])
    return out


@pytest.fixture(scope="module")
def world():
    jm, params = _jax_model_and_params()
    return jm, params, spawn(_world, 4, (params,), threads=1)


def test_sharded_ctx_matches_replicated(world):
    for r in world[2]:
        assert r["ctx"] <= TOL and r["pad_inf"]


@pytest.mark.parametrize("merge", ["all_gather", "ring"])
def test_sharded_retrieval_matches_single_device(world, merge):
    for r in world[2]:
        assert r[merge] <= TOL, r[merge]


def test_sharded_retrieval_matches_jax(world):
    """The same embeddings as the JAX package's single-device retrieve on
    the same weights and inputs."""
    import jax.numpy as jnp

    from rag_snvbert_tpu.train.retrieval import (encode_window_refs as jenc,
                                                 retrieve as jret)

    jm, params, runs = world
    x = _data()

    def embed_fn(p, toks, af, deterministic=True, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    ctx = jenc(embed_fn, params, jnp.asarray(x["ref_tokens"], jnp.int32),
               jnp.asarray(x["ref_af"]), jnp.asarray(x["wmask"], jnp.int32),
               dtype=jnp.float32)
    batch = {k: jnp.asarray(x[k], jnp.int32 if k != "af" else jnp.float32)
             for k in ("hap_1", "hap_2", "af")}
    out = jret(embed_fn, params, batch, ctx, k=2, use_pallas=False)
    np.testing.assert_allclose(runs[0]["rag_emb_h1"],
                               np.asarray(out["rag_emb_h1"]),
                               rtol=TOL, atol=TOL)


def test_sharded_retrieval_gradients_flow(world):
    for r in world[2]:
        assert r["grad_total"] > 0.0 and r["grad_names"]
        assert r["grad"] <= TOL, r["grad"]


def test_dp_by_index_mesh_retrieves_each_data_ranks_rows(world):
    for r in world[2]:
        assert r["dp_idx"] <= TOL, r["dp_idx"]
