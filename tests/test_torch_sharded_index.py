"""The port's row-sharded index (``index/sharded.py``) in gloo worlds of 2
and 4 CPU ranks, held against the JAX package's ``ShardedFlatL2Index`` on
the virtual CPU mesh and against the port's single-process search: the
same ids (near-ties excepted, as in tests/test_sharded_index.py), the
distances within 1e-3.  Mirrors tests/test_sharded_index.py."""

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.index.flat import FlatL2Index
from rag_snvbert_tpu_torch.index.sharded import ShardedFlatL2Index
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh, replicated

TOL = 1e-3


def _cases():
    """name -> (refs, queries, k, build kwargs), made from seeds; every
    row count leaves the shards uneven."""
    rng = np.random.default_rng(0)
    g = np.random.default_rng(5)
    cases = {
        "normal": (rng.standard_normal((1001, 64)).astype(np.float32),
                   rng.standard_normal((23, 64)).astype(np.float32), 10, {}),
        "near_dup": None,
        "large_k": (rng.standard_normal((901, 40)).astype(np.float32),
                    rng.standard_normal((6, 40)).astype(np.float32), 200, {}),
        "clamped_k": (rng.standard_normal((13, 24)).astype(np.float32),
                      rng.standard_normal((5, 24)).astype(np.float32), 6, {}),
        "pack1": (g.integers(0, 2, (403, 130)).astype(np.float32),
                  g.integers(0, 2, (9, 130)).astype(np.float32), 5, {}),
        "pack2": (g.integers(0, 16, (403, 130)).astype(np.float32),
                  g.integers(0, 16, (9, 130)).astype(np.float32), 5,
                  {"pack": 2}),
        "pack8": (g.integers(0, 2, (403, 130)).astype(np.float32),
                  g.integers(0, 2, (9, 130)).astype(np.float32), 5,
                  {"pack": 8}),
    }
    r = rng.standard_normal((131, 32)).astype(np.float32)
    cases["near_dup"] = (r, r[:7] + 1e-4, 5, {})
    return cases


def _world(rank, n_shards):
    """Every case on one rank of a 1 x n_shards x 1 mesh, both merges;
    returns the results and the single-process search's."""
    mesh = make_mesh(1, n_shards, 1, device="cpu")
    # replicated: rank 0's values on every rank
    out = {"replicated": float(replicated(mesh, torch.tensor([rank + 0.5])))}
    for name, (r, q, k, kw) in _cases().items():
        idx = ShardedFlatL2Index.build(mesh, r, device="cpu", **kw)
        for merge in ("all_gather", "ring"):
            v, i = idx.search(q, k, merge=merge)
            out[name, merge] = (v.numpy(), i.numpy())
        store = ({"pack": kw["pack"]} if "pack" in kw else {})
        src = r.astype(np.int8) if "pack" in kw else r
        v, i = FlatL2Index.build(src, device="cpu", **store).search(q, k)
        out[name, "single"] = (v.numpy(), i.numpy())
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def world(request):
    results = spawn(_world, request.param, (request.param,), threads=1)
    for other in results[1:]:            # every rank holds the same answer
        for key, res in results[0].items():
            if key == "replicated":
                assert other[key] == res == 0.5
                continue
            np.testing.assert_array_equal(other[key][1], res[1])
            np.testing.assert_array_equal(other[key][0], res[0])
    return request.param, results[0]


def _jax_search(n_shards, name, merge):
    import jax

    from rag_snvbert_tpu.index.sharded import ShardedFlatL2Index as JaxIndex
    from rag_snvbert_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(n_data=1, n_index=n_shards,
                    devices=jax.devices("cpu")[:n_shards])
    r, q, k, kw = _cases()[name]
    idx = JaxIndex.build(mesh, r.astype(np.int8) if "pack" in kw else r,
                         **kw)
    v, i = idx.search(q, k=k, use_pallas=False, merge=merge)
    return np.asarray(v), np.asarray(i)


def _assert_match(vals, ids, ref_vals, ref_ids):
    np.testing.assert_allclose(vals, ref_vals, rtol=TOL, atol=TOL)
    mismatch = ids != ref_ids
    if mismatch.any():       # an id may differ only at a (near-)tie
        assert np.allclose(vals[mismatch], ref_vals[mismatch], atol=TOL)


def _numpy_topk(q, r, k):
    d = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, axis=1), ids


@pytest.mark.parametrize("merge", ["all_gather", "ring"])
@pytest.mark.parametrize("name", ["normal", "near_dup", "large_k",
                                  "clamped_k", "pack1", "pack2", "pack8"])
def test_sharded_ids_match_jax_and_single(world, name, merge):
    n_shards, res = world
    vals, ids = res[name, merge]
    r, q, k, _ = _cases()[name]
    assert vals.shape == ids.shape == (q.shape[0], k)
    assert (ids >= 0).all() and (ids < r.shape[0]).all()
    jv, ji = _jax_search(n_shards, name, merge)
    _assert_match(vals, ids, jv, ji)
    sv, si = res[name, "single"]
    _assert_match(vals, ids, sv, si)
    nv, ni = _numpy_topk(q, r, k)
    _assert_match(vals, ids, nv, ni)


@pytest.mark.parametrize("name", ["normal", "large_k", "pack8"])
def test_ring_merge_equals_all_gather(world, name):
    _, res = world
    np.testing.assert_array_equal(res[name, "ring"][1],
                                  res[name, "all_gather"][1])
    np.testing.assert_array_equal(res[name, "ring"][0],
                                  res[name, "all_gather"][0])


def test_clamp_filler_never_becomes_a_row():
    """A shard of fewer than k rows pads with (+inf, -1); offsetting the
    filler must leave it -1, not the previous shard's last row."""
    from rag_snvbert_tpu_torch.index.sharded import _global_ids, _local_topk

    def search(q, kk):
        return (torch.zeros(q.shape[0], kk),
                torch.arange(kk, dtype=torch.int32).expand(q.shape[0], kk))

    v, i = _local_topk(search, torch.zeros(2, 3), rows=2, k=4)
    assert torch.isinf(v[:, 2:]).all() and (i[:, 2:] == -1).all()
    g = _global_ids(i, shard=3, rows_per_shard=2)
    assert g[0].tolist() == [6, 7, -1, -1]
