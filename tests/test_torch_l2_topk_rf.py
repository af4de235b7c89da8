"""The port's int8 refs-outer top-k (``ops.l2_topk_rf``) and planar
packing (``ops.planar``) against the JAX package on the CPU.

``l2_topk_rf_plain`` is held to ``l2_topk_pallas(..., interpret=True)``,
run as tests/test_pallas_kernel.py runs it, with integer inputs: ids and
distances must be exactly equal.  Inputs come from numpy with fixed seeds.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.ops.l2_topk_pallas import (l2_topk_pallas, pack_planar,
                                                planar_sq_norms,
                                                planar_unpack)
from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.ops import planar
from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                  l2_topk_rf_plain,
                                                  split_plan, unpacked_width)
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

# Values each pack admits; pack 1 stays inside what the TPU kernel takes
# exactly (|q| <= 63 after its query pre-doubling, distances < 2^20 - 1).
HI = {1: 16, 2: 16, 4: 4, 8: 2}


@pytest.mark.parametrize("pack", [2, 4, 8])
def test_planar_packing_is_bit_identical_to_jax(pack):
    rng = np.random.default_rng(pack)
    v = rng.integers(0, 1 << (8 // pack), (37, 301)).astype(np.int8)
    want = np.asarray(pack_planar(v, pack))
    got = planar.pack_planar(torch.from_numpy(v), pack)
    assert got.dtype == torch.int8 and got.shape[1] == \
        planar.packed_width(301, pack)
    np.testing.assert_array_equal(got.numpy(), want)
    for d in (301, got.shape[1] * pack):
        np.testing.assert_array_equal(
            planar.planar_unpack(got, pack, d).numpy(),
            np.asarray(planar_unpack(jnp.asarray(want), pack, d)))
    np.testing.assert_array_equal(
        planar.planar_sq_norms(got, pack).numpy(),
        np.asarray(planar_sq_norms(jnp.asarray(want), pack)))


def _case(pack, seed, b=9, n=300, d=203, lo=0):
    """int8 queries and refs with duplicated rows (exact ties), queries
    planted on rows, two +inf rows; refs planar-packed for pack > 1."""
    rng = np.random.default_rng(seed)
    r = rng.integers(lo, HI[pack], (n, d)).astype(np.int8)
    r[n // 2: n // 2 + 4] = r[:4]
    q = rng.integers(lo, HI[pack], (b, d)).astype(np.int8)
    q[:3] = r[:3]
    rn = (r.astype(np.int64) ** 2).sum(1).astype(np.float32)
    rn[[5, n - 10]] = np.inf
    refs = r if pack == 1 else np.asarray(pack_planar(r, pack))
    return q, refs, rn


@pytest.mark.parametrize("k", [1, 5, 128])
@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_plain_matches_pallas_interpret_exactly(pack, k):
    q, refs, rn = _case(pack, 10 * pack + k, lo=-16 if pack == 1 else 0)
    jv, ji = l2_topk_pallas(jnp.asarray(q), jnp.asarray(refs),
                            jnp.asarray(rn), k, pack=pack, interpret=True)
    tv, ti = l2_topk_rf_plain(torch.from_numpy(q), torch.from_numpy(refs),
                              torch.from_numpy(rn), k, pack=pack)
    # integer distances on both sides: exactly equal
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    # the duplicated rows tie: the lower id comes first
    assert ti[0, 0].item() == 0


def test_int4_compute_matches_pallas_interpret():
    q, refs, rn = _case(4, 3)
    jv, ji = l2_topk_pallas(jnp.asarray(q), jnp.asarray(refs),
                            jnp.asarray(rn), 7, pack=4, compute=jnp.int4,
                            interpret=True)
    tv, ti = l2_topk_rf(torch.from_numpy(q), torch.from_numpy(refs),
                        torch.from_numpy(rn), 7, pack=4, compute="int4")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _oracle(q, r, rn, k):
    """Brute force in Python integers: (dist, id) order, +inf rows after
    every finite row, (+inf, -1) past the last row."""
    out_v, out_i = [], []
    for qi in q.astype(np.int64):
        keys = []
        for j, rj in enumerate(r.astype(np.int64)):
            dist = np.inf if np.isinf(rn[j]) else float(
                int((qi * qi).sum()) + int(rn[j]) - 2 * int((qi * rj).sum()))
            keys.append((dist, j))
        keys.sort()
        keys = keys[:k] + [(np.inf, -1)] * max(0, k - len(keys))
        out_v.append([v for v, _ in keys])
        out_i.append([i for _, i in keys])
    return np.float32(out_v), np.int32(out_i)


@pytest.mark.parametrize("b,n,d,k", [
    (5, 70, 31, 10),      # the whole int8 range, an odd d
    (3, 6, 1, 10),        # fewer rows than k
    (4, 40, 17, 40),      # every row returned, +inf rows last in id order
])
def test_plain_matches_brute_force(b, n, d, k):
    rng = np.random.default_rng(n)
    r = rng.integers(-128, 128, (n, d)).astype(np.int8)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    rn = (r.astype(np.int64) ** 2).sum(1).astype(np.float32)
    rn[n // 3] = np.inf
    ov, oi = _oracle(q, r, rn, k)
    tv, ti = l2_topk_rf(torch.from_numpy(q), torch.from_numpy(r),
                        torch.from_numpy(rn), k)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_array_equal(tv.numpy(), ov)


def test_plain_chunks_keep_the_tie_order(monkeypatch):
    """The plain version merges its row chunks with a stable sort: ties
    across a chunk border keep the lower id first."""
    import importlib

    mod = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_rf")
    q, refs, rn = _case(8, 5, n=700)
    whole = l2_topk_rf_plain(torch.from_numpy(q), torch.from_numpy(refs),
                             torch.from_numpy(rn), 50, pack=8)
    monkeypatch.setattr(mod, "_PLAIN_CHUNK", 64)
    chunked = l2_topk_rf_plain(torch.from_numpy(q), torch.from_numpy(refs),
                               torch.from_numpy(rn), 50, pack=8)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, refs, rn = _case(2, 4)
    ops.reset_launches()
    got = l2_topk_rf(torch.from_numpy(q), torch.from_numpy(refs),
                     torch.from_numpy(rn), 4, pack=2)
    want = l2_topk_rf_plain(torch.from_numpy(q), torch.from_numpy(refs),
                            torch.from_numpy(rn), 4, pack=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.launch_counts()["l2_topk_rf"] == 0


BAD = {
    "pack 3": (dict(pack=3), "pack must be"),
    "compute": (dict(compute="fp8"), "compute must be"),
    "int4 at pack 2": (dict(pack=2, compute="int4"), "pack >= 4"),
    "k 0": (dict(k=0), "k=0"),
    "k 129": (dict(k=129), "k=129"),
    "float queries": (dict(q_dtype=torch.float32), "int8"),
    "d mismatch": (dict(d_q=100), "queries d=100"),
    "packed width": (dict(pack=4, width=200), "multiple of 128"),
    "norms": (dict(norms_dtype=torch.float64), "r_norms"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_wrapper_rejects_bad_arguments(name):
    kw, match = BAD[name]
    width = kw.get("width", 128)
    q = torch.zeros(3, kw.get("d_q", width), dtype=kw.get("q_dtype",
                                                          torch.int8))
    refs = torch.zeros(16, width, dtype=torch.int8)
    norms = torch.zeros(16, dtype=kw.get("norms_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        l2_topk_rf(q, refs, norms, kw.get("k", 2), pack=kw.get("pack", 1),
                   compute=kw.get("compute"))


@pytest.mark.parametrize("b,n,sms", [(64, 2048, 132), (1024, 664648, 132),
                                     (1, 5, 132), (33, 4100, 8)])
def test_split_plan_covers_every_row_once(b, n, sms):
    splits, rows = split_plan(b, n, sms)
    assert rows % 192 == 0 and splits >= 1       # whole 192-row tiles
    assert (splits - 1) * rows < n <= splits * rows
    assert splits <= max(1, sms)                 # one wave of blocks


def test_unpacked_width():
    assert unpacked_width(1030, 1030, 1) == 1152
    assert unpacked_width(1, 1, 1) == 128
    assert unpacked_width(2040, 256, 8) == 2048
    assert planar.packed_width(2040, 8) == 256
    assert planar.packed_width(301, 2) == 256
