"""``l2_topk_float``'s plain version against the TPU kernel it replaces
(``l2_topk_pallas(..., interpret=True)``: float32 through the query-first
route with two d tiles, bf16 through the refs-outer route), the wrapper's
CPU routing and errors, and the host-side plans of ``csrc/l2_topk_float.cu``.

Tolerances: the Pallas kernel orders by distance quantized to 2048 ULP
(relative 2^-12, l2_topk_pallas.py:35-42) and returns the quantized value,
so values agree to twice that quantum (plus 1e-3 absolute near zero), and
where ids differ the exact distances of both rows lie within it.  On
integer-valued vectors the quantization is lossless: ids and values are
equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.ops import l2_ref as jl2
from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.ops import l2_ref
from rag_snvbert_tpu_torch.ops.l2_topk_float import (l2_topk_float,
                                                     l2_topk_float_plain)

# the packages' ops/__init__ export functions of these modules' names
jpallas = importlib.import_module("rag_snvbert_tpu.ops.l2_topk_pallas")
lf = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_float")
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
QUANTUM = 2.0 ** -12


def _case(b, n, d, seed, binary):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.integers(0, 2, (b, d)).astype(np.float32),
                rng.integers(0, 2, (n, d)).astype(np.float32))
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


# float32: d = 1100 makes two 1024-column d tiles -> the query-first route;
# bf16: d = 200 fits one tile -> the refs-outer route (l2_topk_pallas.py:
# 608-634).
SHAPES = {"f32": (9, 300, 1100), "bf16": (9, 300, 200)}


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "gauss"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(dtype, binary, k):
    b, n, d = SHAPES[dtype]
    q, r = _case(b, n, d, seed=k, binary=binary)
    jdt, tdt = DT[dtype]
    rj = jnp.asarray(r, jdt)
    rn = np.array(jl2.squared_norms(rj))
    rn[-5:] = np.inf                       # padding rows: never ahead
    pv, pi = jpallas.l2_topk_pallas(jnp.asarray(q), rj, jnp.asarray(rn), k,
                                    interpret=True)
    pv, pi = np.asarray(pv), np.asarray(pi)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r).to(tdt)
    tv, ti = l2_topk_float_plain(qt, rt, torch.from_numpy(rn), k)
    tv, ti = tv.numpy(), ti.numpy()
    if binary:
        np.testing.assert_array_equal(ti, pi)
        np.testing.assert_array_equal(tv, pv)
        return
    np.testing.assert_allclose(pv, tv, rtol=2 * QUANTUM, atol=1e-3)
    full = l2_ref.l2_distances(qt.to(tdt).float(), rt.float(),
                               r_norms=torch.from_numpy(rn)).numpy()
    picked = np.take_along_axis(full, pi, axis=1)
    np.testing.assert_allclose(picked, tv, rtol=2 * QUANTUM, atol=1e-3)
    assert (pi < n - 5).all() and (ti < n - 5).all()


@pytest.mark.parametrize("chunk", [7, 64, 65536])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_chunks_give_the_oracle(dtype, chunk, monkeypatch):
    """Chunked over ref rows or whole, the plain version is ``l2_ref``'s
    oracle (the same float32 arithmetic per row) with its tie rule."""
    monkeypatch.setattr(lf, "_PLAIN_CHUNK", chunk)
    q, r = _case(6, 150, 37, seed=1, binary=True)
    tdt = DT[dtype][1]
    qt, rt = torch.from_numpy(q), torch.from_numpy(r).to(tdt)
    rn = l2_ref.squared_norms(rt)
    rn[[3, 90]] = float("inf")
    v, i = l2_topk_float_plain(qt, rt, rn, 20)
    ov, oi = l2_ref.l2_topk(qt.to(tdt), rt, 20, r_norms=rn)
    assert torch.equal(i, oi) and torch.equal(v, ov)


def test_plain_ranks_inf_rows_last_in_id_order_and_pads_past_n():
    q, r = _case(2, 6, 16, seed=2, binary=False)
    rn = l2_ref.squared_norms(torch.from_numpy(r))
    rn[[1, 4]] = float("inf")
    v, i = l2_topk_float_plain(torch.from_numpy(q), torch.from_numpy(r),
                               rn, 9)
    assert i[:, 4:].tolist() == [[1, 4, -1, -1, -1]] * 2
    assert torch.isinf(v[:, 4:]).all() and torch.isfinite(v[:, :4]).all()


def test_wrapper_takes_the_plain_version_on_the_cpu_uncounted():
    q, r = _case(3, 40, 24, seed=3, binary=False)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r).to(torch.bfloat16)
    rn = l2_ref.squared_norms(rt)
    ops.reset_launches()
    got = l2_topk_float(qt, rt, rn, 5)
    want = l2_topk_float_plain(qt, rt, rn, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert ops.launch_counts()["l2_topk_float"] == 0


def _bad(case):
    r = torch.zeros(10, 8)
    q = torch.zeros(2, 8)
    rn = torch.zeros(10)
    return {"int8 refs": (q, r.to(torch.int8), rn, 3),
            "integer queries": (q.to(torch.int32), r, rn, 3),
            "k 0": (q, r, rn, 0),
            "k 129": (q, r, rn, 129),
            "d mismatch": (torch.zeros(2, 9), r, rn, 3),
            "norms float64": (q, r, rn.double(), 3),
            "norms shape": (q, r, rn[:9], 3)}[case]


@pytest.mark.parametrize("case", ["int8 refs", "integer queries", "k 0",
                                  "k 129", "d mismatch", "norms float64",
                                  "norms shape"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="l2_topk_float"):
        l2_topk_float(*_bad(case))


@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 64, 65, 96, 97, 100,
                               128])
def test_block_config_fits_shared_memory(k):
    """Lists of 16 entries for k <= 16, else k rounded up to 32; the
    deepest ring of 64 KB stages (four 128-row panels: bf16 queries and
    refs over two chunks of d, float32 their TF32 hi and lo parts over one)
    that fits 232,448 bytes with them, one stage at least."""
    kp, stages = lf.block_config(k)
    assert kp >= k and (kp == 16 or kp % 32 == 0)
    assert kp == (16 if k <= 16 else -(-k // 32) * 32)
    assert 1 <= stages <= 4
    assert lf.smem_bytes(kp, stages) <= 232448
    assert stages == 4 or lf.smem_bytes(kp, stages + 1) > 232448
    # the ring shrinks as k grows; small k (the index's 10) is the deepest
    assert stages == {16: 3, 32: 3, 64: 2, 96: 2, 128: 1}[kp]


@pytest.mark.parametrize("b,n", [(1024, 664648), (1025, 200), (3, 50001),
                                 (1, 1), (65, 49153), (20000, 1000),
                                 (5, 0)])
def test_split_plan_covers_the_rows_in_one_wave(b, n):
    """Splits of whole 128-row tiles that cover every row once, in id
    order, and a grid of at most one block an SM (one split when the query
    tiles alone fill the card)."""
    splits, rows = lf.split_plan(b, n, 132)
    assert rows % 128 == 0 and rows > 0 and splits >= 1
    assert splits * rows >= n and (splits - 1) * rows < max(n, 1)
    covered = [range(s * rows, min((s + 1) * rows, n)) for s in range(splits)]
    assert [i for r in covered for i in r] == list(range(n))
    q_tiles = -(-b // 128)
    assert splits == 1 or q_tiles * splits <= 132
    if q_tiles * 2 <= 132 and n > 128 * 132:
        assert q_tiles * splits > 66       # at least half a wave


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,d", [(1024, 664648, 2040), (3, 50001, 40),
                                   (1, 1, 8), (129, 1 << 20, 4096),
                                   (5, 0, 8)])
def test_batch_plan_covers_the_rows_once_in_id_order(b, n, d, bf16):
    """bf16 in one batch; float32 in batches whose TF32 parts fit the
    workspace cap; each batch split as ``split_plan`` splits it."""
    plan = lf.batch_plan(b, n, d, bf16, 132)
    assert [r0 for r0, *_ in plan] == \
        [sum(p[1] for p in plan[:i]) for i in range(len(plan))]
    assert sum(p[1] for p in plan) == n
    for _, rows, splits, per in plan:
        assert (splits, per) == lf.split_plan(b, rows, 132)
        assert bf16 or rows * d * 8 <= max(lf._SPLIT_BYTES, 128 * d * 8)
    assert len(plan) == (0 if n == 0 else 1 if bf16
                         else -(-n // plan[0][1]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_padded_width_gives_16_byte_rows(dtype):
    """d rounded up to 8 columns: a row stride that is a multiple of 16
    bytes in either dtype, what a TMA tensor map needs."""
    size = DT[dtype][1].itemsize
    widths = [lf.padded_width(d) for d in (1, 8, 37, 2040, 2048)]
    assert widths == [8, 8, 40, 2040, 2048]
    assert all(w * size % 16 == 0 for w in widths)
