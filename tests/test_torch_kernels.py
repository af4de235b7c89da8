"""The kernels' plain versions against the JAX package: attention against
the splash-attention Pallas kernel (interpret mode) and the einsum path;
L2 top-k against ``l2_ref`` and against ``l2_topk_pallas`` (interpret
mode).  On the CPU the wrappers run exactly these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.models.transformer import _splash_attention
from rag_snvbert_tpu.ops import l2_ref as jl2
from rag_snvbert_tpu.ops.l2_topk_pallas import l2_topk_pallas
from rag_snvbert_tpu_torch.ops import l2_ref as tl2
from rag_snvbert_tpu_torch.ops.attention import attention, attention_plain
from rag_snvbert_tpu_torch.ops.l2_topk import l2_topk, l2_topk_plain, split_plan
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)


def _einsum_attention(q, k, v, scale):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1),
                      v.astype(jnp.float32))


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,block", [
    ((1, 2, 50, 32), 128),      # ragged L, padded to one 128 block in-kernel
    ((2, 1, 130, 128), 128),    # ragged L across two blocks, head dim 128
])
def test_attention_plain_matches_splash_interpret(shape, block):
    q, k, v = _qkv(shape)
    scale = shape[-1] ** -0.5
    ref = _splash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, block=block, interpret=True)
    out = attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    # splash scales q before the product and both sum in float32 in other
    # orders: agreement to 2e-4, as tests/test_model_shapes.py holds splash
    # to the XLA reference.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_plain_matches_einsum_path(dtype):
    q, k, v = _qkv((2, 3, 37, 64), seed=1)
    scale = 64 ** -0.5
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = _einsum_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale)
    out = attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale)
    assert out.dtype == tdt
    # float32: summation order only.  bf16: same bf16 inputs and float32
    # math on both sides; the port rounds its output to bf16 (2^-8 rel).
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _l2_case(b, n, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:   # exact arithmetic on both sides: ids must be identical
        r = rng.integers(0, 3, (n, d)).astype(np.float32)
        q = rng.integers(0, 3, (b, d)).astype(np.float32)
        r[n // 2: n // 2 + 4] = r[:4]           # exact ties, lower id wins
        q[:4] = r[:4]
    else:
        r = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    rn = (r.astype(np.float64) ** 2).sum(1).astype(np.float32)
    rn[-7:] = np.inf                            # padding rows
    return q, r, rn


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_l2_plain_matches_l2_ref(k, integer):
    q, r, rn = _l2_case(9, 200, 48, seed=k, integer=integer)
    jv, ji = jl2.l2_topk(jnp.asarray(q), jnp.asarray(r), k, jnp.asarray(rn))
    tv, ti = l2_topk(*map(torch.from_numpy, (q, r, rn)), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # same float32 formula, other summation order in the matmul
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-3)
    assert (ti.numpy() < 200 - 7).all()         # +inf rows never win
    if integer:
        # duplicated rows tie exactly: the lower id comes first
        assert ti[:4, 0].tolist() == [0, 1, 2, 3]
        if k > 1:
            assert ti[:4, 1].tolist() == [100, 101, 102, 103]


def test_l2_plain_ranks_padding_rows_last_in_id_order():
    q, r, rn = _l2_case(3, 20, 16, seed=0)
    _, ti = l2_topk_plain(*map(torch.from_numpy, (q, r, rn)), 20)
    np.testing.assert_array_equal(ti[:, -7:].numpy(),
                                  np.tile(np.arange(13, 20), (3, 1)))


@pytest.mark.parametrize("k", [1, 5, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("td", [128, None])     # multi-d-tile | single tile
def test_l2_plain_matches_pallas_interpret(td, dtype, k):
    q, r, rn = _l2_case(8, 300, 260, seed=3)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rj = jnp.asarray(r, jdt)
    rn = np.array(jl2.squared_norms(rj))
    rn[-7:] = np.inf
    pv, pi = l2_topk_pallas(jnp.asarray(q, jdt), rj, jnp.asarray(rn), k,
                            tq=8, tn=128, td=td, interpret=True)
    pv, pi = np.asarray(pv), np.asarray(pi)
    qt, rt = torch.from_numpy(q).to(tdt), torch.from_numpy(r).to(tdt)
    tv, ti = l2_topk(qt, rt, torch.from_numpy(rn), k)
    tv, ti = tv.numpy(), ti.numpy()
    # The Pallas kernel orders by distance quantized to 2048 ULP (relative
    # 2^-12, l2_topk_pallas.py:35-42) and returns the quantized value:
    # values agree to that quantum, and where ids differ the two rows'
    # exact distances lie within one quantum of each other.
    quantum = 2.0 ** -12
    np.testing.assert_allclose(pv, tv, rtol=2 * quantum, atol=1e-3)
    full = tl2.l2_distances(qt.float(), rt.float(),
                            r_norms=torch.from_numpy(rn)).numpy()
    picked = np.take_along_axis(full, pi, axis=1)
    np.testing.assert_allclose(picked, tv, rtol=2 * quantum, atol=1e-3)
    for row in pi:
        assert len(set(row.tolist())) == k
    assert (pi < 300 - 7).all() and (ti < 300 - 7).all()


def test_split_plan_covers_d_exactly():
    for b, n, d in [(64, 2048, 1030 * 384), (5, 300, 520), (64, 64, 8)]:
        splits, chunk = split_plan(b, n, d, sm_count=132)
        assert chunk % 64 == 0 and splits * chunk >= d
        assert (splits - 1) * chunk < d
