"""The attention backward's plain version and ``AttentionFn`` against
``jax.grad`` through the splash-attention Pallas kernel (interpret mode, as
tests/test_model_shapes.py runs it), at ragged L (one case one past the
forward kernel's key tile) and head dims 32 and 128.
On the CPU ``AttentionFn`` runs ``attention_fwd_plain`` and
``attention_bwd_plain``: these tests hold its wiring (saved tensors, scale,
output dtypes, no gradient for ``scale``) as well as the arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.models.transformer import _splash_attention
from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.ops.attention import (
    LOG2E, AttentionFn, attention, attention_bwd_plain, attention_fwd_plain)
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

# L = 177 is one past the forward kernel's 176-key tile, where its last
# tile holds a single valid key.
CASES = [((1, 2, 50, 32), 128), ((2, 1, 130, 128), 128),
         ((1, 1, 177, 128), 128)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _splash_grads(q, k, v, do, scale, block):
    def loss(q_, k_, v_):
        out = _splash_attention(q_, k_, v_, scale, block=block,
                                interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("shape,block", CASES)
def test_plain_backward_and_attention_fn_match_splash_grad(shape, block):
    q, k, v, do = _inputs(shape, seed=shape[2])
    scale = shape[-1] ** -0.5
    want = _splash_grads(q, k, v, do, scale, block)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = attention_fwd_plain(tq, tk, tv, scale)
    plain = attention_bwd_plain(tq, tk, tv, out, lse, tdo, scale)

    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    ops.reset_launches()
    attention(*leaves, scale).backward(tdo)
    assert ops.launch_counts()["attention_bwd"] == 0   # CPU: plain version
    # Splash scales q before the product and runs its fused dq/dkv kernel
    # in float32 in another summation order; the plain version recomputes
    # P from the LSE.  Both sides are float32: agreement to 2e-4 of the
    # largest gradient (observed ~1e-6), as test_kernels holds the forward.
    for name, w, p, leaf in zip("qkv", want, plain, leaves):
        tol = 2e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"plain d{name}")
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"AttentionFn d{name}")


def test_lse_is_base_two_log_sum_exp_of_scaled_scores():
    q, k, v, _ = _inputs((2, 3, 37, 64), seed=1)
    scale = 0.125
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)) * LOG2E
    _, lse = attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), scale)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 37)
    # float32 log-sum-exp of the same products, other summation order
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_attention_fn_wiring_in_bf16():
    """bf16 leaves get bf16 gradients, the forward saves (q, k, v, out,
    lse) with the scale, and ``scale`` gets no gradient."""
    q, k, v, do = _inputs((1, 2, 20, 32), seed=2)
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_()
              for x in (q, k, v)]
    out = AttentionFn.apply(*leaves, 0.3)
    assert out.dtype == torch.bfloat16
    q_s, k_s, v_s, o_s, lse_s = out.grad_fn.saved_tensors
    for a, b in zip((q_s, k_s, v_s), leaves):
        assert a.data_ptr() == b.data_ptr()
    assert torch.equal(o_s, out.detach()) and lse_s.dtype == torch.float32
    assert out.grad_fn.scale == 0.3
    tdo = torch.from_numpy(do).bfloat16()
    out.backward(tdo, retain_graph=True)
    want = attention_bwd_plain(*[x.detach() for x in leaves], o_s, lse_s,
                               tdo, 0.3)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)
    grads = out.grad_fn.apply(tdo)
    assert len(grads) == 4 and grads[3] is None


def test_attention_without_grad_saves_nothing():
    q, k, v, _ = _inputs((1, 1, 9, 32), seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = attention(tq, tk, tv, 0.2)
    assert out.grad_fn is None
    with torch.inference_mode():
        assert torch.equal(attention(tq, tk, tv, 0.2), out)
