"""The CUDA kernels against their plain versions on the card, at edge
shapes the serving path does not reach (ragged tiles, every head dim, odd
batch/row/d counts), their input checks, and a small model served on the
card against the same model on the CPU.

Marked ``cuda``; every test skips without a CUDA device.  On a machine
with one (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.ops import l2_ref
from rag_snvbert_tpu_torch.ops.attention import attention, attention_plain
from rag_snvbert_tpu_torch.ops.l2_topk import l2_topk, l2_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 32), (2, 3, 63, 64), (2, 3, 64, 128), (1, 2, 65, 128),
    (3, 1, 1030, 128), (1, 4, 200, 32),
])
def test_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_bf16(shape, gen, cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = ops.launch_counts()["attention"]
    out = attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["attention"] == before + 1
    ref = attention_plain(q, k, v, scale)
    # bf16 P operand and bf16 output: 2^-8 relative of |O| < ~4
    assert (out.float() - ref.float()).abs().max().item() <= 2 ** -6


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 1, 8, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        attention(x.float(), x.float(), x.float(), 1.0)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros(1, 1, 8, 96, device=cuda, dtype=torch.bfloat16)
        attention(y, y, y, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 1, 128, 8, device=cuda,
                        dtype=torch.bfloat16).transpose(2, 3)
        attention(t, t, t, 1.0)


@pytest.mark.parametrize("b,n,d,k", [
    (1, 1, 8, 1), (5, 300, 520, 3), (70, 130, 1000, 128), (64, 2048, 4096, 8),
])
def test_l2_kernel_matches_plain(cuda, b, n, d, k):
    gen = torch.Generator(device=cuda).manual_seed(1)
    refs = _bf16((n, d), gen, cuda)
    q = _bf16((b, d), gen, cuda)
    norms = l2_ref.squared_norms(refs)
    if n > 4:
        norms[-2:] = float("inf")
    vals, ids = l2_topk(q, refs, norms, k)
    torch.cuda.synchronize()
    rv, ri = l2_topk_plain(q, refs, norms, k)
    scale = l2_ref.squared_norms(q)[:, None] + norms[ri.long()].clamp_max(
        1e30)
    # float32 sums of d products in other orders, relative to the scale
    # of the norm expansion's terms
    assert ((vals - rv).abs() / scale).max().item() <= 2e-4
    full = l2_ref.l2_distances(q, refs, r_norms=norms)
    picked = torch.gather(full, 1, ids.long())
    assert ((picked - rv).abs() / scale).max().item() <= 2e-4


def test_l2_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    r = torch.zeros(16, 12, device=cuda, dtype=torch.bfloat16)
    n = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="d % 8"):
        l2_topk(r, r, n, 1)
    r = torch.zeros(16, 16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        l2_topk(r, r, n, 1)
    with pytest.raises(ValueError, match="k="):
        l2_topk(r.bfloat16(), r.bfloat16(), n, 17)


def test_small_model_serves_on_the_card_like_on_the_cpu(cuda):
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, flash_attention="splash"))
    b = make_bundle(n_train_samples=8, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    keep = np.random.default_rng(0).random(b.train.n_variants) > 0.5
    target = dataclasses.replace(
        b.train, gt=b.train.gt[keep], pos=b.train.pos[keep],
        chrom=b.train.chrom[keep], ref=b.train.ref[keep],
        alt=b.train.alt[keep], ids=b.train.ids[keep])
    kw = dict(seq_len=138, window_len=128, ref_pad_haps=64, batch_size=8)
    ops.reset_launches()
    on_card = Imputer(build_model(cfg, b.vocab.size, seed=1), b.ref, b.freq,
                      **kw).impute(target)
    assert ops.launch_counts() == {"attention": 2 * 2, "l2_topk": 2}
    on_cpu = Imputer(build_model(cfg, b.vocab.size, device="cpu", seed=1),
                     b.ref, b.freq, device="cpu", **kw).impute(target)
    miss = on_card.imputed_flag
    d = np.abs(on_card.hap1_prob[miss] - on_cpu.hap1_prob[miss])
    # bf16 on both sides, rounded at other places (card kernels vs CPU
    # plain math), two layers deep
    assert d.mean() <= 5e-3 and d.max() <= 0.05
