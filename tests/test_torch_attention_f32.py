"""The float32 attention kernels' CPU side (``ops/attention_f32.py``): the
plain forward and backward against autograd of the einsum path
(``MultiHeadAttention._core``) with the same keep mask; the mask's bits,
from the bool mask or from its draws; ``models.layers.keep_mask`` and
``keep_draws`` giving ``dropout``'s draws; the routing of
``MultiHeadAttention`` (float32 CUDA q, k, v of head dim 32, float32
scores and no mask take the op, handed the draws; nothing else does); the
wrapper's checks and ``AttentionF32Fn``'s plumbing.  The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.models import layers, transformer
from rag_snvbert_tpu_torch.models.transformer import MultiHeadAttention

# the module (``ops.attention_f32`` is its differentiable function)
af = importlib.import_module("rag_snvbert_tpu_torch.ops.attention_f32")

RATE = 0.1


def _qkv(shape, seed=0, requires_grad=False):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .requires_grad_(requires_grad) for _ in range(3)]


def _mha(heads, hd, rate, seed=0):
    """A float32 attention module in training, its dropout seeded."""
    mod = MultiHeadAttention(heads, heads * hd, dropout=rate).train()
    gen = torch.Generator().manual_seed(seed)
    layers.set_dropout_generator(mod, gen)
    return mod, gen


# V18 as published (12 heads of 32) and V17 (6 of 32); the plain versions
# take any head dim
@pytest.mark.parametrize("heads,hd", [(12, 32), (6, 32), (2, 64)])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("L", [1, 7, 70])
def test_plain_op_is_the_einsum_path(heads, hd, rate, L):
    mod, gen = _mha(heads, hd, rate, seed=L)
    q, k, v = _qkv((2, heads, L, hd), seed=heads + L, requires_grad=True)
    state = gen.get_state()
    keep = mod.attn_drop.keep((2, heads, L, L), q.device)
    assert (keep is None) == (rate == 0.0)
    gen.set_state(state)
    want = mod._core(q, k, v, None)        # draws the same mask
    do = _qkv((2, heads, L, hd), seed=99)[0]
    gw = torch.autograd.grad(want, (q, k, v), do)
    got = af.attention_f32(q, k, v, hd ** -0.5, keep, rate)
    gg = torch.autograd.grad(got, (q, k, v), do)
    # float32 on both sides: the einsum path divides by sqrt(hd) and drops
    # softmax(s); the op multiplies by the scale and, backward, recomputes
    # p from the LSE: rounding of a few float32 ulps a term
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_plain_halves_are_the_op_with_the_mask_as_bits():
    q, k, v = _qkv((2, 3, 40, 32), seed=1)
    keep = torch.rand(2, 3, 40, 40, generator=torch.Generator()
                      .manual_seed(2)) >= RATE
    out, lse, bits = af.attention_f32_fwd(q, k, v, 0.2, keep, RATE)
    want, want_lse = af.attention_f32_fwd_plain(q, k, v, 0.2, keep, RATE)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(bits, af.pack_keep_plain(keep))
    do = _qkv((2, 3, 40, 32), seed=3)[0]
    got = af.attention_f32_bwd(q, k, v, out, lse, do, 0.2, bits, RATE)
    ref = af.attention_f32_bwd_plain(q, k, v, out, lse, do, 0.2, keep, RATE)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # without a gradient to record there is no LSE, and without a mask no
    # bits
    out2, lse2, bits2 = af.attention_f32_fwd(q, k, v, 0.2, with_lse=False)
    assert lse2 is None and bits2 is None
    torch.testing.assert_close(out2, af.attention_f32_fwd_plain(
        q, k, v, 0.2)[0], rtol=0, atol=0)


def test_lse_is_base_two_of_the_scaled_scores():
    q, k, v = _qkv((1, 2, 9, 32), seed=4)
    _, lse = af.attention_f32_fwd_plain(q, k, v, 0.3)
    s = (q.double() @ k.double().transpose(-1, -2)) * 0.3
    want = torch.log2(torch.exp2(s * af.LOG2E).sum(-1))
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [1, 31, 32, 33, 63, 64, 65, 130, 1030])
def test_mask_bits_layout(L):
    keep = torch.rand(2, 3, L, generator=torch.Generator().manual_seed(L)) \
        >= 0.5
    bits = af.pack_keep_plain(keep)
    assert bits.dtype == torch.int32
    assert bits.shape == (2, 3, af.mask_words(L)) and bits.shape[-1] % 2 == 0
    assert torch.equal(af.unpack_keep_plain(bits, L), keep)
    # bit c % 32 of word c // 32 is column c; bits past L are 0
    words = bits.numpy().view(np.uint32).astype(np.int64)
    for c in (0, L // 2, L - 1):
        got = (words[..., c // 32] >> (c % 32)) & 1
        assert np.array_equal(got, keep[..., c].numpy().astype(np.int64))
    tail = af.unpack_keep_plain(bits, bits.shape[-1] * 32)[..., L:]
    assert not tail.any()
    assert torch.equal(af.pack_keep(keep), bits)     # the CPU: plain


def test_keep_mask_is_the_dropout_draw():
    x = torch.ones(3, 5, 8)
    for broadcast in (False, True):
        g1 = torch.Generator().manual_seed(7)
        g2 = torch.Generator().manual_seed(7)
        dropped = layers.dropout(x, RATE, g1, broadcast)
        keep = layers.keep_mask(x.shape, RATE, g2, x.device, broadcast)
        assert torch.equal((dropped != 0), keep.expand_as(x))
        # the generator ends where dropout left it
        assert torch.equal(g1.get_state(), g2.get_state())
    # the draw itself: torch.rand of the mask's shape, at least the rate
    g = torch.Generator().manual_seed(8)
    want = torch.rand(3, 5, 8, generator=g) >= RATE
    assert torch.equal(layers.keep_mask((3, 5, 8), RATE, torch.Generator()
                                        .manual_seed(8), "cpu"), want)


def test_keep_mask_rows_and_heads_are_the_whole_draws_slices():
    """Data parallelism draws the global batch and keeps the rank's rows;
    tensor parallelism draws every head and keeps the rank's."""
    shape = (2 * 3, 4, 5, 5)           # [2B, H, L, L] of B = 3 local rows
    rows = layers.BatchRows.stacked(3, 3, 6)
    whole = layers.keep_mask((2 * 6, 4, 5, 5), RATE,
                             torch.Generator().manual_seed(9), "cpu")
    got = layers.keep_mask(shape, RATE, torch.Generator().manual_seed(9),
                           "cpu", rows=rows)
    assert torch.equal(got, torch.cat([whole[3:6], whole[9:12]]))
    x = torch.ones(shape)
    assert torch.equal(layers.dropout(x, RATE, torch.Generator()
                                      .manual_seed(9), rows=rows) != 0, got)
    heads = layers.keep_mask((2, 2, 5, 5), RATE,
                             torch.Generator().manual_seed(10), "cpu",
                             heads=(2, 4, 4))
    all_heads = layers.keep_mask((2, 4, 5, 5), RATE,
                                 torch.Generator().manual_seed(10), "cpu")
    assert torch.equal(heads, all_heads[:, 2:4])
    assert torch.equal(layers.dropout(torch.ones(2, 2, 5, 5), RATE,
                                      torch.Generator().manual_seed(10),
                                      heads=(2, 4, 4)) != 0, heads)


@pytest.mark.parametrize("shape,rows,heads", [
    ((2, 4, 33, 33), None, None),
    ((2 * 3, 4, 33, 33), layers.BatchRows.stacked(3, 3, 6), None),
    ((2, 2, 70, 70), None, (2, 4, 4))], ids=["plain", "rows", "heads"])
def test_draws_give_the_bits_of_keep_mask(shape, rows, heads):
    """The op's draws, turned into bits by its forward, are the bits of
    the mask ``keep_mask`` draws with the same arguments (a data-parallel
    rank's rows, a tensor-parallel rank's heads); ``keep_draws`` and
    ``keep_mask`` leave the generator alike."""
    g1, g2 = (torch.Generator().manual_seed(13) for _ in range(2))
    draws = layers.keep_draws(shape, g1, "cpu", rows=rows, heads=heads)
    keep = layers.keep_mask(shape, RATE, g2, "cpu", rows=rows, heads=heads)
    assert draws.dtype == torch.float32 and draws.shape == keep.shape
    assert torch.equal(g1.get_state(), g2.get_state())
    assert torch.equal(draws >= RATE, keep)
    q, k, v = _qkv(shape[:3] + (32,), seed=shape[2])
    _, _, bits = af.attention_f32_fwd(q, k, v, 0.2, draws, RATE)
    assert torch.equal(bits, af.pack_keep_plain(keep))
    assert torch.equal(af.attention_f32_fwd(q, k, v, 0.2, keep, RATE)[2],
                       bits)


@pytest.mark.parametrize("heads", [12, 6])
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_op_with_draws_is_the_op_with_their_mask(heads, rate):
    """Forward, backward and gradients through ``attention_f32`` are the
    same handed the draws or the bool mask they give."""
    q, k, v = _qkv((2, heads, 37, 32), seed=heads, requires_grad=True)
    draws = torch.rand(2, heads, 37, 37,
                       generator=torch.Generator().manual_seed(heads))
    do = _qkv((2, heads, 37, 32), seed=14)[0]
    got, want = ([af.attention_f32(q, k, v, 32 ** -0.5, m, rate)]
                 for m in (draws, draws >= rate))
    for side in (got, want):
        side.extend(torch.autograd.grad(side[0], (q, k, v), do))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, lse, bits = af.attention_f32_fwd(q.detach(), k.detach(),
                                          v.detach(), 0.2, draws, rate)
    halves = af.attention_f32_bwd(q.detach(), k.detach(), v.detach(), out,
                                  lse, do, 0.2, bits, rate)
    plain = af.attention_f32_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       out, lse, do, 0.2, draws >= rate,
                                       rate)
    for a, b in zip(halves, plain):
        assert torch.equal(a, b)


def test_draws_the_card_does_not_take_raise(monkeypatch):
    """On the card the draws must be float32 ``[B, H, L, L]`` with rows of
    stride L: anything else raises before a launch."""
    q, k, v = _qkv((1, 2, 8, 32), seed=15)
    monkeypatch.setattr(af, "_check", lambda what, t: (1, 2, 8, 32))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda")))
    good = torch.rand(1, 2, 8, 8)
    for bad in (good.double(), good[..., :7], good.transpose(2, 3),
                torch.rand(1, 2, 8, 16)[..., ::2]):
        with pytest.raises(ValueError, match="draws"):
            af.attention_f32_fwd(q, k, v, 0.2, bad, RATE)
    with pytest.raises(ValueError, match="scale"):
        af.attention_f32_fwd(q, k, v, -0.2, good, RATE)


def test_dropout_module_keep():
    drop = layers.Dropout(RATE)
    gen = torch.Generator().manual_seed(11)
    drop.generator = gen
    assert drop.keep((2, 3), "cpu") is not None
    drop.eval()
    assert drop.keep((2, 3), "cpu") is None
    drop.train()
    drop.rate = 0.0
    assert drop.keep((2, 3), "cpu") is None
    assert drop.draws((2, 3), "cpu") is None
    drop.rate = RATE
    g2 = torch.Generator().manual_seed(11)
    drop.generator = g2
    state = g2.get_state()
    draws = drop.draws((2, 3), "cpu")
    g2.set_state(state)
    assert torch.equal(draws >= RATE, drop.keep((2, 3), "cpu"))
    drop.generator = None
    with pytest.raises(RuntimeError, match="generator"):
        drop.keep((2, 3), "cpu")
    with pytest.raises(RuntimeError, match="generator"):
        drop.draws((2, 3), "cpu")


class _Spy:
    """A counting stand-in for one of ``transformer``'s attention ops."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)


@pytest.fixture
def spies(monkeypatch):
    s = {"f32": _Spy(af.attention_f32),
         "bf16": _Spy(transformer.attention)}
    monkeypatch.setattr(transformer, "attention_f32", s["f32"])
    monkeypatch.setattr(transformer, "attention", s["bf16"])
    return s


@pytest.fixture
def as_cuda(monkeypatch):
    """Every tensor reads ``is_cuda`` True, so the routing can be seen on
    the CPU."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


@pytest.mark.parametrize("heads,hd", [(12, 32), (6, 32), (1, 32)])
@pytest.mark.parametrize("remat", [False, True, "save_most"])
def test_float32_on_the_card_takes_the_op(spies, as_cuda, heads, hd, remat):
    mod, gen = _mha(heads, hd, RATE, seed=12)
    mod.remat = remat
    x = _qkv((2, 9, heads * hd), seed=5)[0]
    state = gen.get_state()
    got = mod(x)
    assert len(spies["f32"].calls) == 1 and not spies["bf16"].calls
    q, k, v, scale, keep, rate = spies["f32"].calls[0]
    assert q.is_contiguous() and scale == 1.0 / hd ** 0.5 and rate == RATE
    # the op is handed the draws, whose mask is the one the einsum path's
    # dropout draws
    assert keep.dtype == torch.float32
    gen.set_state(state)
    assert torch.equal(keep, mod.attn_drop.draws((2, heads, 9, 9), "cpu"))
    gen.set_state(state)
    assert torch.equal(keep >= RATE,
                       mod.attn_drop.keep((2, heads, 9, 9), "cpu"))
    gen.set_state(state)
    with torch.no_grad():
        mod.remat = False
        b, l = 2, 9
        qs, ks, vs = (lyr(x).reshape(b, l, heads, hd).transpose(1, 2)
                      for lyr in (mod.query, mod.key, mod.value))
        want = mod.output(mod._core(qs, ks, vs, None).transpose(1, 2)
                          .reshape(b, l, heads * hd))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_eval_takes_the_op_without_a_mask(spies, as_cuda):
    mod, _ = _mha(12, 32, RATE)
    mod.eval()
    with torch.no_grad():
        mod(_qkv((1, 5, 384), seed=6)[0])
    (call,) = spies["f32"].calls
    assert call[4] is None and call[5] == 0.0


@pytest.mark.parametrize("case", ["cpu", "mask", "bf16", "bf16_scores",
                                  "head_dim_16", "head_dim_64",
                                  "head_dim_128"])
def test_everything_else_keeps_its_path(spies, monkeypatch, case):
    heads, hd = {"head_dim_16": (4, 16), "head_dim_64": (2, 64),
                 "head_dim_128": (3, 128)}.get(case, (12, 32))
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    mod = MultiHeadAttention(heads, heads * hd, 0.0, dtype=dtype,
                             attn_dropout=0.0, flash=case == "bf16",
                             score_dtype=(torch.bfloat16 if case ==
                                          "bf16_scores" else torch.float32))
    x = _qkv((1, 6, heads * hd), seed=7)[0].to(dtype)
    mask = torch.ones(1, 1, 6, 6) if case == "mask" else None
    if case == "bf16":
        # the bf16 kernels' entry; its CPU plain version computes it here
        mod(x, mask)
        assert len(spies["bf16"].calls) == 1
    else:
        mod(x, mask)
        assert not spies["bf16"].calls
    assert not spies["f32"].calls


def test_cpu_wrapper_is_the_plain_version_uncounted():
    q, k, v = _qkv((1, 2, 7, 32), seed=8)
    ops.reset_launches()
    # the wrapper hands on the keys less their mean over the sequence
    kc = k - k.mean(dim=2, keepdim=True)
    assert torch.equal(ops.attention_f32(q, k, v, 0.2),
                       af.attention_f32_fwd_plain(q, kc, v, 0.2)[0])
    assert ops.launch_counts()["attention_f32"] == 0


@pytest.mark.parametrize("what,match", [
    ("hd16", "head dim"), ("hd64", "head dim"), ("f64", "float32"),
    ("bf16", "float32"),
    ("strided", "contiguous"), ("shapes", "shape"), ("cpu", "CUDA")])
def test_checks_refuse_what_the_kernels_do_not_take(what, match):
    q, k, v = _qkv((1, 2, 8, 32), seed=9)
    if what in ("hd16", "hd64"):
        q, k, v = _qkv((1, 2, 8, int(what[2:])), seed=9)
    elif what == "f64":
        k = k.double()
    elif what == "bf16":
        v = v.bfloat16()
    elif what == "strided":
        q = _qkv((1, 2, 32, 8), seed=9)[0].transpose(-1, -2)
    elif what == "shapes":
        k = k[:, :, :5].contiguous()
    with pytest.raises(ValueError, match=match):
        af._check("attention_f32", {"q": q, "k": k, "v": v})


@pytest.mark.parametrize("rate", [-0.1, 1.0, 1.5])
def test_rate_out_of_range_raises(rate):
    q, k, v = _qkv((1, 1, 4, 32))
    with pytest.raises(ValueError, match="rate"):
        af.attention_f32_fwd(q, k, v, 0.2, None, rate)


def test_function_keeps_the_lse_only_under_grad(monkeypatch):
    calls = []
    fwd = af.attention_f32_fwd

    def stand_in(q, k, v, scale, keep=None, rate=0.0, with_lse=True):
        calls.append(with_lse)
        return fwd(q, k, v, scale, keep, rate, with_lse)

    monkeypatch.setattr(af, "attention_f32_fwd", stand_in)
    q, k, v = _qkv((1, 2, 6, 32), seed=10)
    with torch.no_grad():
        af.attention_f32(q, k, v, 0.2)
    af.attention_f32(q, k, v, 0.2)            # nothing needs a gradient
    af.attention_f32(q.requires_grad_(), k, v, 0.2)
    assert calls == [False, False, True]


def test_function_gradients_reach_their_inputs_from_a_strided_do():
    q, k, v = _qkv((1, 2, 6, 32), seed=11, requires_grad=True)
    keep = torch.rand(1, 2, 6, 6, generator=torch.Generator()
                      .manual_seed(3)) >= RATE
    out = af.attention_f32(q, k, v, 0.2, keep, RATE)
    do = _qkv((1, 2, 32, 6), seed=12)[0].transpose(-1, -2)
    got = torch.autograd.grad(out, (q, k, v), do)
    kc = (k - k.mean(dim=2, keepdim=True)).detach()
    o, lse = af.attention_f32_fwd_plain(q.detach(), kc, v.detach(),
                                        0.2, keep, RATE)
    want = af.attention_f32_bwd_plain(q.detach(), kc, v.detach(),
                                      o, lse, do.contiguous(), 0.2, keep,
                                      RATE)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _einsum_attention(q, k, v, keep, scale):
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
    p = torch.where(keep, p / (1.0 - RATE), torch.zeros((), dtype=p.dtype))
    return torch.matmul(p, v)


def _grad_errors(fn, q, k, v, keep, do, exact):
    """``fn``'s output and input gradients, each as its norm distance
    from ``exact``'s over the norm of ``exact``'s."""
    got = _out_and_grads(fn, q, k, v, keep, do)
    return [float((a.double() - e).norm() / e.norm())
            for a, e in zip(got, exact)]


def _out_and_grads(fn, q, k, v, keep, do):
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs, keep, 32 ** -0.5)
    out.backward(do)
    return [out.detach()] + [x.grad for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_with_a_shared_part_keep_dq_accurate(seed):
    """Keys that share a large part, as a trained encoder's do: against
    float64, the op (its keys less their mean) stays as close as autograd
    of the einsum path in float32 for the output and every gradient.  Fed
    the keys as they are, its dq (from ds whose rows sum to a rounding
    residue, times the keys) is more than twice as far."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, 6, 130, 32)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    k = k + 16.0 * torch.randn(2, 6, 1, 32, generator=g)
    keep = torch.rand(2, 6, 130, 130, generator=g) >= RATE
    exact = _out_and_grads(_einsum_attention,
                           *(x.double() for x in (q, k, v)), keep,
                           do.double())
    einsum = _grad_errors(_einsum_attention, q, k, v, keep, do, exact)
    op = _grad_errors(lambda a, b, c, m, s: af.attention_f32(a, b, c, s, m,
                                                             RATE),
                      q, k, v, keep, do, exact)
    for name, mine, theirs in zip(("o", "dq", "dk", "dv"), op, einsum):
        assert mine <= theirs, (name, mine, theirs)
    as_given = _grad_errors(
        lambda a, b, c, m, s: af.AttentionF32Fn.apply(a, b, c, m, s, RATE),
        q, k, v, keep, do, exact)
    assert as_given[1] > 2 * einsum[1], (as_given[1], einsum[1])
