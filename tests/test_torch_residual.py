"""The residual epilogue kernels' CPU side (``ops/residual.py``): the plain
version is the chain a pre-LN block ran before the kernels, bit for bit,
forward and backward; ``models.transformer.residual_epilogue`` sends only
a pre-LN block's contiguous bf16 CUDA activations of a supported width,
with masks along the sequence, to the kernels, and draws their masks as
the chain did; the wrapper's checks; and ``ResidualFn``'s autograd
plumbing with the kernels replaced by the plain version.  The kernels
themselves run in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on
the card.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.models import layers, transformer

# the module (``ops.residual`` is its differentiable function)
res = importlib.import_module("rag_snvbert_tpu_torch.ops.residual")
ln = importlib.import_module("rag_snvbert_tpu_torch.ops.layer_norm")

RATE = 0.1
CASES = [(n, leaky) for n in (0, 1, 2) for leaky in (False, True)]
CASE_IDS = [f"{n}masks-{'leaky' if leaky else 'identity'}"
            for n, leaky in CASES]


def _inputs(shape, dtype=torch.bfloat16, seed=0, n_masks=0):
    rng = np.random.default_rng(seed)
    x, f = (torch.from_numpy(rng.standard_normal(shape, np.float32) * 2)
            .to(dtype) for _ in range(2))
    masks = [torch.from_numpy(rng.random((shape[0], 1, shape[-1])) >= RATE)
             for _ in range(n_masks)]
    return x, f, masks


def _old_chain(x, f, masks, rate, leaky):
    """The pre-LN block's epilogue before the kernels: LeakyReLU, then
    each dropout as models/layers.py::dropout wrote it, then the add."""
    t = F.leaky_relu(f, 0.1) if leaky else f
    for keep in masks:
        t = torch.where(keep, t / (1.0 - rate),
                        torch.zeros((), dtype=t.dtype, device=t.device))
    return x + t


@pytest.mark.parametrize("n_masks,leaky", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_old_chain_bit_for_bit(n_masks, leaky, dtype):
    x, f, masks = _inputs((3, 7, 64), dtype, n_masks=n_masks)
    rates = [RATE] * n_masks
    assert torch.equal(res.residual_plain(x, f, masks, rates, leaky),
                       _old_chain(x, f, masks, RATE, leaky))
    g = _inputs((3, 7, 64), dtype, seed=1)[0]
    xo, fo, xn, fn = (t.clone().requires_grad_() for t in (x, f, x, f))
    want = torch.autograd.grad(_old_chain(xo, fo, masks, RATE, leaky),
                               (xo, fo), g)
    got = torch.autograd.grad(res.residual_plain(xn, fn, masks, rates,
                                                 leaky), (xn, fn), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert torch.equal(res.residual_bwd_plain(g, f, masks, rates, leaky),
                       want[1])


def test_dropout_is_the_old_formula():
    x, _, _ = _inputs((2, 5, 64))
    gen = torch.Generator().manual_seed(3)
    keep = layers.keep_mask(x.shape, RATE, torch.Generator().manual_seed(3),
                            x.device, broadcast=True)
    assert torch.equal(layers.dropout(x, RATE, gen, broadcast=True),
                       _old_chain(torch.zeros_like(x), x, [keep], RATE,
                                  False))


def test_scale_is_the_float32_reciprocal():
    for rate in (0.1, 0.25, 0.5, 0.0):
        want = np.float32(1.0) / np.float32(1.0 - rate)
        assert np.float32(res.scale_of(rate)) == want


def _block(pre_ln=True, dims=64, dtype=torch.bfloat16, broadcast=True,
           seed=0):
    torch.manual_seed(seed)
    blk = transformer.TransformerBlock(
        dims, 2, 4 * dims, RATE, pre_ln=pre_ln, dtype=dtype, attn_dropout=0.0,
        dropout_broadcast=broadcast)
    layers.init_weights(blk, seed)
    return blk


def _old_block(blk, x, mask=None):
    """The pre-LN block's forward before the kernels."""
    x = x.to(blk.dtype)
    x = x + blk.drop(blk.attention(blk.LayerNorm_0(x), mask))
    h = blk.feed_forward.hidden(blk.LayerNorm_1(x))
    return x + blk.drop(blk.feed_forward.tail(h))


class _Spy:
    """``transformer.residual`` (the kernels' entry) replaced by the plain
    version, recording each call's mask count and LeakyReLU."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, f, masks=(), rates=(), leaky=False):
        self.calls.append((len(masks), leaky))
        return res.residual_plain(x, f, masks, rates, leaky)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy()
    monkeypatch.setattr(transformer, "residual", s)
    return s


@pytest.fixture
def as_cuda(monkeypatch):
    """Every tensor reads ``is_cuda`` True, so the routing can be seen on
    the CPU; the LayerNorm kernels' entry takes its plain version."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(layers, "layer_norm",
                        lambda x, w, b, eps: ln.layer_norm_plain(x, w, b, eps))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pre_ln_bf16_on_the_card_takes_the_kernels_with_the_chains_draws(
        spy, as_cuda, train):
    """The block through the kernels' entry equals the old block bit for
    bit, forward and backward, and leaves the dropout generator where the
    old block did: the same draws in the same order."""
    blk = _block()
    blk.train(train)
    x = _inputs((3, 9, 64))[0]
    outs, states, grads = [], [], []
    for fn in (blk, lambda t: _old_block(blk, t)):
        gen = torch.Generator().manual_seed(11)
        layers.set_dropout_generator(blk, gen)
        xg = x.clone().requires_grad_()
        y = fn(xg)
        y.float().square().sum().backward()
        outs.append(y)
        states.append(gen.get_state())
        grads.append([xg.grad] + [p.grad.clone() for p in blk.parameters()])
        blk.zero_grad()
    assert spy.calls == ([(1, False), (2, True)] if train
                         else [(0, False), (0, True)])
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(states[0], states[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, "save_ffn"])
def test_remat_recomputes_the_kernels_masks(spy, as_cuda, remat):
    blk, ref = _block(), _block()
    blk.remat = remat
    x = _inputs((2, 9, 64))[0]
    got = []
    for mod in (blk, ref):
        gen = torch.Generator().manual_seed(5)
        layers.set_dropout_generator(mod, gen)
        xg = x.clone().requires_grad_()
        mod(xg).float().square().sum().backward()
        got.append((xg.grad, gen.get_state()))
    # the remat block's forward and its recompute, then the plain block's
    assert sorted(spy.calls) == [(1, False)] * 3 + [(2, True)] * 3
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


@pytest.mark.parametrize("what", ["cpu", "float32", "post_ln", "width",
                                  "per_position_masks"])
def test_everything_else_takes_the_chain(spy, monkeypatch, what):
    if what != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
        monkeypatch.setattr(layers, "layer_norm", lambda x, w, b, eps:
                            ln.layer_norm_plain(x, w, b, eps))
    blk = _block(pre_ln=what != "post_ln",
                 dims=20 if what == "width" else 64,
                 dtype=torch.float32 if what == "float32" else torch.bfloat16,
                 broadcast=what != "per_position_masks")
    layers.set_dropout_generator(blk, torch.Generator().manual_seed(1))
    ops.reset_launches()
    y = blk(_inputs((2, 5, blk.LayerNorm_0.weight.numel()))[0])
    assert spy.calls == [] and y.dtype == blk.dtype
    assert not any(ops.launch_counts().values())
    if what == "per_position_masks":
        # no masks to draw in eval mode: the kernels again
        blk.eval()
        blk(_inputs((2, 5, 64))[0])
        assert spy.calls == [(0, False), (0, True)]


def test_a_strided_input_takes_the_chain(spy, as_cuda):
    x = _inputs((9, 2, 64))[0].transpose(0, 1)
    f = _inputs((2, 9, 64), seed=1)[0]
    drop = layers.Dropout(RATE, broadcast=True)
    drop.generator = torch.Generator().manual_seed(2)
    y = transformer.residual_epilogue(x, f, (drop,), leaky=True)
    assert spy.calls == []
    keep = layers.keep_mask(f.shape, RATE, torch.Generator().manual_seed(2),
                            f.device, broadcast=True)
    assert torch.equal(y, _old_chain(x, f, [keep], RATE, True))


def test_cpu_wrapper_is_the_plain_version_uncounted():
    x, f, masks = _inputs((3, 5, 64), n_masks=2)
    ops.reset_launches()
    assert torch.equal(ops.residual(x, f, masks, [RATE] * 2, True),
                       res.residual_plain(x, f, masks, [RATE] * 2, True))
    assert ops.launch_counts()["residual"] == 0
    assert ops.launch_counts()["residual_bwd"] == 0


@pytest.mark.parametrize("d", [0, 4, 12, 100, 4104, 8192])
def test_wrapper_raises_on_an_unsupported_width(d):
    x, f, _ = _inputs((2, 3, max(d, 1)))
    with pytest.raises(ValueError, match="width"):
        res.residual_fwd(x[..., :d].contiguous(), f[..., :d].contiguous())


@pytest.mark.parametrize("what", ["x_f32", "f_f16", "f_shape", "mask_u8",
                                  "mask_per_position", "x_2d",
                                  "three_masks"])
def test_wrapper_raises_on_an_unsupported_dtype_or_shape(what):
    x, f, masks = _inputs((2, 3, 64), n_masks=3 if what == "three_masks"
                          else 1)
    x = {"x_f32": x.float(), "x_2d": x[0]}.get(what, x)
    f = {"f_f16": f.half(), "f_shape": f[:, :2].contiguous(),
         "x_2d": f[0]}.get(what, f)
    if what == "mask_u8":
        masks = [masks[0].to(torch.uint8)]
    elif what == "mask_per_position":
        masks = [masks[0].expand(2, 3, 64).contiguous()]
    with pytest.raises(ValueError, match="bf16|bool|\\[B, L, D\\]|masks"):
        res.residual_fwd(x, f, masks, [RATE] * len(masks))


@pytest.mark.parametrize("what", ["x_strided", "x_offset", "mask_strided"])
def test_wrapper_raises_on_an_unsupported_layout(what):
    x, f, masks = _inputs((2, 3, 64), n_masks=1)
    if what == "x_strided":
        x = _inputs((3, 2, 64))[0].transpose(0, 1)
    elif what == "x_offset":
        x = _inputs((2 * 3 * 64 + 1,))[0][1:].view(2, 3, 64)   # 2 bytes off
    else:
        masks = [torch.ones(2, 1, 128, dtype=torch.bool)[..., ::2]]
    with pytest.raises(ValueError, match="contiguous"):
        res.residual_fwd(x, f, masks, [RATE])


def test_wrapper_needs_cuda_tensors_and_a_rate_a_mask():
    x, f, masks = _inputs((2, 3, 64), n_masks=1)
    with pytest.raises(ValueError, match="CUDA"):
        res.residual_fwd(x, f, masks, [RATE])
    with pytest.raises(ValueError, match="CUDA"):
        res.residual_bwd(x, f, masks, [RATE], True)
    with pytest.raises(ValueError, match="rate"):
        res.residual_fwd(x, f, masks, [])
    with pytest.raises(ValueError, match="LeakyReLU"):
        res.residual_bwd(x, None, masks, [RATE], True)


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernels' halves replaced by the plain version, recording what
    each got."""
    calls = []

    def fwd(x, f, masks=(), rates=(), leaky=False):
        calls.append(("fwd", len(masks), leaky))
        return res.residual_plain(x, f, masks, rates, leaky)

    def bwd(g, f, masks=(), rates=(), leaky=False):
        calls.append(("bwd", len(masks), leaky, f is not None,
                      g.is_contiguous()))
        if not masks and not leaky:
            return g
        return res.residual_bwd_plain(g, f, masks, rates, leaky)

    monkeypatch.setattr(res, "residual_fwd", fwd)
    monkeypatch.setattr(res, "residual_bwd", bwd)
    return calls


@pytest.mark.parametrize("n_masks,leaky", CASES, ids=CASE_IDS)
def test_function_gradients_are_the_chains(stand_ins, n_masks, leaky):
    x, f, masks = _inputs((2, 5, 64), n_masks=n_masks)
    rates = (RATE,) * n_masks
    g = _inputs((5, 2, 64), seed=2)[0].transpose(0, 1)     # a strided g
    xg, fg = x.clone().requires_grad_(), f.clone().requires_grad_()
    y = res.ResidualFn.apply(xg, fg, rates, leaky, *masks)
    saved = y.grad_fn.saved_tensors
    # the masks, and f only under LeakyReLU
    assert (saved[0] is not None) == leaky and len(saved) == 1 + n_masks
    got = torch.autograd.grad(y, (xg, fg), g)
    assert stand_ins == [("fwd", n_masks, leaky),
                         ("bwd", n_masks, leaky, leaky, True)]
    xo, fo = x.clone().requires_grad_(), f.clone().requires_grad_()
    want = torch.autograd.grad(_old_chain(xo, fo, masks, RATE, leaky),
                               (xo, fo), g)
    assert torch.equal(got[0], g) and torch.equal(got[1], want[1])


def test_function_only_where_a_gradient_is_recorded(stand_ins, monkeypatch):
    x, f, _ = _inputs((2, 5, 64))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    with torch.no_grad():
        y = res.residual(x, f.requires_grad_(), leaky=True)
    assert y.grad_fn is None
    y = res.residual(x, f, leaky=True)
    assert y.grad_fn is not None
    assert [c[0] for c in stand_ins] == ["fwd", "fwd"]
