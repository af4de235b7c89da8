"""The bf16 LayerNorm kernels' CPU side (``ops/layer_norm.py``): the plain
version is the float32 chain the model ran before the kernels, bit for
bit; ``models.layers.LayerNorm`` sends only a bf16 CUDA input normalised
into bf16 outside tensor parallelism to the kernels; the wrapper's checks;
and ``LayerNormFn``'s autograd plumbing with the kernels' halves replaced
by float32 stand-ins.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.models import layers

# the module (``ops.layer_norm`` is its differentiable function)
ln = importlib.import_module("rag_snvbert_tpu_torch.ops.layer_norm")

EPS = 1e-6


def _inputs(shape, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, np.float32) * 3 + 0.5)
    w = torch.from_numpy(rng.standard_normal(d, np.float32) * 0.2 + 1)
    b = torch.from_numpy(rng.standard_normal(d, np.float32) * 0.1)
    return x.to(dtype), w, b


def _chain(x, w, b, dtype):
    """models/layers.py::LayerNorm.forward before the kernels."""
    return F.layer_norm(x.float(), w.shape, w, b, EPS).to(dtype)


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 384), (3, 1536), (1, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_old_chain_bit_for_bit(shape, dtype):
    x, w, b = _inputs(shape, dtype)
    assert torch.equal(ln.layer_norm_plain(x, w, b, EPS),
                       _chain(x, w, b, dtype))
    assert torch.equal(ln.layer_norm_plain(x, w, b, EPS, torch.float32),
                       _chain(x, w, b, torch.float32))
    dy = _inputs(shape, dtype, seed=1)[0]
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(_chain(xg, wg, bg, dtype), (xg, wg, bg), dy)
    got = ln.layer_norm_bwd_plain(dy, x, w, b, EPS)
    assert got[0].dtype == dtype
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype,out", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.float32), (torch.bfloat16, None)],
    ids=["bf16", "f32-promoted", "f32", "bf16-promoted"])
def test_layernorm_module_on_the_cpu_is_the_old_chain(dtype, out):
    x, w, b = _inputs((2, 9, 64), dtype)
    mod = layers.LayerNorm(64, out)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
    ops.reset_launches()
    y = mod(x)
    want = _chain(x, w, b, layers._out_dtype(x, mod.weight, out))
    assert y.dtype == want.dtype and torch.equal(y, want)
    y.float().sum().backward()
    assert not any(ops.launch_counts().values())


class _Spy:
    def __init__(self):
        self.calls = 0
        self.contiguous = []

    def __call__(self, x, w, b, eps):
        self.calls += 1
        self.contiguous.append(x.is_contiguous())
        return ln.layer_norm_plain(x, w, b, eps)


@pytest.fixture
def spy(monkeypatch):
    """``layers.layer_norm`` (the kernels' entry) replaced by a counting
    stand-in."""
    s = _Spy()
    monkeypatch.setattr(layers, "layer_norm", s)
    return s


@pytest.fixture
def as_cuda(monkeypatch):
    """Every tensor reads ``is_cuda`` True, so the routing can be seen on
    the CPU."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def test_bf16_input_normalised_into_bf16_on_the_card_takes_the_kernels(
        spy, as_cuda):
    x, w, b = _inputs((4, 384))
    layers.LayerNorm(384, torch.bfloat16)(x)
    assert spy.calls == 1
    # the input handed over is contiguous (the kernels refuse a stride)
    layers.LayerNorm(384, torch.bfloat16)(
        torch.zeros(384, 4, dtype=torch.bfloat16).t())
    assert spy.calls == 2 and spy.contiguous == [True, True]


@pytest.mark.parametrize("dtype,out", [
    (torch.float32, torch.float32), (torch.float32, None),
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_other_dtypes_take_torchs_path(spy, as_cuda, dtype, out):
    x, _, _ = _inputs((4, 64), dtype)
    y = layers.LayerNorm(64, out)(x)
    assert spy.calls == 0
    assert y.dtype == layers._out_dtype(x, torch.zeros(1), out)


def test_cpu_tensors_take_torchs_path(spy):
    x, _, _ = _inputs((4, 64))
    ops.reset_launches()
    layers.LayerNorm(64, torch.bfloat16)(x)
    assert spy.calls == 0 and not any(ops.launch_counts().values())


def test_tensor_parallel_slice_takes_torchs_path(spy, as_cuda, monkeypatch):
    from rag_snvbert_tpu_torch.parallel import comm

    # a one-rank group: the sums over the group are the local sums
    monkeypatch.setattr(comm, "all_reduce_sum", lambda t, group: t)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 1)
    x, w, b = _inputs((3, 5, 64))
    mod = layers.LayerNorm(64, torch.bfloat16)
    mod.tp_group = object()
    y = mod(x)
    assert spy.calls == 0 and y.dtype == torch.bfloat16
    # the group's statistics, computed apart: within a bf16 rounding
    ref = _chain(x, mod.weight.detach(), mod.bias.detach(), torch.bfloat16)
    assert (y.float() - ref.float()).abs().max() <= 2 ** -7 * 4


def test_cpu_wrapper_is_the_plain_version_uncounted():
    x, w, b = _inputs((3, 256))
    ops.reset_launches()
    assert torch.equal(ops.layer_norm(x, w, b, EPS),
                       ln.layer_norm_plain(x, w, b, EPS))
    assert ops.launch_counts()["layer_norm"] == 0


@pytest.mark.parametrize("d", [0, 4, 12, 100, 4104, 8192])
def test_wrapper_raises_on_an_unsupported_width(d):
    x, w, b = _inputs((3, max(d, 1)))
    x, w, b = x[:, :d], w[:d], b[:d]
    with pytest.raises(ValueError, match="width"):
        ln.layer_norm_fwd(x.contiguous(), w, b, EPS)


@pytest.mark.parametrize("what", ["x_f32", "x_f16", "w_bf16", "b_f64",
                                  "w_short"])
def test_wrapper_raises_on_an_unsupported_dtype_or_shape(what):
    x, w, b = _inputs((3, 64))
    x = {"x_f32": x.float(), "x_f16": x.half()}.get(what, x)
    w = {"w_bf16": w.bfloat16(), "w_short": w[:32]}.get(what, w)
    b = b.double() if what == "b_f64" else b
    with pytest.raises(ValueError, match="bf16|float32"):
        ln.layer_norm_fwd(x, w, b, EPS)


@pytest.mark.parametrize("what", ["x_strided", "x_offset", "w_strided"])
def test_wrapper_raises_on_an_unsupported_layout(what):
    x, w, b = _inputs((3, 64))
    if what == "x_strided":
        x = _inputs((64, 3))[0].t()
    elif what == "x_offset":
        x = _inputs((3 * 64 + 1,))[0][1:].view(3, 64)   # 2 bytes off
    else:
        w = _inputs((128,))[0].float()[::2]
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd(x, w, b, EPS)


def test_wrapper_needs_a_cuda_tensor_and_checks_the_statistics():
    x, w, b = _inputs((3, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_fwd(x, w, b, EPS)
    stats = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_bwd(x, x, stats, stats, w)
    with pytest.raises(ValueError, match="bf16"):
        ln.layer_norm_bwd(x.float(), x, stats, stats, w)
    with pytest.raises(ValueError, match="mean"):
        ln.layer_norm_bwd(x, x, stats[:2], stats, w)
    with pytest.raises(ValueError, match="rstd"):
        ln.layer_norm_bwd(x, x, stats, stats.double(), w)


def _fwd_stand_in(calls):
    def fwd(x, weight, bias, eps, with_stats=True):
        calls.append(("fwd", with_stats))
        xf = x.float()
        mean = xf.mean(-1)
        rstd = torch.rsqrt(((xf - mean[..., None]) ** 2).mean(-1) + eps)
        y = ((xf - mean[..., None]) * rstd[..., None] * weight + bias)
        return (y.to(x.dtype), mean if with_stats else None,
                rstd if with_stats else None)
    return fwd


def _bwd_stand_in(calls):
    def bwd(dy, x, mean, rstd, weight):
        calls.append(("bwd", dy.is_contiguous()))
        xh = (x.float() - mean[..., None]) * rstd[..., None]
        g = dy.float() * weight
        dx = rstd[..., None] * (g - g.mean(-1, keepdim=True)
                                - xh * (g * xh).mean(-1, keepdim=True))
        rows = dy.float().reshape(-1, dy.shape[-1])
        return (dx.to(x.dtype), (rows * xh.reshape(rows.shape)).sum(0),
                rows.sum(0))
    return bwd


@pytest.fixture
def stand_ins(monkeypatch):
    calls = []
    monkeypatch.setattr(ln, "layer_norm_fwd", _fwd_stand_in(calls))
    monkeypatch.setattr(ln, "layer_norm_bwd", _bwd_stand_in(calls))
    return calls


def test_function_saves_statistics_only_under_grad(stand_ins):
    x, w, b = _inputs((2, 5, 64))
    with torch.no_grad():
        ln.LayerNormFn.apply(x, w, b, EPS)
    ln.LayerNormFn.apply(x, w, b, EPS)        # nothing needs a gradient
    ln.LayerNormFn.apply(x, w.requires_grad_(), b, EPS)
    assert stand_ins == [("fwd", False), ("fwd", False), ("fwd", True)]


def test_function_gradients_reach_their_inputs(stand_ins):
    x, w, b = _inputs((2, 5, 64))
    dy = _inputs((5, 2, 64), seed=2)[0].transpose(0, 1)    # a strided dy
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y = ln.LayerNormFn.apply(xg, wg, bg, EPS)
    got = torch.autograd.grad(y, (xg, wg, bg), dy)
    assert stand_ins == [("fwd", True), ("bwd", True)]
    want = ln.layer_norm_bwd_plain(dy, x, w, b, EPS)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert (got[0].float() - want[0].float()).abs().max() <= \
        2 ** -7 * want[0].float().abs().max()
    for g, r in zip(got[1:], want[1:]):
        assert torch.allclose(g, r, rtol=1e-5, atol=1e-5)
    # only what needs a gradient gets one
    xg = x.clone().requires_grad_()
    y = ln.LayerNormFn.apply(xg, w.detach(), b, EPS)
    (gx,) = torch.autograd.grad(y, (xg,), dy)
    assert gx.shape == x.shape
