"""The CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach (ragged tiles, every head dim, odd
batch/row/d counts), their input checks, and a small model served and
trained on the card against the same model on the CPU.

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
from rag_snvbert_tpu_torch.ops.attention import (
    attention, attention_bwd, attention_bwd_plain, attention_fwd,
    attention_fwd_plain, attention_plain)
from rag_snvbert_tpu_torch.ops.l2_topk import l2_topk, l2_topk_plain
from rag_snvbert_tpu_torch.ops.layer_norm import (
    layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd,
    layer_norm_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


# Sequence lengths at the kernels' tile edges: the forward's 128-query
# blocks (64 rows a consumer warpgroup) and 176-key tiles, the backward's
# 128-row blocks and 64-row streamed tiles: L = 1, tile - 1, tile, tile + 1,
# 2 tile + 1, and the main paths' 1030.
EDGE_LS = (1, 63, 64, 65, 127, 128, 129, 175, 176, 177, 257, 353, 1030)
EDGE_SHAPES = [(2, 3, l, hd) for hd in (32, 64, 128) for l in EDGE_LS]


@pytest.mark.parametrize("shape", EDGE_SHAPES + [
    (1, 1, 1, 32), (1, 2, 65, 128), (3, 1, 1030, 128), (1, 4, 200, 32),
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


def test_attention_kernel_runs_are_bit_identical(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_bf16((2, 3, 1030, 128), gen, cuda) for _ in range(3))
    first = attention_fwd(q, k, v, 0.1)
    second = attention_fwd(q, k, v, 0.1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd", (32, 64, 128))
@pytest.mark.parametrize("l", (65, 177))
def test_attention_kernels_keep_to_their_head(cuda, hd, l):
    """Head 1 with NaN in the K, V and dO of head 2 and 1e4 in head 3's:
    its O, LSE, dQ, dK and dV equal those of head 1 run alone, bit for bit
    (the ragged rows past L of a head must read as zeros, not as the next
    head's rows)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (_bf16((1, 4, l, hd), gen, cuda) for _ in range(4))
    for x in (k, v, do):
        x[:, 2] = float("nan")
        x[:, 3] = 1e4
    scale = hd ** -0.5
    out, lse = attention_fwd(q, k, v, scale)
    grads = attention_bwd(q, k, v, out, lse, do, scale)
    one = [x[:, 1:2].contiguous() for x in (q, k, v, do)]
    alone_out, alone_lse = attention_fwd(*one[:3], scale)
    alone = attention_bwd(*one[:3], alone_out, alone_lse, one[3], scale)
    assert torch.equal(out[:, 1:2], alone_out)
    assert torch.equal(lse[:, 1:2], alone_lse)
    for a, b in zip(grads, alone):
        assert torch.equal(a[:, 1:2], b)
    assert bool(torch.isfinite(out[:, :2]).all())


BWD_SHAPES = EDGE_SHAPES + [(1, 1, 1, 32), (1, 2, 64, 128), (2, 1, 65, 32),
                            (1, 3, 1030, 128), (1, 2, 130, 64)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (_bf16(shape, gen, cuda) for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = attention_fwd(q, k, v, scale)
    ref_out, ref_lse = attention_fwd_plain(q, k, v, scale)
    # fp32 scores summed in another order: lse agrees to ~1e-6 relative
    assert (lse - ref_lse).abs().max().item() <= \
        1e-4 * ref_lse.abs().max().item()
    before = ops.launch_counts()["attention_bwd"]
    got = attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["attention_bwd"] == before + 1
    want = attention_bwd_plain(q, k, v, out, lse, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        # P and dS rounded to bf16 as product operands, bf16 outputs
        # (2^-9 relative each): within 2^-6 of the largest gradient.  At
        # L = 1 dq is zero and the plain version leaves float32 rounding
        # noise (~1e-7): hence the 1e-5 floor.
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2 ** -6 * b.float().abs().max().item() + 1e-5, \
            (name, err)


def test_attention_bwd_kernel_runs_are_bit_identical(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 3, 1030, 128)
    q, k, v, do = (_bf16(shape, gen, cuda) for _ in range(4))
    out, lse = attention_fwd(q, k, v, 0.1)
    first = attention_bwd(q, k, v, out, lse, do, 0.1)
    second = attention_bwd(q, k, v, out, lse, do, 0.1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_is_differentiable_through_the_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_bf16((1, 2, 70, 64), gen, cuda).requires_grad_()
               for _ in range(3))
    ops.reset_launches()
    out = attention(q, k, v, 0.125)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert ops.launch_counts() == {"attention": 1, "attention_bwd": 1,
                                   "attention_f32": 0,
                                   "attention_f32_bwd": 0,
                                   "layer_norm": 0, "layer_norm_bwd": 0,
                                   "residual": 0, "residual_bwd": 0,
                                   "l2_topk": 0, "l2_topk_rf": 0,
                                   "l2_topk_float": 0}
    qp, kp, vp = (x.detach().float().requires_grad_() for x in (q, k, v))
    attention_plain(qp, kp, vp, 0.125).square().sum().backward()
    for a, b in ((q, qp), (k, kp), (v, vp)):
        # autograd of float32 plain math vs bf16 kernels and a bf16 dO
        assert (a.grad.float() - b.grad).abs().max().item() <= \
            2 ** -5 * b.grad.abs().max().item()


def test_attention_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        attention_bwd(x, x, x, x, lse.double(), x, 1.0)
    with pytest.raises(ValueError, match="lse"):
        attention_bwd(x, x, x, x, lse[..., :4], x, 1.0)
    with pytest.raises(ValueError, match="bf16"):
        attention_bwd(x, x, x, x, lse, x.float(), 1.0)
    with pytest.raises(ValueError, match="shape"):
        attention_bwd(x, x, x, x, lse, x[..., :4, :], 1.0)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros(1, 1, 8, 96, device=cuda, dtype=torch.bfloat16)
        attention_bwd(y, y, y, y, lse, y, 1.0)


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


# Pass 1's tiles: 64 queries, 128 ref rows, pipeline stages of 128 columns
# of d.  B and N one below, at and one above a tile; d of one 16-byte
# vector, off the 64-column panel (72), several stages and a ragged last
# one (520), and short of one stage (200); +inf rows on both sides of a
# tile's edge.
L2_EDGES = [
    (63, 127, 8, 1), (64, 128, 72, 8), (65, 129, 520, 128),
    (1, 255, 200, 8), (64, 256, 1096, 128), (129, 257, 128, 1),
    (48, 2048, 4104, 8), (127, 385, 200, 128),
]


@pytest.mark.parametrize("b,n,d,k", L2_EDGES)
def test_l2_kernel_at_its_tiles_edges(cuda, b, n, d, k):
    gen = torch.Generator(device=cuda).manual_seed(5)
    refs = _bf16((n, d), gen, cuda)
    q = _bf16((b, d), gen, cuda)
    norms = l2_ref.squared_norms(refs)
    norms[n - 1] = float("inf")
    if n > 129:
        norms[127:129] = float("inf")
    before = ops.launch_counts()["l2_topk"]
    vals, ids = l2_topk(q, refs, norms, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["l2_topk"] == before + 1
    rv, ri = l2_topk_plain(q, refs, norms, k)
    scale = l2_ref.squared_norms(q)[:, None] + norms[ri.long()].clamp_max(
        1e30)
    # as test_l2_kernel_matches_plain: relative to the expansion's scale
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals), finite)
    err = ((vals - rv).abs() / scale)[finite]
    assert err.numel() == 0 or err.max().item() <= 2e-4
    full = l2_ref.l2_distances(q, refs, r_norms=norms)
    picked = torch.gather(full, 1, ids.long())
    perr = ((picked - rv).abs() / scale)[finite]
    assert perr.numel() == 0 or perr.max().item() <= 2e-4
    if k < n - 3:
        assert bool(torch.isfinite(vals).all())     # no +inf row returned
    again = l2_topk(q, refs, norms, k)
    assert torch.equal(again[0], vals) and torch.equal(again[1], ids)


def test_l2_kernel_orders_exact_ties_by_id_across_tiles(cuda):
    """Rows 5, 130 and 300 (three ref tiles) duplicate each other and the
    query: three exact zeros, ids ascending."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    refs = _bf16((400, 264), gen, cuda)
    refs[130] = refs[5]
    refs[300] = refs[5]
    norms = l2_ref.squared_norms(refs)
    _, ids = l2_topk(refs[5:6].clone(), refs, norms, 3)
    assert ids[0].tolist() == [5, 130, 300]


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
    # bf16 LayerNorms a window: the context's AF embedding, then the
    # forward's 3 a block, the AF embedding twice (target and reference
    # streams), the embedding fusion, the RAG fusion and its AF interaction;
    # two residual epilogues a block
    assert ops.launch_counts() == {"attention": 2 * 2, "attention_bwd": 0,
                                   "attention_f32": 0,
                                   "attention_f32_bwd": 0,
                                   "layer_norm": 2 * (1 + 3 * 2 + 5),
                                   "layer_norm_bwd": 0,
                                   "residual": 2 * 2 * 2, "residual_bwd": 0,
                                   "l2_topk": 2, "l2_topk_rf": 0,
                                   "l2_topk_float": 0}
    on_cpu = Imputer(build_model(cfg, b.vocab.size, device="cpu", seed=1),
                     b.ref, b.freq, device="cpu", **kw).impute(target)
    miss = on_card.imputed_flag
    d = np.abs(on_card.hap1_prob[miss] - on_cpu.hap1_prob[miss])
    # bf16 on both sides, rounded at other places (card kernels vs CPU
    # plain math), two layers deep
    assert d.mean() <= 5e-3 and d.max() <= 0.05


def _graph_and_eager_runs(rag_mode, device="cuda", pipeline_depth=8,
                          stall=0):
    """The smoke model's imputer in ``rag_mode`` on ``device``, called
    with a CUDA graph of ``_forward`` (the first call captures it), with
    the eager ``_forward`` (graphs off) and with the graph again, on the
    same batches: 10 targets at batch 4 over 2 windows, the last batch of
    each window ragged.  ``stall``: cycles the card spins before each
    graph call, so the host runs ahead of the replays.  Returns the
    imputer and each call's (result, launch counts)."""
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, flash_attention="splash", rag_mode=rag_mode))
    b = make_bundle(n_train_samples=10, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    keep = np.random.default_rng(0).random(b.train.n_variants) > 0.5
    target = dataclasses.replace(
        b.train, gt=b.train.gt[keep], pos=b.train.pos[keep],
        chrom=b.train.chrom[keep], ref=b.train.ref[keep],
        alt=b.train.alt[keep], ids=b.train.ids[keep])
    imp = Imputer(build_model(cfg, b.vocab.size, seed=1), b.ref, b.freq,
                  seq_len=138, window_len=128, ref_pad_haps=64,
                  batch_size=4, rag_mode=rag_mode, device=device,
                  pipeline_depth=pipeline_depth)
    assert imp.use_graphs and len(imp.windows) == 2
    runs = []
    for graphs in (True, False, True):
        imp.use_graphs = graphs
        ops.reset_launches()
        if graphs and stall:
            with torch.cuda.device(imp.device):
                torch.cuda._sleep(stall)
        res = imp.impute(target)
        runs.append((res, ops.launch_counts()))
    return imp, runs


def _assert_graph_bits(imp, runs):
    """Both graph calls give the eager call's bits; one capture, a replay
    a batch."""
    (g1, _), (eager, _), (g2, _) = runs
    for got in (g1, g2):
        for f in ("hap1_prob", "hap2_prob", "gt_prob", "imputed_flag"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(eager, f), err_msg=f)
    assert imp.graphs.captures == len(imp.graphs.by_key) == 1
    assert imp.graphs.replays == 2 * 2 * 3


@pytest.mark.parametrize("rag_mode", ["embedding", "token", "none"])
def test_imputer_graph_replays_give_the_eager_bits(cuda, rag_mode):
    """Calls with a CUDA graph of ``_forward`` against one with the eager
    ``_forward`` on the same batches (``_graph_and_eager_runs``): the same
    bits and the same kernel launches; one capture, a replay a batch."""
    imp, runs = _graph_and_eager_runs(rag_mode)
    (_, c1), (_, c0), (_, c2) = runs
    assert c1 == c0 == c2
    assert c0["attention"] > 0 and c0["layer_norm"] > 0
    assert c0["l2_topk"] == (2 * 3 if rag_mode == "embedding" else 0)
    assert c0["l2_topk_rf"] == (2 * 3 if rag_mode == "token" else 0)
    _assert_graph_bits(imp, runs)


def test_imputer_graph_replays_on_a_second_card(cuda):
    """An imputer on ``cuda:1`` while ``cuda:0`` stays the current device:
    the replays, their copies out and the events the drain waits on are
    all on ``cuda:1``'s stream, so the graph calls give the eager call's
    bits.  The card spins before each graph call and each batch is
    drained right after the next one's replay (pipeline depth 1), so a
    drain that waited on the wrong card would read host buffers the
    copies have not filled."""
    _second_card()
    _graph_and_eager_runs("embedding")     # the kernels first on cuda:0
    imp, runs = _graph_and_eager_runs("embedding", device="cuda:1",
                                      pipeline_depth=1, stall=10 ** 9)
    assert torch.cuda.current_device() == 0
    assert next(imp.model.parameters()).device == torch.device("cuda:1")
    _assert_graph_bits(imp, runs)


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("op", ["l2_topk", "l2_topk_rf", "l2_topk_float"])
def test_searches_run_on_each_card_of_a_process(op):
    """A search kernel launched on ``cuda:0`` and then, in the same
    process, on ``cuda:1`` (``cuda:0`` still the current device) gives
    the same bits there: its shared memory limit is a per-device
    attribute, raised on each card it runs on."""
    from rag_snvbert_tpu_torch.ops.l2_topk_float import l2_topk_float
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import l2_topk_rf

    _second_card()
    if op == "l2_topk":
        gen = torch.Generator(device="cuda:0").manual_seed(5)
        args = (_bf16((48, 4104), gen, "cuda:0"),
                _bf16((2048, 4104), gen, "cuda:0"))
        args += (l2_ref.squared_norms(args[1]), 8)
        fn = l2_topk
    elif op == "l2_topk_rf":
        args = _int8_case(64, 4100, 2040, 8, 3, "cuda:0") + (128, 8)
        fn = l2_topk_rf
    else:
        args = _float_case(130, 20000, 4096, torch.float32, 11,
                           "cuda:0") + (32,)
        fn = l2_topk_float
    first = fn(*args)
    on_1 = [a.to("cuda:1") if isinstance(a, torch.Tensor) else a
            for a in args]
    second = fn(*on_1)
    assert torch.cuda.current_device() == 0
    assert second[0].device == torch.device("cuda:1")
    for x, y in zip(first, second):
        assert torch.equal(x, y.cpu().to(x.device))


def test_small_model_trains_on_the_card_like_on_the_cpu(cuda):
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.models.layers import Dropout
    from rag_snvbert_tpu_torch.train import retrieval, step
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer

    cfg = PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, flash_attention="splash"))
    b = make_bundle(n_train_samples=8, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)
    meta = ds.windows[0]
    np_batch = ds.make_batch(meta, np.arange(6), 1, 0, pad_to=8, packed=True)
    toks, af, valid = ds.window_ref_tokens(meta, pad_haps_to=64)
    results = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, b.vocab.size, device=dev, seed=2)
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        model.eval()
        ctx = retrieval.encode_window_refs(
            model.embed, t(toks).long(), t(af),
            t(ds.window_mask(meta, 1, 0)), valid=t(valid))
        batch = {k: t(v) for k, v in np_batch.items()}
        ops.reset_launches()
        opt = make_optimizer(model, 1e-3, 2e-3, 10)
        stats = step.train_step(model, opt, batch, ctx, step.StepConfig())
        if dev == "cuda":
            torch.cuda.synchronize()
            # every bf16 LayerNorm of the micro-step forward and back;
            # two residual epilogues a block, of which dropout 0 leaves
            # only the FFN's LeakyReLU a backward kernel
            assert ops.launch_counts() == {"attention": 2,
                                           "attention_bwd": 2,
                                           "attention_f32": 0,
                                           "attention_f32_bwd": 0,
                                           "layer_norm": 3 * 2 + 5,
                                           "layer_norm_bwd": 3 * 2 + 5,
                                           "residual": 2 * 2,
                                           "residual_bwd": 2,
                                           "l2_topk": 1, "l2_topk_rf": 0,
                                           "l2_topk_float": 0}
        results[dev] = (stats["loss"].item(), stats["grad_norm"].item(),
                        {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
    (l_gpu, n_gpu, p_gpu), (l_cpu, n_cpu, p_cpu) = results["cuda"], \
        results["cpu"]
    # bf16 on both sides, rounded at other places (card kernels vs CPU
    # plain math), two layers deep: loss and raw gradient norm to 2%
    assert abs(l_gpu - l_cpu) <= 0.02 * abs(l_cpu)
    assert abs(n_gpu - n_cpu) <= 0.02 * n_cpu
    # one Adam step of lr 1e-3 moves each element by at most about lr
    # (g / (|g| + eps)): the two devices' parameters stay within 2.5 lr
    for name, p in p_cpu.items():
        assert (p_gpu[name] - p).abs().max().item() <= 2.5e-3, name


# ---- l2_topk_rf: int8 refs-outer top-k, exact ----

def _int8_case(b, n, d, pack, seed, dev):
    """Queries and refs with the values ``pack`` admits (pack 1: the whole
    int8 range), duplicated rows (exact ties), +inf rows; refs packed."""
    from rag_snvbert_tpu_torch.ops.planar import pack_planar

    gen = torch.Generator().manual_seed(seed)
    if pack == 1:
        lo, hi = -128, 128
    else:
        lo, hi = 0, 1 << (8 // pack)
    r = torch.randint(lo, hi, (n, d), generator=gen, dtype=torch.int8)
    q = torch.randint(lo, hi, (b, d), generator=gen, dtype=torch.int8)
    if n > 8:
        r[n // 2: n // 2 + 4] = r[:4]            # exact duplicates
        q[: min(b, 4)] = r[: min(b, 4)]          # queries on those rows
    norms = (r.double() ** 2).sum(1).float()
    if n > 8:
        norms[1] = norms[-3] = float("inf")
    refs = r if pack == 1 else pack_planar(r, pack)
    return q.to(dev), refs.to(dev), norms.to(dev)


RF_CASES = [  # (b, n, d, pack, k): N off the 64-row tile, N < k, odd d
    (1, 5, 1, 1, 10), (33, 130, 31, 1, 10), (33, 1000, 1030, 1, 128),
    (1, 3000, 2040, 1, 1), (33, 700, 2040, 8, 10), (33, 257, 1030, 4, 128),
    (1, 129, 31, 2, 10), (33, 70, 1, 8, 128), (33, 2048, 1030, 1, 1),
    (64, 4100, 2040, 8, 128), (33, 65, 300, 2, 1),
]


@pytest.mark.parametrize("b,n,d,pack,k", RF_CASES)
def test_l2_topk_rf_kernel_matches_plain_exactly(cuda, b, n, d, pack, k):
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain)

    q, refs, norms = _int8_case(b, n, d, pack, 7, cuda)
    before = ops.launch_counts()["l2_topk_rf"]
    vals, ids = l2_topk_rf(q, refs, norms, k, pack=pack)
    torch.cuda.synchronize()
    assert ops.launch_counts()["l2_topk_rf"] == before + 1
    rv, ri = l2_topk_rf_plain(q, refs, norms, k, pack=pack)
    # integer distances: ids and values exactly equal
    assert torch.equal(ids, ri), (ids.cpu(), ri.cpu())
    assert torch.equal(vals, rv)
    again = l2_topk_rf(q, refs, norms, k, pack=pack)
    assert torch.equal(again[0], vals) and torch.equal(again[1], ids)


# Pass 1's tiles: 128 queries (64 a consumer warpgroup), 192 ref rows,
# 128-byte chunks of the unpacked width.  B and N one below, at and one
# above a tile (or half a query tile) at every pack; widths that TMA cannot
# take (1030, 31: the cp.async and byte loaders) and ones it can (1040,
# 128); k = 128 (a one-stage ring) and small k.
RF_EDGES = [(b, n, d, pack, k)
            for pack, ds in ((1, (1030, 31, 1040, 128)), (2, (200, 512)),
                             (4, (1030, 512)), (8, (2040, 1024)))
            for (b, n), d, k in zip(
                ((63, 191), (64, 192), (65, 193), (127, 383), (128, 384),
                 (129, 385)),
                ds * 3, (10, 1, 128, 10, 32, 64))]
# rings of two stages and of one (k = 96, 128) behind each loader
RF_EDGES += [(33, 600, 1030, 1, 96), (33, 600, 1040, 1, 96),
             (33, 600, 520, 1, 128), (33, 600, 300, 2, 96),
             (130, 600, 2040, 8, 17)]


@pytest.mark.parametrize("b,n,d,pack,k", RF_EDGES)
def test_l2_topk_rf_kernel_at_its_tiles_edges(cuda, b, n, d, pack, k):
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain)

    q, refs, norms = _int8_case(b, n, d, pack, 11, cuda)
    norms[191 % n] = float("inf")                # a tile's last row
    vals, ids = l2_topk_rf(q, refs, norms, k, pack=pack)
    torch.cuda.synchronize()
    rv, ri = l2_topk_rf_plain(q, refs, norms, k, pack=pack)
    assert torch.equal(ids, ri), (ids.cpu(), ri.cpu())
    assert torch.equal(vals, rv)
    again = l2_topk_rf(q, refs, norms, k, pack=pack)
    assert torch.equal(again[0], vals) and torch.equal(again[1], ids)


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_l2_topk_rf_takes_an_unaligned_base(cuda, pack):
    """Queries and refs that start 3 bytes into a buffer: no 16-byte base
    for TMA, no 4-byte base for cp.async."""
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain)

    q, refs, norms = _int8_case(70, 600, 300 if pack > 1 else 272, pack, 3,
                                cuda)

    def shifted(x):
        buf = torch.zeros(x.numel() + 3, dtype=torch.int8, device=cuda)
        out = buf[3:].view(x.shape)
        out.copy_(x)
        assert out.data_ptr() % 4 == 3 and out.is_contiguous()
        return out

    vals, ids = l2_topk_rf(shifted(q), shifted(refs), norms, 10, pack=pack)
    rv, ri = l2_topk_rf_plain(q, refs, norms, 10, pack=pack)
    assert torch.equal(ids, ri) and torch.equal(vals, rv)


@pytest.mark.parametrize("b,n,d,pack,k", [
    (33, 4100, 2040, 1, 10), (130, 5000, 2040, 8, 10),
    (33, 3000, 1030, 1, 128), (64, 4100, 1040, 2, 17)])
@pytest.mark.parametrize("rows_x", [1, 8, 40])
def test_l2_topk_rf_plans_give_the_default_bits(cuda, b, n, d, pack, k,
                                                rows_x):
    """Any ``plan=(rows, stages)`` within the ring's depth: the plain
    version's answer and the default plan's bits (a plan of 192 rows is
    tens of splits, several waves of blocks)."""
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain,
                                                      list_stride,
                                                      ring_stages)

    q, refs, norms = _int8_case(b, n, d, pack, 11, cuda)
    want = l2_topk_rf(q, refs, norms, k, pack=pack)
    rv, ri = l2_topk_rf_plain(q, refs, norms, k, pack=pack)
    assert torch.equal(want[1], ri) and torch.equal(want[0], rv)
    for stages in range(1, ring_stages(list_stride(k), pack > 1) + 1):
        got = l2_topk_rf(q, refs, norms, k, pack=pack,
                         plan=(192 * rows_x, stages))
        assert torch.equal(got[0], want[0]), stages
        assert torch.equal(got[1], want[1]), stages


@pytest.mark.parametrize("pack", [1, 8])
@pytest.mark.parametrize("first", [185, 570, 49140])
def test_l2_topk_rf_all_ties_across_tile_and_split_edges(cuda, pack, first):
    """Every row at the same distance, the rows below ``first`` at +inf:
    the 20 nearest are first .. first + 19, across a tile's edge (192),
    across a split's (70,001 rows on 132 SMs: splits of 576 rows) and
    across the last split's start."""
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import l2_topk_rf, split_plan
    from rag_snvbert_tpu_torch.ops.planar import pack_planar

    n = 70001
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, rows = split_plan(5, n, sms)
    assert splits > 1 and rows > 192
    if first == 49140:
        first = (splits - 1) * rows - 10
    r = torch.ones(n, 64, dtype=torch.int8, device=cuda)
    refs = r if pack == 1 else pack_planar(r, pack)
    norms = torch.full((n,), 64.0, device=cuda)
    norms[:first] = float("inf")
    q = torch.zeros(5, 64, dtype=torch.int8, device=cuda)
    vals, ids = l2_topk_rf(q, refs, norms, 20, pack=pack)
    assert ids[0].tolist() == list(range(first, first + 20))
    assert ids[4].tolist() == list(range(first, first + 20))
    assert bool((vals == 64.0).all())


def test_l2_topk_rf_packed_reruns_stay_exact(cuda):
    """Many tiles a split, packed refs, eight fresh runs: the loader takes
    each packed column block into registers and starts the next block's
    load into the same buffer; a load that overtook those reads showed as
    a few wrong rows in the first runs only."""
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain)

    q, refs, norms = _int8_case(1024, 20000, 2040, 8, 13, cuda)
    rv, ri = l2_topk_rf_plain(q, refs, norms, 1, pack=8)
    for _ in range(8):
        fresh = refs.clone()
        vals, ids = l2_topk_rf(q, fresh, norms, 1, pack=8)
        assert torch.equal(ids, ri) and torch.equal(vals, rv)


def test_l2_topk_rf_smem_twin_matches_the_kernel(cuda):
    import importlib

    from rag_snvbert_tpu_torch.ops import _build

    mod = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_rf")
    lib = _build.load("l2_topk_rf", mod._SIGNATURES)
    for kp in (16, 32, 64, 96, 128):
        for packed in (False, True):
            for stages in (1, 2, 3, 4):
                assert lib.l2_topk_rf_smem(kp, int(packed), stages) == \
                    mod.smem_bytes(kp, packed, stages)


def test_l2_topk_rf_all_ties_and_inf_rows(cuda):
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import l2_topk_rf

    r = torch.ones(300, 64, dtype=torch.int8, device=cuda)
    norms = torch.full((300,), 64.0, device=cuda)
    norms[:10] = float("inf")
    q = torch.zeros(5, 64, dtype=torch.int8, device=cuda)
    vals, ids = l2_topk_rf(q, r, norms, 128)
    assert ids[0].tolist() == list(range(10, 138))
    assert bool((vals == 64.0).all())
    # fewer finite rows than k: the +inf rows follow in id order
    norms[20:] = float("inf")
    vals, ids = l2_topk_rf(q, r, norms, 20)
    assert ids[0].tolist() == list(range(10, 20)) + list(range(10))
    assert bool(torch.isinf(vals[:, 10:]).all())
    # fewer rows than k: (+inf, -1) past the last row
    vals, ids = l2_topk_rf(q, r[:3], norms[:3].clone().fill_(64.0), 5)
    assert ids[0].tolist() == [0, 1, 2, -1, -1]


def test_l2_topk_rf_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import l2_topk_rf

    r = torch.zeros(16, 256, dtype=torch.int8, device=cuda)
    n = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        l2_topk_rf(r.float(), r.float(), n, 1)
    with pytest.raises(ValueError, match="pack >= 4"):
        l2_topk_rf(r, r, n, 1, pack=2, compute="int4")
    with pytest.raises(ValueError, match="k="):
        l2_topk_rf(r, r, n, 129)
    with pytest.raises(ValueError, match="multiple of 128"):
        l2_topk_rf(r[:, :40], r[:, :100], n, 1, pack=4)
    with pytest.raises(ValueError, match="overflow"):
        w = torch.zeros(4, 20000, dtype=torch.int8, device=cuda)
        l2_topk_rf(w, w, n[:4], 128)
    # wider than any block's shared memory could hold whole: d is streamed
    w = torch.zeros(4, 4000, dtype=torch.int8, device=cuda)
    assert l2_topk_rf(w, w, n[:4], 128)[1][0, :4].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="contiguous"):
        l2_topk_rf(r.t()[:16], r.t()[:16].contiguous(), n, 1)
    w = r[:, :64].contiguous()
    vals, ids = l2_topk_rf(w, w, n, 3, compute="int4")
    assert ids[0].tolist() == [0, 1, 2]


def _token_cfg():
    from rag_snvbert_tpu_torch.config import PRESETS

    cfg = PRESETS["v17_token_rag"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dims=32, n_layers=2, attn_heads=4, seq_len=138,
        dropout=0.0))


def test_small_token_model_trains_on_the_card_like_on_the_cpu(cuda):
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train import retrieval, step
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer

    cfg = _token_cfg()
    b = make_bundle(n_train_samples=8, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)
    meta = ds.windows[0]
    np_batch = ds.make_batch(meta, np.arange(6), 1, 0, pad_to=8, packed=True)
    toks, _, valid = ds.window_ref_tokens(meta, pad_haps_to=64)
    results = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, b.vocab.size, device=dev, seed=2)
        model.bert.rag_fusion.drop.rate = 0.0
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        ctx = retrieval.build_token_window_ctx(
            t(toks).long(), t(ds.window_mask(meta, 1, 0)), valid=t(valid))
        batch = {k: t(v) for k, v in np_batch.items()}
        ops.reset_launches()
        opt = make_optimizer(model, 1e-3, 2e-3, 10)
        stats = step.train_step(model, opt, batch, ctx, step.StepConfig())
        segs = retrieval.retrieve_tokens(step.expand_packed(batch), ctx)
        if dev == "cuda":
            torch.cuda.synchronize()
            # float32 LayerNorms only: the kernels take none
            assert ops.launch_counts() == {"attention": 0,
                                           "attention_bwd": 0,
                                           "attention_f32": 0,
                                           "attention_f32_bwd": 0,
                                           "layer_norm": 0,
                                           "layer_norm_bwd": 0,
                                           "residual": 0, "residual_bwd": 0,
                                           "l2_topk": 0, "l2_topk_rf": 2,
                                           "l2_topk_float": 0}
        results[dev] = (stats["loss"].item(), stats["grad_norm"].item(),
                        segs["rag_seg_h1"].cpu(),
                        {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
    (l_gpu, n_gpu, s_gpu, p_gpu), (l_cpu, n_cpu, s_cpu, p_cpu) = \
        results["cuda"], results["cpu"]
    assert torch.equal(s_gpu, s_cpu)           # exact search on both
    # float32 on both sides (no TF32), other summation orders, two layers
    # deep: the loss to 1e-5 and the raw gradient norm to 1e-4 relative
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(n_gpu - n_cpu) <= 1e-4 * n_cpu
    # one Adam step of lr 1e-3: elements whose gradient is float32 noise can
    # move by a different fraction of lr on the two devices
    for name, p in p_cpu.items():
        assert (p_gpu[name] - p).abs().max().item() <= 2.5e-3, name


def test_token_ids_beyond_int8_raise_on_the_card(cuda):
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.train import retrieval

    ref = torch.full((40, 48), 5, dtype=torch.long, device=cuda)
    ref[3, 0] = 200
    ctx = retrieval.build_token_window_ctx(
        ref, torch.zeros(48, dtype=torch.int32, device=cuda))
    assert ctx.ref_search is None
    batch = {"hap_1": ref[:2], "hap_2": ref[2:4]}
    with pytest.raises(ValueError, match="int8"):
        retrieval.retrieve_tokens(batch, ctx)
    # the plain version on request only
    out = retrieval.retrieve_tokens(batch, ctx, use_kernel=False)
    assert out["rag_seg_h1"].shape == (2, 1, 48)
    with pytest.raises(ValueError, match="fit int8"):
        retrieval.check_int8_vocab(build_model(_token_cfg(), 200))


# ---- l2_topk_float and the offline index on the card ----

# Pass 1's tiles: 128 queries (64 a consumer), 128 ref rows, stages of 128
# bf16 / 32 float32 columns; B and N at, below and above a tile (N = 0
# too), d below a 16-byte row (1, 37: the wrapper pads), at one (8), and
# several stages (2040, 4096); k where the lists' stride and the ring's
# depth change (16 | 17..32 | 33..64 | 65..128); N < k.
FLOAT_CASES = [  # (b, n, d, k)
    (1, 1, 1, 1), (63, 191, 8, 10), (64, 192, 37, 128), (65, 49153, 8, 1),
    (1025, 200, 37, 128), (1, 200000, 2040, 10), (65, 191, 4096, 33),
    (64, 1, 2040, 10), (63, 49153, 37, 128), (1025, 20000, 8, 10),
    (3, 50001, 37, 128), (1, 192, 4096, 1), (65, 200000, 1, 10),
    (130, 20000, 4096, 32), (5, 3, 16, 128),
    (4, 0, 40, 10), (4, 100, 40, 10), (1, 3000, 37, 1), (129, 3000, 8, 32),
    (129, 1000, 4096, 33), (1, 20000, 4096, 64), (33, 5000, 37, 65),
    (129, 300, 8, 128), (2, 127, 8, 128),
]
# float32 sums of up to 4096 products in another order than the plain
# version's matmul: values to 1e-5 of |q|^2 + |r|^2, and where ids differ
# the float64 distances of both rows lie that close (a near-tie).
FLOAT_TOL = 1e-5


def _float_case(b, n, d, dtype, seed, dev, gauss=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if gauss:
        q = torch.randn(b, d, generator=gen, device=dev)
        r = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    else:
        q = torch.randint(0, 2, (b, d), generator=gen, device=dev).float()
        r = torch.randint(0, 2, (n, d), generator=gen, device=dev).to(dtype)
    rn = l2_ref.squared_norms(r)
    if n > 3:
        rn[[1, n // 2]] = float("inf")      # tombstones: never ahead
    return q, r, rn


def _float_tie_aware(q, r, rn, got, want):
    (v, i), (pv, pi) = got, want
    inf = torch.isinf(pv)
    assert torch.equal(torch.isinf(v), inf)
    assert torch.equal(i[inf], pi[inf])          # +inf rows in id order, -1
    scale = (l2_ref.squared_norms(q.to(r.dtype)).double()[:, None]
             + rn.double()[pi.clamp_min(0).long()])
    fin = ~inf
    err = ((v.double() - pv.double()).abs() / scale)[fin]
    assert err.numel() == 0 or err.max().item() <= FLOAT_TOL
    diff = (i != pi) & fin
    if diff.any():
        rows = diff.nonzero()[:, 0]
        qd = q.to(r.dtype).double()[rows]
        d_got = ((qd - r.double()[i[diff].long()]) ** 2).sum(-1)
        d_want = ((qd - r.double()[pi[diff].long()]) ** 2).sum(-1)
        assert ((d_got - d_want).abs() / scale[diff]).max().item() \
            <= FLOAT_TOL
    for row in i.cpu().tolist():
        ids = [x for x in row if x >= 0]
        assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,d,k", FLOAT_CASES)
def test_l2_topk_float_kernel_matches_plain(cuda, b, n, d, k, dtype):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    q, r, rn = _float_case(b, n, d, dtype, 11, cuda)
    before = ops.launch_counts()["l2_topk_float"]
    got = l2_topk_float(q, r, rn, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["l2_topk_float"] == before + 1
    assert got[0].shape == got[1].shape == (b, k)
    assert got[1].dtype == torch.int32
    if n == 0:
        assert torch.isinf(got[0]).all() and (got[1] == -1).all()
    else:
        _float_tie_aware(q, r, rn, got, l2_topk_float_plain(q, r, rn, k))
    again = l2_topk_float(q, r, rn, k)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_l2_topk_float_genotypes_are_exact(cuda, dtype):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    q, r, rn = _float_case(100, 30000, 2040, dtype, 12, cuda, gauss=False)
    got = l2_topk_float(q, r, rn, 10)
    want = l2_topk_float_plain(q, r, rn, 10)
    # integer distances below 2^24: ids and values exactly equal
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_l2_topk_float_ties_go_to_the_lower_id(cuda):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import l2_topk_float

    q, r, rn = _float_case(10, 60000, 40, torch.float32, 13, cuda)
    r[50000:50010] = r[:10]
    r[20000:20010] = r[:10]
    rn = l2_ref.squared_norms(r)
    _, ids = l2_topk_float(r[:10].clone(), r, rn, 3)
    want = torch.stack([torch.arange(10), torch.arange(20000, 20010),
                        torch.arange(50000, 50010)], 1)
    assert torch.equal(ids.cpu().long(), want)


def test_l2_topk_float_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import l2_topk_float

    q, r, rn = _float_case(4, 300, 40, torch.float32, 14, cuda)
    with pytest.raises(ValueError, match="int8"):
        l2_topk_float(q, r.to(torch.int8), rn, 3)
    with pytest.raises(ValueError, match="contiguous"):
        l2_topk_float(q, r.t().contiguous().t(), rn, 3)
    with pytest.raises(ValueError, match="not on"):
        l2_topk_float(q, r.cpu(), rn, 3)
    with pytest.raises(ValueError, match="not on"):
        l2_topk_float(q, r, rn.cpu(), 3)
    with pytest.raises(ValueError, match="k=129"):
        l2_topk_float(q, r, rn, 129)


@pytest.mark.parametrize("k", [1, 32, 33, 128])
def test_l2_topk_float_smem_plan_is_the_kernels(cuda, k):
    import importlib

    from rag_snvbert_tpu_torch.ops import _build

    lf = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_float")
    lib = _build.load("l2_topk_float", lf._SIGNATURES)
    cfg = lf.block_config(k)
    assert lib.l2_topk_float_smem(*cfg) == lf.smem_bytes(*cfg)


def _float_split_rows(b, n):
    import importlib

    lf = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_float")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lf.split_plan(b, n, sms)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_l2_topk_float_inf_rows_on_both_sides_of_a_split(cuda, dtype):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    b, n, d, k = 200, 50001, 40, 33     # N off the tile, several splits
    q, r, rn = _float_case(b, n, d, dtype, 22, cuda)
    rows = _float_split_rows(b, n)
    assert rows < n
    rn[[rows - 2, rows - 1, rows, rows + 1, n - 1]] = float("inf")
    # a list left short by its finite rows takes +inf rows in id order
    few = rn.clone()
    few[3:] = float("inf")
    for norms in (rn, few):
        got = l2_topk_float(q, r, norms, k)
        _float_tie_aware(q, r, norms, got,
                         l2_topk_float_plain(q, r, norms, k))
    for row in got[1].tolist():
        assert sorted(row[:3]) == [0, 1, 2] and row[3:] == list(range(3, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_l2_topk_float_takes_a_base_off_16_bytes(cuda, dtype):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    gen = torch.Generator(device=cuda).manual_seed(23)
    n, d = 3000, 40
    flat = torch.randn(n * d + 1, generator=gen, device=cuda).to(dtype)
    r = flat[1:].view(n, d)                 # contiguous, base 2-4 bytes off
    assert r.data_ptr() % 16 != 0
    q = torch.randn(17, d, generator=gen, device=cuda)
    rn = l2_ref.squared_norms(r)
    got = l2_topk_float(q, r, rn, 10)
    _float_tie_aware(q, r, rn, got, l2_topk_float_plain(q, r, rn, 10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_l2_topk_float_equal_rows_across_splits_go_to_the_lower_id(cuda,
                                                                    dtype):
    from rag_snvbert_tpu_torch.ops.l2_topk_float import l2_topk_float

    b, n, d = 10, 60000, 40
    q, r, _ = _float_case(b, n, d, dtype, 24, cuda)
    rows = _float_split_rows(b, n)
    assert 2 * rows + b < n
    r[rows:rows + b] = r[:b]
    r[2 * rows:2 * rows + b] = r[:b]
    rn = l2_ref.squared_norms(r)
    _, ids = l2_topk_float(r[:b].float(), r, rn, 3)
    want = torch.stack([torch.arange(b), torch.arange(rows, rows + b),
                        torch.arange(2 * rows, 2 * rows + b)], 1)
    assert torch.equal(ids.cpu().long(), want)


def test_l2_topk_float_f32_batches_give_the_one_launch_answer(cuda,
                                                              monkeypatch):
    """float32 refs taken in batches of rows (the TF32 lo parts' workspace
    capped) give exactly the answer of one batch: the same products per
    pair, lists merged in id order."""
    import importlib

    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    lf = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_float")
    q, r, rn = _float_case(70, 3000, 40, torch.float32, 26, cuda)
    r[2900:2910] = r[:10]                  # ties across batches
    rn = l2_ref.squared_norms(r)
    rn[[5, 1500]] = float("inf")
    whole = l2_topk_float(q, r, rn, 33)
    monkeypatch.setattr(lf, "_SPLIT_BYTES", 384 * 40 * 8)
    assert len(lf.batch_plan(70, 3000, 40, False, 132)) == 8
    parts = l2_topk_float(q, r, rn, 33)
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])
    _float_tie_aware(q, r, rn, parts, l2_topk_float_plain(q, r, rn, 33))


def test_l2_topk_float_f32_error_is_the_plain_products_or_less(cuda):
    """Precision.HIGHEST: the kernel's distances (three TF32 products a
    pair, IEEE sums of fresh accumulators, formed in double) are no
    further from float64 than the plain float32 matmul's."""
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (
        l2_topk_float, l2_topk_float_plain)

    for d in (37, 2040):
        q, r, rn = _float_case(64, 20000, d, torch.float32, 25, cuda)
        rn = l2_ref.squared_norms(r)
        errs = []
        for v, i in (l2_topk_float(q, r, rn, 10),
                     l2_topk_float_plain(q, r, rn, 10)):
            qd = q.double()
            qn = (qd ** 2).sum(1)[:, None]
            rows = r[i.long()].double()
            rnd = rn.double()[i.long()]
            d64 = qn - 2.0 * (qd[:, None, :] * rows).sum(-1) + rnd
            errs.append(((v.double() - d64).abs() / (qn + rnd)).max().item())
        assert errs[0] <= errs[1], (d, errs)


def _index_routes():
    # (storage, n, d, kernel the search launches)
    return [("f32", 3000, 45, "l2_topk_float"),
            ("bf16", 3000, 48, "l2_topk"),
            ("bf16", 60000, 45, "l2_topk_float"),
            ("int8", 3000, 45, "l2_topk_rf"),
            ("int4", 3000, 45, "l2_topk_rf"),
            ("pack8", 3000, 45, "l2_topk_rf"),
            ("pack4", 3000, 45, "l2_topk_rf")]


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("storage,n,d,kernel", _index_routes())
def test_flat_index_routes_to_a_kernel_on_the_card(cuda, storage, n, d,
                                                   kernel, align):
    from rag_snvbert_tpu_torch.index import FlatL2Index

    gen = torch.Generator(device=cuda).manual_seed(15)
    hi = 4 if storage in ("pack4", "int4") else 2
    bits = torch.randint(0, hi, (n, d), generator=gen, device=cuda)
    q = torch.randint(0, hi, (33, d), generator=gen, device=cuda).float()
    if storage.startswith("pack"):
        idx = FlatL2Index.build(bits.to(torch.int8), pack=int(storage[4:]),
                                align=align)
    else:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8, "int4": "int4"}[storage]
        idx = FlatL2Index.build(bits.float(), dtype=dt, align=align)
    mask = torch.rand(d, generator=gen, device=cuda) > 0.3
    for search in (lambda **kw: idx.search(q, 10, **kw),
                   lambda **kw: idx.masked_search(q, mask, 10, **kw)):
        ops.reset_launches()
        plain = search(use_pallas=False)
        assert not any(ops.launch_counts().values())
        got = search(use_pallas=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[kernel] == 1 and sum(counts.values()) == 1, counts
        # integer distances: exactly the plain answers
        assert torch.equal(got[1], plain[1]) and torch.equal(got[0], plain[0])


def test_flat_index_size_rule_on_the_card(cuda):
    from rag_snvbert_tpu_torch.index import FlatL2Index

    gen = torch.Generator(device=cuda).manual_seed(16)
    idx = FlatL2Index.build(torch.randint(0, 2, (66000, 24), generator=gen,
                                          device=cuda).float())
    q = torch.randint(0, 2, (1024, 24), generator=gen, device=cuda).float()
    ops.reset_launches()
    small = idx.search(q[:8], 5)          # 4 B N below 2^28: plain
    assert not any(ops.launch_counts().values())
    big = idx.search(q, 5)                # above: the kernel
    assert ops.launch_counts()["l2_topk_float"] == 1
    assert torch.equal(big[1][:8], small[1])
    # k above 128 streams (torch ops), on the card too
    ops.reset_launches()
    v, i = idx.search(q[:4], 200)
    assert i.shape == (4, 200) and not any(ops.launch_counts().values())


def test_hamming_index_on_the_card_matches_the_cpu(cuda):
    from rag_snvbert_tpu_torch.index import HammingIndex

    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, (5000, 100)).astype(np.int8)
    qb = torch.from_numpy(rng.integers(0, 2, (20, 100)).astype(np.int8))
    card = HammingIndex.build(bits)
    host = HammingIndex.build(bits, device="cpu")
    for streaming in (False, True):
        a = card.search(qb, 7, streaming=streaming, chunk=1024)
        b = host.search(qb, 7, streaming=streaming, chunk=1024)
        assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])


# ---- the int8 probe (csrc/int8_probe.cu) and Int8Dense ----

def _probe_configs():
    from rag_snvbert_tpu_torch.ops.int8_probe import TILES

    out = []
    for mode, tiles in TILES.items():
        for tile in tiles:
            orders = ("rfirst", "qfirst") if mode == "direct" else ("rfirst",)
            out += [(mode, tile, order) for order in orders]
    return out


# (B, N, d): aligned; ragged (d = 70 rows as eight row classes); d = 2040
# (two row classes, the index shape's width) with N off every tile
PROBE_SHAPES = [(16, 256, 64), (20, 1000, 70), (300, 50004, 2040)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("config", _probe_configs(),
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}x"
                                       f"{c[1][2]}-{c[2]}")
def test_int8_probe_matches_plain(cuda, config, shape):
    from rag_snvbert_tpu_torch.ops.int8_probe import (int8_probe,
                                                      int8_probe_plain)

    mode, tile, order = config
    b, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(b + n + d)
    q = torch.randint(-128, 128, (b, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    r = torch.randint(-128, 128, (n, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    kw = {"trans": mode == "trans", "int4": mode == "int4",
          "running": mode != "direct"}
    if kw["trans"]:
        r = r.t().contiguous()
    before = ops.launch_counts(tools=True)["int8_probe"]
    out, total = int8_probe(q, r, 8, 128, tile=tile, order=order,
                            return_checksum=True, **kw)
    assert ops.launch_counts(tools=True)["int8_probe"] == before + 1
    want, want_total = int8_probe_plain(q, r, 8, 128, return_checksum=True,
                                        **kw)
    assert torch.equal(out, want)
    assert int(total) == int(want_total)


def test_int8_probe_full_shape_and_int4_from_refs_t(cuda):
    from rag_snvbert_tpu_torch.ops.int8_probe import (int8_probe,
                                                      int8_probe_plain)

    gen = torch.Generator(device=cuda).manual_seed(21)
    q = torch.randint(0, 2, (1024, 2040), generator=gen, device=cuda,
                      dtype=torch.int8)
    r = torch.randint(0, 2, (664648, 2040), generator=gen, device=cuda,
                      dtype=torch.int8)
    out, total = int8_probe(q, r, 256, 512, return_checksum=True)
    want, want_total = int8_probe_plain(q, r, 256, 512, return_checksum=True)
    assert torch.equal(out, want) and int(total) == int(want_total)
    del r
    rt = torch.randint(-8, 8, (2048, 50000), generator=gen, device=cuda,
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (300, 2048), generator=gen, device=cuda,
                      dtype=torch.int8)
    out, total = int8_probe(q, rt, 64, 1024, trans=True, int4=True,
                            running=True, return_checksum=True)
    want, want_total = int8_probe_plain(q, rt, 64, 1024, trans=True,
                                        int4=True, running=True,
                                        return_checksum=True)
    assert torch.equal(out, want) and int(total) == int(want_total)


def test_int8_probe_refuses_what_tma_cannot_take(cuda):
    from rag_snvbert_tpu_torch.ops.int8_probe import int8_probe

    q = torch.zeros(4, 70, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        int8_probe(q, torch.zeros(300, 70, dtype=torch.int8, device=cuda),
                   8, 128)                       # 8 classes, 300 rows
    with pytest.raises(ValueError, match="not built"):
        int8_probe(q, torch.zeros(256, 70, dtype=torch.int8, device=cuda),
                   8, 128, tile=(64, 64, 64))


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_int8_probe_int4_from_refs_t_matches_plain(cuda, shape):
    from rag_snvbert_tpu_torch.ops.int8_probe import (TILES, int8_probe,
                                                      int8_probe_plain)

    b, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(b * n + d)
    q = torch.randint(-128, 128, (b, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    rt = torch.randint(-128, 128, (d, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    kw = {"trans": True, "int4": True, "running": True}
    want, want_total = int8_probe_plain(q, rt, 8, 128, return_checksum=True,
                                        **kw)
    for tile in TILES["int4"]:
        out, total = int8_probe(q, rt, 8, 128, tile=tile,
                                return_checksum=True, **kw)
        assert torch.equal(out, want) and int(total) == int(want_total)


@pytest.mark.parametrize("trans", [False, True], ids=["refs", "refs_t"])
@pytest.mark.parametrize("n,d", [(1, 1), (37, 70), (1000, 2040),
                                 (5003, 2048)])
def test_pack_int4_matches_plain(cuda, n, d, trans):
    from rag_snvbert_tpu_torch.ops.int8_probe import (pack_int4,
                                                      pack_int4_plain)

    gen = torch.Generator(device=cuda).manual_seed(n + d)
    r = torch.randint(-128, 128, (n, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    src = r.t().contiguous() if trans else r
    before = ops.launch_counts(tools=True)["int8_probe_pack_int4"]
    got = pack_int4(src, trans=trans)
    assert ops.launch_counts(tools=True)["int8_probe_pack_int4"] == before + 1
    assert torch.equal(got, pack_int4_plain(src, trans=trans))


def test_int8_probe_refuses_refs_t_of_odd_width(cuda):
    from rag_snvbert_tpu_torch.ops.int8_probe import int8_probe

    q = torch.zeros(4, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_probe(q, torch.zeros(64, 258, dtype=torch.int8, device=cuda),
                   8, 128, trans=True)


@pytest.mark.parametrize("mode", ["fwd_bwd", "fwd"])
@pytest.mark.parametrize("shape", [(2, 40, 48, 24), (3, 7, 384, 1536),
                                   (2, 5, 13, 9)])
def test_int8_dense_on_the_card_matches_the_cpu(cuda, shape, mode):
    """Forward bit-identical (exact integer products around the same IEEE
    steps); the quantized backward's dx and dw too.  The exact ("fwd")
    backward's products and every bias gradient (a sum over rows) are
    summed in another order on the card: one bf16 rounding."""
    import copy

    from rag_snvbert_tpu_torch.ops.quant import Int8Dense

    b, l, k, n = shape
    gen = torch.Generator().manual_seed(k * n)
    layer = Int8Dense(k, n, torch.bfloat16, mode=mode)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(n, k, generator=gen) / k ** 0.5)
        layer.bias.copy_(torch.randn(n, generator=gen))
    x = torch.randn(b, l, k, generator=gen).to(torch.bfloat16)
    g = torch.randn(b, l, n, generator=gen).to(torch.bfloat16)
    got = {}
    for dev in ("cpu", "cuda"):
        lay = copy.deepcopy(layer).to(dev)
        xd = x.to(dev).detach().clone().requires_grad_()
        y = lay(xd)
        y.backward(g.to(dev))
        got[dev] = [t.detach().cpu().float() for t in
                    (y, xd.grad, lay.weight.grad, lay.bias.grad)]
    for i, (a, c) in enumerate(zip(got["cuda"], got["cpu"])):
        if i == 0 or (mode == "fwd_bwd" and i in (1, 2)):
            assert torch.equal(a, c), i
        else:
            assert (a - c).abs().max() <= 2 ** -7 * c.abs().max(), i


# LayerNorm (csrc/layer_norm.cu): the main path's widths at its 49,440 rows
# (48 sequences x 1030) and a ragged count, and one width for each of the
# kernel's twelve (threads a row, vectors a thread) instances.
LN_EPS = 1e-6
LN_SHAPES = [(49440, 384), (49440, 1536), (1037, 384), (1037, 1536),
             (3, 64), (517, 64), (5, 8), (129, 128), (65, 192), (77, 256),
             (40, 512), (50, 768), (301, 1000), (31, 2048), (33, 2056),
             (9, 4096)]


def _ln_inputs(rows, d, cuda):
    gen = torch.Generator(device=cuda).manual_seed(rows * 7 + d)
    x = (torch.randn(rows, d, generator=gen, device=cuda) * 3 + 0.5).to(
        torch.bfloat16)
    w = torch.randn(d, generator=gen, device=cuda) * 0.2 + 1
    b = torch.randn(d, generator=gen, device=cuda) * 0.1
    dy = _bf16((rows, d), gen, cuda)
    return x, w, b, dy


@pytest.mark.parametrize("rows,d", LN_SHAPES)
def test_layer_norm_kernels_match_plain(cuda, rows, d):
    x, w, b, dy = _ln_inputs(rows, d, cuda)
    before = ops.launch_counts()
    y, mean, rstd = layer_norm_fwd(x, w, b, LN_EPS)
    dx, dg, db = layer_norm_bwd(dy, x, mean, rstd, w)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["layer_norm"] == before["layer_norm"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    # float32 statistics against float64: a few float32 roundings of a sum
    # of d terms
    x64 = x.double()
    m64 = x64.mean(-1)
    r64 = (x64.var(-1, unbiased=False) + LN_EPS).rsqrt()
    assert ((mean.double() - m64).abs()
            <= 1e-5 * x64.abs().amax(-1)).all()
    assert ((rstd.double() - r64).abs() <= 1e-5 * r64).all()
    # y and dx: the same float32 formulas as the plain chain in another
    # order, rounded once to bf16 on both sides: a bf16 rounding (2^-8
    # relative, one flip of the last bit 2^-7) and float32 noise
    ref = layer_norm_plain(x, w, b, LN_EPS).float()
    assert ((y.float() - ref).abs() <= 2 ** -7 * ref.abs() + 1e-4).all()
    rdx, rdg, rdb = layer_norm_bwd_plain(dy, x, w, b, LN_EPS)
    rdx = rdx.float()
    assert ((dx.float() - rdx).abs()
            <= 2 ** -7 * rdx.abs() + 1e-4 * rdx.abs().max()).all()
    # dgamma, dbeta: float32 sums over the rows in another order than the
    # plain backward's, within 1e-5 of the sum of the terms' magnitudes
    xhat = (x64 - m64[:, None]) * r64[:, None]
    for got, want, terms in ((dg, rdg, dy.double() * xhat),
                             (db, rdb, dy.double())):
        tol = 1e-5 * terms.abs().sum(0) + 1e-6
        assert ((got.double() - terms.sum(0)).abs() <= tol).all()
        assert ((got.double() - want.double()).abs() <= 2 * tol).all()


def test_layer_norm_kernel_runs_are_bit_identical(cuda):
    x, w, b, dy = _ln_inputs(49440, 384, cuda)
    first = layer_norm_fwd(x, w, b, LN_EPS)
    grads = layer_norm_bwd(dy, x, first[1], first[2], w)
    second = layer_norm_fwd(x, w, b, LN_EPS)
    again = layer_norm_bwd(dy, x, first[1], first[2], w)
    for a, c in zip((*first, *grads), (*second, *again)):
        assert torch.equal(a, c)
    # without statistics the output is the same
    y, mean, rstd = layer_norm_fwd(x, w, b, LN_EPS, with_stats=False)
    assert mean is None and rstd is None and torch.equal(y, first[0])


def test_layer_norm_replays_in_a_cuda_graph_like_eager(cuda):
    x, w, b, dy = _ln_inputs(1037, 1536, cuda)
    x2, _, _, dy2 = _ln_inputs(1037, 1536, cuda)
    x2, dy2 = x2.flip(0).contiguous(), dy2.flip(1).contiguous()
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))

    def run():
        y = layer_norm(xg, wg, bg, LN_EPS)
        return (y, *torch.autograd.grad(y, (xg, wg, bg), dy))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        captured = run()
    after = ops.launch_counts()
    assert after["layer_norm"] == before["layer_norm"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    with torch.no_grad():
        xg.copy_(x2)
        dy.copy_(dy2)
    graph.replay()
    torch.cuda.synchronize()
    eager = run()
    for a, c in zip(captured, eager):
        assert torch.equal(a, c)


def test_layer_norm_launches_in_a_tpu_default_micro_step(cuda):
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.models.layers import Dropout, LayerNorm
    from rag_snvbert_tpu_torch.train import retrieval, step
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer

    cfg = PRESETS["tpu_default"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_layers=2))
    b = make_bundle(n_train_samples=8, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)
    meta = ds.windows[0]
    np_batch = ds.make_batch(meta, np.arange(6), 1, 0, pad_to=8, packed=True)
    toks, af, valid = ds.window_ref_tokens(meta, pad_haps_to=64)
    model = build_model(cfg, b.vocab.size, seed=2)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    ctx = retrieval.encode_window_refs(
        model.embed, t(toks).long(), t(af),
        t(ds.window_mask(meta, 1, 0)), valid=t(valid))
    batch = {k: t(v) for k, v in np_batch.items()}
    calls = []
    for name, mod in model.named_modules():
        if isinstance(mod, LayerNorm):
            mod.register_forward_hook(lambda m, i, o, name=name: calls.append(
                (name, i[0].dtype == o.dtype == torch.bfloat16)))
    ops.reset_launches()
    opt = make_optimizer(model, 1e-3, 2e-3, 10)
    step.train_step(model, opt, batch, ctx, step.StepConfig())
    torch.cuda.synchronize()
    # 3 a block, the AF embedding twice, the embedding fusion, the RAG
    # fusion and its AF interaction; only the heads' stay float32
    bf16 = sum(flag for _, flag in calls)
    assert bf16 == 3 * 2 + 5
    assert all(name.split(".")[0] in ("hap_classifier", "gt_classifier")
               for name, flag in calls if not flag)
    counts = ops.launch_counts()
    assert counts["layer_norm"] == counts["layer_norm_bwd"] == bf16


# ---- the float32 attention kernels with dropout (csrc/attention_f32.cu) ----

F32_RATE = 0.1
# upstream V18 as published at batch 24 (48 sequences of 12 heads) and
# V17 at batch 16 with its retrieved segments (64 sequences of 6 heads)
F32_MAIN = [(48, 12, 1030, 32), (64, 6, 1030, 32)]
# the query tiles of 64 and the backward's blocks of 128 keys, the last of
# which takes its own path when it holds at most 16 keys: L = 1, tile - 1,
# tile, tile + 1, 2 blocks - 1, 2 blocks, 2 blocks + 1, a block + 16 and
# + 17, and the main paths' 1030 (8 blocks and 6 keys)
F32_EDGE_LS = (1, 63, 64, 65, 127, 129, 1030, 128, 144, 145, 255, 256, 257)


def _f32_inputs(shape, dev, seed, rate):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(4))
    keep = None
    if rate:
        keep = torch.rand(*shape[:3], shape[2], generator=gen,
                          device=dev) >= rate
    return q, k, v, do, keep


def _f32_run(q, k, v, do, keep, rate):
    """The kernels' ``(o, lse, dq, dk, dv)``."""
    from rag_snvbert_tpu_torch.ops.attention_f32 import (attention_f32_bwd,
                                                         attention_f32_fwd)

    scale = q.shape[-1] ** -0.5
    out, lse, bits = attention_f32_fwd(q, k, v, scale, keep, rate)
    return (out, lse, *attention_f32_bwd(q, k, v, out, lse, do, scale, bits,
                                         rate))


def _f32_plain(q, k, v, do, keep, rate):
    from rag_snvbert_tpu_torch.ops.attention_f32 import (
        attention_f32_bwd_plain, attention_f32_fwd_plain)

    scale = q.shape[-1] ** -0.5
    out, lse = attention_f32_fwd_plain(q, k, v, scale, keep, rate)
    return (out, lse, *attention_f32_bwd_plain(q, k, v, out, lse, do, scale,
                                               keep, rate))


def _f32_assert_close(got, want):
    # float32 on both sides, sums of up to 1030 terms in other orders
    # (about sqrt(1030) ulps of the largest term): o and the LSE within
    # 1e-5 of their largest value, the gradients (differences of such
    # sums) within 1e-4 of theirs
    for name, a, b, tol in zip(("o", "lse", "dq", "dk", "dv"), got, want,
                               (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= tol * b.abs().max().item() + 1e-6, (name, err)


@pytest.mark.parametrize("rate", [0.0, F32_RATE])
@pytest.mark.parametrize("shape", F32_MAIN + [
    (2, 3, l, 32) for l in F32_EDGE_LS] + [(1, 1, 1030, 32),
                                           (3, 7, 200, 32)])
def test_attention_f32_kernels_match_plain(cuda, shape, rate):
    q, k, v, do, keep = _f32_inputs(shape, cuda, 1, rate)
    before = ops.launch_counts()
    got = _f32_run(q, k, v, do, keep, rate)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["attention_f32"] == before["attention_f32"] + 1
    assert after["attention_f32_bwd"] == before["attention_f32_bwd"] + 1
    want = _f32_plain(q, k, v, do, keep, rate)
    _f32_assert_close(got, want)


def test_attention_f32_error_is_the_plain_versions_or_less(cuda):
    """Against float64, the kernels' error is at most about the plain
    float32 version's (which rounds its products and softmax once)."""
    q, k, v, do, keep = _f32_inputs((4, 12, 1030, 32), cuda, 2, F32_RATE)
    got = _f32_run(q, k, v, do, keep, F32_RATE)
    plain = _f32_plain(q, k, v, do, keep, F32_RATE)
    exact = _f32_plain(*(x.double() for x in (q, k, v, do)), keep, F32_RATE)
    for name, a, p, e in zip(("o", "lse", "dq", "dk", "dv"), got, plain,
                             exact):
        err = (a.double() - e).abs().max().item()
        ref = (p.double() - e).abs().max().item()
        assert err <= 4 * ref + 1e-7 * e.abs().max().item(), (name, err, ref)


def test_attention_f32_keys_with_a_shared_part_keep_dq_accurate(cuda):
    """Keys that share a large part, as a trained encoder's do: against
    float64, ``ops.attention_f32`` (its keys less their mean) stays as
    close as autograd of the einsum path in float32 for the output and
    every gradient; the kernels fed the keys as they are put dq further
    than the einsum path's, and more than ten times as far as with the
    mean taken out (its rows of ds sum to a rounding residue, which
    multiplies the keys' shared part)."""
    q, k, v, do, keep = _f32_inputs((4, 12, 1030, 32), cuda, 5, F32_RATE)
    gen = torch.Generator(device=cuda).manual_seed(6)
    k = k + 16.0 * torch.randn(4, 12, 1, 32, generator=gen, device=cuda)
    scale = 32 ** -0.5

    def einsum(a, b, c):
        p = torch.softmax(torch.matmul(a, b.transpose(-1, -2)) * scale, -1)
        p = torch.where(keep, p / (1.0 - F32_RATE),
                        torch.zeros((), dtype=p.dtype, device=p.device))
        return torch.matmul(p, c)

    def out_and_grads(fn, *xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out = fn(*xs)
        out.backward(do.to(out.dtype))
        return [out.detach()] + [x.grad for x in xs]

    def errors(got):
        return [((a.double() - e).norm() / e.norm()).item()
                for a, e in zip(got, exact)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        exact = out_and_grads(einsum, *(x.double() for x in (q, k, v)))
        theirs = errors(out_and_grads(einsum, q, k, v))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    mine = errors(out_and_grads(
        lambda a, b, c: ops.attention_f32(a, b, c, scale, keep, F32_RATE),
        q, k, v))
    for name, a, b in zip(("o", "dq", "dk", "dv"), mine, theirs):
        assert a <= b, (name, a, b)
    o, lse, dq, dk, dv = _f32_run(q, k, v, do, keep, F32_RATE)
    as_given = errors([o, dq, dk, dv])
    assert as_given[1] > theirs[1], (as_given[1], theirs[1])
    assert as_given[1] > 10 * mine[1], (as_given[1], mine[1])


@pytest.mark.parametrize("shape", F32_MAIN)
def test_attention_f32_runs_are_bit_identical(cuda, shape):
    q, k, v, do, keep = _f32_inputs(shape, cuda, 3, F32_RATE)
    first = _f32_run(q, k, v, do, keep, F32_RATE)
    second = _f32_run(q, k, v, do, keep, F32_RATE)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", F32_MAIN)
def test_attention_f32_bwd_is_its_three_kernels_once(cuda, shape):
    """One backward call is one launch each of the row sums, the dk/dv pass
    and the dq sum, and no other device work: the kernel names by which
    ``benchmark/metrics/attention_f32_bwd_roofline.train.py`` reads the
    backward's time and counts its calls."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import kernel_class
    from rag_snvbert_tpu_torch.ops.attention_f32 import (attention_f32_bwd,
                                                         attention_f32_fwd)

    q, k, v, do, keep = _f32_inputs(shape, cuda, 7, F32_RATE)
    scale = shape[-1] ** -0.5
    out, lse, bits = attention_f32_fwd(q, k, v, scale, keep, F32_RATE)
    attention_f32_bwd(q, k, v, out, lse, do, scale, bits, F32_RATE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention_f32_bwd(q, k, v, out, lse, do, scale, bits, F32_RATE)
        torch.cuda.synchronize()
    launches = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_class(e.name)
            launches[name] = launches.get(name, 0) + 1
    assert launches == {"attn_f32_dsum_kernel": 1,
                        "attn_f32_bwd_dkv_kernel": 1,
                        "attn_f32_bwd_dq_kernel": 1}, launches


def _f32_draws(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(*shape[:3], shape[2], generator=gen, device=dev)


@pytest.mark.parametrize("rate", [0.0, F32_RATE])
@pytest.mark.parametrize("shape", F32_MAIN + [
    (2, 3, l, 32) for l in F32_EDGE_LS])
def test_attention_f32_fwd_from_draws_matches_plain(cuda, shape, rate):
    """The forward handed the dropout's draws (the model's path) against
    its plain version with their mask, its bits against the packed mask
    element for element, and its output, LSE and bits against those of
    the forward handed the bool mask, bit for bit."""
    from rag_snvbert_tpu_torch.ops.attention_f32 import (
        attention_f32_fwd, attention_f32_fwd_plain, pack_keep_plain)

    q, k, v, _, _ = _f32_inputs(shape, cuda, 8, 0.0)
    draws = _f32_draws(shape, cuda, 9)
    keep = draws >= rate
    scale = shape[-1] ** -0.5
    out, lse, bits = attention_f32_fwd(q, k, v, scale, draws, rate)
    torch.cuda.synchronize()
    assert torch.equal(bits, pack_keep_plain(keep))
    want, want_lse = attention_f32_fwd_plain(q, k, v, scale, keep, rate)
    for a, b, tol in ((out, want, 1e-5), (lse, want_lse, 1e-5)):
        err = (a - b).abs().max().item()
        assert err <= tol * b.abs().max().item() + 1e-6, err
    by_mask = attention_f32_fwd(q, k, v, scale, keep, rate)
    for a, b in zip((out, lse, bits), by_mask):
        assert torch.equal(a, b)


@pytest.mark.parametrize("l", (65, 1030))
def test_attention_f32_draws_of_a_heads_slice(cuda, l):
    """A tensor-parallel rank's heads of the draws (a view of every head's)
    give the bits and outputs of those heads in the whole call."""
    from rag_snvbert_tpu_torch.ops.attention_f32 import attention_f32_fwd

    shape = (2, 4, l, 32)
    q, k, v, _, _ = _f32_inputs(shape, cuda, 10, 0.0)
    draws = _f32_draws(shape, cuda, 11)
    whole = attention_f32_fwd(q, k, v, 0.2, draws, F32_RATE)
    part = attention_f32_fwd(*(x[:, 1:3].contiguous() for x in (q, k, v)),
                             0.2, draws[:, 1:3], F32_RATE)
    for a, b in zip(whole, part):
        assert torch.equal(a[:, 1:3], b)


@pytest.mark.parametrize("shape", F32_MAIN)
def test_attention_f32_fwd_from_draws_is_bit_identical(cuda, shape):
    from rag_snvbert_tpu_torch.ops.attention_f32 import attention_f32_fwd

    q, k, v, _, _ = _f32_inputs(shape, cuda, 12, 0.0)
    draws = _f32_draws(shape, cuda, 13)
    first = attention_f32_fwd(q, k, v, 0.2, draws, F32_RATE)
    second = attention_f32_fwd(q, k, v, 0.2, draws, F32_RATE)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", F32_MAIN)
def test_attention_f32_fwd_is_its_kernels_once(cuda, shape):
    """One forward call handed the draws launches ``attn_f32_fwd_kernel``
    once and nothing else: no pass over the draws and no bool mask; handed
    a bool mask, the packing once before it.  The kernel names by which
    ``benchmark/metrics/attention_f32_fwd_roofline.train.py`` reads the
    forward's time and counts its calls."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import kernel_class
    from rag_snvbert_tpu_torch.ops.attention_f32 import attention_f32_fwd

    q, k, v, _, _ = _f32_inputs(shape, cuda, 14, 0.0)
    draws = _f32_draws(shape, cuda, 15)
    keep = draws >= F32_RATE
    for mask, want in ((draws, {"attn_f32_fwd_kernel": 1}),
                       (keep, {"attn_f32_pack_kernel": 1,
                               "attn_f32_fwd_kernel": 1})):
        attention_f32_fwd(q, k, v, 0.2, mask, F32_RATE)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            attention_f32_fwd(q, k, v, 0.2, mask, F32_RATE)
            torch.cuda.synchronize()
        launches = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = kernel_class(e.name)
                launches[name] = launches.get(name, 0) + 1
        assert launches == want, launches


@pytest.mark.parametrize("l", (1, 65, 1030))
def test_attention_f32_pack_matches_plain(cuda, l):
    from rag_snvbert_tpu_torch.ops.attention_f32 import (pack_keep,
                                                         pack_keep_plain)

    keep = torch.rand(3, 5, l, l, device=cuda) >= F32_RATE
    assert torch.equal(pack_keep(keep), pack_keep_plain(keep))
    # a non-contiguous mask (a tensor-parallel rank's heads) packs alike
    assert torch.equal(pack_keep(keep[:, 1:3]),
                       pack_keep_plain(keep[:, 1:3].contiguous()))


@pytest.mark.parametrize("l", (65, 129))
def test_attention_f32_kernels_keep_to_their_head(cuda, l):
    """Head 1 with NaN in the K, V and dO of head 2 and 1e4 in head 3's:
    its O, LSE and gradients equal those of head 1 run alone, bit for
    bit."""
    q, k, v, do, keep = _f32_inputs((1, 4, l, 32), cuda, 4, F32_RATE)
    for x in (k, v, do):
        x[:, 2] = float("nan")
        x[:, 3] = 1e4
    got = _f32_run(q, k, v, do, keep, F32_RATE)
    one = [x[:, 1:2].contiguous() for x in (q, k, v, do, keep)]
    alone = _f32_run(*one, F32_RATE)
    for a, b in zip(got, alone):
        assert torch.equal(a[:, 1:2], b)
    assert bool(torch.isfinite(got[0][:, :2]).all())


def test_attention_f32_is_differentiable_through_the_kernels(cuda):
    q, k, v, do, keep = _f32_inputs((2, 6, 70, 32), cuda, 5, F32_RATE)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launches()
    out = ops.attention_f32(*leaves, 32 ** -0.5, keep, F32_RATE)
    grads = torch.autograd.grad(out, leaves, do)
    assert ops.launch_counts() == {"attention": 0, "attention_bwd": 0,
                                   "attention_f32": 1,
                                   "attention_f32_bwd": 1,
                                   "layer_norm": 0, "layer_norm_bwd": 0,
                                   "residual": 0, "residual_bwd": 0,
                                   "l2_topk": 0, "l2_topk_rf": 0,
                                   "l2_topk_float": 0}
    want = _f32_plain(q, k, v, do, keep, F32_RATE)
    for a, b in zip((out, *grads), (want[0], *want[2:])):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_attention_f32_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    from rag_snvbert_tpu_torch.ops.attention_f32 import (attention_f32_bwd,
                                                         attention_f32_fwd)

    x = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        attention_f32_fwd(x.bfloat16(), x.bfloat16(), x.bfloat16(), 1.0)
    for hd in (16, 64, 128):
        y = torch.zeros(1, 2, 8, hd, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            attention_f32_fwd(y, y, y, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 32, 8, device=cuda).transpose(2, 3)
        attention_f32_fwd(t, t, t, 1.0)
    with pytest.raises(ValueError, match="keep"):
        attention_f32_fwd(x, x, x, 1.0, torch.ones(1, 2, 8, 7, device=cuda,
                                                   dtype=torch.bool), 0.1)
    out, lse, _ = attention_f32_fwd(x, x, x, 1.0)
    with pytest.raises(ValueError, match="bits"):
        attention_f32_bwd(x, x, x, out, lse, x, 1.0,
                          torch.zeros(1, 2, 8, 1, device=cuda,
                                      dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="lse"):
        attention_f32_bwd(x, x, x, out, lse[:, :1], x, 1.0)


def _v18_published(**model_kw):
    """Upstream V18 as published (12 heads of 32, post-LN, float32,
    attention dropout 0.1) at two layers over windows of 128 sites."""
    from rag_snvbert_tpu_torch.config import PRESETS

    cfg = PRESETS["v18_embedding_rag"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_layers=2, seq_len=138, **model_kw))


def test_v18_published_graphs_and_remat_are_bit_identical(cuda, tmp_path,
                                                          monkeypatch):
    """An epoch of V18 as published at batch 4 x accumulation 2 through
    ``Trainer``: K = 4 CUDA graphs and every remat mode give the bits of
    K = 1 without remat, under deterministic algorithms (the CUDA
    embedding backward sums in a varying order otherwise); the attention
    runs on the float32 kernels, a forward and a backward a layer and a
    micro-step."""
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    b = make_bundle(n_train_samples=16, n_ref_samples=24, n_sites=256,
                    n_windows=2, seed=5)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)

    def fit(k, remat):
        cfg = _v18_published(remat=remat)
        tcfg = TrainerConfig(
            epochs=1, batch_size=4, val_batch_size=4, init_lr=cfg.init_lr,
            max_lr=cfg.max_lr, warmup_steps=cfg.warmup_steps,
            grad_accum_steps=cfg.grad_accum_steps,
            focal_gamma=cfg.focal_gamma, rag_k=cfg.rag_k, ref_pad_haps=64,
            output_dir=str(tmp_path / f"k{k}-{remat}"), log_freq=1000,
            seed=0, rag_mode="embedding", steps_per_dispatch=k,
            async_checkpoints=False, keep_checkpoints=1)
        trainer = Trainer(build_model(cfg, b.vocab.size, seed=0), ds, tcfg)
        ops.reset_launches()
        row = trainer.fit()["history"][0]
        torch.cuda.synchronize()
        return ({n: p.detach().cpu() for n, p in
                 trainer.model.state_dict().items()},
                {n: v for n, v in row.items() if "seconds" not in n},
                ops.launch_counts())

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        params, row, launches = fit(1, False)
        others = {(k, r): fit(k, r) for k, r in (
            (4, False), (1, True), (1, "save_ffn"), (1, "attention"),
            (1, "save_most"), (4, True))}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    micro = 2 * 16 // 4          # two windows of 16 samples at batch 4
    assert launches["attention_f32_bwd"] == 2 * micro
    assert launches["attention_f32"] >= 2 * micro
    assert launches["attention"] == launches["attention_bwd"] == 0
    for key, (p, r, _) in others.items():
        assert r == row, key
        assert all(torch.equal(p[n], v) for n, v in params.items()), key
    # a graph's warm-up and capture launch nothing the counts keep
    assert others[(4, False)][2] == launches
    assert others[(4, True)][2] == others[(1, True)][2]


def test_v18_published_imputes_on_the_card_like_on_the_cpu(cuda):
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = _v18_published()
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
    counts = ops.launch_counts()
    # two layers a window, without a mask; nothing else
    assert counts["attention_f32"] == 2 * 2
    assert counts["attention_f32_bwd"] == counts["attention"] == 0
    on_cpu = Imputer(build_model(cfg, b.vocab.size, device="cpu", seed=1),
                     b.ref, b.freq, device="cpu", **kw).impute(target)
    miss = on_card.imputed_flag
    for got, want in ((on_card.hap1_prob, on_cpu.hap1_prob),
                      (on_card.hap2_prob, on_cpu.hap2_prob)):
        # float32 on both sides (TF32 off), sums in other orders
        assert np.abs(got[miss] - want[miss]).max() <= 1e-4


RESIDUAL_EDGE_SHAPES = [(1, 1, 8), (3, 5, 64), (2, 257, 384), (5, 1030, 64),
                        (2, 3, 4096), (4, 129, 1536)]


def _residual_inputs(shape, cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, f, g = ((torch.randn(shape, generator=gen, device=cuda) * 2).to(
        torch.bfloat16) for _ in range(3))
    keeps = [torch.rand(shape[0], 1, shape[2], generator=gen, device=cuda)
             >= 0.1 for _ in range(2)]
    return x, f, g, keeps


@pytest.mark.parametrize("shape", RESIDUAL_EDGE_SHAPES)
@pytest.mark.parametrize("n_masks", [0, 1, 2])
@pytest.mark.parametrize("leaky", [False, True], ids=["identity", "leaky"])
def test_residual_kernels_equal_the_chain(cuda, shape, n_masks, leaky):
    from rag_snvbert_tpu_torch.ops.residual import residual, residual_plain

    x, f, g, keeps = _residual_inputs(shape, cuda)
    masks, rates = keeps[:n_masks], [0.1, 0.25][:n_masks]
    xg, fg, xc, fc = (t.clone().requires_grad_() for t in (x, f, x, f))
    ops.reset_launches()
    y = residual(xg, fg, masks, rates, leaky)
    got = torch.autograd.grad(y, (xg, fg), g)
    y_chain = residual_plain(xc, fc, masks, rates, leaky)
    want = torch.autograd.grad(y_chain, (xc, fc), g)
    # the chain's roundings, in its order: bit for bit
    assert torch.equal(y, y_chain)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    assert ops.launch_counts()["residual"] == 1
    assert ops.launch_counts()["residual_bwd"] == int(n_masks > 0 or leaky)


def test_residual_replays_in_a_cuda_graph_like_eager(cuda):
    from rag_snvbert_tpu_torch.ops.residual import residual

    x, f, g, keeps = _residual_inputs((3, 130, 384), cuda)
    x2, f2, g2, _ = _residual_inputs((3, 130, 384), cuda, seed=1)
    xg, fg = x.clone().requires_grad_(), f.clone().requires_grad_()

    def run():
        y = residual(xg, fg, keeps, [0.1, 0.1], True)
        return (y, *torch.autograd.grad(y, (xg, fg), g))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        captured = run()
    after = ops.launch_counts()
    assert after["residual"] == before["residual"] + 1
    assert after["residual_bwd"] == before["residual_bwd"] + 1
    with torch.no_grad():
        xg.copy_(x2)
        fg.copy_(f2)
        g.copy_(g2)
        keeps[0].logical_not_()
    graph.replay()
    torch.cuda.synchronize()
    eager = run()
    for a, c in zip(captured, eager):
        assert torch.equal(a, c)


def test_residual_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    from rag_snvbert_tpu_torch.ops.residual import residual_bwd, residual_fwd

    x, f, g, keeps = _residual_inputs((2, 3, 64), cuda)
    with pytest.raises(ValueError, match="bf16"):
        residual_fwd(x, f.float())
    with pytest.raises(ValueError, match="width"):
        residual_fwd(x[..., :60].contiguous(), f[..., :60].contiguous())
    with pytest.raises(ValueError, match="bool"):
        residual_fwd(x, f, [keeps[0].expand(2, 3, 64).contiguous()], [0.1])
    with pytest.raises(ValueError, match="contiguous"):
        residual_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), f)
    with pytest.raises(ValueError, match="on cuda"):
        residual_bwd(g, f, [keeps[0].cpu()], [0.1], True)
