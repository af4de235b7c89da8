"""The imputer's CUDA graphs of ``_forward`` (infer/imputer.py), off the
card: which imputers take them, and the key logic.

On the card each device batch of ``Imputer.impute`` is one replay of its
key's graph; tests/test_torch_cuda.py holds the replays to the eager
path's bits and launch counts there.  Here the capture is replaced by a
CPU stand-in that keeps static copies of the batch and the context, as
the card's does, and whose replay runs ``_forward`` on them and writes
the graph's output buffers (the event after a replay's copies out is a
no-op): so the imputer's loads of the static buffers (the haplotypes
every batch, the window rows and context a window) and its copies out
are held to the eager path's bits as well, in every RAG mode, over a
ragged last batch and two windows."""

import dataclasses

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.infer import imputer as imputer_mod
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.utils import graphs

from test_torch_dispatch import _guarded

SEQ_LEN = 138
MODES = ("embedding", "token", "none")
FIELDS = ("hap1_prob", "hap2_prob", "gt_prob", "imputed_flag")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drop(vcf, keep):
    return dataclasses.replace(vcf, gt=vcf.gt[keep], pos=vcf.pos[keep],
                               chrom=vcf.chrom[keep], ref=vcf.ref[keep],
                               alt=vcf.alt[keep], ids=vcf.ids[keep])


def _setup(rag_mode="embedding", batch_size=4, mesh=None):
    """The smoke model in ``rag_mode`` over 2 windows, 10 targets at
    ``batch_size`` (3 device batches a window at 4, the last padded by
    2 rows), and two targets with other missing sites."""
    b = make_bundle(n_train_samples=10, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    cfg = tconfig.PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rag_mode=rag_mode))
    model = tconfig.build_model(cfg, b.vocab.size, device="cpu", seed=0)
    imp = Imputer(model, b.ref, b.freq, window_len=SEQ_LEN - 10,
                  seq_len=SEQ_LEN, ref_pad_haps=32, batch_size=batch_size,
                  device="cpu", rag_mode=rag_mode, mesh=mesh)
    targets = [_drop(b.train, np.random.default_rng(seed).random(
        b.train.n_variants) > 0.5) for seed in (3, 4)]
    return imp, targets


class _CPUGraph:
    """``torch.cuda.CUDAGraph``'s stand-in: made by running ``fn`` once
    (its outputs are the graph's buffers); a replay runs ``fn`` again and
    writes its outputs into them."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for buf, new in zip(self.out, self.fn()):
            buf.copy_(new)


class _NoEvent:
    """``torch.cuda.Event``'s stand-in: the CPU's copies are done when
    they return.  ``recorded`` keeps the stream of every event
    recorded."""

    recorded: list = []

    def record(self, stream=None):
        self.recorded.append(stream)

    def synchronize(self):
        pass


def _stream(device=None):
    """``torch.cuda.current_stream``'s stand-in: the stream named by the
    device it was asked for (``None``: the current device's)."""
    return ("stream", device)


def use_stand_in(monkeypatch, capture=None):
    """Captures go to ``capture`` (``_cpu_capture``), events to
    ``_NoEvent``, ``current_stream`` to ``_stream``; returns the streams
    events are recorded on."""
    monkeypatch.setattr(Imputer, "_capture", capture or _cpu_capture)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", _stream)
    monkeypatch.setattr(_NoEvent, "recorded", [])
    return _NoEvent.recorded


def _cpu_capture(self, batch, ctx):
    static = {k: v.clone() for k, v in batch.items()}
    static_ctx = None
    if ctx is not None:
        static_ctx = graphs.empty_ctx(ctx)
        graphs.load_ctx(static_ctx, ctx)
    g = _CPUGraph(lambda: self._forward(static, static_ctx))
    return imputer_mod._Graph(g, static, static_ctx, g.out,
                              [0] * len(graphs.counters()))


@pytest.fixture
def stand_in(monkeypatch):
    """Captures go to ``_cpu_capture``; returns the keys captured."""
    keys = []

    def capture(self, batch, ctx):
        keys.append(len(self._graphs))
        return _cpu_capture(self, batch, ctx)

    use_stand_in(monkeypatch, capture)
    return keys


def _eager(imp, target):
    imp.use_graphs = False
    try:
        return imp.impute(target)
    finally:
        imp.use_graphs = True


def _assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _batches(imp, target):
    return len(imp.windows) * -(-target.n_samples // imp.batch_size)


def _mesh_world(rank):
    imp, targets = _setup(batch_size=4, mesh=make_mesh(2, device="cpu"))
    res = imp.impute(targets[0])
    return (imp.use_graphs, imp.graph_captures, imp.graph_replays,
            res.hap1_prob)


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_and_mesh_imputers_stay_eager(where, monkeypatch):
    """The CPU and a mesh (two gloo ranks) run ``_forward`` eagerly: no
    capture, both counters 0, and the mesh's probabilities are the single
    process's."""
    def boom(*a, **kw):
        raise AssertionError("a capture off the card")

    monkeypatch.setattr(Imputer, "_capture", boom)
    imp, targets = _setup()
    single = imp.impute(targets[0])
    assert (imp.use_graphs, imp.graph_captures, imp.graph_replays) == \
        (False, 0, 0)
    assert not imp._graphs
    if where == "mesh":
        for uses, captures, replays, hap1 in spawn(_mesh_world, 2,
                                                   threads=1):
            assert (uses, captures, replays) == (False, 0, 0)
            np.testing.assert_allclose(hap1, single.hap1_prob, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("rag_mode", MODES)
def test_a_repeated_key_replays_without_recapture(stand_in, rag_mode):
    """Two calls with other missing sites: one capture (the first batch),
    a replay every batch, and each call's bits the eager path's (the
    window rows and context reloaded at every window)."""
    imp, targets = _setup(rag_mode)
    imp.use_graphs = True
    for target in targets:
        _assert_same(imp.impute(target), _eager(imp, target))
    assert imp.graph_captures == len(stand_in) == len(imp._graphs) == 1
    assert imp.graph_replays == sum(_batches(imp, t) for t in targets)


@pytest.mark.parametrize("change", ["batch", "context"])
def test_a_new_batch_or_context_shape_makes_a_new_key(stand_in, change):
    """Another device batch (5 rows) or another context (48 reference
    rows) captures a graph of its own; back at the first shape the first
    graph replays again."""
    imp, targets = _setup()
    imp.use_graphs = True
    imp.impute(targets[0])
    first, batches = dict(imp._graphs), _batches(imp, targets[0])
    for size, rows in ((5, 48), (4, 32)):
        if change == "batch":
            imp.batch_size, imp.rows = size, slice(0, size)
        else:
            imp.ref_pad_haps = rows
        _assert_same(imp.impute(targets[1]), _eager(imp, targets[1]))
        batches += _batches(imp, targets[1])
        assert imp.graph_captures == len(stand_in) == len(imp._graphs) == 2
    assert all(imp._graphs[k] is g for k, g in first.items())
    assert imp.graph_replays == batches


@pytest.mark.parametrize("rag_mode", MODES)
def test_the_captured_forward_reads_nothing_back(monkeypatch, rag_mode):
    """``_forward``, the body a graph captures, makes no host read of a
    tensor (a read inside a capture fails on the card)."""
    monkeypatch.setattr(Imputer, "_forward", _guarded(Imputer._forward))
    imp, targets = _setup(rag_mode)
    imp.impute(targets[0])


def test_the_launch_counts_take_back_the_capture(monkeypatch):
    """A capture's warm-up and capture leave the kernel counters as they
    were; each replay adds the graph's captured counts."""
    from rag_snvbert_tpu_torch import ops

    ops.reset_launches()
    captured = [7 if name == "attention" else 0
                for name, _, _ in graphs.counters()]

    def capture(self, batch, ctx):
        g = _cpu_capture(self, batch, ctx)
        g.counts = captured
        return g

    use_stand_in(monkeypatch, capture)
    imp, targets = _setup()
    imp.use_graphs = True
    imp.impute(targets[0])
    n = _batches(imp, targets[0])
    assert imp.graph_replays == n
    assert ops.launch_counts()["attention"] == n * 7
    ops.reset_launches()


def test_the_replay_event_waits_on_the_imputers_own_card(monkeypatch):
    """The event after each replay's copies out is recorded on the
    current stream of the imputer's device, named explicitly (the copies
    run there whichever card is the current device): a bare ``record()``
    would wait on the current device's stream, and on a second card the
    drain would read host buffers not yet filled."""
    recorded = use_stand_in(monkeypatch)
    imp, targets = _setup()
    imp.use_graphs = True
    imp.impute(targets[0])
    assert len(recorded) == imp.graph_replays == _batches(imp, targets[0])
    assert set(recorded) == {("stream", imp.device)}
