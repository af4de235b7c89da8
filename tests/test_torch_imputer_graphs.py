"""The CUDA graphs of the imputer's ``_forward`` (infer/imputer.py) and of
the trainer's chunks (train/dispatch.py), both captured and replayed by
``utils.graphs.Graphs``, off the card: which imputers take them, the
keys, the static window context and the launch counts.

On the card each device batch of ``Imputer.impute`` and each chunk of
``ChunkRunner.run`` is one replay of its key's graph;
tests/test_torch_cuda.py and ``chip_smoke.py``'s ``phase_dispatch`` hold
the replays to the eager path's bits and launch counts there.  Here the
card's part of a capture (``Graphs._record``: the warm-up and the
capture on a side stream) is replaced by a CPU stand-in that runs the
body for each and puts the caller's state back after each (a capture
runs nothing), and whose replay runs the body again and writes the
graph's output buffers (the event after an imputer replay's copies out
is a no-op).  So the runners' loads of their static buffers, their keys
and the shared launch counting are held to the eager path's bits as
well: the imputer in every RAG mode over a ragged last batch and two
windows, the trainer over chunks of 3 and 1 (or 3 and 2) in two
windows."""

import dataclasses

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.train import dispatch
from rag_snvbert_tpu_torch.utils import graphs

from test_torch_dispatch import (_assert_same_state, _csv_rows,
                                 _fit_trainer, _guarded)

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


def _trainers(tmp, accum=1, n_samples=14):
    """Two trainers of tests/test_torch_dispatch.py's fit at K = 3 from
    the same weights, one epoch: the first's chunks go through graphs
    (the stand-in's), the second's run eagerly."""
    pair = [_fit_trainer(tmp / name, 3, accum, epochs=1, n_samples=n_samples)
            for name in ("graphs", "eager")]
    pair[0].runner.graphs = graphs.Graphs(pair[0].device)
    return pair


class _CPUGraph:
    """``torch.cuda.CUDAGraph``'s stand-in: a replay runs the captured
    body again and writes what it returns into the graph's outputs (the
    body's return at capture; the trainer's body returns its own output
    buffers, written in place).  A replay on the card calls no kernel
    wrapper, so what this one counts is taken back."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        before = graphs.counts()
        new = self.body()
        graphs.take_back(before)
        if new is not self.out:
            for buf, t in zip(self.out, new):
                buf.copy_(t)


def _cpu_record(self, body, state, generators):
    """``Graphs._record``'s stand-in: the warm-up and the capture each run
    ``body`` on the CPU and put ``state`` back after it."""
    saved = [t.detach().clone() for t in state]

    def once():
        out = body()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        return out

    once()
    generators()
    out = once()
    return _CPUGraph(body, out), out


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


def use_stand_in(monkeypatch, record=None):
    """Captures go to ``record`` (``_cpu_record``), events to
    ``_NoEvent``, ``current_stream`` to ``_stream``; returns the streams
    events are recorded on."""
    monkeypatch.setattr(graphs.Graphs, "_record", record or _cpu_record)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", _stream)
    monkeypatch.setattr(_NoEvent, "recorded", [])
    return _NoEvent.recorded


@pytest.fixture
def stand_in(monkeypatch):
    """Captures go to ``_cpu_record``; returns one entry a capture."""
    captured = []

    def record(self, body, state, generators):
        captured.append(len(self.by_key))
        return _cpu_record(self, body, state, generators)

    use_stand_in(monkeypatch, record)
    return captured


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
    return (imp.use_graphs, imp.graphs.captures, imp.graphs.replays,
            res.hap1_prob)


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_and_mesh_imputers_stay_eager(where, monkeypatch):
    """The CPU and a mesh (two gloo ranks) run ``_forward`` eagerly: no
    capture, both counters 0, and the mesh's probabilities are the single
    process's."""
    def boom(*a, **kw):
        raise AssertionError("a capture off the card")

    monkeypatch.setattr(graphs.Graphs, "capture", boom)
    imp, targets = _setup()
    single = imp.impute(targets[0])
    assert (imp.use_graphs, imp.graphs.captures, imp.graphs.replays) == \
        (False, 0, 0)
    assert not imp.graphs.by_key
    if where == "mesh":
        for uses, captures, replays, hap1 in spawn(_mesh_world, 2,
                                                   threads=1):
            assert (uses, captures, replays) == (False, 0, 0)
            np.testing.assert_allclose(hap1, single.hap1_prob, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("runner", [*MODES, "trainer"])
def test_a_repeated_key_replays_without_recapture(stand_in, runner,
                                                  tmp_path):
    """The imputer in each RAG mode, two calls with other missing sites:
    one capture (the first batch), a replay every batch, and each call's
    bits the eager path's (the window rows and context reloaded at every
    window).  The trainer, one epoch at K = 3 over 2 windows of 4
    batches: a capture for the chunk of 3 and one for the chunk of 1,
    the second window's chunks replays of them, and the fit the eager
    fit's bits."""
    if runner == "trainer":
        tr, eager = _trainers(tmp_path)
        tr.fit()
        eager.fit()
        _assert_same_state(eager, tr)
        assert _csv_rows(tmp_path / "graphs" / "metrics.csv") == \
            _csv_rows(tmp_path / "eager" / "metrics.csv")
        g = tr.runner.graphs
        assert g.captures == len(stand_in) == len(g.by_key) == 2
        assert g.replays == 2 * 2
        return
    imp, targets = _setup(runner)
    imp.use_graphs = True
    for target in targets:
        _assert_same(imp.impute(target), _eager(imp, target))
    assert imp.graphs.captures == len(stand_in) == len(imp.graphs.by_key) \
        == 1
    assert imp.graphs.replays == sum(_batches(imp, t) for t in targets)


def _trainer_new_keys(stand_in, change, tmp_path):
    """``chunk``: an epoch at K = 3 (chunks of 3 and 1), one at K = 2 (a
    new length, 2) and one at K = 3 again, which captures nothing.
    ``updates``: accumulation 2 over 2 windows of 5 batches at K = 3, so
    the second window's chunks start half way through an accumulation:
    their update patterns make keys of their own."""
    if change == "chunk":
        tr, eager = _trainers(tmp_path)
        first = None
        for epoch, k in enumerate((3, 2, 3)):
            for t in (tr, eager):
                t.cfg.steps_per_dispatch = k
                t._run_epoch(epoch, train=True)
            first = first or dict(tr.runner.graphs.by_key)
            assert tr.runner.graphs.captures == len(stand_in) == \
                (2 if epoch == 0 else 3)
        assert all(tr.runner.graphs.by_key[k] is g for k, g in first.items())
        assert tr.runner.graphs.replays == 4 + 4 + 4
    else:
        tr, eager = _trainers(tmp_path, accum=2, n_samples=20)
        tr.fit()
        eager.fit()
        assert {key[0] for key in tr.runner.graphs.by_key} == {
            ((0, False), (1, True), (0, False)), ((1, True), (0, False)),
            ((1, True), (0, False), (1, True)), ((0, False), (1, True))}
        assert tr.runner.graphs.captures == len(stand_in) == 4
        assert tr.runner.graphs.replays == 4
    _assert_same_state(eager, tr)


@pytest.mark.parametrize("change", ["batch", "context", "chunk", "updates"])
def test_a_new_batch_or_context_shape_makes_a_new_key(stand_in, change,
                                                      tmp_path):
    """The imputer: another device batch (5 rows) or another context (48
    reference rows) captures a graph of its own; back at the first shape
    the first graph replays again.  The trainer: a new chunk length or
    update pattern (``_trainer_new_keys``)."""
    if change in ("chunk", "updates"):
        _trainer_new_keys(stand_in, change, tmp_path)
        return
    imp, targets = _setup()
    imp.use_graphs = True
    imp.impute(targets[0])
    first, batches = dict(imp.graphs.by_key), _batches(imp, targets[0])
    for size, rows in ((5, 48), (4, 32)):
        if change == "batch":
            imp.batch_size, imp.rows = size, slice(0, size)
        else:
            imp.ref_pad_haps = rows
        _assert_same(imp.impute(targets[1]), _eager(imp, targets[1]))
        batches += _batches(imp, targets[1])
        assert imp.graphs.captures == len(stand_in) == \
            len(imp.graphs.by_key) == 2
    assert all(imp.graphs.by_key[k] is g for k, g in first.items())
    assert imp.graphs.replays == batches


@pytest.mark.parametrize("runner", ["imputer", "trainer"])
def test_the_static_context_reloads_only_at_a_new_window(
        stand_in, monkeypatch, runner, tmp_path):
    """One static context for the one context signature, loaded once a
    window (its context a new object) however many graphs and replays
    read it: the imputer's two calls over 2 windows of 3 batches, the
    trainer's epoch over 2 windows of 2 chunks."""
    loads = []
    real = graphs.load_ctx

    def load(static, ctx):
        loads.append(id(ctx))
        real(static, ctx)

    monkeypatch.setattr(graphs, "load_ctx", load)
    if runner == "trainer":
        tr, eager = _trainers(tmp_path)
        tr.fit()
        eager.fit()
        _assert_same_state(eager, tr)
        g, windows = tr.runner.graphs, 2
    else:
        imp, targets = _setup()
        imp.use_graphs = True
        for target in targets:
            _assert_same(imp.impute(target), _eager(imp, target))
        g, windows = imp.graphs, 2 * 2
    assert len(loads) == windows
    assert len(g._ctx) == 1
    assert g.replays > windows


@pytest.mark.parametrize("rag_mode", MODES)
def test_the_captured_forward_reads_nothing_back(monkeypatch, rag_mode):
    """``_forward``, the body a graph captures, makes no host read of a
    tensor (a read inside a capture fails on the card)."""
    monkeypatch.setattr(Imputer, "_forward", _guarded(Imputer._forward))
    imp, targets = _setup(rag_mode)
    imp.impute(targets[0])


@pytest.mark.parametrize("runner", ["imputer", "trainer"])
def test_the_launch_counts_take_back_the_capture(monkeypatch, runner,
                                                 tmp_path):
    """A capture's warm-up and capture leave the kernel counters as they
    were, and each replay adds the graph's captured counts: with a body
    that counts 7 attention launches a batch (a micro-step for the
    trainer), the graph run's ``ops.launch_counts()`` equal the eager
    run's."""
    use_stand_in(monkeypatch)
    ops.reset_launches()
    if runner == "trainer":
        real = dispatch.train_steps

        def steps(model, opt, batches, ctx, cfg, gens, plan, *rest):
            ops.attention.launches += 7 * len(plan)
            return real(model, opt, batches, ctx, cfg, gens, plan, *rest)

        monkeypatch.setattr(dispatch, "train_steps", steps)
        runs = _trainers(tmp_path)
        n = 2 * 4
    else:
        real = Imputer._forward

        def forward(self, batch, ctx):
            ops.attention.launches += 7
            return real(self, batch, ctx)

        monkeypatch.setattr(Imputer, "_forward", forward)
        imp, targets = _setup()
        runs = [imp, imp]
        n = _batches(imp, targets[0])
    counts = []
    for graphed, run in zip((True, False), runs):
        if runner == "trainer":
            run.fit()
        else:
            run.use_graphs = graphed
            run.impute(targets[0])
        counts.append(ops.launch_counts())
        ops.reset_launches()
    assert counts[0] == counts[1]
    assert counts[0]["attention"] == n * 7
    graphed = runs[0].runner.graphs if runner == "trainer" else imp.graphs
    assert graphed.captures == (2 if runner == "trainer" else 1)
    assert graphed.replays == (4 if runner == "trainer" else n)


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
    assert len(recorded) == imp.graphs.replays == _batches(imp, targets[0])
    assert set(recorded) == {("stream", imp.device)}
