"""The port's program spans (``utils/timing.py``'s ``span``): free while
no profiler capture records, and under a CPU ``torch.profiler`` capture
written by a tiny ``Trainer`` epoch (K = 1, and K > 1 through
``ChunkRunner``) and a tiny ``Imputer.impute``: every span, nested on
the launching thread as ``trainer.* > dispatch.*`` and ``imputer.call >
imputer.*``, inside an enclosing ``record_function`` of the same exported
trace (one clock), one span per unit of work."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig
from rag_snvbert_tpu_torch.utils import timing

SEQ_LEN = 138
BUNDLE = dict(n_ref_samples=12, n_sites=256, n_windows=2, seed=11)
TRAIN = ("trainer.epoch", "trainer.window_context", "trainer.batch_wait",
         "dispatch.chunk")
IMPUTE = ("imputer.call", "imputer.window_context", "imputer.assembly_wait",
          "imputer.launch", "imputer.drain")
# each span's parent: the innermost program span around it
PARENT = {"trainer.window_context": "trainer.epoch",
          "trainer.batch_wait": "trainer.epoch",
          "dispatch.chunk": "trainer.epoch",
          "imputer.window_context": "imputer.call",
          "imputer.assembly_wait": "imputer.call",
          "imputer.launch": "imputer.call",
          "imputer.drain": "imputer.call",
          "imputer.capture": "imputer.launch"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(tmp, k, n_samples=14):
    """The smoke preset over ``n_samples`` at batch 4: ceil(n / 4) batches
    a window, in chunks of up to ``k``."""
    b = make_bundle(n_train_samples=n_samples, **BUNDLE)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=SEQ_LEN)
    model = tconfig.build_model(tconfig.PRESETS["smoke"], b.vocab.size,
                                device="cpu", seed=0)
    tc = TrainerConfig(epochs=1, batch_size=4, warmup_steps=20,
                       ref_pad_haps=32, output_dir=str(tmp),
                       steps_per_dispatch=k, keep_checkpoints=0)
    return Trainer(model, ds, tc)


def _imputer(batch_size=4):
    b = make_bundle(n_train_samples=10, **BUNDLE)
    model = tconfig.build_model(tconfig.PRESETS["smoke"], b.vocab.size,
                                device="cpu", seed=0)
    imp = Imputer(model, b.ref, b.freq, window_len=SEQ_LEN - 10,
                  seq_len=SEQ_LEN, ref_pad_haps=32, batch_size=batch_size,
                  device="cpu")
    keep = np.random.default_rng(3).random(b.train.n_variants) > 0.5
    target = dataclasses.replace(
        b.train, gt=b.train.gt[keep], pos=b.train.pos[keep],
        chrom=b.train.chrom[keep], ref=b.train.ref[keep],
        alt=b.train.alt[keep], ids=b.train.ids[keep])
    return imp, target


def _traced(tmp_path, fn):
    """Run ``fn`` under a CPU capture inside a ``record_function``
    ``test.window``; returns the exported trace's complete events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.window"):
            fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def _spans(events, prefixes=("trainer.", "dispatch.", "imputer.")):
    return [e for e in events if e["name"].startswith(prefixes)]


def _inside(inner, outer) -> bool:
    a, b = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    c, d = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return c <= a and b <= d


def _parent(span, spans):
    """The innermost other program span that holds ``span``, or None."""
    around = [s for s in spans if s is not span and _inside(span, s)
              and float(s["dur"]) >= float(span["dur"])]
    return min(around, key=lambda s: float(s["dur"]), default=None)


def _check_nesting(events, names):
    spans = _spans(events)
    window = [e for e in events if e["name"] == "test.window"]
    assert len(window) == 1
    tids = {(e["pid"], e["tid"]) for e in spans}
    assert tids == {(window[0]["pid"], window[0]["tid"])}   # launching thread
    assert {s["name"] for s in spans} >= set(names)
    for s in spans:
        assert _inside(s, window[0]), s["name"]            # one clock
        p = _parent(s, spans)
        want = PARENT.get(s["name"])
        if s["name"] == "dispatch.capture":
            want = "dispatch.chunk"
        assert (p and p["name"]) == want, (s["name"], p and p["name"])
    return spans


def _count(spans, name):
    return sum(s["name"] == name for s in spans)


def test_span_without_a_capture_calls_no_record_function(tmp_path,
                                                         monkeypatch):
    """Off the profiler, ``span`` is one shared no-op: a trainer epoch
    (K = 1 and K = 2) and an imputation never reach ``record_function``."""
    def boom(*a, **kw):
        raise AssertionError("record_function called with no capture")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert timing.span("a.b") is timing.span("c.d")
    with timing.span("a.b"):
        pass
    for k in (1, 2):
        _trainer(tmp_path / f"k{k}", k)._run_epoch(0, train=True)
    imp, target = _imputer()
    imp.impute(target)


@pytest.mark.parametrize("k", [1, 3])
def test_trainer_spans_nest_and_count(tmp_path, k):
    """14 samples at batch 4: 4 batches a window over 2 windows; K = 3
    gives chunks of 3 and 1, K = 1 a dispatch a batch."""
    tr = _trainer(tmp_path / "run", k)
    spans = _check_nesting(
        _traced(tmp_path, lambda: tr._run_epoch(0, train=True)), TRAIN)
    n_windows, per_window = 2, 4
    chunks = n_windows * -(-per_window // k)
    assert _count(spans, "trainer.epoch") == 1
    assert _count(spans, "trainer.window_context") == n_windows
    assert _count(spans, "dispatch.chunk") == chunks
    # one wait a chunk taken, and one for the end of the stream
    assert _count(spans, "trainer.batch_wait") == chunks + 1
    assert _count(spans, "dispatch.capture") == 0     # no graphs on the CPU
    assert tr.step == n_windows * per_window


def test_imputer_spans_nest_and_count(tmp_path):
    """10 samples at batch 4 (3 device batches a window, the last padded
    by 2 rows) over every window."""
    imp, target = _imputer(batch_size=4)
    spans = _check_nesting(
        _traced(tmp_path, lambda: imp.impute(target)), IMPUTE)
    n_win = len(imp.windows)
    assert n_win >= 2
    assert _count(spans, "imputer.call") == 1
    assert _count(spans, "imputer.window_context") == n_win
    assert _count(spans, "imputer.assembly_wait") == n_win
    assert _count(spans, "imputer.launch") == 3 * n_win
    assert _count(spans, "imputer.drain") == 3 * n_win
    assert _count(spans, "imputer.capture") == 0      # no graphs on the CPU
    assert imp.rows_padded == 2 * n_win


def test_imputer_capture_span_sits_in_the_launch(tmp_path, monkeypatch):
    """With graphs (the capture a CPU stand-in): one ``imputer.capture``,
    inside the first batch's ``imputer.launch``; the other spans as
    eager."""
    from test_torch_imputer_graphs import use_stand_in

    use_stand_in(monkeypatch)
    imp, target = _imputer(batch_size=4)
    imp.use_graphs = True
    spans = _check_nesting(
        _traced(tmp_path, lambda: imp.impute(target)), IMPUTE)
    n_win = len(imp.windows)
    assert _count(spans, "imputer.capture") == imp.graphs.captures == 1
    assert _count(spans, "imputer.launch") == imp.graphs.replays == 3 * n_win
    assert _count(spans, "imputer.drain") == 3 * n_win


def test_dispatch_capture_span_sits_in_the_chunk(tmp_path, monkeypatch):
    """With graphs (the capture a CPU stand-in): one ``dispatch.capture``
    a key (chunks of 3 and 1), each inside its chunk's
    ``dispatch.chunk``; the other spans as eager."""
    from rag_snvbert_tpu_torch.utils.graphs import Graphs
    from test_torch_imputer_graphs import use_stand_in

    use_stand_in(monkeypatch)
    tr = _trainer(tmp_path / "run", 3)
    tr.runner.graphs = Graphs(tr.device)
    spans = _check_nesting(
        _traced(tmp_path, lambda: tr._run_epoch(0, train=True)), TRAIN)
    assert _count(spans, "dispatch.capture") == tr.runner.graphs.captures \
        == 2
    assert _count(spans, "dispatch.chunk") == tr.runner.graphs.replays == 4


def test_spans_record_on_the_capturing_thread_only(tmp_path):
    """A span on a thread the capture does not record is the no-op."""
    seen = []

    def work():
        seen.append(timing.span("other.thread"))

    def fn():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with timing.span("this.thread"):
            pass

    names = {e["name"] for e in _traced(tmp_path, fn)}
    assert "this.thread" in names and "other.thread" not in names
    assert seen == [timing.span("x.y")]
