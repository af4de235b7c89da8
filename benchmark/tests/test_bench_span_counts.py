"""The drivers' counts, which ``mfu.*`` reads, against what the program
did: a traced tiny run of each driver on the CPU, and the program's spans
(``rag_snvbert_tpu_torch/utils/timing.py``) inside ``bench.window``.
Training: ``window_contexts`` is the count of ``trainer.window_context``,
``epochs`` of ``trainer.epoch``, and ``micro_steps`` K times the count of
``dispatch.chunk`` (every chunk is whole at these sizes: 16 samples a
window at batch 4, K = 4).  Imputation: ``window_contexts`` is the count
of ``imputer.window_context``, ``batches`` of ``imputer.launch`` and of
``imputer.drain``, ``impute_calls`` of ``imputer.call``."""

import collections

import pytest

from benchmark import harness, trace
from benchmark.tests.conftest import tiny


def _traced(monkeypatch, cell: str):
    """The result and the span counts inside the traced window."""
    seen = []
    real = trace.Trace.from_events.__func__

    def keep(cls, events, lo=None, hi=None):
        seen.append(real(cls, events, lo, hi))
        return seen[-1]

    monkeypatch.setattr(trace.Trace, "from_events", classmethod(keep))
    res = harness.run_cell(harness.Cell.load(cell), 2 ** 31 + 11, 0.5, True,
                           "cpu", 0.0, tiny(cell))
    (tr,) = seen
    counts = collections.Counter(n for a, b, n in tr.host
                                 if tr.lo <= a and b <= tr.hi)
    return res, counts


@pytest.mark.parametrize("cell", ["tpu_default.train",
                                  "v17_token_rag.train"])
def test_train_counts_are_the_programs(monkeypatch, cell):
    res, spans = _traced(monkeypatch, cell)
    c = res["counts"]
    k = harness.Cell.load(cell).traffic["steps_per_dispatch"]
    assert c["epochs"] >= 1 and spans["trainer.epoch"] == c["epochs"]
    assert spans["trainer.window_context"] == c["window_contexts"]
    assert spans["dispatch.chunk"] * k == c["micro_steps"]


def test_impute_counts_are_the_programs(monkeypatch):
    res, spans = _traced(monkeypatch, "tpu_default.impute")
    c = res["counts"]
    assert c["impute_calls"] >= 1
    assert spans["imputer.call"] == c["impute_calls"]
    assert spans["imputer.window_context"] == c["window_contexts"]
    assert spans["imputer.launch"] == spans["imputer.drain"] == c["batches"]
