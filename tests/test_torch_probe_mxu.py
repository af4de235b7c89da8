"""The port's int8 probe (``ops.int8_probe``) against the three JAX Pallas
probes on the CPU.

``tools/probe_mxu.py``, ``probe_mxu2.py`` and ``probe_mxu3.py`` are run
with ``pallas_call`` in interpret mode (patched for the test only): every
order, layout and int4 case at an aligned and a ragged shape (B, N and d
off every tile), with 0/1 and full-range int8 inputs from numpy.  The
port's output must be bit-identical, and its checksum the sum of every
product.  JAX cannot run int4 in interpret mode on the CPU ("custom element
sizes"), so the int4 cases are held against the JAX int8 output on values
in [-8, 7].  The sums stay far inside int32 here (|q.r| <= 70 x 128^2 and
at most three query tiles), so wrapping never decides a result.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import functools

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.ops import int8_probe as probe
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

SHAPES = {"aligned": (16, 256, 64), "ragged": (20, 300, 70)}
TQ, TN, TD = 8, 128, 32


@pytest.fixture
def interpret(monkeypatch):
    """The JAX probes' ``pl.pallas_call`` in interpret mode (they look it
    up at call time, through the module)."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))


def _data(shape, kind, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if kind == "bits":
        return rng.integers(0, 2, shape).astype(np.int8)
    lo, hi = (-128, 128) if lo is None else (lo, hi)
    return rng.integers(lo, hi, shape).astype(np.int8)


def _inputs(shape, kind, lo=None, hi=None):
    b, n, d = SHAPES[shape]
    return (_data((b, d), kind, 1, lo, hi), _data((n, d), kind, 2, lo, hi))


def _port(q, r, **kw):
    out, total = probe.int8_probe(torch.from_numpy(q), torch.from_numpy(r),
                                  TQ, TN, return_checksum=True, **kw)
    rows = r.T if kw.get("trans") else r
    want_sum = int((q.astype(np.int64).sum(0)
                    * rows.astype(np.int64).sum(0)).sum())
    assert out.dtype == torch.int32 and total.dtype == torch.int64
    assert int(total) == want_sum
    return out.numpy()


@pytest.mark.parametrize("kind", ["bits", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_probe_mxu_matmul_only(interpret, shape, kind):
    from tools import probe_mxu

    q, r = _inputs(shape, kind)
    want = np.asarray(probe_mxu.pallas_matmul(jnp.asarray(q), jnp.asarray(r),
                                              TQ, TN, TD))
    np.testing.assert_array_equal(_port(q, r), want)


@pytest.mark.parametrize("case", [("qfirst", False), ("rfirst", False),
                                  ("rfirst", True)],
                         ids=["qfirst", "rfirst", "par"])
@pytest.mark.parametrize("kind", ["bits", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_probe_mxu2_orders(interpret, shape, kind, case):
    from tools import probe_mxu2

    order, par = case
    q, r = _inputs(shape, kind)
    want = np.asarray(probe_mxu2.pallas_mm(jnp.asarray(q), jnp.asarray(r),
                                           TQ, TN, TD, order=order, par=par))
    # "par" runs as its order twin on the card
    np.testing.assert_array_equal(_port(q, r, order=order), want)


@pytest.mark.parametrize("trans", [False, True], ids=["base", "rT"])
@pytest.mark.parametrize("kind", ["bits", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_probe_mxu3_running_sum(interpret, shape, kind, trans):
    from tools import probe_mxu3

    q, r = _inputs(shape, kind)
    rr = np.ascontiguousarray(r.T) if trans else r
    want = np.asarray(probe_mxu3.pallas_mm(jnp.asarray(q), jnp.asarray(rr),
                                           TQ, TN, jnp.int8, trans))
    np.testing.assert_array_equal(_port(q, rr, trans=trans, running=True),
                                  want)


@pytest.mark.parametrize("trans", [False, True], ids=["base_i4", "rT_i4"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_probe_mxu3_int4_against_int8(interpret, shape, trans):
    from tools import probe_mxu3

    q, r = _inputs(shape, "full", -8, 8)
    rr = np.ascontiguousarray(r.T) if trans else r
    want = np.asarray(probe_mxu3.pallas_mm(jnp.asarray(q), jnp.asarray(rr),
                                           TQ, TN, jnp.int8, trans))
    np.testing.assert_array_equal(
        _port(q, rr, trans=trans, running=True, int4=True), want)


def test_int4_wraps_to_four_bits_as_astype_does():
    x = torch.arange(-128, 128, dtype=torch.int8)
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.int4)
                      .astype(jnp.int8))
    np.testing.assert_array_equal(probe.wrap_int4(x).numpy(), want)


def test_checksum_counts_the_wrapped_int4_operands():
    q, r = _inputs("ragged", "full")
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    got = probe.checksum_of(qt, rt, int4=True)
    want = (probe.wrap_int4(qt).long().sum(0)
            * probe.wrap_int4(rt).long().sum(0)).sum()
    assert int(got) == int(want)
    assert int(probe.checksum_of(qt, rt.t().contiguous(), trans=True)) == \
        int((qt.long() @ rt.long().t()).sum())


def test_plan_row_classes_and_ring():
    # d = 2040: rows of 2040 bytes are seen as 2 classes of 4080-byte rows
    assert probe.row_classes(2040, 664648) == 2
    assert probe.row_classes(2048, 664648) == 1
    assert probe.row_classes(70, 300) == 0          # 8 does not divide 300
    assert probe.row_classes(664648, 2048) == 2     # refs^T: d rows
    p = probe.plan(1024, 664648, 2040, "direct", (128, 256, 128),
                   (128 + 256) * 128, 132)
    assert p == {"classes": 2, "tiles": 8 * 2 * -(-332324 // 256),
                 "grid": 132, "stages": 4}
    p = probe.plan(1024, 664648, 2048, "trans", (128, 128, 128),
                   2 * 128 * 128 + 18432, 132)
    assert p["classes"] == 2 and p["tiles"] == 8 * -(-664648 // 128)
    assert probe.out_window(664648, 1024) == 649 * 1024


@pytest.mark.parametrize("bad", ["dtype", "width", "tn"])
def test_wrapper_refuses_what_it_cannot_take(bad):
    q = torch.zeros(4, 32, dtype=torch.int8)
    r = torch.zeros(300, 32, dtype=torch.int8)
    kw = {"dtype": dict(q=q.float()), "width": dict(r=r[:, :16]),
          "tn": dict(tn=64)}[bad]
    args = {"q": q, "r": r, "tq": 8, "tn": 128, **kw}
    with pytest.raises(ValueError):
        probe.int8_probe(args.pop("q"), args.pop("r"), **args)


@pytest.mark.parametrize("tool", ["probe_mxu", "probe_mxu2", "probe_mxu3"])
def test_probe_tools_raise_without_a_card(monkeypatch, tool):
    import importlib

    mod = importlib.import_module(f"rag_snvbert_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run()


def test_probe_row_refuses_a_reading_above_the_int8_peak():
    from rag_snvbert_tpu_torch.tools import probe_mxu

    ok = probe_mxu.row("x", 2.0, 1024, 664648, 2040)
    assert ok["TOPs"] == round(2 * 1024 * 664648 * 2040 / 2.0 / 1e9, 1)
    assert ok["pct_of_bound"] == round(100 * 1.403156226457807 / 2.0, 1)
    for ms in (1.0, 0.0, -4.6):           # 2,777 TOP/s; no time; a slope < 0
        with pytest.raises(RuntimeError, match="probe is at fault"):
            probe_mxu.row("x", ms, 1024, 664648, 2040)


def test_benchmarking_helpers_on_cpu_tensors():
    from rag_snvbert_tpu_torch.utils import benchmarking as bm

    x = torch.arange(6.0).reshape(2, 3) + 2
    assert bm.fetch_scalar({"a": [x]}) == 2.0
    assert bm.fetch_scalar([1, "no tensor"]) == 0.0
    t = bm.steady_state_ms(lambda a: a @ a.t(), x, iters_lo=1, iters_hi=3)
    assert set(t) == {"per_iter_ms", "raw_lo_ms", "raw_hi_ms", "iters"}
    assert t["iters"] == (1, 3) and t["raw_lo_ms"] > 0
    c = bm.chained_state_ms(lambda s, a: (s + a, s.sum()), x, x,
                            iters_lo=1, iters_hi=2)
    # the first call warms up, then 1 + 2 more: the state moved 4 times
    assert torch.equal(c["state"], 5 * x)
    assert set(c) == {"per_iter_ms", "raw_lo_ms", "raw_hi_ms", "state"}
