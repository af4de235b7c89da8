"""``l2_topk_rf``'s ``plan`` keyword and the port's ``tools/sweep_topk.py``:
the plan grid at the genotype index shape (planned for an H100's 132 SMs),
the plans the keyword refuses, every plan's answer equal to the default's
at a cut size on the CPU, and the tool's oracle equal to the JAX tool's
numpy expression (tools/sweep_topk.py:92-98)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf, list_stride,
                                                  plan_splits, ring_stages,
                                                  split_plan)
from rag_snvbert_tpu_torch.ops.planar import pack_planar, planar_sq_norms
from rag_snvbert_tpu_torch.tools import sweep_topk
from test_torch_modules import torch_one_thread  # noqa: F401

B, N, D, K = 1024, 331 * 2008, 2040, 10
# (pack, row classes, stored width) of the index's int8 and packed storage
STORAGES = {"int8": (1, 2, 2040), "packed": (8, 1, 256)}


@pytest.mark.parametrize("storage", list(STORAGES))
def test_plan_grid_at_the_index_shape(storage):
    pack, classes, _ = STORAGES[storage]
    grid = sweep_topk.plan_grid(B, N, K, pack, classes, 132)
    splits, rows = split_plan(B, N, 132, classes)
    deepest = ring_stages(list_stride(K), pack > 1)
    assert grid[0] == (rows, deepest) == (41664, 4)
    assert plan_splits(N, classes, rows) == splits == 16
    assert len(grid) == len(set(grid)) == 16
    assert {r for r, _ in grid} == {20928, 41664, 83328, 166656}
    for r, s in grid:
        assert r > 0 and r % 192 == 0 and 1 <= s <= deepest
    waves = [sweep_topk.describe(p, B, N, classes, 132)["waves"]
             for p in grid]
    assert waves[0] == 1 and max(waves) == 2      # x1/2 takes two waves


@pytest.mark.parametrize("plan,k,pack", [
    ((0, 4), 10, 1), ((-192, 4), 10, 1), ((100, 4), 10, 1),
    ((192, 0), 10, 1), ((192, 5), 10, 1), ((192, 2), 128, 8),
    ((192.0, 4), 10, 1), ((192, True), 10, 1), ((192,), 10, 1),
    ((192, 4, 1), 10, 1), ("192,4", 10, 1), (192, 10, 1)])
def test_invalid_plans_raise(plan, k, pack):
    bits = torch.randint(0, 2, (300, 256), dtype=torch.int8)
    q = torch.randint(0, 2, (4, 256), dtype=torch.int8)
    refs = bits if pack == 1 else pack_planar(bits, pack)
    norms = (bits.float() ** 2).sum(1) if pack == 1 else \
        planar_sq_norms(refs, pack)
    with pytest.raises(ValueError, match="plan"):
        l2_topk_rf(q, refs, norms, k, pack=pack, plan=plan)


@pytest.mark.parametrize("storage", list(STORAGES))
def test_every_plan_equals_the_default_on_the_cpu(storage):
    pack = STORAGES[storage][0]
    n, b = 3000, 64
    g = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 2, (n, D), generator=g, dtype=torch.int8)
    bits[7] = bits[3]                                  # an exact tie
    q = torch.randint(0, 2, (b, D), generator=g, dtype=torch.int8)
    q[0] = bits[3]
    refs = bits if pack == 1 else pack_planar(bits, pack)
    norms = (bits.float() ** 2).sum(1) if pack == 1 else \
        planar_sq_norms(refs, pack)
    want = l2_topk_rf(q, refs, norms, K, pack=pack)
    assert want[1][0, :2].tolist() == [3, 7]
    classes = sweep_topk.classes_of(refs, pack)
    grid = sweep_topk.plan_grid(b, n, K, pack, classes, 132)
    # x1/2 of the default's 192 rows rounds back up to 192
    assert grid[0] == sweep_topk.default_plan(b, n, K, pack, classes, 132)
    assert len(grid) == 12
    for plan in grid:
        got = l2_topk_rf(q, refs, norms, K, pack=pack, plan=plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_oracle_equals_the_jax_tools_expression(monkeypatch):
    rng = np.random.default_rng(3)
    refs = rng.integers(0, 2, (1000, D), dtype=np.int8)
    refs[500] = refs[20]
    q = rng.integers(0, 2, (16, D), dtype=np.int8)
    q[0] = refs[20]
    # tools/sweep_topk.py:92-98, on the same inputs
    refs_np = refs.astype(np.float32)
    q0 = q.astype(np.float32)
    dists = ((q0 ** 2).sum(1)[:, None] - 2.0 * q0 @ refs_np.T
             + (refs_np ** 2).sum(1)[None, :])
    oid = np.argsort(dists, 1, kind="stable")[:, :K]
    monkeypatch.setattr(sweep_topk, "ORACLE_CHUNK", 300)
    got = sweep_topk.oracle_ids(q, refs, K)
    np.testing.assert_array_equal(got, oid)
    assert got[0, :2].tolist() == [20, 500]


@pytest.mark.parametrize("dtype", ["int8", "int4", "packed"])
def test_main_on_the_cpu_at_a_cut_size(dtype):
    argv = ["--device", "cpu", "--n-rows", "700", "--batch", "32",
            "--chunks", "2", "--dtype", dtype, "--rows", "192,384",
            "--stages", "1,2", "--compute", "int4", "--order", "rfirst",
            "--prepad"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rows = sweep_topk.main(argv)
    keys = {"rows", "splits", "stages", "qps", "ms_per_batch",
            "ids_equal_default", "recall_ok", "oracle_exact"}
    assert len(rows) == 5 and keys <= set(rows[0])
    assert all(r["ids_equal_default"] and r["oracle_exact"]
               and r["recall_ok"] and r["qps"] > 0 for r in rows)
    assert [len(r["ms_turns"]) for r in rows] == [2] * 5
    assert '"best": {' in out.getvalue().splitlines()[-1]


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_topk.main(["--chunks", "1"])
