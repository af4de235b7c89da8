"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level module name (``rag_snvbert_tpu_torch`` begins with
``rag_snvbert_tpu``)."""

import subprocess
import sys
import types

from benchmark import harness

SNIPPET = """
import json, sys
from benchmark import harness
from benchmark.tests.conftest import tiny
for cell in ("tpu_default.train", "tpu_default.impute",
             "v17_token_rag.train"):
    harness.run_cell(harness.Cell.load(cell), 3, 0.3, False, "cpu", 0.0,
                     tiny(cell))
for name in ("benchmark.calibrate", "benchmark.run", "benchmark.trace"):
    __import__(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_forbidden_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "rag_snvbert_tpu_torch_x",
                        types.ModuleType("rag_snvbert_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rag_snvbert_tpu.config",
                        types.ModuleType("rag_snvbert_tpu.config"))
    assert harness.forbidden_modules() == ["rag_snvbert_tpu"]


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SNIPPET], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN)
    assert "rag_snvbert_tpu_torch" in loaded
