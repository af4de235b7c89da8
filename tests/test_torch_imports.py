"""The torch port stands alone: it imports neither JAX, flax, optax nor the
JAX package, and its entry points refuse to drop quietly to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import rag_snvbert_tpu_torch

PKG = pathlib.Path(rag_snvbert_tpu_torch.__file__).parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "flax", "optax", "rag_snvbert_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    # exact match on the first dotted part: rag_snvbert_tpu_torch is fine
    return name.split(".")[0] in FORBIDDEN


def test_import_leaves_jax_and_jax_package_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PRESETS["smoke"]
    b = make_bundle(n_train_samples=2, n_ref_samples=4, n_sites=40,
                    n_windows=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, b.vocab.size)
    model = build_model(cfg, b.vocab.size, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Imputer(model, b.ref, b.freq, seq_len=138)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImputationService.create(model, b.ref, b.freq, seq_len=138)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.ops.attention import attention_plain

    ops.reset_launches()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 7, 32),
                                                    np.float32))
               for _ in range(3))
    assert torch.equal(ops.attention(q, k, v, 0.2),
                       attention_plain(q, k, v, 0.2))
    r = torch.from_numpy(rng.standard_normal((9, 16), np.float32))
    ops.l2_topk(r[:3], r, (r * r).sum(-1), 2)
    ri = torch.from_numpy(rng.integers(-9, 9, (9, 16)).astype(np.int8))
    ops.l2_topk_rf(ri[:3], ri, (ri.float() ** 2).sum(-1), 2)
    assert ops.launch_counts() == {"attention": 0, "attention_bwd": 0,
                                   "attention_f32": 0,
                                   "attention_f32_bwd": 0,
                                   "layer_norm": 0, "layer_norm_bwd": 0,
                                   "residual": 0, "residual_bwd": 0,
                                   "l2_topk": 0, "l2_topk_rf": 0,
                                   "l2_topk_float": 0}


def test_seeded_weights_are_reproducible_and_leave_global_rng_alone():
    from rag_snvbert_tpu_torch.config import PRESETS, build_model

    state = torch.get_rng_state()
    a = build_model(PRESETS["smoke"], 9, device="cpu", seed=3).state_dict()
    assert torch.equal(torch.get_rng_state(), state)
    b = build_model(PRESETS["smoke"], 9, device="cpu", seed=3).state_dict()
    c = build_model(PRESETS["smoke"], 9, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert not all(torch.equal(a[key], c[key]) for key in a)


def test_frozen_batch_norm_model_starts_from_identity_statistics():
    import dataclasses

    from rag_snvbert_tpu_torch.config import PRESETS, build_model

    cfg = PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pos_norm="frozen_batch"))
    model = build_model(cfg, 9, device="cpu")
    bn = model.bert.emb_fusion.pos_feat.FrozenBatchNorm_0
    for t, want in ((bn.weight, 1.0), (bn.bias, 0.0), (bn.mean, 0.0),
                    (bn.var, 1.0)):
        assert torch.equal(t.detach(), torch.full_like(t, want))
    assert all(torch.isfinite(p).all() for p in model.state_dict().values())


def test_port_imports_no_pandas():
    """The card's machine has no pandas: no module of the port, the
    analysis included, may need it."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('pandas' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    names = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module or "")
    assert not [n for n in names if n.split(".")[0] == "pandas"]
