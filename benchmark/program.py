"""The program's objects built from the benchmark's inputs: a model with
the seed's weights on the device, the panel as the program's data
classes, a preset checked against the configuration file.  Only what the
system under test needs to be handed its inputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import weights

MODEL_KEYS = ("dims", "n_layers", "attn_heads", "dropout", "attn_dropout",
              "pre_ln", "dropout_broadcast", "rag_mode", "bf16",
              "flash_attention", "score_bf16")


def preset(run):
    """The configuration's preset from the program's ``config.PRESETS``,
    after checking that it is the model the configuration file states
    (a run's overrides, the CPU tests' small sizes, go into both)."""
    from rag_snvbert_tpu_torch.config import get_preset

    cfg = run.cell.config
    rc = get_preset(cfg["preset"])
    stated = dict(cfg["model"])
    for key in MODEL_KEYS:
        have = getattr(rc.model, key)
        if key == "attn_dropout" and have is None:
            have = rc.model.dropout
        if stated[key] != have:
            raise ValueError(f"preset {cfg['preset']!r} has {key}={have!r}, "
                             f"the configuration file {stated[key]!r}")
    model_over = {k: v for k, v in run.overrides.items()
                  if k in MODEL_KEYS or k == "seq_len"}
    run_over = {k: v for k, v in run.overrides.items()
                if k in ("batch_size", "grad_accum_steps")}
    return dataclasses.replace(
        rc, model=dataclasses.replace(rc.model, **model_over), **run_over)


def model_block(run) -> dict:
    """The configuration's ``model`` block with the run's overrides."""
    return {**run.cell.config["model"],
            **{k: v for k, v in run.overrides.items() if k in MODEL_KEYS}}


def build_model(rc, vocab_size: int, seed: int, device):
    """``config.build_model``'s model of ``rc``, built on the meta device
    and given the seed's weights on ``device`` (``weights.fill``), in
    eval mode."""
    from rag_snvbert_tpu_torch.models import (BERT, BERTFoundationModel,
                                              BERTWithEmbeddingRAG,
                                              BERTWithRAG)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = rc.model
    cls = {"embedding": BERTWithEmbeddingRAG, "token": BERTWithRAG,
           "none": BERT}[m.rag_mode]
    with torch.device("meta"):
        bert = cls(vocab_size=vocab_size, dims=m.dims, n_layers=m.n_layers,
                   attn_heads=m.attn_heads, dropout=m.dropout,
                   pre_ln=m.pre_ln,
                   dtype=torch.bfloat16 if m.bf16 else torch.float32,
                   attn_dropout=m.attn_dropout,
                   flash_attention=bool(m.flash_attention),
                   score_dtype=(torch.bfloat16 if m.score_bf16
                                else torch.float32),
                   dropout_broadcast=m.dropout_broadcast,
                   fused_qkv=m.fused_qkv, pos_norm=m.pos_norm,
                   int8_matmuls=m.int8_matmuls, remat=m.remat)
        model = BERTFoundationModel(
            bert, compat_double_softmax=m.compat_double_softmax)
    model = model.to_empty(device=device)
    return weights.fill(model, seed).eval()


def vcf(gt: np.ndarray, positions: np.ndarray, names: list[str]):
    from rag_snvbert_tpu_torch.io.vcf import VCFData

    n = len(positions)
    return VCFData(gt=np.ascontiguousarray(gt), pos=np.asarray(positions),
                   chrom=np.asarray(["21"] * n, object),
                   ref=np.asarray(["A"] * n, object),
                   alt=np.asarray(["G"] * n, object),
                   ids=np.asarray(["."] * n, object), samples=list(names))


def freq_table(panel):
    from rag_snvbert_tpu_torch.io.freq import FreqTable

    return FreqTable(panel.freq, panel.positions)


def vocab_of(panel):
    from rag_snvbert_tpu_torch.io.vocab import Vocab

    return Vocab.from_panel_pops(panel.train_pops)


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
