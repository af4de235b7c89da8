"""Typed configuration + named presets (copied from rag_snvbert_tpu/config.py)
and the torch model builder.

The dataclasses and ``PRESETS`` are verbatim copies, so a preset means the
same model in both packages.  Fields that only shape the TPU program
(``scan_layers``: the port's layers are unrolled, and a scanned flax tree
loads all the same; the block sizes in a ``flash_attention`` string) are
accepted and have no effect here.  ``remat`` is activation checkpointing
with the JAX meanings (``models/transformer.py``), so ``tpu_scan`` is
``tpu_default`` with block remat: the same numbers for less memory.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dims: int = 384
    n_layers: int = 12
    attn_heads: int = 12
    dropout: float = 0.1
    seq_len: int = 1030
    rag_mode: str = "embedding"   # "embedding" | "token" | "none"
    pre_ln: bool = False          # True = modern pre-norm variant
    remat: bool | str = False     # True | "save_most" | "save_ffn" | "attention"
    bf16: bool = False            # bf16 compute dtype for the encoder
    dropout_broadcast: bool = False  # sequence-shared residual dropout masks
    fused_qkv: bool = False       # one [D,3D] QKV projection (changes param tree)
    attn_dropout: float | None = None  # 0 disables attention-prob dropout
    scan_layers: bool = False     # lax.scan over encoder layers (fast compile)
    flash_attention: bool | str = False  # True|"flash"|"splash[:block]"
    score_bf16: bool = False      # bf16 attention scores (XLA path)
    int8_matmuls: bool | str = False  # int8 encoder matmuls (MXU 2x path):
    # True/"fwd_bwd" = fwd+bwd, "fwd" = int8 forward with bf16 gradients
    compat_double_softmax: bool = False
    pos_norm: str = "group"       # "frozen_batch" for converted torch ckpts


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = ModelConfig()
    epochs: int = 20
    batch_size: int = 24
    val_batch_size: int = 48
    init_lr: float = 1e-5
    max_lr: float = 7.5e-5
    warmup_steps: int = 15000
    grad_accum_steps: int = 2
    focal_gamma: float = 2.0
    use_recon_loss: bool = False
    rag_k: int = 1
    rare_threshold: float = 0.05
    patience: int = 5
    min_delta: float = 0.001

    def build_model(self, vocab_size: int, device=None, seed: int = 0):
        return build_model(self, vocab_size, device=device, seed=seed)


PRESETS: dict[str, RunConfig] = {
    # v10-era baseline: small model, no RAG (run_v10_20250411_mafData.sh)
    "v10_baseline": RunConfig(
        model=ModelConfig(dims=128, n_layers=8, attn_heads=4,
                          rag_mode="none"),
        batch_size=64, grad_accum_steps=1, max_lr=1e-4, warmup_steps=10000,
        focal_gamma=5.0, use_recon_loss=True),
    # v13 optimized training recipe (run_v13_optimized.sh): gamma 2.5,
    # recon off
    "v13_optimized": RunConfig(
        model=ModelConfig(dims=128, n_layers=8, attn_heads=4,
                          rag_mode="none"),
        batch_size=64, grad_accum_steps=1, focal_gamma=2.5),
    # v17 token-space RAG (run_v17_FIXED.sh): 192d/10L/6H, batch 16
    "v17_token_rag": RunConfig(
        model=ModelConfig(dims=192, n_layers=10, attn_heads=6,
                          rag_mode="token"),
        batch_size=16, grad_accum_steps=1, max_lr=5e-5),
    # v18 embedding RAG, the flagship (run_v18_embedding_rag.sh:40-60)
    "v18_embedding_rag": RunConfig(),
    # v18 at the 256d "Large" point (HOW_TO_RUN.md:79-81)
    "v18_large": RunConfig(
        model=ModelConfig(dims=256, n_layers=12, attn_heads=8)),
    # TPU-tuned variant — the recommended starting point for new training
    # runs on TPU.  Measured ablations (v5e, 12L/384d, L=1030, 48 streams):
    # attention-score HBM traffic dominates, so 3 fat heads (head_dim 128:
    # score bytes are B*H*L^2, FLOPs are not) + bf16 scores (round 1:
    # encoder fwd+bwd 522 -> 168 ms).  Round 2: dropping remat entirely
    # (fits HBM only with scan_layers=False — scanned no-remat overflows)
    # + sequence-broadcast residual-dropout masks + stacked dual-hap
    # retrieval takes the full train step 213 -> 161.3 ms (B=24); the
    # splash-attention kernel (fused bwd, whole-sequence 1152 blocks —
    # never materializes [L,L] scores in HBM) takes it to 129.1 ms
    # (block sweep in DESIGN.md section 4; at batch > 24 the whole-tile
    # dkv kernel overflows scoped VMEM — use "splash:1152x384f" there).
    # Off-TPU the splash flag falls back to the identical XLA einsum
    # path.  Same parameter count as 12 heads.
    "tpu_default": RunConfig(
        model=ModelConfig(dims=384, n_layers=12, attn_heads=3,
                          pre_ln=True, remat=False, bf16=True,
                          attn_dropout=0.0, scan_layers=False,
                          dropout_broadcast=True,
                          flash_attention="splash:1152x1152f",
                          score_bf16=True)),
    # Memory/compile-latency variant of tpu_default: lax.scan over layers
    # + full-block remat.  Measured round 3 (DESIGN.md section 6): 2.7x
    # smaller activation footprint (HBM temps 7.5 -> 2.8 GB) and 1.5x
    # faster compile (55 -> 36 s) for a 40% slower step (173 vs 123 ms @
    # B=24) — pick this for bigger batches/models or fast iteration, and
    # tpu_default for production throughput.
    "tpu_scan": RunConfig(
        model=ModelConfig(dims=384, n_layers=12, attn_heads=3,
                          pre_ln=True, remat=True, bf16=True,
                          attn_dropout=0.0, scan_layers=True,
                          dropout_broadcast=True,
                          flash_attention="splash:1152x1152f",
                          score_bf16=True)),
    # Minimal embedding-RAG model for CPU smoke drives and fast local
    # iteration: same architecture/flow as tpu_default (pre-LN, embedding
    # RAG, bf16) at ~1/500 the step cost.  seq_len 138 keeps the 10-token
    # special-token layout with a 128-site window.
    "smoke": RunConfig(
        model=ModelConfig(dims=64, n_layers=2, attn_heads=2, seq_len=138,
                          pre_ln=True, bf16=True, attn_dropout=0.0),
        batch_size=8, val_batch_size=8, grad_accum_steps=1,
        warmup_steps=20),
}


def get_preset(name: str) -> RunConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}") from None


def build_model(cfg: RunConfig, vocab_size: int, device=None,
                seed: int = 0):
    """Build the torch ``BERTFoundationModel`` for ``cfg`` on ``device``.

    ``device=None`` means the card (raises without one); pass ``"cpu"`` to
    run off the card.  Weights are random from ``seed`` (one CPU
    generator, ``models.init_weights``); load trained or flax weights over
    them.  The model is in eval mode.

    ``flash_attention``: any truthy value selects the fused attention kernel
    (``ops/attention.py``) wherever the JAX package would take its Pallas
    kernel (attention dropout 0, no mask).  The TPU block sizes of a
    ``"splash:BQxBKVf"`` string are parsed by the JAX package only; the
    CUDA kernel has its own fixed tiles, so they are ignored here.
    """
    from .device import resolve_device
    from .models import (BERT, BERTFoundationModel, BERTWithEmbeddingRAG,
                         BERTWithRAG, init_weights)

    dev = resolve_device(device)
    # A float32 Conv1d (PositionFeatModule) runs in TF32 on the card by
    # default; the JAX package computes it in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.model
    cls = {"embedding": BERTWithEmbeddingRAG, "token": BERTWithRAG,
           "none": BERT}.get(m.rag_mode)
    if cls is None:
        raise ValueError(f"unknown rag_mode {m.rag_mode!r}")
    with torch.device("meta"):   # no default init: init_weights fills all
        bert = cls(vocab_size=vocab_size, dims=m.dims, n_layers=m.n_layers,
                   attn_heads=m.attn_heads, dropout=m.dropout, pre_ln=m.pre_ln,
                   dtype=torch.bfloat16 if m.bf16 else torch.float32,
                   attn_dropout=m.attn_dropout,
                   flash_attention=bool(m.flash_attention),
                   score_dtype=(torch.bfloat16 if m.score_bf16
                                else torch.float32),
                   dropout_broadcast=m.dropout_broadcast,
                   fused_qkv=m.fused_qkv,
                   pos_norm=m.pos_norm, int8_matmuls=m.int8_matmuls,
                   remat=m.remat)
        model = BERTFoundationModel(
            bert, compat_double_softmax=m.compat_double_softmax)
    model = init_weights(model.to_empty(device="cpu"), seed)
    return model.to(dev).eval()
