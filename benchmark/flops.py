"""Operations and bytes from shapes, and the card's peaks: the
yardstick of the ``mfu`` and ``*_roofline`` metrics.

Peaks (NVIDIA's H100 SXM data sheet, dense, at its 700 W limit): bf16
989 TFLOP/s, TF32 495, float32 outside the tensor cores 67, int8 1979
TOP/s, HBM 3.35 TB/s.  A product of ``[m, k] x [k, n]`` is ``2 m k n``
operations.  Model operations count every product of the forward pass
that the configuration defines (dense layers, attention's two products,
the search's dot products); a training step is three times the forward's
differentiable part (forward, and backward to inputs and weights) plus
the search once.  Elementwise work, norms and softmax are not counted.
"""

from __future__ import annotations

PEAK_FLOP_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                   "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def dense(tokens: float, n_in: int, n_out: int) -> float:
    return 2.0 * tokens * n_in * n_out


def embedding(tokens: float, d: int) -> float:
    """The AF embedding's two dense layers (the token table is a lookup)."""
    return dense(tokens, 64, d) + dense(tokens, d, d)


def emb_fusion(tokens: float, d: int) -> float:
    """The fusion dense layer and the three 9-tap position convolutions
    (1 -> 4 -> 4 -> 1 channels)."""
    return dense(tokens, d + 2, d) + 2.0 * tokens * 9 * (4 + 16 + 4)


def rag_fusion(tokens: float, d: int, k: int) -> float:
    af = dense(tokens, 2, 32) + dense(tokens, 32, d) + dense(tokens, 2, d)
    return (af + dense(tokens, d, 4 * d) + dense(tokens, 4 * d, d)
            + dense(tokens * k, d, 1) + dense(tokens, 2 * d, 4 * d)
            + dense(tokens, 4 * d, d))


def attention_fwd(seqs: float, L: int, d: int) -> float:
    """``q k^T`` and ``p v`` over all heads: ``4 seqs L^2 d``."""
    return 4.0 * seqs * L * L * d


def encoder(seqs: float, L: int, d: int, layers: int) -> float:
    t = seqs * L
    per = 4 * dense(t, d, d) + dense(t, d, 4 * d) + dense(t, 4 * d, d)
    return layers * (per + attention_fwd(seqs, L, d))


def heads(samples: float, L: int, d: int) -> float:
    t2 = 2 * samples * L
    hap = (dense(t2, d + 2, 4 * d) + dense(t2, 4 * d, d)
           + dense(t2, d, 4 * d) + dense(t2, 4 * d, 2))
    t = samples * L
    gt = dense(t, 7, 16) + 2 * dense(t, 16, 16) + dense(t, 16, 4)
    return hap + gt


def search(queries: float, rows: int, dim: int) -> float:
    return 2.0 * queries * rows * dim


def forward(m: dict, batch: int, L: int, rows: int, k: int = 1
            ) -> tuple[float, float]:
    """``(differentiable, search)`` operations of one forward pass of
    ``batch`` samples (both haplotypes) of model block ``m`` against a
    window context of ``rows`` reference haplotypes."""
    d, layers = m["dims"], m["n_layers"]
    q = 2 * batch                                   # query haplotypes
    if m["rag_mode"] == "token":
        seqs = q * (1 + k)                          # queries + segments
        diff = (embedding(seqs * L, d) + emb_fusion(seqs * L, d)
                + encoder(seqs, L, d, layers) + rag_fusion(q * L, d, k)
                + heads(batch, L, d))
        return diff, search(q, rows, L)
    diff = (embedding(q * L, d) + embedding(q * k * L, d)
            + emb_fusion(2 * q * L, d) + rag_fusion(q * L, d, 1)
            + encoder(q, L, d, layers) + heads(batch, L, d))
    return diff, search(q, rows, L * d)


def train_step(m: dict, batch: int, L: int, rows: int, k: int = 1) -> float:
    diff, srch = forward(m, batch, L, rows, k)
    return 3.0 * diff + srch


def infer_batch(m: dict, batch: int, L: int, rows: int, k: int = 1) -> float:
    return sum(forward(m, batch, L, rows, k))


def window_context(m: dict, rows: int, L: int) -> float:
    """Embedding the window's reference rows (embedding mode; token mode
    keeps the tokens)."""
    return embedding(rows * L, m["dims"]) if m["rag_mode"] == "embedding" \
        else 0.0


# The attention kernels' bounds (the operations and bytes of the kernel
# table in PERF.md): forward reads q, k, v and writes o in bf16; backward
# reads q, k, v, o, do, the LSE and writes dq, dk, dv.

def attention_fwd_bound_s(seqs: int, heads: int, L: int, hd: int) -> float:
    flop = 4.0 * seqs * heads * L * L * hd
    nbytes = 4.0 * seqs * heads * L * hd * 2
    return max(flop / PEAK_FLOP_PER_S["bf16"], nbytes / HBM_BYTES_PER_S)


def attention_bwd_bound_s(seqs: int, heads: int, L: int, hd: int) -> float:
    flop = 10.0 * seqs * heads * L * L * hd
    nbytes = 8.0 * seqs * heads * L * hd * 2 + seqs * heads * L * 4
    return max(flop / PEAK_FLOP_PER_S["bf16"], nbytes / HBM_BYTES_PER_S)


def encoder_seqs(m: dict, batch: int, k: int = 1) -> int:
    """Sequences one encoder pass holds for ``batch`` samples: both
    haplotypes, and in token mode each one's ``k`` retrieved segments."""
    return 2 * batch * (1 + k) if m["rag_mode"] == "token" else 2 * batch
