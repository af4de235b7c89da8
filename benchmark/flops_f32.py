"""The float32 attention kernels' bounds (``csrc/attention_f32.cu``), the
yardstick of the ``attention_f32_*_roofline`` metrics, at ``flops.py``'s
peaks.

Forward: ``4 seqs H L^2 hd`` operations at the float32 peak (67 TFLOP/s,
outside the tensor cores); bytes: q, k and v read and o written at 4
bytes, the LSE written, and the dropout's keep mask read at one bit a
score, the least any implementation reads.  Backward: ``10 seqs H L^2
hd`` operations; q, k, v, o and do read and dq, dk and dv written at 4
bytes, the LSE read, the mask at a bit a score.  Without dropout there is
no mask."""

from __future__ import annotations

from . import flops


def _bound_s(flop: float, nbytes: float) -> float:
    return max(flop / flops.PEAK_FLOP_PER_S["fp32"],
               nbytes / flops.HBM_BYTES_PER_S)


def attention_f32_fwd_bound_s(seqs: int, heads: int, L: int, hd: int,
                              dropout: bool) -> float:
    rows = seqs * heads * L
    mask = rows * L / 8 if dropout else 0.0
    return _bound_s(4.0 * rows * L * hd, 4 * 4.0 * rows * hd + 4.0 * rows
                    + mask)


def attention_f32_bwd_bound_s(seqs: int, heads: int, L: int, hd: int,
                              dropout: bool) -> float:
    rows = seqs * heads * L
    mask = rows * L / 8 if dropout else 0.0
    return _bound_s(10.0 * rows * L * hd, 8 * 4.0 * rows * hd + 4.0 * rows
                    + mask)
