"""``attention_bwd_roofline.train``: the fused attention backward
(``csrc/attention_bwd.cu``: ``attention_bwd_dq_kernel`` and
``attention_bwd_dkv_kernel`` a call) against its bound: each call's
``flops.attention_bwd_bound_s`` at the training batch's shape over the
two kernels' device time in the trace.  Nothing without the kernel (the
einsum path)."""

from benchmark import flops

UNIT = "%"


def read(r):
    if r.trace is None:
        return None
    calls, secs = r.trace.kernel_seconds("attention_bwd_dq_kernel")
    _, secs_kv = r.trace.kernel_seconds("attention_bwd_dkv_kernel")
    if not calls or secs + secs_kv <= 0:
        return None
    c, m = r.counts, r.config["model"]
    bound = flops.attention_bwd_bound_s(
        flops.encoder_seqs(m, c["batch_size"]), m["attn_heads"],
        c["seq_len"], m["dims"] // m["attn_heads"])
    return 100.0 * calls * bound / (secs + secs_kv)
