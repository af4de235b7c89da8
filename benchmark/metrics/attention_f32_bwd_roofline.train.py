"""``attention_f32_bwd_roofline.train``: the float32 attention backward with
dropout (``csrc/attention_f32.cu``: ``attn_f32_dsum_kernel``,
``attn_f32_bwd_dkv_kernel`` and ``attn_f32_bwd_dq_kernel`` a call)
against its bound: each call's ``flops_f32.attention_f32_bwd_bound_s`` at
the training batch's shape over the three kernels' device time in the
trace.  Nothing without the kernels."""

from benchmark import flops, flops_f32

UNIT = "%"


def read(r):
    if r.trace is None:
        return None
    calls, secs = r.trace.kernel_seconds("attn_f32_bwd_dq_kernel")
    _, kv = r.trace.kernel_seconds("attn_f32_bwd_dkv_kernel")
    _, dsum = r.trace.kernel_seconds("attn_f32_dsum_kernel")
    if not calls or secs + kv + dsum <= 0:
        return None
    c, m = r.counts, r.config["model"]
    bound = flops_f32.attention_f32_bwd_bound_s(
        flops.encoder_seqs(m, c["batch_size"]), m["attn_heads"],
        c["seq_len"], m["dims"] // m["attn_heads"], m["attn_dropout"] > 0)
    return 100.0 * calls * bound / (secs + kv + dsum)
