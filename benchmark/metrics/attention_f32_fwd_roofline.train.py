"""``attention_f32_fwd_roofline.train``: the float32 attention forward with
dropout (``csrc/attention_f32.cu``: ``attn_f32_pack_kernel``, the mask's
packing, and ``attn_f32_fwd_kernel`` a call) against its bound: each
call's ``flops_f32.attention_f32_fwd_bound_s`` at the training batch's
shape over the two kernels' device time in the trace.  Nothing without
the kernels."""

from benchmark import flops, flops_f32

UNIT = "%"


def read(r):
    if r.trace is None:
        return None
    calls, secs = r.trace.kernel_seconds("attn_f32_fwd_kernel")
    _, pack = r.trace.kernel_seconds("attn_f32_pack_kernel")
    if not calls or secs + pack <= 0:
        return None
    c, m = r.counts, r.config["model"]
    bound = flops_f32.attention_f32_fwd_bound_s(
        flops.encoder_seqs(m, c["batch_size"]), m["attn_heads"],
        c["seq_len"], m["dims"] // m["attn_heads"], m["attn_dropout"] > 0)
    return 100.0 * calls * bound / (secs + pack)
