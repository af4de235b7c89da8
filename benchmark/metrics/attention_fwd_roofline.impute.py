"""``attention_fwd_roofline.impute``: the fused attention forward
(``csrc/attention.cu``'s ``attention_fwd_kernel``) against its bound:
each call's ``flops.attention_fwd_bound_s`` at the device batch's shape
over the kernel's device time in the trace.  Nothing without the
kernel."""

from benchmark import flops

UNIT = "%"


def read(r):
    if r.trace is None:
        return None
    calls, secs = r.trace.kernel_seconds("attention_fwd_kernel")
    if not calls or secs <= 0:
        return None
    c, m = r.counts, r.config["model"]
    bound = flops.attention_fwd_bound_s(
        flops.encoder_seqs(m, c["batch_size"]), m["attn_heads"],
        c["seq_len"], m["dims"] // m["attn_heads"])
    return 100.0 * calls * bound / secs
