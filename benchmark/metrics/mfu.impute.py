"""``mfu.impute``: the imputation window's model operations (each device
batch's forward, ``flops.infer_batch``, and each window context's
``flops.window_context``, counted from shapes) over its seconds, as a
share of the configuration's peak."""

from benchmark import flops

UNIT = "%"


def read(r):
    c, m = r.counts, r.config["model"]
    if not c.get("batches"):
        return None
    ops = (c["batches"] * flops.infer_batch(m, c["batch_size"], c["seq_len"],
                                            c["context_rows"])
           + c["window_contexts"] * flops.window_context(
               m, c["context_rows"], c["seq_len"]))
    return 100.0 * ops / r.window_s / flops.PEAK_FLOP_PER_S[r.config["peak"]]
