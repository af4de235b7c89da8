"""The operation and byte counts against counts made by hand."""

from benchmark import flops


def test_dense_and_encoder():
    assert flops.dense(10, 3, 4) == 240
    # one layer, one sequence of 2 tokens, width 4: QKVO 4 x (2 * 2*4*4),
    # FFN 2 x (2 * 2*4*16), attention 4 * 1 * 2 * 2 * 4
    assert flops.encoder(1, 2, 4, 1) == 4 * 64 + 2 * 256 + 64


def test_tpu_default_step():
    m = {"dims": 384, "n_layers": 12, "rag_mode": "embedding"}
    # a hand count: 2.1 TFLOP of linear and 0.94 of attention
    # forward for the encoder of 48 sequences of 1030
    enc = flops.encoder(48, 1030, 384, 12)
    assert abs(enc - (24 * 384 ** 2 * 48 * 1030 * 12
                      + 4 * 1030 ** 2 * 384 * 48 * 12)) < 1
    diff, srch = flops.forward(m, 24, 1030, 2048)
    assert srch == 2 * 48 * 2048 * 1030 * 384
    assert flops.train_step(m, 24, 1030, 2048) == 3 * diff + srch
    assert 10.7e12 < flops.train_step(m, 24, 1030, 2048) < 10.9e12


def test_token_mode_counts_segments():
    m = {"dims": 192, "n_layers": 10, "rag_mode": "token"}
    assert flops.encoder_seqs(m, 16) == 64
    diff, srch = flops.forward(m, 16, 1030, 2048)
    assert srch == 2 * 32 * 2048 * 1030
    assert flops.window_context(m, 2048, 1030) == 0


def test_attention_bounds_match_the_kernel_table():
    # PERF.md's kernel table: forward 0.1055 ms at 64 x 3 x 1030 x 128
    # (operations), backward 0.1977 ms at 48 x 3 x 1030 x 128
    assert abs(flops.attention_fwd_bound_s(64, 3, 1030, 128) * 1e3
               - 0.1055) < 5e-4
    assert abs(flops.attention_bwd_bound_s(48, 3, 1030, 128) * 1e3
               - 0.1977) < 5e-4
    # bytes bound a short one
    b = flops.attention_fwd_bound_s(1, 1, 8, 128)
    assert b == 4 * 8 * 128 * 2 / flops.HBM_BYTES_PER_S
