"""Host-side layout of the int8 probe's ``trans`` and ``int4`` producers
(``ops.int8_probe``), on the CPU: the packed nibbles of ``pack_int4_plain``
unpack to the 4-bit refs in both orientations, ``plan()`` sizes the rings
and grids of the refs-x-queries tiles, and the orders that the ``trans``
kernel and its query copy share (``k_rows_of``, ``trans_d_order``,
``ref_rows_of``) are bijections that meet no bank conflict, write each
output column once, and compose into the exact product.  The kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py);
here their arithmetic is modelled from the same functions."""

import math

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.ops import int8_probe as probe

SMS = 132                                   # an H100's streaming multiprocessors
INDEX = (1024, 664648, 2048)                # tools/probe_mxu3.py's B, N, D
PROBE_EDGE = ((300, 50004, 2040), (20, 1000, 70))   # as chip_smoke.py
RS_TILES = [(mode, tile) for mode in ("trans", "int4")
            for tile in probe.TILES[mode]]


def _unpack(packed: np.ndarray, d: int) -> np.ndarray:
    """The packed layout read back independently: byte j of 16-byte group p
    holds column 32 p + j in its low nibble and 32 p + 16 + j in its high
    one, each a 4-bit two's-complement value."""
    n, pw = packed.shape
    b = packed.view(np.uint8).reshape(n, pw // 16, 16).astype(np.int16)
    cols = np.stack([b & 15, b >> 4], axis=2).reshape(n, -1)   # [n, 32 g]
    vals = np.where(cols >= 8, cols - 16, cols)
    assert not vals[:, d:].any(), "nibbles past D must be zero"
    return vals[:, :d].astype(np.int8)


@pytest.mark.parametrize("trans", [False, True], ids=["refs", "refs_t"])
@pytest.mark.parametrize("d", [70, 2040, 2048])
def test_pack_int4_plain_unpacks_to_the_4bit_refs(d, trans):
    rng = np.random.default_rng(d)
    refs = rng.integers(-128, 128, (37, d)).astype(np.int8)
    src = torch.from_numpy(refs.T.copy() if trans else refs)
    packed = probe.pack_int4_plain(src, trans=trans)
    assert packed.dtype == torch.int8
    assert packed.shape == (37, 16 * math.ceil(d / 32))
    want = probe.wrap_int4(torch.from_numpy(refs)).numpy()
    np.testing.assert_array_equal(_unpack(packed.numpy(), d), want)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(probe.pack_int4(src, trans=trans), packed)


@pytest.mark.parametrize("shape", [INDEX, *PROBE_EDGE],
                         ids=["index", "edge_2040", "edge_70"])
@pytest.mark.parametrize("mode,tile", RS_TILES,
                         ids=[f"{m}-{t[0]}x{t[1]}" for m, t in RS_TILES])
def test_plan_of_the_refs_by_queries_tiles(mode, tile, shape):
    b, n, d = shape
    br, bq, kd = tile
    stage = probe.stage_bytes(mode, tile)
    p = probe.plan(b, n, d, mode, tile, stage, SMS)
    # the ring, its barriers and the 1024-byte alignment fit the block
    assert 2 <= p["stages"] <= probe._MAX_STAGES
    assert p["stages"] * stage + probe._BARS <= probe.SMEM_MAX
    if p["stages"] < probe._MAX_STAGES:     # as deep as shared memory allows
        assert (p["stages"] + 1) * stage + probe._BARS > probe.SMEM_MAX
    # refs are the tile's rows (A), queries its columns (B)
    assert p["tiles"] == math.ceil(b / bq) * math.ceil(n / br)
    assert p["grid"] == min(p["tiles"], SMS)
    # trans: refs^T's d rows as classes whose view rows TMA can take
    want = probe.row_classes(n, d) if mode == "trans" else 1
    assert p["classes"] == want and want > 0
    if mode == "trans":
        assert (want * n) % 16 == 0 and d % want == 0
        assert kd // want >= 32       # a k32 step lies in one class


def test_plan_at_the_index_shape():
    for mode, tile in RS_TILES:
        p = probe.plan(*INDEX, mode, tile, probe.stage_bytes(mode, tile),
                       SMS)
        assert p["tiles"] == (4 * 5193 if tile[0] == 128 else 8 * 2597)
        assert p["grid"] == SMS
    assert probe.plan(*INDEX, "trans", (128, 256, 128), probe.stage_bytes(
        "trans", (128, 256, 128)), SMS)["classes"] == 2   # N = 8 mod 16


def test_k_rows_of_is_a_bijection_lanes_two_rows_apart():
    rows = probe.k_rows_of(128)
    assert sorted(rows) == list(range(128))
    for ks in range(4):
        for h in range(2):
            for j in range(4):
                quad = [rows[32 * ks + 16 * h + 4 * q + j] for q in range(4)]
                assert np.diff(quad).tolist() == [2, 2, 2]
                assert all(32 * ks <= r < 32 * ks + 32 for r in quad)


@pytest.mark.parametrize("classes", [1, 2, 4])
def test_trans_d_order_is_a_bijection(classes):
    order = probe.trans_d_order(128, classes)
    assert sorted(order) == list(range(128))
    rows = probe.k_rows_of(128)
    per_class = 128 // classes
    for p, r in enumerate(rows):     # landed row r = view row i of class cd
        assert order[p] == classes * (r % per_class) + r // per_class


@pytest.mark.parametrize("mode", ["trans", "int4"])
def test_ref_rows_of_is_a_bijection(mode):
    refs = probe.ref_rows_of(mode)
    assert refs.shape == (2, 4, 2, 8)
    assert sorted(refs.flatten().tolist()) == list(range(128))
    # each warpgroup holds its own half of the tile, each warp 16 refs
    for wg in range(2):
        for w in range(4):
            rows = sorted(refs[wg, w].flatten().tolist())
            assert rows == list(range(64 * wg + 16 * w, 64 * wg + 16 * w + 16))
    if mode == "trans":     # rows g and g + 8: adjacent refs, even first
        assert (refs[:, :, 1] == refs[:, :, 0] + 1).all()
        assert (refs[:, :, 0] % 2 == 0).all()


@pytest.mark.parametrize("delta", [0, 4, 8, 12])
def test_trans_gather_meets_no_bank_conflict(delta):
    """Each 16-bit load of the trans gather (a row of 64 + 16 bytes a
    warpgroup, refs starting delta bytes in): the 32 lanes' words lie on
    distinct banks, or share a word (a broadcast)."""
    row_bytes = 64 + 16
    refs = probe.ref_rows_of("trans")
    rows = probe.k_rows_of(128)
    for wg in range(2):
        for warp in range(4):
            for ks in range(4):
                for h in range(2):
                    for j in range(4):
                        words = {}
                        for lane in range(32):
                            g, q = lane // 4, lane % 4
                            row = rows[32 * ks + 16 * h + 4 * q + j]
                            ref = int(refs[wg, warp, 0, g]) - 64 * wg
                            byte = row * row_bytes + delta + ref
                            for x in range(2):   # the load's two bytes
                                w = (byte + x) // 4
                                assert words.setdefault(w % 32, w) == w


def test_int4_gather_meets_no_bank_conflict():
    """The 32-bit loads of packed rows, 64 bytes a row, 64-byte swizzled
    (16-byte group G of row r at G ^ ((r >> 1) & 3))."""
    refs = probe.ref_rows_of("int4")
    for wg in range(2):
        for warp in range(4):
            for i in range(2):
                for ks in range(4):
                    banks = set()
                    for lane in range(32):
                        g, q = lane // 4, lane % 4
                        r = int(refs[wg, warp, i, g])
                        byte = r * 64 + ((ks ^ ((r >> 1) & 3)) << 4) + 4 * q
                        banks.add(byte // 4 % 32)
                    assert len(banks) == 32


@pytest.mark.parametrize("shape", [INDEX, *PROBE_EDGE, (5, 300, 64)],
                         ids=["index", "edge_2040", "edge_70", "small"])
@pytest.mark.parametrize("mode,tile", RS_TILES,
                         ids=[f"{m}-{t[0]}x{t[1]}" for m, t in RS_TILES])
def test_epilogue_writes_each_output_column_once(mode, tile, shape):
    """The epilogue's mapping (ref = r0 + ref_rows_of, column = ref - o0
    for refs below N) over every ref tile returns exactly the columns
    o0 .. o0 + 127 that exist, once each, for the probes' tn."""
    b, n, d = shape
    br = tile[0]
    local = probe.ref_rows_of(mode).flatten()
    for tn in (128, 512, 1024):
        o0 = probe.out_window(n, tn)
        written = []
        for r0 in range(0, n, br):
            refs = r0 + local
            cols = refs - o0
            keep = (refs < n) & (cols >= 0) & (cols < probe.OUT_COLS)
            written += cols[keep].tolist()
        assert sorted(written) == list(range(min(probe.OUT_COLS, n - o0)))


def _box(view, row0, col0, rows, cols):
    """A TMA box of ``view``: zeros past its edges."""
    out = np.zeros((rows, cols), np.int64)
    r = np.arange(row0, row0 + rows)[:, None]
    c = np.arange(col0, col0 + cols)[None, :]
    ok = (r < view.shape[0]) & (c >= 0) & (c < view.shape[1])
    out[ok] = view[np.broadcast_to(r, ok.shape)[ok],
                   np.broadcast_to(c, ok.shape)[ok]]
    return out


def _model_rs_tile(q, refs, mode, tile, r0):
    """One ref tile (all queries as one query tile) of
    int8_probe_rs_kernel, modelled with the kernel's own addressing: the
    query copy in its k order, the raw ref tile as TMA lands it (trans:
    each warpgroup's half, each d row class's box starting delta bytes
    early; int4: packed rows, 64-byte swizzled), and each lane's A
    fragment gathered from it (CUTLASS's ALayout_64x32: register r of lane
    (g, q) holds fragment row g + 8 (r % 2), k 16 (r // 2) + 4 q .. + 3).
    Returns acc[ref of the tile, query]."""
    b, d = q.shape
    n = refs.shape[0]
    br, bq, kd = tile
    classes = probe.row_classes(n, d) if mode == "trans" else 1
    order = (probe.trans_d_order(kd, classes) if mode == "trans"
             else list(range(kd)))
    rows = probe.k_rows_of(kd)
    ref_of = probe.ref_rows_of(mode).numpy()
    qk = q.astype(np.int64)
    if mode == "int4":
        qk = ((qk & 15) ^ 8) - 8
        packed = probe.pack_int4_plain(torch.from_numpy(refs)).numpy()
        packed = packed.view(np.uint8).astype(np.int64)
    else:
        view = refs.T.reshape(d // classes, classes * n).astype(np.int64)
    acc = np.zeros((br, b), np.int64)
    per = kd // classes
    row_bytes = br // 2 + 16
    for k0 in range(0, d, kd):
        dq = k0 + np.asarray(order)
        qc = np.where(dq < d, qk[:, np.minimum(dq, d - 1)], 0)   # [b, kd]
        if mode == "trans":
            raw = np.zeros((2, kd, row_bytes), np.int64)
            for h in range(2):
                for cd in range(classes):
                    delta = cd * (n % 16) % 16
                    raw[h, cd * per:(cd + 1) * per] = _box(
                        view, k0 // classes,
                        cd * n - delta + r0 + h * br // 2, per, row_bytes)
        else:
            box = _box(packed, r0, k0 // 2, br, kd // 2)
            smem = np.zeros_like(box)        # 16-byte group G at G ^ swz
            for r in range(br):
                for grp in range(kd // 32):
                    x = (grp ^ ((r >> 1) & 3)) * 16
                    smem[r, x:x + 16] = box[r, 16 * grp:16 * grp + 16]
        a = np.zeros((br, kd), np.int64)      # a[ref, k position]
        for wg in range(2):
            for warp in range(4):
                for lane in range(32):
                    g, t4 = lane // 4, lane % 4
                    for ks in range(kd // 32):
                        frag = np.zeros((4, 4), np.int64)
                        if mode == "trans":
                            delta = (32 * ks // per) * (n % 16) % 16
                            mine = ref_of[wg, warp, 0, g] - 64 * wg
                            for h in range(2):
                                for j in range(4):
                                    row = rows[32 * ks + 16 * h + 4 * t4 + j]
                                    for i in range(2):   # the 16-bit load
                                        frag[2 * h + i, j] = raw[
                                            wg, row, delta + mine + i]
                        else:
                            swz = (g >> 1) & 3
                            for i in range(2):
                                row = ref_of[wg, warp, i, g]
                                x = ((ks ^ swz) << 4) + 4 * t4
                                for j in range(4):
                                    byte = smem[row, x + j]
                                    lo, hi = byte & 15, byte >> 4
                                    frag[i, j] = (lo ^ 8) - 8
                                    frag[2 + i, j] = (hi ^ 8) - 8
                        for r in range(4):
                            ref = ref_of[wg, warp, r % 2, g]
                            k = 32 * ks + 16 * (r // 2) + 4 * t4
                            a[ref, k:k + 4] = frag[r]
        acc += a @ qc.T
    return acc


# (B, N, d): N = 8 mod 16 (two d row classes, delta 0 and 8), N = 12 mod
# 16 (four classes, delta 0, 12, 8, 4), N = 0 mod 16 (one class); d off the
# 128-byte chunk and the 32-column int4 group
MODEL_SHAPES = [(6, 1000, 200), (5, 1004, 200), (4, 1024, 136),
                (3, 1000, 70)]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,tile", RS_TILES,
                         ids=[f"{m}-{t[0]}x{t[1]}" for m, t in RS_TILES])
def test_the_layout_composes_into_the_exact_product(mode, tile, shape):
    b, n, d = shape
    rng = np.random.default_rng(n + d)
    q = rng.integers(-128, 128, (b, d)).astype(np.int8)
    refs = rng.integers(-128, 128, (n, d)).astype(np.int8)
    qq, rr = q.astype(np.int64), refs.astype(np.int64)
    if mode == "int4":
        qq, rr = ((qq & 15) ^ 8) - 8, ((rr & 15) ^ 8) - 8
    br = tile[0]
    for r0 in (0, (n - 1) // br * br):     # the first and the last ref tile
        acc = _model_rs_tile(q, refs, mode, tile, r0)
        m = min(br, n - r0)
        # rows past N hold a neighbour class's bytes (trans) or zeros
        # (int4): the epilogue masks them
        # (test_epilogue_writes_each_output_column_once)
        np.testing.assert_array_equal(acc[:m], rr[r0:r0 + m] @ qq.T)
