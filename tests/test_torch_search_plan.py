"""Host-side planning of the two search kernels (``ops.l2_topk``,
``ops.l2_topk_rf``), on the CPU: the splits cover every column and row
once, the kernel's K walk over packed refs visits every unpacked column
once and agrees with ``planar_unpack``, the row-class view that lets TMA
take rows of any width lines queries and rows up, and every k the wrapper
accepts fits the block's shared memory.  The kernels themselves run only on
the card (tests/test_torch_cuda.py)."""

import importlib
import math

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch.ops import planar

# ``ops`` exports the wrappers under their modules' names: take the modules
l2 = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk")
rf = importlib.import_module("rag_snvbert_tpu_torch.ops.l2_topk_rf")

SMS = 132           # an H100's streaming multiprocessors
SMEM_MAX = 232448   # dynamic shared memory a block may use there


@pytest.mark.parametrize("b,n,d", [
    (64, 2048, 1030 * 384), (48, 2048, 1030 * 384), (5, 300, 520),
    (64, 64, 8), (65, 129, 200), (1, 1, 8), (200, 49152, 4096),
])
@pytest.mark.parametrize("sms", [SMS, 8])
def test_l2_topk_split_plan_covers_d_once(b, n, d, sms):
    splits, chunk = l2.split_plan(b, n, d, sms)
    assert chunk % l2._STAGE_D == 0 and splits >= 1
    # split s takes columns [s * chunk, min((s + 1) * chunk, d)): all of d,
    # no split empty
    assert (splits - 1) * chunk < d <= splits * chunk
    tiles = -(-n // l2._TILE_N) * -(-b // l2._TILE_B)
    if tiles <= sms:    # the grid stays within the planned waves
        assert tiles * splits <= l2._WAVES * sms


def test_l2_topk_serving_plan_fills_whole_waves():
    splits, chunk = l2.split_plan(64, 2048, 1030 * 384, SMS)
    assert 16 * splits == l2._WAVES * SMS        # 16 ref tiles of 128 rows


@pytest.mark.parametrize("b,n,sms,classes", [
    (64, 2048, SMS, 1), (1024, 664648, SMS, 1), (1024, 664648, SMS, 2),
    (1, 5, SMS, 1), (33, 4100, 8, 1), (33, 4096, SMS, 16), (5, 70001, SMS, 1),
    (129, 1000, SMS, 8), (1, 192, SMS, 1), (1, 193, SMS, 1),
])
def test_l2_topk_rf_split_plan_covers_every_row_once(b, n, sms, classes):
    assert n % classes == 0
    splits, rows = rf.split_plan(b, n, sms, classes)
    assert rows % rf._BN == 0 and splits % classes == 0
    ranges, per_class = splits // classes, n // classes
    assert (ranges - 1) * rows < per_class <= ranges * rows
    seen = np.zeros(n, dtype=np.int64)
    for split in range(splits):              # the kernel's blockIdx.y
        cls, begin = split % classes, (split // classes) * rows
        end = min(begin + rows, per_class)
        seen[np.arange(begin, end) * classes + cls] += 1
    assert (seen == 1).all()
    q_tiles = -(-b // rf._BQ)
    if q_tiles * classes <= sms:             # one wave of one block per SM
        assert q_tiles * splits <= sms


@pytest.mark.parametrize("width,n,pack,aligned,want", [
    (2040, 664648, 1, True, 2), (2040, 664649, 1, True, 1),
    (1040, 2048, 1, True, 1), (1030, 2048, 1, True, 8),
    (31, 128, 1, True, 16), (31, 130, 1, True, 1), (2040, 664648, 1, False, 1),
    (256, 664648, 8, True, 1), (4, 40, 1, True, 4),
])
def test_row_classes(width, n, pack, aligned, want):
    f = rf.row_classes(width, n, pack, aligned)
    assert f == want
    if f > 1:       # what TMA and the class split need
        assert (f * width) % 16 == 0 and n % f == 0


@pytest.mark.parametrize("d,f", [(2040, 2), (1030, 8), (31, 16), (200, 2)])
def test_row_class_boxes_line_queries_and_rows_up(d, f):
    """A numpy twin of the kernel's addressing with row classes: class c's
    boxes start ``delta = (c * d) % 16`` bytes before its rows do, on
    16-byte boundaries of the ``[N / f, f * d]`` view, against a copy of the
    queries shifted right by delta; bytes of neighbouring rows meet zeros.
    The chunks' products add up to q . r for every row of the class."""
    rng = np.random.default_rng(d)
    n = 4 * f
    refs = rng.integers(-128, 128, (n, d)).astype(np.int64)
    q = rng.integers(-128, 128, d).astype(np.int64)
    view = np.concatenate([refs.reshape(n // f, f * d),
                           np.zeros((n // f, 256), np.int64)], axis=1)
    for c in range(f):
        delta = (c * d) % 16
        width = -(-(d + 15) // 16) * 16 + 128      # the copy, then zeros
        shifted = np.zeros(width + 128, np.int64)
        shifted[delta:delta + d] = q
        dots = np.zeros(n // f, np.int64)
        for u0 in range(0, d + delta, rf._KD):
            start = c * d - delta + u0
            assert start % 16 == 0 and start >= 0
            dots += view[:, start:start + rf._KD] @ shifted[u0:u0 + rf._KD]
        np.testing.assert_array_equal(dots, refs[c::f] @ q)


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [1, 31, 128, 129, 1030, 2040])
def test_k_walk_visits_every_unpacked_column_once(pack, d):
    width = d if pack == 1 else planar.packed_width(d, pack)
    if pack > 1 and d > width * pack:
        pytest.skip("d beyond the packed width")
    walk = rf.packed_k_walk(d, width, pack)
    assert walk and walk == sorted(walk)         # (column block, plane) order
    seen = np.zeros(rf.unpacked_width(d, width, pack), dtype=np.int64)
    for cb, m, u0 in walk:
        assert 0 <= m < pack and u0 < d
        assert u0 == (m * width if pack > 1 else 0) + cb * rf._KD
        seen[u0:u0 + rf._KD] += 1
    assert (seen[:d] == 1).all()                 # every column of d once
    assert (seen <= 1).all()


@pytest.mark.parametrize("pack", [2, 4, 8])
def test_k_walk_agrees_with_planar_unpack(pack):
    """Plane m of packed bytes [cb * 128, cb * 128 + 128), by shift and
    mask as the kernel's loader unpacks it, is the walk's chunk of the
    unpacked rows."""
    d = 1000
    gen = torch.Generator().manual_seed(pack)
    v = torch.randint(0, 1 << (8 // pack), (7, d), generator=gen,
                      dtype=torch.int8)
    packed = planar.pack_planar(v, pack)
    width = packed.shape[1]
    full = planar.planar_unpack(packed, pack, width * pack)
    bits = 8 // pack
    raw = packed.view(torch.uint8).to(torch.int32)
    for cb, m, u0 in rf.packed_k_walk(d, width, pack):
        block = raw[:, cb * rf._KD:(cb + 1) * rf._KD]
        plane = (block >> (m * bits)) & ((1 << bits) - 1)
        assert torch.equal(plane.to(torch.int8), full[:, u0:u0 + rf._KD])
    assert torch.equal(full[:, :d], v)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 64, 65, 96, 97, 128])
def test_every_k_fits_shared_memory(k, packed):
    """The twin of the kernel's shared-memory layout: shared memory does
    not grow with the width, so every (width, k) the wrapper accepts gets a
    ring of at least one stage within an H100 block's 232,448 bytes, and
    the deepest ring that fits."""
    kp = rf.list_stride(k)
    assert kp >= k and (kp == 16 or kp % 32 == 0)
    stages = rf.ring_stages(kp, packed)
    assert 1 <= stages <= rf._MAX_STAGES
    assert rf.smem_bytes(kp, packed, stages) <= SMEM_MAX == rf._SMEM_MAX
    if stages < rf._MAX_STAGES:
        assert rf.smem_bytes(kp, packed, stages + 1) > SMEM_MAX
    if k <= 16:
        assert stages == rf._MAX_STAGES          # the shapes that must be fast


def test_width_limit_keeps_distances_in_the_selections_range():
    """The kernel's selection leans on distances below 2^29 and
    |2 q.r| below 2^28 at the widest row it takes."""
    assert rf.MAX_WIDTH * 255 ** 2 < 2 ** 29
    assert 2 * rf.MAX_WIDTH * 128 ** 2 <= 2 ** 28
    assert math.gcd(rf.MAX_WIDTH, rf._KD) == rf._KD
