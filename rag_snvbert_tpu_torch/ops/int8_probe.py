"""The int8 tensor-core probe: wrapper of ``csrc/int8_probe.cu`` and its
plain version.

The kernel replaces the three Pallas probes at the repository root
(``tools/probe_mxu.py::matmul_only_kernel``, ``tools/probe_mxu2.py::kern``,
``tools/probe_mxu3.py::kern``), which time the int8 products of the
genotype index search (queries ``[B, D]`` against refs ``[N, D]``) with no
top-k epilogue.  It returns what those ``pallas_call``s return:

  - ``bp = ceil(B / tq) tq`` and ``J = ceil(N / tn)``; queries and refs are
    zero-padded;
  - int32 ``[bp, 128]`` = ``Qp @ Rp[(J-1) tn : (J-1) tn + 128].T`` (the
    output block is rewritten for every ref tile, so the last one stays),
    the same for probe_mxu's and probe_mxu2's every order and ``par``;
  - ``running=True`` (probe_mxu3): the accumulator is reset only at the
    first query tile of each ref tile, so the rows of query tile i are
    ``sum_{i' <= i} Q_{i'} @ R_last.T``; ``trans=True`` takes refs as
    ``[D, N]`` and gives the same output;
  - ``int4=True``: both operands wrapped to 4-bit two's complement first
    (``astype(int4)``), the same products.

Sums wrap in int32, as on the TPU.  ``tq``, ``tn`` (and probe_mxu's ``td``,
which pads d with zeros) decide only the padding and which ref rows the
output holds: the kernel's own tiles are ``tile`` (``TILES``; the last
entry is ``kd``, bytes of d a pipeline stage), walked in ``order``
("qfirst": query-tile-major, "rfirst": ref-tile-major; the TPU probes'
"par" runs as its order twin).  A direct tile is BM query rows x BN refs;
a ``trans`` or ``int4`` tile is BR refs x BQ query rows, because those
modes turn the product around (the refs are wgmma's A operand, converted
in registers: csrc/int8_probe.cu).  ``k_rows_of``, ``trans_d_order`` and
``ref_rows_of`` are the orders the ``trans`` kernel and its query copy
share; ``stage_bytes`` mirrors the kernel's shared memory a stage.  With
``return_checksum`` the wrapper also returns the kernel's 64-bit sum of
every product it took (int64, 0-d), which equals ``checksum_of(q, r)``.

``int8_probe`` and ``pack_int4`` take their plain versions
(``int8_probe_plain``, ``pack_int4_plain``) for CPU tensors only; a CUDA
tensor goes to the kernel, or the wrapper raises on what the kernel does
not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

OUT_COLS = 128
# the tiles built for each producer (csrc/int8_probe.cu I8P_DIRECT, I8P_RS):
# direct (BM query rows, BN refs, KD); trans and int4 (BR refs, BQ query
# rows, KD)
TILES = {"direct": ((128, 128, 128), (128, 128, 64), (128, 192, 128),
                    (128, 192, 64), (128, 256, 128), (128, 256, 64),
                    (256, 128, 128), (256, 128, 64)),
         "trans": ((128, 256, 128),),
         "int4": ((128, 256, 128),)}
# the fastest of each producer on an H100 (PERF.md, the int8 probes)
DEFAULT_TILE = {"direct": (256, 128, 128), "trans": (128, 256, 128),
                "int4": (128, 256, 128)}
_MODES = {"direct": 0, "trans": 1, "int4": 2}
_ORDERS = {"qfirst": 0, "rfirst": 1}
_MAX_STAGES = 8
SMEM_MAX = 232448     # dynamic shared memory a block may use on an H100
_BARS = 2 * _MAX_STAGES * 8 + 1024
_SIGNATURES = {
    "int8_probe_s8": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p] + [ctypes.c_int] * 14
                     + [ctypes.c_void_p],
    "int8_probe_stage_bytes": [ctypes.c_int] * 4,
    "int8_probe_pad_queries": [ctypes.c_void_p, ctypes.c_void_p]
                              + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "int8_probe_pack_int4": [ctypes.c_void_p, ctypes.c_void_p]
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "int8_probe_running_sum": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def out_window(n: int, tn: int) -> int:
    """o0: the first ref row of the output columns, ``(ceil(N / tn) - 1)
    tn``."""
    return (-(-n // tn) - 1) * tn


def wrap_int4(x: torch.Tensor) -> torch.Tensor:
    """int8 -> the int8 value of its low 4 bits read as two's complement
    (what ``astype(int4)`` keeps)."""
    return ((x.to(torch.int16) & 15) ^ 8).sub(8).to(torch.int8)


def _operands(q, r, trans, int4):
    rows = r.t() if trans else r            # [N, D]
    if int4:
        q, rows = wrap_int4(q), wrap_int4(rows)
    return q, rows


def checksum_of(q: torch.Tensor, r: torch.Tensor, trans: bool = False,
                int4: bool = False) -> torch.Tensor:
    """``colsum(Q) . colsum(R)`` in int64 (0-d): the sum of every product
    of the B x N x D grid."""
    q, rows = _operands(q, r, trans, int4)
    return (q.sum(0, dtype=torch.int64)
            * rows.sum(0, dtype=torch.int64)).sum()


def int8_probe_plain(q: torch.Tensor, r: torch.Tensor, tq: int, tn: int, *,
                     trans: bool = False, running: bool = False,
                     int4: bool = False, return_checksum: bool = False):
    """The probes' output by the formulas of the module docstring: int64
    products (float64 on the card, which has no int64 matmul: exact below
    2^53), wrapped to int32."""
    qq, rows = _operands(q, r, trans, int4)
    b, n = qq.shape[0], rows.shape[0]
    bp = _round_up(b, tq)
    o0 = out_window(n, tn)
    last = F.pad(rows[o0:o0 + OUT_COLS], (0, 0, 0, OUT_COLS
                                          - rows[o0:o0 + OUT_COLS].shape[0]))
    dt = torch.int64 if qq.device.type == "cpu" else torch.float64
    out = (qq.to(dt) @ last.to(dt).t()).to(torch.int64)
    out = F.pad(out, (0, 0, 0, bp - b))
    if running:
        out = out.view(bp // tq, tq, OUT_COLS).cumsum(0).view(bp, OUT_COLS)
    out = out.to(torch.int32)               # two's-complement wrap
    if return_checksum:
        return out, checksum_of(q, r, trans, int4)
    return out


def row_classes(width: int, rows: int) -> int:
    """F: seen as ``[rows / F, F * width]`` a matrix of rows of ``width``
    bytes has 16-byte strides for F = 16 / gcd(width, 16); 0 where F does
    not divide ``rows`` (TMA cannot take the matrix)."""
    f = 16 // math.gcd(width, 16)
    return f if rows % f == 0 else 0


def stage_bytes(mode: str, tile: tuple[int, int, int]) -> int:
    """Shared memory of one pipeline stage (csrc/int8_probe.cu ``Cfg`` and
    ``RsCfg``::kStage): direct, the query and ref panels; trans and int4,
    the query panel and the raw ref tile (trans: each warpgroup's half as
    KD d rows of BR / 2 + 16 bytes; int4: BR packed rows of KD / 2 bytes),
    rounded up to 1024 bytes."""
    a, b, kd = tile
    if mode == "direct":
        return (a + b) * kd
    raw = 2 * kd * (a // 2 + 16) if mode == "trans" else a * kd // 2
    return b * kd + _round_up(raw, 1024)


def k_rows_of(kd: int) -> list[int]:
    """trans: the landed row (of a warpgroup's ``[kd, BR / 2 + 16]`` half
    of the raw tile) that k position p of a chunk reads (csrc ``k_row``).
    p = 32 ks + 16 h + 4 q + j, for the wgmma k32 step ks, register pair h
    (a[0..1] or a[2..3]), lane % 4 = q and byte j, reads row 32 ks + 16 h
    + 8 (j >> 1) + 2 q + (j & 1): the four lanes of a quad read rows two
    apart, 8 banks apart with rows of BR / 2 + 16 bytes.  A bijection of
    0 .. kd - 1."""
    return [32 * (p // 32) + 16 * (p // 16 % 2) + 8 * (p % 4 >> 1)
            + 2 * (p // 4 % 4) + (p % 2) for p in range(kd)]


def trans_d_order(kd: int, classes: int) -> list[int]:
    """trans: the d offset (in a chunk of kd) of the query column that k
    position p carries, under ``classes`` d row classes: landed row i of
    class cd's box (row cd kd / F + i) is d = F i + cd (csrc
    ``trans_d_of``; the query copy is laid out in this order)."""
    rows = kd // classes
    return [classes * (r % rows) + r // rows for r in k_rows_of(kd)]


def ref_rows_of(mode: str) -> torch.Tensor:
    """trans and int4: the ref (row of a 128-ref tile) that each
    accumulator row holds, int64 ``[2 warpgroups, 4 warps, 2, 8]`` indexed
    by (wg, warp, i, g) for fragment row 16 warp + g + 8 i of warpgroup
    wg's m64 slab (csrc ``ref_row``).  trans: rows g and g + 8 are the
    adjacent refs 2 g, 2 g + 1 (one 16-bit load at a d row gives both);
    int4: in order."""
    wg, w, i, g = torch.meshgrid(
        *(torch.arange(x) for x in (2, 4, 2, 8)), indexing="ij")
    if mode == "trans":
        return 64 * wg + 16 * w + 2 * g + i
    return 64 * wg + 16 * w + 8 * i + g


def plan(b: int, n: int, d: int, mode: str, tile: tuple[int, int, int],
         stage_bytes: int, sm_count: int) -> dict:
    """The launch of one call: row classes (direct: of the refs' rows;
    trans: of refs^T's d rows), the output tiles, the grid (one block an
    SM, persistent) and the ring's depth within shared memory."""
    if mode == "direct":
        bm, bn, _ = tile
        classes = row_classes(d, n)
        tiles = -(-b // bm) * classes * -(-(n // max(classes, 1)) // bn)
    else:
        br, bq, _ = tile
        classes = row_classes(n, d) if mode == "trans" else 1
        tiles = -(-b // bq) * -(-n // br)
    stages = min(_MAX_STAGES, (SMEM_MAX - _BARS) // stage_bytes)
    return {"classes": classes, "tiles": tiles,
            "grid": max(1, min(tiles, sm_count)), "stages": stages}


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(q, r, tq, tn, trans, order) -> int:
    for name, x in (("q", q), ("r", r)):
        if x.dtype != torch.int8 or x.dim() != 2:
            raise ValueError(f"int8_probe: {name} must be 2-D int8, got "
                             f"{x.dtype} {tuple(x.shape)}")
    d = r.shape[0] if trans else r.shape[1]
    if q.shape[1] != d or d == 0 or q.shape[0] == 0:
        raise ValueError(f"int8_probe: q {tuple(q.shape)} does not fit r "
                         f"{tuple(r.shape)} (trans={trans})")
    if tq < 1 or tn < OUT_COLS:
        raise ValueError(f"int8_probe: need tq >= 1 and tn >= {OUT_COLS}, "
                         f"got {tq}, {tn}")
    if order not in _ORDERS:
        raise ValueError(f"int8_probe: order must be one of "
                         f"{sorted(_ORDERS)}, got {order!r}")
    return d


def int8_probe(q: torch.Tensor, r: torch.Tensor, tq: int, tn: int, *,
               trans: bool = False, running: bool = False,
               int4: bool = False, tile: tuple[int, int, int] | None = None,
               order: str = "rfirst", checksum: bool = True,
               return_checksum: bool = False):
    """The probe (see the module docstring) on q's device.  ``checksum``
    False skips the kernel's 64-bit sum (to time what it costs)."""
    d = _check(q, r, tq, tn, trans, order)
    if q.device.type == "cpu":
        return int8_probe_plain(q, r, tq, tn, trans=trans, running=running,
                                int4=int4, return_checksum=return_checksum)
    if q.device.type != "cuda" or r.device != q.device:
        raise ValueError(f"int8_probe: q and r must be on one CUDA device, "
                         f"got {q.device}, {r.device}")
    # int4 with trans: the pack reads refs^T
    mode = "int4" if int4 else "trans" if trans else "direct"
    tile = tuple(tile or DEFAULT_TILE[mode])
    if tile not in TILES[mode]:
        raise ValueError(f"int8_probe: tile {tile} not built for {mode}; "
                         f"built: {TILES[mode]}")
    for name, x in (("q", q), ("r", r)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"int8_probe: {name} must be contiguous on a "
                             "16-byte boundary")
    b = q.shape[0]
    n = r.shape[1] if trans else r.shape[0]
    lib = _build.load("int8_probe", _SIGNATURES)
    stage = lib.int8_probe_stage_bytes(_MODES[mode], *tile)
    index = q.device.index
    p = plan(b, n, d, mode, tile, stage, _sm_count(
        torch.cuda.current_device() if index is None else index))
    if not p["classes"]:
        raise ValueError(
            f"int8_probe: TMA cannot take {'refs^T' if trans else 'refs'} "
            f"{tuple(r.shape)}: their rows need 16 / gcd(row bytes, 16) to "
            "divide the row count")
    if mode == "trans" and n % 4:
        raise ValueError("int8_probe: refs^T needs N a multiple of 4 (the "
                         "consumers read its rows in 2- or 4-byte words)")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bp = _round_up(b, tq)
    out = torch.empty(bp, OUT_COLS, dtype=torch.int32, device=q.device)
    total = torch.empty((), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        # queries: as they are where their rows are 128-byte strided, else
        # a copy with such rows (box rows that straddle 128-byte lines set
        # the pace: csrc/int8_probe.cu): direct, one per row class shifted
        # to the classes' boxes; trans, in each chunk's k order
        # (trans_d_order); int4, wrapped to 4 bits
        classes = p["classes"] if mode == "direct" else 1
        if mode != "direct" or classes > 1 or d % 128:
            qw = _round_up(d + (15 if classes > 1 else 0), 128)
            qk = torch.empty(classes * b, qw, dtype=torch.int8,
                             device=q.device)
            trans_kd = tile[2] if mode == "trans" else 0
            _build.check(lib.int8_probe_pad_queries(
                q.data_ptr(), qk.data_ptr(), b, d, qw, classes, int(int4),
                trans_kd, p["classes"], stream), "int8_probe_pad_queries")
        else:
            qk, qw = q, d
        rk, r_stride = r, (n if trans else d)
        if int4:
            rk = pack_int4(r, trans=trans)
            r_stride = rk.shape[1]
        _build.check(lib.int8_probe_s8(
            qk.data_ptr(), qw, b, rk.data_ptr(), r_stride, out.data_ptr(),
            total.data_ptr(), b, n, d, _MODES[mode], *tile, p["classes"],
            _ORDERS[order], out_window(n, tn), bp, p["stages"], int(checksum),
            p["grid"], stream), "int8_probe")
        int8_probe.launches += 1
        if running and bp > tq:
            _build.check(lib.int8_probe_running_sum(
                out.data_ptr(), bp // tq, tq, stream),
                "int8_probe_running_sum")
    if return_checksum:
        return out, total
    return out


int8_probe.launches = 0


def pack_int4_plain(r: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """refs ``[N, D]`` (or refs^T ``[D, N]``) to the packed nibbles
    ``[N, 16 ceil(D / 32)]`` int8 that the int4 producer reads: byte j of
    16-byte group p holds the low 4 bits of column 32 p + j (low nibble)
    and of column 32 p + 16 + j (high nibble), zero past D."""
    rows = r.t() if trans else r
    n, d = rows.shape
    groups = -(-d // 32)
    nib = torch.zeros(n, 32 * groups, dtype=torch.uint8, device=r.device)
    nib[:, :d] = (rows.to(torch.int16) & 15).to(torch.uint8)
    nib = nib.view(n, groups, 2, 16)
    packed = nib[:, :, 0] | (nib[:, :, 1] << 4)
    return packed.reshape(n, 16 * groups).view(torch.int8)


def pack_int4(r: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """The int4 producer's first step (``pack_int4_plain``'s layout) on r's
    device: refs by a coalesced pass a 16-byte group a thread, refs^T by a
    tiled transpose through shared memory (csrc/int8_probe.cu
    ``pack_int4_rows``, ``pack_int4_cols``).  Called by ``int8_probe``
    for int4, and alone to time it apart."""
    if r.dtype != torch.int8 or r.dim() != 2 or 0 in r.shape:
        raise ValueError(f"pack_int4: r must be non-empty 2-D int8, got "
                         f"{r.dtype} {tuple(r.shape)}")
    if r.device.type == "cpu":
        return pack_int4_plain(r, trans)
    if r.device.type != "cuda" or not r.is_contiguous() or r.data_ptr() % 16:
        raise ValueError("pack_int4: r must be a contiguous CUDA tensor on "
                         "a 16-byte boundary")
    n, d = (r.shape[1], r.shape[0]) if trans else r.shape
    lib = _build.load("int8_probe", _SIGNATURES)
    pw = 16 * -(-d // 32)
    out = torch.empty(n, pw, dtype=torch.int8, device=r.device)
    with torch.cuda.device(r.device):
        _build.check(lib.int8_probe_pack_int4(
            r.data_ptr(), out.data_ptr(), n, d, pw, int(trans),
            torch.cuda.current_stream(r.device).cuda_stream),
            "int8_probe_pack_int4")
    pack_int4.launches += 1
    return out


pack_int4.launches = 0
