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
output holds: the kernel's own tiles are ``tile`` (BM x BN query rows x
refs, ``TILES``) and ``kd`` (bytes of d a pipeline stage), walked in
``order`` ("qfirst": query-tile-major, "rfirst": ref-tile-major; the TPU
probes' "par" runs as its order twin).  With ``return_checksum`` the
wrapper also returns the kernel's 64-bit sum of every product it took
(int64, 0-d), which equals ``checksum_of(q, r)``.

``int8_probe`` takes the plain version for CPU tensors only; a CUDA tensor
goes to the kernel, or the wrapper raises on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

OUT_COLS = 128
# (BM, BN, KD) built for each producer (csrc/int8_probe.cu I8P_LAUNCH)
TILES = {"direct": ((128, 128, 128), (128, 128, 64), (128, 192, 128),
                    (128, 192, 64), (128, 256, 128), (128, 256, 64),
                    (256, 128, 128), (256, 128, 64)),
         "trans": ((128, 128, 128), (128, 192, 128)),
         "int4": ((128, 128, 128), (128, 256, 128))}
# the fastest of each producer on an H100 (PERF.md, the int8 probes)
DEFAULT_TILE = {"direct": (256, 128, 128), "trans": (128, 192, 128),
                "int4": (128, 256, 128)}
_MODES = {"direct": 0, "trans": 1, "int4": 2}
_ORDERS = {"qfirst": 0, "rfirst": 1}
_MAX_STAGES = 8
_SMEM_MAX = 232448    # dynamic shared memory a block may use on an H100
_BARS = 3 * _MAX_STAGES * 8 + 1024
_SIGNATURES = {
    "int8_probe_s8": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p] + [ctypes.c_int] * 14
                     + [ctypes.c_void_p],
    "int8_probe_stage_bytes": [ctypes.c_int] * 4,
    "int8_probe_pad_queries": [ctypes.c_void_p, ctypes.c_void_p]
                              + [ctypes.c_int] * 5 + [ctypes.c_void_p],
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


def plan(b: int, n: int, d: int, mode: str, tile: tuple[int, int, int],
         stage_bytes: int, sm_count: int) -> dict:
    """The launch of one call: row classes, the query copy's width (0: the
    queries go as they are), the output tiles, the grid (one block an SM,
    persistent) and the ring's depth within shared memory."""
    bm, bn, kd = tile
    if mode == "direct":
        classes, n_view = row_classes(d, n), 0
        if classes:
            n_view = n // classes
    else:
        classes = row_classes(n, d) if mode == "trans" else 1
        n_view = n
    tiles_n = (classes * -(-n_view // bn) if mode == "direct"
               else -(-n // bn))
    tiles = -(-b // bm) * tiles_n
    stages = min(_MAX_STAGES, (_SMEM_MAX - _BARS) // stage_bytes)
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
                         "transposing pass reads 4-byte words)")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bp = _round_up(b, tq)
    out = torch.empty(bp, OUT_COLS, dtype=torch.int32, device=q.device)
    total = torch.empty((), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        # queries: as they are where their rows are 128-byte strided, else
        # a copy with such rows (box rows that straddle 128-byte lines set
        # the pace: csrc/int8_probe.cu), one per row class shifted to the
        # classes' boxes, wrapped to 4 bits for int4
        classes = p["classes"] if mode == "direct" else 1
        if int4 or classes > 1 or d % 128:
            qw = _round_up(d + (15 if classes > 1 else 0), 128)
            qk = torch.empty(classes * b, qw, dtype=torch.int8,
                             device=q.device)
            _build.check(lib.int8_probe_pad_queries(
                q.data_ptr(), qk.data_ptr(), b, d, qw, classes, int(int4),
                stream), "int8_probe_pad_queries")
        else:
            qk, qw = q, d
        rk, r_stride = r, (n if trans else d)
        if int4:
            r_stride = 16 * -(-d // 32)
            rk = torch.empty(n, r_stride, dtype=torch.int8, device=q.device)
            _build.check(lib.int8_probe_pack_int4(
                r.data_ptr(), rk.data_ptr(), n, d, r_stride, int(trans),
                stream), "int8_probe_pack_int4")
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


def pack_int4(r: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """The int4 producer's first step alone (to time it apart): refs (or
    refs^T) to the packed nibbles ``[N, 16 ceil(D / 32)]`` the kernel
    reads."""
    n, d = (r.shape[1], r.shape[0]) if trans else r.shape
    lib = _build.load("int8_probe", _SIGNATURES)
    pw = 16 * -(-d // 32)
    out = torch.empty(n, pw, dtype=torch.int8, device=r.device)
    with torch.cuda.device(r.device):
        _build.check(lib.int8_probe_pack_int4(
            r.data_ptr(), out.data_ptr(), n, d, pw, int(trans),
            torch.cuda.current_stream(r.device).cuda_stream),
            "int8_probe_pack_int4")
    return out
