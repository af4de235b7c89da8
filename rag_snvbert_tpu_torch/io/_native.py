"""ctypes bindings for the port's native (C++) VCF reader and writer.

Port of rag_snvbert_tpu/io/_native.py over the port's own copy of the
source, ``native/vcf_reader.cpp``.  The shared library is built with
``g++ -O3 -shared -fPIC ... -lz`` at first use into ``_build/`` (named by
a hash of the source, so an edited source is rebuilt, and written through
a temporary file, so processes building at once never load half a file).
Host code, not a device kernel.

Every caller degrades to the pure-Python path when ``g++`` or zlib is
missing (``get_vcf_reader() -> None``), as the JAX package does.  The
native writer formats ``%.3f`` in fixed point and rounds half-ULP ties
half up, where Python's ``%.3f`` rounds them half to even: the two writers
can differ in the last digit of a float field at such ties, never in GT.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("rag_snvbert_tpu_torch")

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "vcf_reader.cpp"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libvcf_reader-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(SRC), "-lz", "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed to run: %s", e)
        return False
    if res.returncode != 0:
        log.warning("native build failed:\n%s", res.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_vcf_reader():
    """Load (building if needed) the native VCF library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None
        lib.vcf_scan.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.vcf_scan.restype = ctypes.c_int
        lib.vcf_parse_gt.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64]
        lib.vcf_parse_gt.restype = ctypes.c_int64
        lib.vcf_write_body.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong, ctypes.c_longlong]
        lib.vcf_write_body.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def native_read_gt(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Fast path: (gt [V,S,2] int8 binarized, pos [V] int64) or None."""
    lib = get_vcf_reader()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    ns = ctypes.c_int64()
    if lib.vcf_scan(str(path).encode(), ctypes.byref(nv),
                    ctypes.byref(ns)) != 0:
        return None
    n_variants, n_samples = nv.value, ns.value
    if n_variants < 0 or n_samples <= 0:
        return None
    gt = np.empty(n_variants * n_samples * 2, np.int8)
    pos = np.empty(n_variants, np.int64)
    got = lib.vcf_parse_gt(str(path).encode(), gt, pos, n_variants,
                           n_samples)
    if got != n_variants:
        log.warning("native parse returned %d of %d variants; falling back",
                    got, n_variants)
        return None
    return gt.reshape(n_variants, n_samples, 2), pos


def native_write_vcf_body(path: str, prefixes: bytes,
                          prefix_off: np.ndarray,
                          p1: np.ndarray, p2: np.ndarray) -> bool:
    """Append the per-sample GT:HDS:GP:DS body to an already-written
    header through the C++ writer.  Returns False (the caller falls back
    to the Python formatter) if the library is unavailable or fails."""
    lib = get_vcf_reader()
    if lib is None:
        return False
    n_v, n_s = p1.shape
    got = lib.vcf_write_body(
        str(path).encode(), 1 if str(path).endswith(".gz") else 0,
        prefixes, np.ascontiguousarray(prefix_off, np.int64),
        np.ascontiguousarray(p1, np.float32),
        np.ascontiguousarray(p2, np.float32), n_v, n_s)
    if got != n_v:
        log.warning("native VCF write returned %d of %d variants", got, n_v)
        return False
    return True
