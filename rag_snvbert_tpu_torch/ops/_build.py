"""Build the package's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``_build/lib<name>-<hash>.so`` at first use (the hash is of the source and
of the shared headers ``csrc/*.cuh``, so an edited kernel is rebuilt), with
nvcc's report (``-Xptxas -v``: registers, spills) beside it as ``.log``.
``build`` starts one ``nvcc`` per source at once and waits for all of them.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("attention", "attention_bwd", "attention_f32", "layer_norm",
           "residual", "l2_topk", "l2_topk_rf", "l2_topk_float",
           "int8_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or in CUDA_HOME")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel that is not built yet, all at once.

    Returns ``{name: wall seconds}`` for the ones compiled here (their
    compiler reports: ``ptxas_log``); raises with nvcc's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def ptxas_log(name: str) -> str:
    """nvcc's report of the current build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def ptxas_entries(name: str) -> list[tuple[str, int, int, int]]:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of each
    kernel in the current build of ``csrc/<name>.cu``."""
    entries, spills = [], (0, 0)
    for line in ptxas_log(name).splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            kernel = _demangle(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif m := re.search(r"Used (\d+) registers", line):
            entries.append((kernel, int(m.group(1)), *spills))
    return entries


def _demangle(symbol: str) -> str:
    """``attention_fwd_kernel<128>`` from an Itanium-mangled kernel name
    (namespaces dropped; integer and bool template arguments kept, as in
    ``l2f_split_topk<0,64,2>``)."""
    if not symbol.startswith("_Z"):
        return symbol
    i, name = (3 if symbol.startswith("_ZN") else 2), symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    args = re.match(r"I((?:L[a-z]\d+E)+)E", symbol[i:])
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>"


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each C
    function (they return the CUDA error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")
