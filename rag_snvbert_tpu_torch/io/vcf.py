"""Host-side VCF reading: the genotype matrix of a VCF and its HDF5 cache.

Copy of the reading half of rag_snvbert_tpu/io/vcf.py (numpy only):
  - ``read_vcf``: phased biallelic GT matrix [n_variants, n_samples, 2]
    (binarized: any ALT allele -> 1), POS, CHROM, REF/ALT, IDs, samples;
  - ``vcf_to_hdf5`` / ``load_hdf5`` / ``load_vcf_or_hdf5``: the reference's
    HDF5 cache layout (``calldata/GT``, ``variants/POS`` plus site
    metadata), with ``h5py`` optional: without it ``.vcf`` input is parsed
    and not cached.
Parsing is pure Python.  The native C++ GT reader (``io/_native.py``) and
the VCF writers (``write_simple_vcf``, ``write_imputed_vcf``) are not
ported yet (ROADMAP Queue A 4).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


@dataclasses.dataclass
class VCFData:
    """In-memory biallelic phased genotype matrix + site metadata."""

    gt: np.ndarray       # [n_variants, n_samples, 2] int8, binarized 0/1
    pos: np.ndarray      # [n_variants] int64
    chrom: np.ndarray    # [n_variants] object (str)
    ref: np.ndarray      # [n_variants] object (str)
    alt: np.ndarray      # [n_variants] object (str)
    ids: np.ndarray      # [n_variants] object (str)
    samples: list[str]

    @property
    def n_variants(self) -> int:
        return self.gt.shape[0]

    @property
    def n_samples(self) -> int:
        return self.gt.shape[1]


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def read_vcf(path: str, use_native: bool = True) -> VCFData:
    """Parse a (optionally gzipped) VCF into a binarized GT matrix.

    Haploid calls are duplicated to both haplotype slots; missing calls
    ('.') become 0 (REF).  ``use_native`` is accepted for the JAX
    signature; the port parses in Python either way (its native reader is
    Queue A 4)."""
    chroms, poss, refs, alts, vids = [], [], [], [], []
    gt_rows: list[np.ndarray] = []
    samples: list[str] = []
    with _open_text(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\r\n").split("\t")[9:]
                continue
            fields = line.rstrip("\r\n").split("\t")
            if len(fields) < 10:
                continue
            chroms.append(fields[0])
            poss.append(int(fields[1]))
            vids.append(fields[2])
            refs.append(fields[3])
            alts.append(fields[4])
            # GT is the first colon-separated subfield of each sample column
            row = np.zeros((len(samples), 2), dtype=np.int8)
            for s, col in enumerate(fields[9:]):
                g = col.split(":", 1)[0]
                parts = g.split("|" if "|" in g else "/")
                a0 = 0 if parts[0] in (".", "0", "") else 1
                a1 = a0 if len(parts) < 2 else (
                    0 if parts[1] in (".", "0", "") else 1)
                row[s, 0] = a0
                row[s, 1] = a1
            gt_rows.append(row)
    gt = (np.stack(gt_rows) if gt_rows
          else np.zeros((0, len(samples), 2), np.int8))
    return VCFData(gt=gt, pos=np.asarray(poss, np.int64),
                   chrom=np.asarray(chroms, object),
                   ref=np.asarray(refs, object),
                   alt=np.asarray(alts, object),
                   ids=np.asarray(vids, object), samples=samples)


def _read_vcf_metadata(path: str) -> dict:
    """Light pass: header samples and the first columns' site metadata."""
    chroms, poss, refs, alts, vids = [], [], [], [], []
    samples: list[str] = []
    with _open_text(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\r\n").split("\t")[9:]
                continue
            fields = line.split("\t", 5)
            if len(fields) < 5:
                continue
            chroms.append(fields[0])
            poss.append(int(fields[1]))
            vids.append(fields[2])
            refs.append(fields[3])
            alts.append(fields[4])
    return {"chrom": np.asarray(chroms, object),
            "pos": np.asarray(poss, np.int64),
            "ref": np.asarray(refs, object),
            "alt": np.asarray(alts, object),
            "ids": np.asarray(vids, object), "samples": samples}


def _h5_base(vcf_path: str) -> str:
    base = str(vcf_path)
    for suf in (".vcf.gz", ".vcf"):
        if base.endswith(suf):
            return base[: -len(suf)]
    return base


def vcf_to_hdf5(vcf_path: str, h5_path: str | None = None) -> str:
    """Cache a VCF as HDF5 (``calldata/GT``, ``variants/POS``, CHROM, REF,
    ALT, ID and the samples); needs ``h5py``."""
    if h5py is None:
        raise RuntimeError("vcf_to_hdf5 needs h5py")
    if h5_path is None:
        h5_path = _h5_base(vcf_path) + ".h5"
    data = read_vcf(vcf_path)
    str_dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(h5_path, "w") as h5:
        h5.create_dataset("calldata/GT", data=data.gt, compression="gzip")
        h5.create_dataset("variants/POS", data=data.pos, compression="gzip")
        for name, col in (("CHROM", data.chrom), ("REF", data.ref),
                          ("ALT", data.alt), ("ID", data.ids)):
            h5.create_dataset(f"variants/{name}", data=col.astype(str_dt),
                              dtype=str_dt)
        h5.create_dataset("samples",
                          data=np.asarray(data.samples, object).astype(str_dt),
                          dtype=str_dt)
    return h5_path


def load_hdf5(h5_path: str) -> VCFData:
    """Read the HDF5 cache (the reference's layout; the metadata columns
    are optional); needs ``h5py``."""
    if h5py is None:
        raise RuntimeError("load_hdf5 needs h5py")

    def text(x):
        return x.decode() if isinstance(x, bytes) else x

    with h5py.File(h5_path, "r") as h5:
        def column(name, n):
            if name in h5:
                return np.asarray([text(x) for x in h5[name][:]], object)
            return np.asarray([""] * n, object)

        gt = np.where(h5["calldata/GT"][:] > 0, 1, 0).astype(np.int8)
        pos = h5["variants/POS"][:].astype(np.int64)
        n = gt.shape[0]
        samples = ([text(x) for x in h5["samples"][:]] if "samples" in h5
                   else [f"S{i}" for i in range(gt.shape[1])])
        return VCFData(gt=gt, pos=pos, chrom=column("variants/CHROM", n),
                       ref=column("variants/REF", n),
                       alt=column("variants/ALT", n),
                       ids=column("variants/ID", n), samples=samples)


def load_vcf_or_hdf5(path: str, cache: bool = True) -> VCFData:
    """The reference's load-with-cache pattern: a ``.h5`` is read; for a
    ``.vcf[.gz]`` the ``.h5`` beside it is read if it exists, else built
    first (with ``cache`` and ``h5py``), else the VCF is parsed."""
    p = str(path)
    if p.endswith(".h5"):
        return load_hdf5(p)
    h5_path = _h5_base(p) + ".h5"
    if os.path.exists(h5_path):
        return load_hdf5(h5_path)
    if cache and h5py is not None:
        vcf_to_hdf5(p, h5_path)
        return load_hdf5(h5_path)
    return read_vcf(p)
