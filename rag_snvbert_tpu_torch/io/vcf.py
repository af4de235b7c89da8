"""Host-side VCF I/O: the genotype matrix of a VCF, its HDF5 cache, and
the imputed-VCF writer.

Port of rag_snvbert_tpu/io/vcf.py (numpy only), the same files byte for
byte:
  - ``read_vcf``: phased biallelic GT matrix [n_variants, n_samples, 2]
    (binarized: any ALT allele -> 1), POS, CHROM, REF/ALT, IDs, samples;
    the GT matrix parses through the native C++ reader (``io/_native.py``)
    where it builds, else in Python;
  - ``vcf_to_hdf5`` / ``load_hdf5`` / ``load_vcf_or_hdf5``: the reference's
    HDF5 cache layout (``calldata/GT``, ``variants/POS`` plus site
    metadata), with ``h5py`` optional: without it ``.vcf`` input is parsed
    and not cached;
  - ``write_simple_vcf`` (GT only) and ``write_imputed_vcf`` (GT/HDS/GP/DS,
    the reference's generate_vcf_efficient_optimized,
    src/dataset/utils.py:378-479), plain or ``.gz``.  The sample fields of
    an imputed VCF are rendered by the native writer where it builds
    (it rounds half-ULP ``%.3f`` ties half up, Python half to even), else
    by the Python formatter.
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
    ('.') become 0 (REF).  With ``use_native`` the GT matrix comes from the
    native reader (``io/_native.py``) and the site metadata from a light
    pass over the first columns; where the library does not build, or the
    two passes disagree on the positions, the Python parser runs."""
    if use_native:
        from ._native import native_read_gt

        nat = native_read_gt(path)
        if nat is not None:
            gt, pos = nat
            meta = _read_vcf_metadata(path)
            if len(meta["pos"]) == len(pos) and (meta["pos"] == pos).all():
                return VCFData(gt=gt, pos=pos, chrom=meta["chrom"],
                               ref=meta["ref"], alt=meta["alt"],
                               ids=meta["ids"], samples=meta["samples"])
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


# --------------------------------------------------------------------------
# VCF writing (reference: generate_vcf_efficient_optimized,
# src/dataset/utils.py:378-479 — GT/HDS/GP/DS fields, chunked writes).
# --------------------------------------------------------------------------

def _opener(path: str):
    return gzip.open if str(path).endswith(".gz") else open


def write_simple_vcf(path: str, data: VCFData) -> None:
    """Write a plain GT-only VCF (the round-trip partner of ``read_vcf``).
    The per-sample GT fields come from a 9-entry lookup table indexed by
    both alleles (missing, -1, included), one vectorized gather a site."""
    lut = np.asarray([".|.", ".|0", ".|1", "0|.", "0|0", "0|1",
                      "1|.", "1|0", "1|1"], dtype=object)
    code = ((data.gt[:, :, 0].astype(np.int32) + 1) * 3
            + (data.gt[:, :, 1].astype(np.int32) + 1))
    with _opener(path)(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n##source=rag_snvbert_tpu\n"
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(data.samples) + "\n")
        for v in range(data.n_variants):
            cols = [str(data.chrom[v]), str(int(data.pos[v])),
                    str(data.ids[v]) or ".", str(data.ref[v]),
                    str(data.alt[v]), ".", "PASS", ".", "GT"]
            f.write("\t".join(cols) + "\t"
                    + "\t".join(lut[code[v]].tolist()) + "\n")


_HEADER = """##fileformat=VCFv4.2
##source=rag_snvbert_tpu
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=HDS,Number=2,Type=Float,Description="Estimated Haploid Alternate Allele Dosage">
##FORMAT=<ID=GP,Number=3,Type=Float,Description="Estimated Posterior Probabilities for Genotypes 0/0, 0/1 and 1/1">
##FORMAT=<ID=DS,Number=1,Type=Float,Description="Estimated Alternate Allele Dosage">
"""


def write_imputed_vcf(path: str, chrom, pos, ref, alt, samples,
                      hap1_prob: np.ndarray, hap2_prob: np.ndarray,
                      imputed_flag: np.ndarray | None = None,
                      chunk: int = 4096) -> None:
    """Write imputed genotypes with GT/HDS/GP/DS per sample.

    Args:
      hap{1,2}_prob: [n_variants, n_samples] P(allele==1) per haplotype.
      imputed_flag: optional [n_variants] bool: True rows get IMPUTED in
        INFO (the sites missing from the target).
    """
    from . import _native

    n_v, n_s = hap1_prob.shape
    chrom = np.broadcast_to(np.asarray(chrom, object), (n_v,))
    ref = np.broadcast_to(np.asarray(ref, object), (n_v,))
    alt = np.broadcast_to(np.asarray(alt, object), (n_v,))
    opener = _opener(path)
    with opener(path, "wt") as f:
        f.write(_HEADER)
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")

    # Native path: the per-variant prefix columns are formatted here, the
    # n_v x n_s sample fields by the C++ writer appended after the header.
    prefix_rows = []
    for v in range(n_v):
        info = "IMPUTED" if (imputed_flag is not None
                             and imputed_flag[v]) else "."
        prefix_rows.append(f"{chrom[v]}\t{int(pos[v])}\t.\t{ref[v]}\t"
                           f"{alt[v]}\t.\tPASS\t{info}\tGT:HDS:GP:DS")
    blob = "".join(prefix_rows).encode()
    off = np.zeros(n_v + 1, np.int64)
    np.cumsum([len(r.encode()) for r in prefix_rows], out=off[1:])
    header_size = os.path.getsize(path)
    if _native.native_write_vcf_body(str(path), blob, off,
                                     np.asarray(hap1_prob, np.float32),
                                     np.asarray(hap2_prob, np.float32)):
        return
    # The native writer may have flushed some rows before failing (an I/O
    # error mid-body): truncate back to the bare header so the Python
    # writer never appends a second body after partial native rows.  A
    # .gz header is a complete gzip member and the Python writer appends a
    # new one, so the truncation point is member-aligned.
    if os.path.getsize(path) != header_size:
        with open(path, "rb+") as raw:
            raw.truncate(header_size)

    with opener(path, "at") as f:
        for start in range(0, n_v, chunk):
            end = min(start + chunk, n_v)
            p1 = hap1_prob[start:end]
            p2 = hap2_prob[start:end]
            a1 = (p1 >= 0.5).astype(np.int8)
            a2 = (p2 >= 0.5).astype(np.int8)
            ds = p1 + p2
            gp00 = (1 - p1) * (1 - p2)
            gp11 = p1 * p2
            gp01 = 1.0 - gp00 - gp11
            lines = []
            for i in range(end - start):
                v = start + i
                info = "IMPUTED" if (imputed_flag is not None
                                     and imputed_flag[v]) else "."
                cols = [str(chrom[v]), str(int(pos[v])), ".", str(ref[v]),
                        str(alt[v]), ".", "PASS", info, "GT:HDS:GP:DS"]
                for s in range(n_s):
                    cols.append(
                        f"{a1[i, s]}|{a2[i, s]}:"
                        f"{p1[i, s]:.3f},{p2[i, s]:.3f}:"
                        f"{gp00[i, s]:.3f},{gp01[i, s]:.3f},{gp11[i, s]:.3f}:"
                        f"{ds[i, s]:.3f}")
                lines.append("\t".join(cols))
            f.write("\n".join(lines) + "\n")
