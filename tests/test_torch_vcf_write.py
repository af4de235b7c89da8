"""The port's VCF writers and native reader against the JAX package's.

Both packages write the same files, byte for byte, from the same numpy
arrays: native writer against native writer, Python writer against Python
writer (the two writers differ at half-ULP ``%.3f`` ties; see
``rag_snvbert_tpu_torch/io/_native.py``).  ``.gz`` files carry a header
timestamp, so they are compared decompressed.  Each package reads the
other's files.  Native tests skip where ``g++`` or zlib is missing, as
``tests/test_native_vcf.py`` does.
"""

import gzip
import pathlib
import shutil

import numpy as np
import pytest

from rag_snvbert_tpu.io import _native as jnative
from rag_snvbert_tpu.io import vcf as jvcf
from rag_snvbert_tpu.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.io import _native as tnative
from rag_snvbert_tpu_torch.io import vcf as tvcf

FIELDS = ("gt", "pos", "chrom", "ref", "alt", "ids")


@pytest.fixture
def native():
    """Skip unless both packages' native libraries build here."""
    if tnative.get_vcf_reader() is None or jnative.get_vcf_reader() is None:
        pytest.skip("native toolchain (g++, zlib) unavailable")


@pytest.fixture
def python_writers(monkeypatch):
    """Both packages' imputed-VCF bodies through the Python formatter."""
    monkeypatch.setattr(tnative, "native_write_vcf_body",
                        lambda *a, **k: False)
    monkeypatch.setattr(jnative, "native_write_vcf_body",
                        lambda *a, **k: False)


def _text(path) -> bytes:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _imputed_args(n_v=120, n_s=5, seed=4):
    rng = np.random.default_rng(seed)
    h1 = rng.random((n_v, n_s)).astype(np.float32)
    h2 = rng.random((n_v, n_s)).astype(np.float32)
    # exact 0/1 rows (known sites) and values next to the 0.5 GT threshold
    h1[:10] = (h1[:10] > 0.5).astype(np.float32)
    h2[10:12] = np.float32(0.5)
    h2[12:14] = np.nextafter(np.float32(0.5), np.float32(0))
    chrom = np.asarray(["21"] * n_v, object)
    pos = np.arange(1000, 1000 + 7 * n_v, 7, dtype=np.int64)
    ref = np.asarray(["A", "C", "G", "T"] * (n_v // 4), object)
    alt = np.asarray(["G", "T", "A", "C"] * (n_v // 4), object)
    samples = [f"S{i}" for i in range(n_s)]
    flag = rng.random(n_v) < 0.5
    return (chrom, pos, ref, alt, samples, h1, h2), flag


def _write_imputed_both(tmp_path, suffix, name="x"):
    args, flag = _imputed_args()
    jp = tmp_path / f"{name}_jax.vcf{suffix}"
    tp = tmp_path / f"{name}_port.vcf{suffix}"
    jvcf.write_imputed_vcf(str(jp), *args, imputed_flag=flag)
    tvcf.write_imputed_vcf(str(tp), *args, imputed_flag=flag)
    return jp, tp, args, flag


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_imputed_vcf_native_writers_byte_identical(native, tmp_path, suffix):
    jp, tp, _, _ = _write_imputed_both(tmp_path, suffix)
    assert _text(tp) == _text(jp)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_imputed_vcf_python_writers_byte_identical(python_writers, tmp_path,
                                                   suffix):
    jp, tp, _, _ = _write_imputed_both(tmp_path, suffix)
    assert _text(tp) == _text(jp)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_imputed_vcf_fields(tmp_path, suffix):
    """GT, INFO and the prefix columns exactly; HDS/GP/DS to the third
    decimal (half a unit of the third decimal, plus one float32 rounding of
    the formatter's v * 1000)."""
    _, tp, (chrom, pos, ref, alt, samples, h1, h2), flag = \
        _write_imputed_both(tmp_path, suffix)
    lines = _text(tp).decode().splitlines()
    assert lines[6] == "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                                  "FILTER", "INFO", "FORMAT", *samples])
    body = [line.split("\t") for line in lines[7:]]
    assert len(body) == len(pos)
    for v, cols in enumerate(body):
        assert cols[:9] == [chrom[v], str(pos[v]), ".", ref[v], alt[v], ".",
                            "PASS", "IMPUTED" if flag[v] else ".",
                            "GT:HDS:GP:DS"]
        for s, field in enumerate(cols[9:]):
            gt, hds, gp, ds = field.split(":")
            a, b = float(h1[v, s]), float(h2[v, s])
            assert gt == f"{int(a >= 0.5)}|{int(b >= 0.5)}"
            want = [a, b, (1 - a) * (1 - b), 1 - (1 - a) * (1 - b) - a * b,
                    a * b, a + b]
            got = [float(x) for x in f"{hds},{gp},{ds}".split(",")]
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 + 1e-6)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_simple_vcf_byte_identical(tmp_path, suffix):
    b = make_bundle(n_train_samples=7, n_ref_samples=3, n_sites=50,
                    n_windows=1, seed=9)
    data = b.train
    gt = data.gt.copy()
    gt[3, 2, 0] = gt[5, 0, 1] = -1          # missing alleles: '.'
    data.gt = gt
    jp, tp = tmp_path / f"j.vcf{suffix}", tmp_path / f"t.vcf{suffix}"
    jvcf.write_simple_vcf(str(jp), data)
    tvcf.write_simple_vcf(str(tp), data)
    assert _text(tp) == _text(jp)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_each_package_reads_the_others_files(tmp_path, suffix, use_native):
    b = make_bundle(n_train_samples=6, n_ref_samples=3, n_sites=60,
                    n_windows=1, seed=2)
    jp, tp = tmp_path / f"j.vcf{suffix}", tmp_path / f"t.vcf{suffix}"
    jvcf.write_simple_vcf(str(jp), b.train)
    tvcf.write_simple_vcf(str(tp), b.train)
    for path in (jp, tp):
        t = tvcf.read_vcf(str(path), use_native=use_native)
        j = jvcf.read_vcf(str(path), use_native=use_native)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert t.samples == j.samples == b.train.samples
        np.testing.assert_array_equal(t.gt, b.train.gt)
    # imputed files: GT is p >= 0.5 on each haplotype
    jp, tp, (_, pos, _, _, samples, h1, h2), _ = _write_imputed_both(
        tmp_path, suffix, name="imp")
    want = np.stack([h1 >= 0.5, h2 >= 0.5], -1).astype(np.int8)
    for path in (jp, tp):
        t = tvcf.read_vcf(str(path), use_native=use_native)
        j = jvcf.read_vcf(str(path), use_native=use_native)
        np.testing.assert_array_equal(t.gt, want)
        np.testing.assert_array_equal(j.gt, want)
        np.testing.assert_array_equal(t.pos, pos)
        assert t.samples == samples


@pytest.fixture(scope="module")
def cohort_vcf(tmp_path_factory):
    b = make_bundle(n_train_samples=30, n_ref_samples=1, n_sites=200, seed=7)
    p = tmp_path_factory.mktemp("vcf") / "cohort.vcf"
    jvcf.write_simple_vcf(str(p), b.train)
    return p


def _odd_vcf(path):
    """Missing calls, a haploid call, an extra FORMAT field, '/' phasing."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\n")
        f.write("21\t100\t.\tA\tG\t.\tPASS\t.\tGT\t.|1\t0\n")
        f.write("21\t200\t.\tA\tG\t.\tPASS\t.\tGT:DP\t1/1:3\t0|.\n")
    return path


@pytest.mark.parametrize("case", ["cohort", "gzip", "missing_haploid"])
def test_native_reader_matches_the_jax_reader(native, cohort_vcf, tmp_path,
                                              case):
    if case == "cohort":
        path = cohort_vcf
    elif case == "gzip":
        path = tmp_path / "cohort.vcf.gz"
        with open(cohort_vcf, "rb") as fi, gzip.open(path, "wb") as fo:
            shutil.copyfileobj(fi, fo)
    else:
        path = _odd_vcf(tmp_path / "odd.vcf")
    nat = tnative.native_read_gt(str(path))
    assert nat is not None
    t = tvcf.read_vcf(str(path), use_native=True)
    j = jvcf.read_vcf(str(path), use_native=False)
    np.testing.assert_array_equal(nat[0], j.gt)
    np.testing.assert_array_equal(nat[1], j.pos)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    assert t.samples == j.samples
    if case == "missing_haploid":
        assert t.gt.tolist() == [[[0, 1], [0, 0]], [[1, 1], [0, 0]]]


def test_native_reader_of_a_missing_file_is_none(native):
    assert tnative.native_read_gt("/does/not/exist.vcf") is None


def test_native_library_builds_into_the_ports_build_dir(native):
    import rag_snvbert_tpu_torch

    pkg = pathlib.Path(rag_snvbert_tpu_torch.__file__).resolve().parent
    path = tnative.library_path()
    assert path.exists() and path.parent == pkg / "_build"
    assert tnative.SRC == pkg / "native" / "vcf_reader.cpp"


def test_native_writer_differs_from_python_only_at_ties(native, tmp_path,
                                                         monkeypatch):
    """The port's two writers: the same GT and prefix columns, float fields
    at most one unit of the third decimal apart (a half-ULP tie)."""
    args, flag = _imputed_args(n_v=200, n_s=5, seed=11)
    nat, py = tmp_path / "nat.vcf", tmp_path / "py.vcf"
    tvcf.write_imputed_vcf(str(nat), *args, imputed_flag=flag)
    monkeypatch.setattr(tnative, "native_write_vcf_body",
                        lambda *a, **k: False)
    tvcf.write_imputed_vcf(str(py), *args, imputed_flag=flag)
    ln, lp = _text(nat).decode().splitlines(), _text(py).decode().splitlines()
    assert len(ln) == len(lp)
    for a, b in zip(ln, lp):
        if a == b:
            continue
        ca, cb = a.split("\t"), b.split("\t")
        assert ca[:9] == cb[:9]
        for fa, fb in zip(ca[9:], cb[9:]):
            assert fa.split(":")[0] == fb.split(":")[0]
            xs = [float(x) for x in fa.replace(":", ",").split(",")[1:]]
            ys = [float(x) for x in fb.replace(":", ",").split(",")[1:]]
            np.testing.assert_allclose(xs, ys, rtol=0, atol=1.1e-3)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_partial_native_write_is_truncated_to_the_header(
        tmp_path, monkeypatch, python_writers, suffix):
    """A native body write that flushes some rows and then fails: the file
    is cut back to its header and the Python writer writes the body once,
    giving the JAX package's Python-written file."""
    def partial_fail(path, prefixes, prefix_off, p1, p2):
        with open(path, "ab") as f:
            f.write(b"21\t1\t.\tA\tG\t.\tPASS\t.\tGT\t0|0\nGARBAGE-PART")
        return False

    monkeypatch.setattr(tnative, "native_write_vcf_body", partial_fail)
    jp, tp, (_, pos, _, _, samples, _, _), _ = _write_imputed_both(
        tmp_path, suffix)
    text = _text(tp)
    assert b"GARBAGE" not in text
    assert text == _text(jp)
    body = [line for line in text.decode().splitlines()
            if not line.startswith("#")]
    assert len(body) == len(pos)
    back = tvcf.read_vcf(str(tp), use_native=False)
    assert back.n_variants == len(pos) and back.samples == samples


def test_without_the_toolchain_python_reads_and_writes(tmp_path, monkeypatch):
    """No g++ or zlib: the library does not build, ``read_vcf`` and the
    writer take their Python paths and give the same arrays and text."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "none" / "libvcf_reader.so")
    monkeypatch.setattr(tnative.subprocess, "run", _no_compiler)
    assert tnative.get_vcf_reader() is None
    assert tnative.native_read_gt("x.vcf") is None
    b = make_bundle(n_train_samples=4, n_ref_samples=3, n_sites=40,
                    n_windows=1, seed=3)
    path = tmp_path / "c.vcf.gz"
    tvcf.write_simple_vcf(str(path), b.train)
    got = tvcf.read_vcf(str(path), use_native=True)
    np.testing.assert_array_equal(got.gt, b.train.gt)
    np.testing.assert_array_equal(got.pos, b.train.pos)
    args, flag = _imputed_args(n_v=40, n_s=3, seed=5)
    tp, jp = tmp_path / "t.vcf", tmp_path / "j.vcf"
    tvcf.write_imputed_vcf(str(tp), *args, imputed_flag=flag)
    monkeypatch.setattr(jnative, "native_write_vcf_body",
                        lambda *a, **k: False)
    jvcf.write_imputed_vcf(str(jp), *args, imputed_flag=flag)
    assert _text(tp) == _text(jp)


def _no_compiler(*a, **k):
    raise FileNotFoundError("g++")
