"""The port's command line against the JAX package's on the same VCF files:
``prepare-data``, ``build-index`` and ``query`` write the same files and
the same ``--save-results``, a database built by either package is queried
by the other, and the port's VCF readers give the JAX readers' arrays.

Genotype data: every distance is an exact float32 integer on both sides, so
ids and distances are equal, not close.
"""

import json
import os

import numpy as np
import pytest

from rag_snvbert_tpu.cli.main import main as jmain
from rag_snvbert_tpu.io import vcf as jvcf
from rag_snvbert_tpu.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.cli.main import main as tmain
from rag_snvbert_tpu_torch.io import vcf as tvcf


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A reference VCF with its panel and a target VCF that lacks a third
    of the reference sites and carries a few of its own."""
    b = make_bundle(n_train_samples=6, n_ref_samples=10, n_sites=96,
                    n_windows=2, seed=5)
    root = tmp_path_factory.mktemp("vcf")
    ref_vcf, tgt_vcf = str(root / "ref.vcf"), str(root / "tgt.vcf")
    jvcf.write_simple_vcf(ref_vcf, b.ref)
    keep = np.random.default_rng(1).random(b.train.n_variants) > 0.33
    keep[:3] = True
    tgt = b.train
    tgt = type(tgt)(gt=tgt.gt[keep], pos=tgt.pos[keep] + np.where(
        np.arange(keep.sum()) % 17 == 5, 1, 0), chrom=tgt.chrom[keep],
        ref=tgt.ref[keep], alt=tgt.alt[keep], ids=tgt.ids[keep],
        samples=tgt.samples)
    jvcf.write_simple_vcf(tgt_vcf, tgt)
    panel = str(root / "ref.panel")
    with open(panel, "w") as f:
        f.write("sample\tpop\n")
        for s, pop in zip(b.ref_panel.samples, b.ref_panel.pop_list):
            f.write(f"{s}\t{pop}\n")
    return dict(root=root, ref=ref_vcf, tgt=tgt_vcf, panel=panel)


def _build(main, files, out, dtype, mode="flat", port=False):
    argv = ["build-index", "--vcf", files["ref"], "--out", out,
            "--window-len", "40", "--panel", files["panel"], "--mode", mode,
            "--dtype", dtype]
    main(argv + (["--device", "cpu"] if port else []))


def _query(main, files, db, res, mode, extra=(), port=False, k=5):
    main(["query", "--vcf", files["tgt"], "--db", db, "--k", str(k),
          "--mode", mode, "--save-results", res, *extra]
         + (["--device", "cpu"] if port else []))


def _same_results(a, b, windows=3):
    for w in range(windows):
        for part in ("ids", "vals"):
            x = np.load(os.path.join(a, f"window_{w}_{part}.npy"))
            y = np.load(os.path.join(b, f"window_{w}_{part}.npy"))
            assert x.dtype == y.dtype, (w, part)
            np.testing.assert_array_equal(x, y, err_msg=f"{w} {part}")


@pytest.fixture(scope="module")
def dbs(files):
    """Databases of both packages in every storage (and intersect mode)."""
    out = {}
    for dtype in ("f32", "bf16", "int8", "packed"):
        for port, main in ((False, jmain), (True, tmain)):
            db = str(files["root"] / f"db_{dtype}_{'port' if port else 'jax'}")
            _build(main, files, db, dtype, port=port)
            out[dtype, port] = db
    for port, main in ((False, jmain), (True, tmain)):
        db = str(files["root"] / f"db_intersect_{port}")
        _build(main, files, db, "f32", mode="intersect", port=port)
        out["intersect", port] = db
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "packed",
                                   "intersect"])
def test_build_index_writes_the_jax_files(dbs, dtype):
    a, b = dbs[dtype, False], dbs[dtype, True]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in sorted(os.listdir(a)):
        if name == "meta.json":
            ma, mb = (json.load(open(os.path.join(d, name))) for d in (a, b))
            ma.pop("build_seconds"), mb.pop("build_seconds")
            assert ma == mb
        elif name.endswith(".npz"):
            za, zb = (np.load(os.path.join(d, name)) for d in (a, b))
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
        else:
            np.testing.assert_array_equal(
                np.load(os.path.join(a, name), allow_pickle=True),
                np.load(os.path.join(b, name), allow_pickle=True),
                err_msg=name)


QUERIES = [("f32", "flat", ()), ("bf16", "flat", ()), ("int8", "flat", ()),
           ("packed", "flat", ()), ("f32", "partial", ()),
           ("packed", "partial", ()), ("int8", "partial", ()),
           ("intersect", "intersect", ()),
           ("intersect", "intersect", ("--hamming",))]


@pytest.mark.parametrize("dtype,mode,extra", QUERIES,
                         ids=["-".join((d, m) + e) for d, m, e in QUERIES])
def test_query_saves_the_jax_results(dbs, files, dtype, mode, extra,
                                     capsys):
    root = files["root"]
    tag = "-".join((dtype, mode) + extra)
    res = {}
    for db_port in (False, True):
        for port, main in ((False, jmain), (True, tmain)):
            r = str(root / f"res_{tag}_{db_port}_{port}")
            _query(main, files, dbs[dtype, db_port], r, mode, extra, port)
            res[db_port, port] = r
    out = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(out[-1])
    assert stats["n_queries"] == 3 * 6 and stats["qps"] > 0
    # the port's results equal the JAX CLI's, on a database of either
    for db_port in (False, True):
        _same_results(res[db_port, False], res[db_port, True])
    _same_results(res[False, True], res[True, True])


def test_query_verbose_prints_the_jax_lines(dbs, files, capsys):
    lines = {}
    for port, main in ((False, jmain), (True, tmain)):
        main(["query", "--vcf", files["tgt"], "--db", dbs["packed", port],
              "--k", "3", "--verbose"] + (["--device", "cpu"] if port
                                          else []))
        got = capsys.readouterr().out.strip().splitlines()
        # timings differ; the rest of each line does not
        lines[port] = [l.split(" build ")[0] + l.split("s best")[-1]
                       if l.startswith("window") else l for l in got[:-1]]
    assert lines[True] == lines[False]
    assert any("pop POP" in l for l in lines[True])


def test_prepare_data_writes_the_jax_files(files):
    outs = {}
    for port, main in ((False, jmain), (True, tmain)):
        out = str(files["root"] / f"prep_{port}")
        main(["prepare-data", "--vcf", files["ref"], "--panel",
              files["panel"], "--out", out, "--window-len", "40",
              "--split-test-fraction", "0.2"])
        outs[port] = out
    names = sorted(os.listdir(outs[False]))
    assert names == sorted(os.listdir(outs[True]))
    for name in names:
        a, b = (os.path.join(outs[p], name) for p in (False, True))
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key])
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert open(a).read() == open(b).read(), name


def test_index_shards_names_its_roadmap_item(dbs, files):
    with pytest.raises(SystemExit, match="Queue A, item A7"):
        tmain(["query", "--vcf", files["tgt"], "--db", dbs["f32", True],
               "--index-shards", "2", "--device", "cpu"])


def test_cli_runs_on_the_card_unless_told_otherwise(files, monkeypatch,
                                                    tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["build-index", "--vcf", files["ref"], "--out",
               str(tmp_path / "db")])


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_read_vcf_matches_the_jax_reader(files, suffix, tmp_path):
    b = make_bundle(n_train_samples=3, n_ref_samples=4, n_sites=30,
                    n_windows=1, seed=2)
    path = str(tmp_path / f"x{suffix}")
    jvcf.write_simple_vcf(path, b.ref)
    j = jvcf.read_vcf(path, use_native=False)
    t = tvcf.read_vcf(path)
    for f in ("gt", "pos", "chrom", "ref", "alt", "ids"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    assert t.samples == j.samples
    meta = tvcf._read_vcf_metadata(path)
    np.testing.assert_array_equal(meta["pos"], j.pos)


def test_read_vcf_binarizes_like_the_jax_reader(tmp_path):
    """Haploid calls fill both slots, '.' is REF, any ALT index is 1,
    unphased '/' splits like '|', lines of fewer than 10 fields skip."""
    path = str(tmp_path / "odd.vcf")
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tA\tB\tC\n")
        f.write("1\t10\trs1\tA\tG,T\t.\tPASS\t.\tGT:DS\t0|2:1\t.|1\t1\n")
        f.write("1\t12\trs2\tC\tT\t.\tPASS\t.\tGT\t1/0\t./.\t0\n")
        f.write("1\t13\trs3\tC\tT\t.\tPASS\t.\tGT\n")
    j, t = jvcf.read_vcf(path, use_native=False), tvcf.read_vcf(path)
    np.testing.assert_array_equal(t.gt, j.gt)
    np.testing.assert_array_equal(t.pos, j.pos)
    assert t.gt.tolist() == [[[0, 1], [0, 1], [1, 1]],
                             [[1, 0], [0, 0], [0, 0]]]


def test_hdf5_cache_matches_the_jax_cache(tmp_path):
    pytest.importorskip("h5py")
    b = make_bundle(n_train_samples=3, n_ref_samples=4, n_sites=30,
                    n_windows=1, seed=4)
    path = str(tmp_path / "y.vcf")
    jvcf.write_simple_vcf(path, b.ref)
    h5 = tvcf.vcf_to_hdf5(path)
    assert h5 == str(tmp_path / "y.h5")
    j = jvcf.load_hdf5(h5)            # the JAX reader reads the port's file
    t = tvcf.load_vcf_or_hdf5(path)   # and the port reads it through the
    for f in ("gt", "pos", "chrom", "ref", "alt", "ids"):   # cache
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.samples == j.samples
    np.testing.assert_array_equal(t.gt, b.ref.gt)


def test_load_vcf_or_hdf5_without_a_cache_parses(tmp_path, monkeypatch):
    b = make_bundle(n_train_samples=3, n_ref_samples=4, n_sites=30,
                    n_windows=1, seed=6)
    path = str(tmp_path / "z.vcf.gz")
    jvcf.write_simple_vcf(path, b.ref)
    monkeypatch.setattr(tvcf, "h5py", None)
    t = tvcf.load_vcf_or_hdf5(path)
    assert not os.path.exists(str(tmp_path / "z.h5"))
    np.testing.assert_array_equal(t.gt, b.ref.gt)
    with pytest.raises(RuntimeError, match="h5py"):
        tvcf.vcf_to_hdf5(path)
