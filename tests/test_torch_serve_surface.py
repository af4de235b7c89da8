"""The port's serving surface against the JAX package's: ``handle`` and
``serve_lines`` with VCF in and out, ``BatchingImputationService`` (merged
requests exact against solo imputation, progressive requests, errors,
``close``), the HTTP front end, and the no-RAG imputer.

Same flax weights on both sides (``load_flax_params``), float32 models:
the frameworks differ only in summation order, so probabilities agree to
``TOL`` (as in ``tests/test_torch_serve.py``).  A VCF float field is
printed to three decimals, so two fields of values within ``TOL`` may
differ by one unit of the third decimal (``VCF_TOL``); GT is compared
where the probability is further than ``TOL`` from the 0.5 threshold.
"""

import dataclasses
import gzip
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest

from rag_snvbert_tpu.infer.imputer import Imputer as JImputer
from rag_snvbert_tpu.infer.serve import ImputationService as JService
from rag_snvbert_tpu.io.synthetic import make_bundle as jmake_bundle
from rag_snvbert_tpu.models import BERT as JBERT
from rag_snvbert_tpu.models import BERTFoundationModel as JFoundation
from rag_snvbert_tpu.models import BERTWithEmbeddingRAG as JRAG
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu_torch.infer.httpd import make_server
from rag_snvbert_tpu_torch.infer.imputer import ImputationResult, Imputer
from rag_snvbert_tpu_torch.infer.serve import (BatchingImputationService,
                                               ImputationService)
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.io.vcf import VCFData, write_simple_vcf
from rag_snvbert_tpu_torch.models import (BERT, BERTFoundationModel,
                                          BERTWithEmbeddingRAG)
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

DIMS, SEQ = 32, 64
KW = dict(window_len=SEQ - 10, seq_len=SEQ, ref_pad_haps=64, batch_size=8)
TOL = 1e-5
VCF_TOL = 1e-3 + TOL
BUNDLE = dict(n_train_samples=8, n_ref_samples=24, n_sites=120, n_windows=2,
              seed=3)


def _models(jcls, tcls):
    jb = jmake_bundle(**BUNDLE)
    jm = JFoundation(bert=jcls(vocab_size=jb.vocab.size, dims=DIMS,
                               n_layers=2, attn_heads=4))
    params = jax.jit(jm.init)(jax.random.key(0),
                              init_batch(1, SEQ, DIMS))["params"]

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    tm = BERTFoundationModel(tcls(jb.vocab.size, DIMS, n_layers=2,
                                  attn_heads=4))
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jb, jm, embed_fn, params, tm


@pytest.fixture(scope="module")
def setup():
    jb, jm, embed_fn, params, tm = _models(JRAG, BERTWithEmbeddingRAG)
    return dict(jb=jb, tb=make_bundle(**BUNDLE), jm=jm, embed_fn=embed_fn,
                params=params, tm=tm)


def _drop(vcf, keep):
    return dataclasses.replace(vcf, gt=vcf.gt[keep], pos=vcf.pos[keep],
                               chrom=vcf.chrom[keep], ref=vcf.ref[keep],
                               alt=vcf.alt[keep], ids=vcf.ids[keep])


def _samples(vcf, cols):
    return dataclasses.replace(vcf, gt=vcf.gt[:, cols],
                               samples=list(np.asarray(vcf.samples)[cols]))


def _service(s, cls=ImputationService, **kw):
    return cls.create(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                      **KW, **kw)


def _parse_vcf(path):
    """(prefix columns, GT strings [V, S], floats [V, S, 6])."""
    prefix, gts, nums = [], [], []
    for line in open(path).read().splitlines():
        if line.startswith("#"):
            continue
        cols = line.split("\t")
        prefix.append(cols[:9])
        fields = [c.split(":") for c in cols[9:]]
        gts.append([f[0] for f in fields])
        nums.append([[float(x) for x in ",".join(f[1:]).split(",")]
                     for f in fields])
    return prefix, np.asarray(gts), np.asarray(nums)


def assert_vcfs_match(path_a, path_b, hap1, hap2):
    """Two imputed VCFs of probabilities within ``TOL``: equal prefix
    columns, floats within ``VCF_TOL``, GT equal away from the threshold."""
    pa, ga, na = _parse_vcf(path_a)
    pb, gb, nb = _parse_vcf(path_b)
    assert pa == pb
    np.testing.assert_allclose(na, nb, rtol=0, atol=VCF_TOL)
    clear = (np.abs(hap1 - 0.5) > TOL) & (np.abs(hap2 - 0.5) > TOL)
    np.testing.assert_array_equal(ga[clear], gb[clear])


def test_handle_and_serve_lines_match_jax(setup, tmp_path):
    s = setup
    keep = np.random.default_rng(9).random(s["tb"].train.n_variants) > 0.4
    tgt = str(tmp_path / "target.vcf")
    write_simple_vcf(tgt, _drop(s["tb"].train, keep))
    jsvc = JService.create(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                           s["jb"].freq, use_pallas=False, **KW)
    tsvc = _service(s)
    resps = {}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        reqs = "\n".join(json.dumps(r) for r in (
            {"target": tgt, "output_vcf": str(tmp_path / f"{name}1.vcf"),
             "npy_prefix": str(tmp_path / f"{name}1")},
            {"target": "/nonexistent.vcf",
             "output_vcf": str(tmp_path / f"{name}x.vcf")},
            {"target": tgt, "output_vcf": str(tmp_path / f"{name}2.vcf.gz"),
             "npy_prefix": str(tmp_path / f"{name}2"),
             "progressive_rounds": 2})) + "\n\n" + json.dumps(
                 {"target": tgt}) + "\n"       # after the blank line: unread
        out = io.StringIO()
        assert svc.serve_lines(io.StringIO(reqs), out) == 3
        resps[name] = [json.loads(line) for line in
                       out.getvalue().splitlines()]
    for r in resps.values():
        assert [x["ok"] for x in r] == [True, False, True]
        assert r[1]["error"].startswith("FileNotFoundError")
    for rj, rt in zip(resps["jax"], resps["port"]):
        assert rt.keys() == rj.keys()
        assert {k: v for k, v in rt.items() if k != "seconds"} == \
            {k: v for k, v in rj.items() if k != "seconds"}
    assert resps["port"][0]["sites"] == s["tb"].ref.n_variants
    for i in (1, 2):
        arrays = {}
        for name in ("jax", "port"):
            arrays[name] = {f: np.load(tmp_path / f"{name}{i}.{f}.npy")
                            for f in ("HAP1", "HAP2", "GT", "POS",
                                      "POS_Flag")}
        for f in ("HAP1", "HAP2", "GT"):
            np.testing.assert_allclose(arrays["port"][f], arrays["jax"][f],
                                       rtol=TOL, atol=TOL, err_msg=f)
        for f in ("POS", "POS_Flag"):
            np.testing.assert_array_equal(arrays["port"][f],
                                          arrays["jax"][f])
        if i == 2:                     # .gz: compared decompressed
            for name in ("jax", "port"):
                with gzip.open(tmp_path / f"{name}2.vcf.gz", "rb") as f:
                    (tmp_path / f"{name}2.vcf").write_bytes(f.read())
        assert_vcfs_match(tmp_path / f"port{i}.vcf", tmp_path / f"jax{i}.vcf",
                          arrays["jax"]["HAP1"], arrays["jax"]["HAP2"])


def test_batching_service_merges_and_is_exact(setup):
    """Concurrent same-pattern requests merge along the sample axis into
    shared batches, with results identical to solo imputation, while a
    request of another pattern runs on its own."""
    s = setup
    rng = np.random.default_rng(21)
    keep_a = rng.random(s["tb"].train.n_variants) > 0.4
    keep_b = rng.random(s["tb"].train.n_variants) > 0.6
    base = _drop(s["tb"].train, keep_a)
    parts = [_samples(base, c) for c in (slice(0, 3), slice(3, 6),
                                         slice(6, 8))]
    other = _drop(s["tb"].train, keep_b)
    svc = _service(s, BatchingImputationService)
    svc.max_wait_ms = 2000.0       # a deterministic merge in the test
    results, errs = {}, []

    def run(name, tgt):
        try:
            results[name] = svc.handle_target(tgt)
        except Exception as e:   # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(f"p{i}", t))
               for i, t in enumerate(parts)]
    threads.append(threading.Thread(target=run, args=("other", other)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(results) == 4
    for name, tgt in (("p0", parts[0]), ("p1", parts[1]), ("p2", parts[2]),
                      ("other", other)):
        solo = svc.imputer.impute(tgt)
        for f in ("hap1_prob", "hap2_prob", "gt_prob", "imputed_flag"):
            np.testing.assert_array_equal(getattr(results[name], f),
                                          getattr(solo, f), f"{name} {f}")
    for i, part in enumerate(parts):
        r = results[f"p{i}"]
        assert r.hap1_prob.shape == (s["tb"].ref.n_variants, part.n_samples)
        assert (r.imputed_flag == ~keep_a).all()
    assert svc.stats["merged_requests"] >= 2
    assert svc.stats["impute_calls"] < 4
    svc.close()
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.handle_target(parts[0])
    svc.close()                    # idempotent


def test_batching_service_progressive_and_errors(setup):
    """Progressive requests queue unmerged; a request's error reaches its
    caller and the service stays up."""
    s = setup
    keep = np.random.default_rng(23).random(s["tb"].train.n_variants) > 0.5
    target = _drop(s["tb"].train, keep)
    with _service(s, BatchingImputationService) as svc:
        res = svc.handle_target(target, rounds=2)
        assert (res.imputed_flag == ~keep).all()
        solo = svc.imputer.impute_progressive(target, rounds=2)
        np.testing.assert_array_equal(res.hap1_prob, solo.hap1_prob)
        with pytest.raises(FileNotFoundError):
            svc.handle({"target": "/nonexistent.vcf"})
        assert svc.handle_target(target).hap1_prob.shape == res.hap1_prob.shape
    assert not svc._thread.is_alive()


def test_batching_service_error_reaches_every_waiter(setup, monkeypatch):
    s = setup
    base = _drop(s["tb"].train,
                 np.random.default_rng(5).random(s["tb"].train.n_variants)
                 > 0.5)
    parts = [_samples(base, c) for c in (slice(0, 4), slice(4, 8))]
    svc = _service(s, BatchingImputationService)
    svc.max_wait_ms = 2000.0
    real = svc.imputer.impute

    def failing(target, pop=None):
        if target.n_samples > 4:       # only the merged call fails
            raise ValueError("merged call failed")
        return real(target, pop)

    monkeypatch.setattr(svc.imputer, "impute", failing)
    errs = []

    def run(tgt):
        try:
            svc.handle_target(tgt)
        except ValueError as e:
            errs.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in parts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert len(errs) == 2 and svc.stats["impute_calls"] == 1
    # the scheduler keeps serving after the failed group
    svc.max_wait_ms = 0.0
    assert svc.handle_target(parts[0]).hap1_prob.shape[1] == 4
    svc.close()


def test_batching_service_degenerate_targets(setup):
    """An empty target and an all-present one through the scheduler
    thread (tests/test_serve_fuzz.py's degenerate requests)."""
    s = setup
    empty = dataclasses.replace(
        s["tb"].train, gt=s["tb"].train.gt[:0], pos=s["tb"].train.pos[:0],
        chrom=s["tb"].train.chrom[:0], ref=s["tb"].train.ref[:0],
        alt=s["tb"].train.alt[:0], ids=s["tb"].train.ids[:0])
    with _service(s, BatchingImputationService) as svc:
        res = svc.handle_target(empty)
        assert res.imputed_flag.all()
        assert ((res.hap1_prob >= 0) & (res.hap1_prob <= 1)).all()
        res = svc.handle_target(s["tb"].ref)      # every site present
        assert not res.imputed_flag.any()
    assert not svc._thread.is_alive()


class _EchoImputer:
    """Answers each sample with its own number: a result column names the
    sample it belongs to."""

    def __init__(self):
        self.calls = 0

    def impute(self, target, pop=None):
        self.calls += 1
        ids = np.asarray([int(x[1:]) for x in target.samples], np.float32)
        col = np.broadcast_to(ids, (len(target.pos), len(ids))).copy()
        return ImputationResult(
            hap1_prob=col, hap2_prob=col + 0.5,
            gt_prob=np.repeat(col[..., None], 4, -1), pos=target.pos.copy(),
            imputed_flag=np.zeros(len(target.pos), bool))

    def impute_progressive(self, target, rounds):
        return self.impute(target)


def test_batching_service_under_thread_stress():
    """Thirty-two requesting threads (more than the cores), two site
    patterns and some progressive requests, with a 10 us switch interval:
    every request gets exactly its own samples back, and the scheduler's
    counters match the calls made."""
    import sys

    patterns = [np.arange(0, 40, 2, dtype=np.int64),
                np.arange(1, 41, 2, dtype=np.int64)]
    svc = BatchingImputationService(imputer=_EchoImputer(), ref_vcf=None)
    results, errs = {}, []

    def run(k):
        n = 1 + k % 3
        pos = patterns[k % 2]
        tgt = VCFData(gt=np.zeros((len(pos), n, 2), np.int8), pos=pos,
                      chrom=np.asarray(["1"] * len(pos), object),
                      ref=np.asarray(["A"] * len(pos), object),
                      alt=np.asarray(["G"] * len(pos), object),
                      ids=np.asarray(["."] * len(pos), object),
                      samples=[f"S{100 * k + j}" for j in range(n)])
        try:
            res = svc.handle_target(tgt, rounds=2 if k % 7 == 0 else 1)
            results[k] = (tgt, res)
        except Exception as e:   # surfaced below
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(results) == 32
    for tgt, res in results.values():
        want = np.asarray([int(x[1:]) for x in tgt.samples], np.float32)
        assert res.hap1_prob.shape == (len(tgt.pos), len(want))
        np.testing.assert_array_equal(res.hap1_prob, np.broadcast_to(
            want, res.hap1_prob.shape))
        np.testing.assert_array_equal(res.hap2_prob, res.hap1_prob + 0.5)
        np.testing.assert_array_equal(res.pos, tgt.pos)
    assert svc.stats["impute_calls"] == svc.imputer.calls
    assert svc.stats["merged_requests"] <= 32


def _http(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def rt(method, path, body=None, raw=None):
        conn.request(method, path, body=raw if raw is not None else (
            json.dumps(body) if body is not None else None))
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    return rt


@pytest.mark.parametrize("batching", [False, True])
def test_http_front_end(setup, tmp_path, batching):
    """/health and /impute through a live localhost server; bad requests
    get in-band errors and the server survives them."""
    s = setup
    keep = np.random.default_rng(11).random(s["tb"].train.n_variants) > 0.4
    tgt = str(tmp_path / "target.vcf")
    write_simple_vcf(tgt, _drop(s["tb"].train, keep))
    svc = _service(s, BatchingImputationService if batching
                   else ImputationService)
    server = make_server(svc)                 # port 0: an ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        rt = _http(server.server_address[1])
        status, health = rt("GET", "/health")
        assert status == 200 and health["ok"] and health["requests"] == 0
        assert health["ref_sites"] == s["tb"].ref.n_variants
        out = tmp_path / "http_out.vcf"
        status, resp = rt("POST", "/impute",
                          {"target": tgt, "output_vcf": str(out)})
        assert status == 200 and resp["ok"]
        assert resp["sites"] == s["tb"].ref.n_variants
        assert resp["imputed_sites"] == int((~keep).sum())
        assert out.exists()
        status, resp = rt("POST", "/impute", {"target": "/nonexistent.vcf"})
        assert status == 422 and not resp["ok"] and "error" in resp
        status, resp = rt("POST", "/impute", raw=b"{not json")
        assert status == 400 and not resp["ok"]
        assert rt("POST", "/nope")[0] == 404
        assert rt("GET", "/nope")[0] == 404
        status, health = rt("GET", "/health")
        assert status == 200 and health["requests"] == 2
    finally:
        server.shutdown()
        server.server_close()
        if batching:
            svc.close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_http_concurrent_requests_merge(setup, tmp_path):
    """Three same-pattern requests posted at once through
    ``BatchingImputationService``: merged, and their files equal those of
    the same requests posted one at a time."""
    s = setup
    keep = np.random.default_rng(13).random(s["tb"].train.n_variants) > 0.5
    base = _drop(s["tb"].train, keep)
    paths = []
    for i, cols in enumerate((slice(0, 3), slice(3, 6), slice(6, 8))):
        paths.append(str(tmp_path / f"part{i}.vcf"))
        write_simple_vcf(paths[-1], _samples(base, cols))
    svc = _service(s, BatchingImputationService)
    svc.max_wait_ms = 2000.0
    server = make_server(svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        codes = {}

        def post(i, tag):
            codes[i, tag] = _http(port)("POST", "/impute", {
                "target": paths[i],
                "npy_prefix": str(tmp_path / f"{tag}{i}")})[0]

        threads = [threading.Thread(target=post, args=(i, "merged"))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        merged = svc.stats["merged_requests"]
        svc.max_wait_ms = 0.0          # alone: no partner to wait for
        for i in range(3):
            post(i, "solo")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    assert set(codes.values()) == {200} and len(codes) == 6
    assert merged >= 2
    for i in range(3):
        for f in ("HAP1", "HAP2", "GT"):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"merged{i}.{f}.npy"),
                np.load(tmp_path / f"solo{i}.{f}.npy"))


def test_batching_service_counts_waits_linger_and_padding(setup):
    """Two requests of one pattern (3 and 2 samples) merge while the
    scheduler lingers; one of another pattern (4 samples), enqueued last,
    ends that linger, then lingers the whole ``max_wait_ms`` alone for a
    partner and runs alone.  The counters: two imputations, two requests
    merged, the lone request's full linger inside both the lingers and
    its queue wait, and the batch rows beyond the samples at batch 8: 3
    and 4 a window.  ``/health`` returns them."""
    import time

    s = setup
    rng = np.random.default_rng(31)
    base = _drop(s["tb"].train, rng.random(s["tb"].train.n_variants) > 0.4)
    other = _samples(_drop(s["tb"].train,
                           rng.random(s["tb"].train.n_variants) > 0.6),
                     slice(4, 8))
    parts = [_samples(base, slice(0, 3)), _samples(base, slice(3, 5))]
    svc = _service(s, BatchingImputationService)
    svc.max_wait_ms = 2000.0
    server = make_server(svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    threads = [threading.Thread(target=svc.handle_target, args=(t,))
               for t in (*parts, other)]
    try:
        for t in threads:            # enqueued in this order
            t.start()
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        status, health = _http(server.server_address[1])("GET", "/health")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    stats = svc.stats
    assert status == 200 and health["stats"] == stats
    n_win = len(svc.imputer.windows)
    assert stats["impute_calls"] == 2 and stats["merged_requests"] == 2
    assert stats["rows_padded"] == n_win * (3 + 4)
    alone = 0.95 * svc.max_wait_ms / 1e3
    assert stats["linger_s"] > alone
    assert stats["queue_wait_max_s"] > alone
    assert stats["queue_wait_s"] > stats["queue_wait_max_s"]


def test_no_rag_imputer_matches_jax():
    """rag_mode="none": no window context, the plain BERT forward."""
    jb, jm, embed_fn, params, tm = _models(JBERT, BERT)
    tb = make_bundle(**BUNDLE)
    keep = np.random.default_rng(2).random(tb.train.n_variants) > 0.4
    jres = JImputer(jm, embed_fn, params, jb.ref, jb.freq, use_pallas=False,
                    rag_mode="none", **KW).impute(_drop(jb.train, keep))
    imp = Imputer(tm, tb.ref, tb.freq, device="cpu", rag_mode="none", **KW)
    assert imp._window_ctx(0, 10, np.zeros(10, bool)) is None
    tres = imp.impute(_drop(tb.train, keep))
    for f in ("hap1_prob", "hap2_prob", "gt_prob"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(tres.imputed_flag, jres.imputed_flag)
    svc = ImputationService(imputer=imp, ref_vcf=tb.ref)
    res = svc.handle_target(_drop(tb.train, keep), rounds=2)
    assert (res.imputed_flag == ~keep).all()
    with pytest.raises(ValueError, match="rag_mode"):
        Imputer(tm, tb.ref, tb.freq, device="cpu", rag_mode="tokens", **KW)
