"""Two-process multi-host input of the port: ``epoch_batches(host_id=,
n_hosts=2)`` + ``parallel.multihost.global_batch`` in a gloo world of two
processes (``tools/multihost_worker.py``), whose checksums (an
``all_reduce`` over the ranks' rows) agree with each other and with the
JAX package's single-process iteration of the same schedule (make_bundle
seed 23, batch 8).  Mirrors tests/test_multihost_smoke.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.io.synthetic import make_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_epoch_matches_jax_single_process(tmp_path):
    outs = [tmp_path / f"host{i}.json" for i in range(2)]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rag_snvbert_tpu_torch.tools.multihost_worker",
         str(i), "2", str(tmp_path / "rendezvous"), str(outs[i])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    rec0 = json.loads(outs[0].read_text())
    rec1 = json.loads(outs[1].read_text())
    assert rec0 == rec1          # both hold the global batch's checksums
    assert len(rec0) == 4        # 2 windows x ceil(12 samples / batch 8)

    from rag_snvbert_tpu.data.pipeline import WindowDataset as JaxDataset
    from rag_snvbert_tpu.io.synthetic import make_bundle as jax_bundle

    b = jax_bundle(n_train_samples=12, n_ref_samples=12, n_sites=96,
                   n_windows=2, seed=23)
    ds = JaxDataset(b.train, b.panel, b.freq, b.window.window_info,
                    b.vocab, ref_vcf=b.ref, seq_len=80)
    it = ds.epoch_batches(batch_size=8, epoch=0, level=2)
    for rec, (meta, batch) in zip(rec0, it):
        assert rec["window"] == int(meta.window_idx)
        assert sorted(rec["sums"]) == sorted(batch)
        for k, (s, ws) in rec["sums"].items():
            v = batch[k].astype(np.float64)
            w = 1.0 + np.arange(v.shape[0], dtype=np.float64)
            wv = v * w.reshape((-1,) + (1,) * (v.ndim - 1))
            np.testing.assert_allclose(
                [s, ws], [v.sum(), wv.sum()], rtol=2e-5,
                err_msg=f"window {rec['window']} key {k}")


@pytest.mark.parametrize("packed", [False, True])
def test_host_slices_stitch_into_the_single_host_batch(packed):
    """Every host's rows, stacked, are the single-host batch (packed wire
    format too); global padding rows are loss-masked on their host."""
    b = make_bundle(n_train_samples=12, n_ref_samples=12, n_sites=96,
                    n_windows=2, seed=23)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=80)
    one = list(ds.epoch_batches(8, 0, 2, packed=packed))
    hosts = [list(ds.epoch_batches(8, 0, 2, host_id=h, n_hosts=4,
                                   packed=packed)) for h in range(4)]
    assert all(len(h) == len(one) for h in hosts)
    window_level = {"pos", "af", "feat_rows"}
    for i, (meta, batch) in enumerate(one):
        for k, v in batch.items():
            parts = [h[i][1][k] for h in hosts]
            if packed and k in window_level:
                for p in parts:
                    np.testing.assert_array_equal(p, v)
                continue
            np.testing.assert_array_equal(np.concatenate(parts), v, k)
    with pytest.raises(ValueError, match="divide"):
        next(ds.epoch_batches(8, 0, 2, host_id=0, n_hosts=3))
