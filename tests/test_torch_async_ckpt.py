"""``TrainerConfig.async_checkpoints`` and ``Trainer.finalize`` (JAX
trainer.py:491-520, :547-550): an asynchronous save writes what a
synchronous one writes, even while training goes on changing the
parameters in place; ``finalize`` joins the writer; a failed write is
raised, never swallowed.  CPU, the smoke preset at seq_len 138."""

import os
import threading
import time

import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_modules import torch_one_thread  # noqa: F401

WAIT_S = 60.0        # bound on any wait in these tests


def _trainer(out, async_checkpoints, epochs=2, seed=0):
    b = make_bundle(n_train_samples=8, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=138)
    model = tconfig.build_model(tconfig.PRESETS["smoke"], b.vocab.size,
                                device="cpu", seed=seed)
    cfg = TrainerConfig(epochs=epochs, batch_size=6, val_batch_size=8,
                        warmup_steps=20, ref_pad_haps=32, log_freq=100,
                        output_dir=str(out), curriculum_every=1,
                        grad_accum_steps=2, keep_checkpoints=0,
                        async_checkpoints=async_checkpoints)
    return Trainer(model, ds, cfg, val_ds=ds)


def _restored(path, seed=5):
    t = _trainer(os.path.dirname(path) + "_restored", False, seed=seed)
    t.restore_checkpoint(path)
    return t


def _assert_same_state(a: Trainer, b: Trainer) -> None:
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["count"], sa["mini_step"]) == (sb["count"], sb["mini_step"])
    for key in ("mu", "nu", "acc"):
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert (a.step, a.start_epoch, a.level) == (b.step, b.start_epoch,
                                                b.level)


@pytest.fixture(scope="module")
def sync_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sync") / "run"
    t = _trainer(out, async_checkpoints=False)
    t.fit()
    return t, out


def test_async_checkpoints_restore_what_sync_ones_do(sync_run, tmp_path):
    sync, sync_out = sync_run
    t = _trainer(tmp_path / "run", async_checkpoints=True)
    t.fit()
    assert t._saver is None               # fit ends with finalize
    for p, q in zip(sync.model.parameters(), t.model.parameters()):
        assert torch.equal(p, q)
    for ep in (0, 1):
        _assert_same_state(_restored(str(sync_out / f"ckpt_ep{ep}")),
                           _restored(str(tmp_path / "run" / f"ckpt_ep{ep}")))
    assert os.path.realpath(tmp_path / "run" / "best").endswith(
        os.path.basename(os.path.realpath(sync_out / "best")))


def test_a_slow_writer_still_writes_the_epochs_state(sync_run, tmp_path,
                                                     monkeypatch):
    """The epoch-0 write is held until epoch 1 has applied an update (the
    parameters and moments it copied have changed in place since): the
    file still holds epoch 0's state, the synchronous run's."""
    sync, sync_out = sync_run
    t = _trainer(tmp_path / "run", async_checkpoints=True)
    save, overlapped = torch.save, []

    def slow_save(obj, f, *a, **kw):
        at = obj["step"]
        deadline = time.monotonic() + WAIT_S
        while (obj["epoch"] == 0 and t.optimizer.count * 2 <= at
               and time.monotonic() < deadline):
            time.sleep(0.01)
        overlapped.append((at, t.step, t.optimizer.count))
        return save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", slow_save)
    t.fit()
    monkeypatch.undo()
    # epoch 0 ends at micro-step 4, update 2; its write waited for update 3
    assert overlapped[0][0] == 4 and overlapped[0][2] >= 3, overlapped
    _assert_same_state(_restored(str(sync_out / "ckpt_ep0")),
                       _restored(str(tmp_path / "run" / "ckpt_ep0")))


def test_finalize_joins_the_writer(tmp_path, monkeypatch):
    t = _trainer(tmp_path / "run", async_checkpoints=True, epochs=1)
    save, release = torch.save, threading.Event()

    def held_save(obj, f, *a, **kw):
        release.wait(WAIT_S)
        return save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", held_save)
    t.save_checkpoint(0, is_best=True)
    saver = t._saver
    assert saver is not None and saver.is_alive()
    state = tmp_path / "run" / "ckpt_ep0" / "state.pt"
    assert not state.exists()
    release.set()
    t.finalize()
    assert t._saver is None and not saver.is_alive()
    assert state.exists() and os.path.islink(tmp_path / "run" / "best")
    t.finalize()                          # nothing in flight: a no-op


def test_a_failed_write_raises_at_finalize_and_at_the_next_save(
        tmp_path, monkeypatch):
    t = _trainer(tmp_path / "run", async_checkpoints=True, epochs=1)

    def failing_save(obj, f, *a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", failing_save)
    t.save_checkpoint(0, is_best=False)           # returns; the thread fails
    with pytest.raises(OSError, match="no space"):
        t.finalize()
    t.finalize()                                   # raised once
    t.save_checkpoint(0, is_best=False)
    with pytest.raises(OSError, match="no space"):
        t.save_checkpoint(1, is_best=False)
    with pytest.raises(OSError, match="no space"):
        t.fit()
