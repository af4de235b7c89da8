"""The port's ``Trainer(mesh=...)`` in gloo worlds of CPU ranks against its
single-process fit (dropout on): dp2 and dp2 x idx2 give the same loss
(relative 1e-3) and parameters (rtol 2e-3, atol 2e-4); a tp2 checkpoint
restores on one device and a one-device checkpoint under tp2, and the
continuations agree; a dp2 x idx2 x tp2 train step gives the JAX
package's ``train_step`` loss on a CPU mesh of the same shape, with the
same weights and batch (the multichip dry run's composition at its
shapes).  Mirrors tests/test_mesh_trainer.py and tests/test_tp.py:107-230.
"""

import os

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.interop import load_flax_params
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.parallel import tp
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh, shard_batch
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

LOSS_REL = 1e-3
P_RTOL, P_ATOL = 2e-3, 2e-4


def _trainer(mesh, out_dir, epochs=1, **kw):
    b = make_bundle(n_train_samples=8, n_ref_samples=12, n_sites=96,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=80)
    model = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=32, n_layers=1, attn_heads=4, seq_len=80)), b.vocab.size,
        device="cpu", seed=0)
    cfg = TrainerConfig(epochs=epochs, batch_size=8, val_batch_size=8,
                        warmup_steps=10, ref_pad_haps=32,
                        output_dir=str(out_dir), log_freq=1000,
                        prefetch_batches=0, **kw)
    return Trainer(model, ds, cfg, mesh=mesh)


def _params(trainer):
    full = tp.gather_full(trainer.model.state_dict(), trainer.mesh)
    return {k: v.numpy().copy() for k, v in full.items()}


def _fit_world(rank, shape, out_dir, merges):
    """One fit a merge (one mesh for all of them) on this rank."""
    mesh = make_mesh(*shape, device="cpu")
    out = []
    for merge in merges:
        t = _trainer(mesh, os.path.join(out_dir, f"{merge}{rank}"),
                     ctx_merge=merge)
        assert t.shard_ctx == (shape[1] > 1)
        out.append((t.fit()["history"][0]["train_loss"], _params(t)))
    return out


def _tp_ckpt_world(rank, out_dir):
    """tp2: resume a one-device checkpoint, train epoch 1, save."""
    t = _trainer(make_mesh(1, 1, 2, device="cpu"),
                 os.path.join(out_dir, "tp"), epochs=2)
    t.restore_checkpoint(os.path.join(out_dir, "single", "ckpt_ep0"))
    assert t.start_epoch == 1
    loss = t.fit()["history"][-1]["train_loss"]
    return loss, _params(t)


def _single(out_dir, epochs=1):
    t = _trainer(None, out_dir, epochs=epochs)
    loss = t.fit()["history"][-1]["train_loss"]
    return t, loss, _params(t)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return _single(tmp_path_factory.mktemp("single"))


def _assert_same_fit(got, want):
    loss, params = got
    _, wloss, wparams = want
    assert abs(loss - wloss) / max(abs(wloss), 1.0) < LOSS_REL
    for k, v in wparams.items():
        np.testing.assert_allclose(params[k], v, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("shape,merges", [
    ((2, 1, 1), ("all_gather",)), ((2, 2, 1), ("all_gather", "ring"))],
    ids=["dp2", "dp2xidx2"])
def test_mesh_fit_matches_single_device(single, tmp_path, shape, merges):
    runs = spawn(_fit_world, int(np.prod(shape)),
                 (shape, str(tmp_path), merges), threads=1)
    for rank_runs in runs:             # every rank holds the same result
        for r in rank_runs:
            _assert_same_fit(r, single)
    for merge in merges:               # rank 0 alone writes
        assert os.path.exists(tmp_path / f"{merge}0" / "metrics.csv")
        assert not os.path.exists(tmp_path / f"{merge}1" / "metrics.csv")


def test_tp_checkpoints_round_trip_to_and_from_one_device(tmp_path):
    """A one-device checkpoint restores under tp2 and the continuation
    equals the one-device continuation; the tp2 run's checkpoint holds
    full tensors and restores on one device."""
    one = _trainer(None, tmp_path / "single", epochs=1)
    one.fit()
    runs = spawn(_tp_ckpt_world, 2, (str(tmp_path),), threads=1)
    cont = _trainer(None, tmp_path / "cont", epochs=2)
    cont.restore_checkpoint(str(tmp_path / "single" / "ckpt_ep0"))
    want = (None, cont.fit()["history"][-1]["train_loss"], _params(cont))
    for r in runs:
        _assert_same_fit(r, want)
    back = _trainer(None, tmp_path / "back", epochs=3)
    back.restore_checkpoint(str(tmp_path / "tp" / "ckpt_ep1"))
    assert back.start_epoch == 2 and back.step == cont.step
    for k, v in _params(back).items():
        np.testing.assert_array_equal(v, runs[0][1][k], err_msg=k)
    for name, mu in back.optimizer.state_dict()["mu"].items():
        assert mu.shape == dict(back.model.named_parameters())[name].shape


# ---- dp2 x idx2 x tp2 against the JAX package's train step ----

DIMS, LAYERS, HEADS, SEQ, VOCAB, N_REFS, BATCH = 32, 2, 4, 64, 9, 32, 16


def _step_inputs():
    rng = np.random.default_rng(0)
    i = lambda n: rng.integers(0, n, (BATCH, SEQ)).astype(np.int64)  # noqa: E731
    f = lambda: rng.random((BATCH, SEQ), dtype=np.float32)  # noqa: E731
    batch = {"hap_1": i(VOCAB), "hap_2": i(VOCAB), "hap_1_label": i(2),
             "hap_2_label": i(2), "gt_label": i(4), "mask": i(2),
             "pos": f(), "af": f(), "af_p": f(), "ref": f(), "het": f(),
             "hom": f()}
    ctx = {"ref_tokens": rng.integers(5, 7, (N_REFS, SEQ)).astype(np.int64),
           "ref_af": rng.random(SEQ, dtype=np.float32),
           "wmask": rng.integers(0, 2, SEQ).astype(np.int64)}
    return batch, ctx


def _port_model(params):
    """The port model with every dropout at 0 (the RAG fusion's fixed 0.1
    included): the train step is then deterministic in both packages."""
    m = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=DIMS, n_layers=LAYERS, attn_heads=HEADS, seq_len=SEQ,
        dropout=0.0)), VOCAB, device="cpu")
    load_flax_params(m, params)
    m.bert.rag_fusion.drop.rate = 0.0
    return m


def _step(params, mesh=None):
    """One port train step (loss, gradient norm): on ``mesh``'s ranks with
    the sharded context, or in one process with the replicated one."""
    from rag_snvbert_tpu_torch.train.retrieval import encode_window_refs
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer
    from rag_snvbert_tpu_torch.train.sharded_retrieval import (
        encode_window_refs_sharded)
    from rag_snvbert_tpu_torch.train.step import (StepConfig, step_generator,
                                                  train_step)

    model = tp.shard_model(_port_model(params), mesh)
    opt = make_optimizer(model, warmup_steps=100)
    batch, c = _step_inputs()
    mine = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                       mesh)
    group = None
    if mesh is not None:
        opt.set_tensor_parallel(mesh.get_group("model"),
                                tp.sharded_flags(model))
        group = mesh.get_group("data")
    model.eval()
    args = (model.embed, torch.from_numpy(c["ref_tokens"]),
            torch.from_numpy(c["ref_af"]), torch.from_numpy(c["wmask"]))
    ctx = (encode_window_refs(*args, dtype=torch.float32) if mesh is None
           else encode_window_refs_sharded(*args, mesh, dtype=torch.float32))
    stats = train_step(model, opt, mine, ctx, StepConfig(use_kernel=False),
                       step_generator(0, 0, torch.device("cpu")),
                       data_group=group)
    return float(stats["loss"]), float(stats["grad_norm"])


def _step_world(rank, params):
    return _step(params, make_mesh(2, 2, 2, device="cpu"))


@pytest.fixture(scope="module")
def step_params():
    import jax

    from rag_snvbert_tpu.models import BERTFoundationModel, init_batch

    model = BERTFoundationModel(bert=_jax_no_dropout_bert())
    params = jax.jit(model.init)(jax.random.key(0),
                                 init_batch(1, SEQ, DIMS))["params"]
    return model, jax.tree.map(np.asarray, params)


def _jax_no_dropout_bert():
    from rag_snvbert_tpu.models import BERTWithEmbeddingRAG
    from rag_snvbert_tpu.models.bert import BERT
    from rag_snvbert_tpu.models.fusion import EnhancedRareVariantFusion

    class NoDropoutRAG(BERTWithEmbeddingRAG):
        def setup(self):
            BERT.setup(self)
            self.rag_fusion = EnhancedRareVariantFusion(
                self.dims, dtype=self.dtype, dropout=0.0)

    return NoDropoutRAG(vocab_size=VOCAB, dims=DIMS, n_layers=LAYERS,
                        attn_heads=HEADS, dropout=0.0)


def _jax_step_loss(model, params):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_snvbert_tpu.parallel.mesh import make_mesh as jax_mesh
    from rag_snvbert_tpu.parallel.tp import shard_tree
    from rag_snvbert_tpu.train.schedule import make_optimizer
    from rag_snvbert_tpu.train.sharded_retrieval import (
        encode_window_refs_sharded as jenc)
    from rag_snvbert_tpu.train.step import StepConfig, TrainState, train_step

    mesh = jax_mesh(n_data=2, n_index=2, n_model=2,
                    devices=jax.devices("cpu")[:8])

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return model.apply({"params": p}, toks, af, deterministic,
                           method=model.embed, rngs=rngs)

    batch, c = _step_inputs()
    state = TrainState.create(apply_fn=model.apply,
                              params=jax.tree.map(jnp.asarray, params),
                              tx=make_optimizer(warmup_steps=100))
    with jax.set_mesh(mesh):
        state = shard_tree(state, mesh)
        jb = {k: jax.device_put(v.astype(np.int32) if v.dtype == np.int64
                                else v, NamedSharding(mesh, P("data")))
              for k, v in batch.items()}
        ctx = jenc(embed_fn, state.params,
                   jnp.asarray(c["ref_tokens"], jnp.int32),
                   jnp.asarray(c["ref_af"]),
                   jnp.asarray(c["wmask"], jnp.int32), mesh,
                   dtype=jnp.float32)
        _, stats = train_step(state, jb, ctx, jax.random.key(1), embed_fn,
                              StepConfig(use_pallas=False), mesh=mesh)
        return float(stats["loss"]), float(stats["grad_norm"])


@pytest.fixture(scope="module")
def step_runs(step_params):
    _, params = step_params
    return spawn(_step_world, 8, (params,), threads=1), _step(params)


def test_dp_idx_tp_step_matches_single_process(step_runs):
    runs, (loss1, norm1) = step_runs
    for loss, norm in runs:
        assert abs(loss - loss1) / abs(loss1) < 1e-5
        assert abs(norm - norm1) / norm1 < 1e-4


def test_dp_idx_tp_step_matches_jax(step_params, step_runs):
    model, params = step_params
    jloss, jnorm = _jax_step_loss(model, params)
    for loss, norm in step_runs[0]:
        assert abs(loss - jloss) / abs(jloss) < LOSS_REL
        assert abs(norm - jnorm) / jnorm < LOSS_REL
