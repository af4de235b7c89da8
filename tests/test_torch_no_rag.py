"""The no-RAG mode (ROADMAP A11) in training: the ``v10_baseline`` recipe
(``rag_mode="none"``, the reconstruction loss, focal gamma 5.0), cut to a
2-layer 32d model, one train step against the JAX package's on the same
perturbed flax weights, and ``Trainer.fit`` without a window context.
(The no-RAG imputer: ``tests/test_torch_serve_surface.py``.)
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu.train import step as jstep
from rag_snvbert_tpu.train.schedule import make_optimizer as jmake_optimizer
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                           load_optax_adam_state)
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.train import step as tstep
from rag_snvbert_tpu_torch.train.schedule import make_optimizer
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_modules import _perturb, torch_one_thread  # noqa: F401
from test_torch_train import SEQ_LEN, _datasets, _flat, _key, _to_flax


def _jax_cfg():
    c = jconfig.PRESETS["v10_baseline"]
    assert (c.model.rag_mode, c.use_recon_loss, c.focal_gamma) == \
        ("none", True, 5.0)
    # cut in width and depth for the CPU; dropout off (parity is
    # deterministic only)
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, dims=32, n_layers=2, attn_heads=4, dropout=0.0))


@functools.lru_cache(maxsize=None)
def _jax_params(vocab):
    m = _jax_cfg().model
    params = jax.jit(_jax_cfg().build_model(vocab).init)(
        jax.random.key(0), init_batch(1, SEQ_LEN, m.dims))
    return _perturb(params["params"])


@pytest.fixture(scope="module")
def case():
    jds, tds, vocab = _datasets()
    cfg = _jax_cfg()
    params = _jax_params(vocab)
    jm = cfg.build_model(vocab)
    batch = jds.make_batch(jds.windows[1], np.arange(4), level=2, seed=3,
                           pad_to=6, packed=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    scfg = jstep.StepConfig(focal_gamma=cfg.focal_gamma,
                            use_recon=cfg.use_recon_loss, use_pallas=False)

    @jax.jit
    def loss_and_grads(p):
        def f(p_):
            return jstep._forward(jm.apply, None, p_, jbatch, None, scfg,
                                  deterministic=True, dropout_rng=None)[0]
        return jax.value_and_grad(f)(p)

    loss, grads = loss_and_grads(params)
    state = jstep.TrainState.create(apply_fn=jm.apply, params=params,
                                    tx=jmake_optimizer(1e-3, 2e-3, 10))
    opt_state = jax.tree.map(np.asarray, state.opt_state)
    new_state = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)
    return dict(vocab=vocab, params=params, batch=batch, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                grad_norm=float(jstep.optax_global_norm(grads)),
                tx_state=opt_state,
                new_params=jax.tree.map(np.asarray, new_state.params))


def test_no_rag_train_step_matches_jax(case):
    c = case
    m = _jax_cfg().model
    tm = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(m))), c["vocab"], device="cpu")
    load_flax_params(tm, c["params"])
    assert type(tm.bert).__name__ == "BERT"
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    cfg = tstep.StepConfig(focal_gamma=5.0, use_recon=True, use_kernel=False)
    tm.train()
    loss, aux, _ = tstep._forward(tm, batch, None, cfg)
    assert {"hap_loss", "gt_loss"} <= set(aux)
    loss.backward()
    # float32 on both sides, other summation orders: the loss to 1e-5
    # relative; each parameter's gradient to 1e-4 relative L2, against the
    # larger of its own norm and 1e-4 of the whole gradient's (as in
    # tests/test_torch_train.py::test_train_step_matches_jax)
    np.testing.assert_allclose(loss.item(), c["loss"], rtol=1e-5)
    flat = _flat(c["grads"])
    named = dict(tm.named_parameters())
    assert sorted(map(_key, flat)) == sorted(named)
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in flat.values()))
    for path, g in flat.items():
        mine = _to_flax(path, named[_key(path)].grad)
        rel = np.linalg.norm(mine - g) / max(np.linalg.norm(g), 1e-4 * total)
        assert rel <= 1e-4, (_key(path), rel)

    # the whole step: loss, raw gradient norm, parameters after one update
    # (first Adam step: each element moves by ~lr, so the bound is lr)
    tm.zero_grad()
    opt = make_optimizer(tm, 1e-3, 2e-3, 10)
    load_optax_adam_state(opt, c["tx_state"])
    stats = tstep.train_step(tm, opt, batch, None, cfg)
    np.testing.assert_allclose(stats["loss"].item(), c["loss"], rtol=1e-5)
    np.testing.assert_allclose(stats["grad_norm"].item(), c["grad_norm"],
                               rtol=1e-4)
    assert opt.count == 1
    for path, new in _flat(c["new_params"]).items():
        np.testing.assert_allclose(_to_flax(path, named[_key(path)]), new,
                                   rtol=0, atol=1e-3, err_msg=_key(path))


def _trainer(tmp, seed=0):
    cfg = tconfig.PRESETS["v10_baseline"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dims=32, n_layers=2, attn_heads=4))
    b = make_bundle(n_train_samples=8, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=SEQ_LEN)
    model = tconfig.build_model(cfg, b.vocab.size, device="cpu", seed=seed)
    tc = TrainerConfig(epochs=2, batch_size=6, val_batch_size=8,
                       warmup_steps=20, rag_mode="none", log_freq=1,
                       focal_gamma=cfg.focal_gamma,
                       use_recon_loss=cfg.use_recon_loss, output_dir=str(tmp),
                       curriculum_every=1, patience=10)
    return Trainer(model, ds, tc, val_ds=ds)


def test_no_rag_trainer_fit_and_resume(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path / "run")

    def no_context(*a, **k):
        raise AssertionError("a no-RAG run built a window context")

    monkeypatch.setattr(trainer, "_window_ctx", no_context)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    hist = trainer.fit()["history"]
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               and 0 <= r["val_hap_f1"] <= 1 for r in hist)
    assert trainer.step == 2 * 2 * 2        # 2 epochs x 2 windows x 2
    assert not all(torch.equal(before[k], v)
                   for k, v in trainer.model.state_dict().items())
    fresh = _trainer(tmp_path / "other", seed=5)
    fresh.restore_checkpoint(str(tmp_path / "run" / "ckpt_ep1"))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert (fresh.start_epoch, fresh.step) == (2, trainer.step)
