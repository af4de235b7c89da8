"""The port's training slice against the JAX package on the CPU: masks and
packed batches, losses and metric counters, the LR schedule, one train step
(loss, retrieved ids, gradients), the optimizer (one Adam update and one
accumulate-and-update pair with a clip that binds) from the same state as
optax, and a torch-only ``Trainer.fit`` with checkpoint, GC and an exact
resume.  Inputs come from numpy with fixed seeds; every tolerance is
stated where it is used."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.data import masking as jmasking
from rag_snvbert_tpu.data.pipeline import WindowDataset as JWindowDataset
from rag_snvbert_tpu.io.synthetic import make_bundle as jmake_bundle
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu.train import losses as jlosses
from rag_snvbert_tpu.train import metrics as jmetrics
from rag_snvbert_tpu.train import retrieval as jretrieval
from rag_snvbert_tpu.train import step as jstep
from rag_snvbert_tpu.train.schedule import make_optimizer as jmake_optimizer
from rag_snvbert_tpu.train.schedule import warmup_inverse_sqrt as jschedule
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data import masking as tmasking
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                           load_optax_adam_state)
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.train import losses as tlosses
from rag_snvbert_tpu_torch.train import metrics as tmetrics
from rag_snvbert_tpu_torch.train import retrieval as tretrieval
from rag_snvbert_tpu_torch.train import step as tstep
from rag_snvbert_tpu_torch.train.schedule import make_optimizer
from rag_snvbert_tpu_torch.train.schedule import warmup_inverse_sqrt
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_modules import _perturb, torch_one_thread  # noqa: F401

SEQ_LEN, N_PAD = 138, 32
BUNDLE = dict(n_train_samples=10, n_ref_samples=12, n_sites=256,
              n_windows=2, seed=7)


def _datasets():
    jb, tb = jmake_bundle(**BUNDLE), make_bundle(**BUNDLE)
    jds = JWindowDataset(jb.train, jb.panel, jb.freq, jb.window.window_info,
                         jb.vocab, ref_vcf=jb.ref, seq_len=SEQ_LEN)
    tds = WindowDataset(tb.train, tb.panel, tb.freq, tb.window.window_info,
                        tb.vocab, ref_vcf=tb.ref, seq_len=SEQ_LEN)
    return jds, tds, tb.vocab.size


# ---- data ----

@pytest.mark.parametrize("level", [0, 3, 0.55])
def test_masks_are_bit_identical(level):
    af = np.random.default_rng(0).random(300).astype(np.float32) * 0.2
    np.testing.assert_array_equal(
        tmasking.af_guided_mask(af, level, 5, 3),
        jmasking.af_guided_mask(af, level, 5, 3))
    np.testing.assert_array_equal(tmasking.span_mask(300, 0.3, 5, 3),
                                  jmasking.span_mask(300, 0.3, 5, 3))
    for sched in ("cosine", "linear", "exponential"):
        assert tmasking.adaptive_mask_ratio(3, 9, schedule=sched) == \
            jmasking.adaptive_mask_ratio(3, 9, schedule=sched)


@pytest.mark.parametrize("packed", [False, True])
def test_window_batches_are_bit_identical(packed):
    jds, tds, _ = _datasets()
    jit = jds.epoch_batches(4, 1, 2, shuffle=True, seed=3, packed=packed)
    tit = tds.epoch_batches(4, 1, 2, shuffle=True, seed=3, packed=packed)
    n = 0
    for (jm, jb), (tm, tb) in zip(jit, tit, strict=True):
        assert jm.window_idx == tm.window_idx
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
        n += 1
    assert n == 2 * 3        # 2 windows x ceil(10 / 4) batches
    meta_j, meta_t = jds.windows[1], tds.windows[1]
    np.testing.assert_array_equal(jds.window_mask(meta_j, 4, 2024),
                                  tds.window_mask(meta_t, 4, 2024))
    for a, b in zip(jds.window_ref_tokens(meta_j, pad_haps_to=N_PAD),
                    tds.window_ref_tokens(meta_t, pad_haps_to=N_PAD)):
        np.testing.assert_array_equal(a, b)


def test_multi_host_input_raises():
    _, tds, _ = _datasets()
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        next(tds.epoch_batches(4, 0, 0, n_hosts=2))


# ---- losses, metrics, schedule ----

def _outputs(rng, b=3, length=11, d=8):
    return [rng.standard_normal((b, length, c)).astype(np.float32)
            for c in (2, 2, 4, d, d, d, d)]


@pytest.mark.parametrize("use_recon", [False, True])
def test_losses_match_jax(use_recon):
    rng = np.random.default_rng(1)
    outs = _outputs(rng)
    if use_recon:      # make the recon term large enough for the gate
        outs[5] = outs[3] + 1.0
    labels = {"hap_1": rng.integers(0, 2, (3, 11)),
              "hap_2": rng.integers(0, 2, (3, 11)),
              "gt": rng.integers(0, 4, (3, 11))}
    mask = rng.integers(0, 2, (3, 11))
    jt, jaux = jlosses.total_loss([jnp.asarray(o) for o in outs],
                                  {k: jnp.asarray(v) for k, v in
                                   labels.items()},
                                  jnp.asarray(mask), 2.5, use_recon)
    tt, taux = tlosses.total_loss([torch.from_numpy(o) for o in outs],
                                  {k: torch.from_numpy(v) for k, v in
                                   labels.items()},
                                  torch.from_numpy(mask), 2.5, use_recon)
    # float32 on both sides, other reduction order: 1e-6 relative
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-6)
    fl = tlosses.focal_loss(torch.from_numpy(outs[2]),
                            torch.from_numpy(labels["gt"]),
                            torch.from_numpy(mask), 2.0,
                            alpha=torch.tensor([1.0, 2.0, 0.5, 3.0]))
    jfl = jlosses.focal_loss(jnp.asarray(outs[2]), jnp.asarray(labels["gt"]),
                             jnp.asarray(mask), 2.0,
                             alpha=jnp.asarray([1.0, 2.0, 0.5, 3.0]))
    np.testing.assert_allclose(fl.item(), float(jfl), rtol=1e-6)


def test_counters_and_summary_match_jax():
    rng = np.random.default_rng(2)
    outs = _outputs(rng, b=4, length=30)
    outs[0][0, :5] = 0.0            # argmax ties go to the first class
    labels = {"hap_1": rng.integers(0, 2, (4, 30)),
              "hap_2": rng.integers(0, 2, (4, 30)),
              "gt": rng.integers(0, 4, (4, 30))}
    mask = rng.integers(0, 2, (4, 30))
    af = rng.random((4, 30)).astype(np.float32) * 0.2
    jc = jmetrics.batch_counters([jnp.asarray(o) for o in outs],
                                 {k: jnp.asarray(v) for k, v in
                                  labels.items()}, jnp.asarray(mask),
                                 jnp.asarray(af), 0.05)
    tc = tmetrics.batch_counters([torch.from_numpy(o) for o in outs],
                                 {k: torch.from_numpy(v) for k, v in
                                  labels.items()}, torch.from_numpy(mask),
                                 torch.from_numpy(af), 0.05)
    tc = tmetrics.accumulate(tmetrics.zeros_like_counters(), tc)
    jc = jmetrics.accumulate(jmetrics.zeros_like_counters(), jc)
    flat_j = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, leaf in flat_j:
        node = tc
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    host = jax.tree.map(np.asarray, jc)
    tc_host = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.numpy())
               for k, v in tc.items()}
    assert tmetrics.summarize(tc_host) == jmetrics.summarize(host)


def test_schedule_matches_jax():
    ours = warmup_inverse_sqrt(1e-5, 7.5e-5, 15000)
    ref = jschedule(1e-5, 7.5e-5, 15000)
    for step in (0, 1, 15000, 15001, 150000):
        # both float32; JAX may evaluate x ** -0.5 as rsqrt: 1 ulp
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=3e-7)
    assert ours(0) == pytest.approx(1e-5) and \
        ours(15000) == pytest.approx(7.5e-5)
    assert ours(150000) == pytest.approx(7.5e-5 * 0.1 ** 0.5)


# ---- one train step against JAX ----

def _jax_model_cfg():
    c = jconfig.PRESETS["smoke"]
    # float32 (the point is the algorithm), dropout off (parity is
    # deterministic only), the fused-attention flag on: the port's
    # AttentionFn on the CPU, JAX's einsum path off the TPU.
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, bf16=False, dropout=0.0, flash_attention="splash"))


@functools.lru_cache(maxsize=None)
def _jax_params(vocab):
    cfg = _jax_model_cfg()
    m = cfg.model
    ib = init_batch(1, m.seq_len, m.dims)
    params = jax.jit(cfg.build_model(vocab).init)(jax.random.key(0), ib)
    return _perturb(params["params"])


def _torch_model(vocab, params):
    m = _jax_model_cfg().model
    tm = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(m))), vocab, device="cpu")
    return load_flax_params(tm, params)


@pytest.fixture(scope="module")
def step_case():
    """One packed batch, its window context, and the JAX step's results."""
    jds, tds, vocab = _datasets()
    params = _jax_params(vocab)
    jm = _jax_model_cfg().build_model(vocab)

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    meta = jds.windows[1]
    batch = jds.make_batch(meta, np.arange(4), level=2, seed=3, pad_to=6,
                           packed=True)
    toks, af, valid = jds.window_ref_tokens(meta, pad_haps_to=N_PAD)
    wmask = jds.window_mask(meta, 2, 3)
    ctx = jretrieval.encode_window_refs(
        embed_fn, params, jnp.asarray(toks), jnp.asarray(af),
        jnp.asarray(wmask), valid=jnp.asarray(valid))
    scfg = jstep.StepConfig(use_pallas=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def loss_and_grads(p):
        def f(p_):
            return jstep._forward(jm.apply, embed_fn, p_, jbatch, ctx, scfg,
                                  deterministic=True, dropout_rng=None)[0]
        return jax.value_and_grad(f)(p)

    loss, grads = loss_and_grads(params)
    q = embed_fn(params, jnp.concatenate([jbatch["hap_1"],
                                          jbatch["hap_2"]]).astype(jnp.int32),
                 jnp.broadcast_to(jbatch["af"], (12, SEQ_LEN)), True)
    ids = jretrieval._search(q, ctx, 1, False)
    # JAX's train_step without its dropout: the RAG fusion keeps rate 0.1
    # whatever the config (bert.py:128-129), so the reference is the
    # deterministic loss and gradients applied by the same TrainState.
    state = jstep.TrainState.create(apply_fn=jm.apply, params=params,
                                    tx=jmake_optimizer(1e-3, 2e-3, 10))
    opt_state = jax.tree.map(np.asarray, state.opt_state)
    new_state = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)
    return dict(tds=tds, vocab=vocab, params=params, batch=batch,
                meta=tds.windows[1], loss=float(loss),
                grads=jax.tree.map(np.asarray, grads), ids=np.asarray(ids),
                grad_norm=float(jstep.optax_global_norm(grads)),
                tx_state=opt_state,
                new_params=jax.tree.map(np.asarray, new_state.params))


def _torch_ctx(tm, tds, meta):
    toks, af, valid = tds.window_ref_tokens(meta, pad_haps_to=N_PAD)
    tm.eval()
    return tretrieval.encode_window_refs(
        tm.embed, torch.from_numpy(toks).long(), torch.from_numpy(af),
        torch.from_numpy(tds.window_mask(meta, 2, 3)),
        valid=torch.from_numpy(valid))


_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _key(path):
    """The torch parameter name of a flax leaf path."""
    return ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))


def _to_flax(path, t):
    """A torch tensor in the flax layout of leaf ``path``."""
    t = t.detach().numpy()
    if path[-1] == "kernel":
        return t.T if t.ndim == 2 else t.transpose(2, 1, 0)
    return t


def test_train_step_matches_jax(step_case):
    c = step_case
    tm = _torch_model(c["vocab"], c["params"])
    tm.bert.rag_fusion.drop.rate = 0.0     # see step_case: no dropout
    ctx = _torch_ctx(tm, c["tds"], c["meta"])
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    cfg = tstep.StepConfig(use_kernel=False)

    ex = tstep.expand_packed(batch)
    q = tm.embed(torch.cat([ex["hap_1"], ex["hap_2"]]),
                 torch.cat([ex["af"], ex["af"]]))
    np.testing.assert_array_equal(
        tretrieval.search(q, ctx, 1).numpy(), c["ids"])

    # gradients of the step's loss, parameter by parameter
    tm.train()
    loss, _, _ = tstep._forward(tm, batch, ctx, cfg)
    loss.backward()
    # float32 on both sides, other summation orders: the loss to 1e-5
    # relative; each parameter's gradient to 1e-4 relative L2 (observed
    # <= 3e-6), measured against the larger of its own norm and 1e-4 of the
    # whole gradient's:
    # the key biases' gradients vanish in exact arithmetic (softmax is
    # invariant to a shift shared by all keys), so both sides hold float32
    # rounding noise there.
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
    tm.zero_grad()
    opt = make_optimizer(tm, 1e-3, 2e-3, 10)
    load_optax_adam_state(opt, c["tx_state"])
    stats = tstep.train_step(tm, opt, batch, ctx, cfg)
    np.testing.assert_allclose(stats["loss"].item(), c["loss"], rtol=1e-5)
    np.testing.assert_allclose(stats["grad_norm"].item(), c["grad_norm"],
                               rtol=1e-4)
    assert opt.count == 1
    # First Adam step: each element moves by lr * g / (|g| + eps) = ~lr.
    # Elements whose gradient is within float32 noise of zero can move by
    # a different fraction of lr on the two sides, so the bound is lr.
    for path, new in _flat(c["new_params"]).items():
        np.testing.assert_allclose(_to_flax(path, named[_key(path)]), new,
                                   rtol=0, atol=1e-3, err_msg=_key(path))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


# ---- the optimizer against optax from the same state ----

def _grads_like(params, rng, scale):
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(
            np.float32), params)


def _set_grads(tm, grads):
    named = dict(tm.named_parameters())
    for path, g in _flat(grads).items():
        if path[-1] == "kernel":
            g = g.T if g.ndim == 2 else g.transpose(2, 1, 0)
        named[_key(path)].grad = torch.from_numpy(np.array(g, order="C"))


def _assert_params_equal(tm, params):
    named = dict(tm.named_parameters())
    for path, want in _flat(params).items():
        # the same float32 formulas on the same inputs: the global norm and
        # the bias corrections may round an ulp apart, and the final p + u
        # then lands an ulp or two of p apart (2^-22 relative); 1e-9
        # absolute for entries near zero.  An update is ~lr = 1e-3.
        np.testing.assert_allclose(_to_flax(path, named[_key(path)]), want,
                                   rtol=2 ** -22, atol=1e-9)


def _optimizer_against_optax(accum: int, grad_scale: float,
                             clipped: bool) -> None:
    """From a state with non-zero moments, ``accum`` micro-steps of the
    port's optimizer and of optax on the same gradients: equal parameters
    after each.  ``clipped``: every micro-gradient's global norm is above
    10 (the clip at 1.0 binds), else below 1.0."""
    import optax

    _, _, vocab = _datasets()
    params = jax.tree.map(np.asarray, _jax_params(vocab))
    rng = np.random.default_rng(accum)
    tx = jmake_optimizer(1e-3, 2e-3, 10, accum_steps=accum)
    state = tx.init(params)
    update = jax.jit(tx.update)
    # Reach a state with non-zero moments and count (one full update),
    # then load it into the port's optimizer.
    for _ in range(accum):
        upd, state = update(_grads_like(params, rng, 1e-3), state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
    tm = _torch_model(vocab, params)
    opt = make_optimizer(tm, 1e-3, 2e-3, 10, accum_steps=accum)
    load_optax_adam_state(opt, state)
    assert opt.count == 1 and opt.mini_step == 0

    for micro in range(accum):
        grads = _grads_like(params, rng, grad_scale)
        norm = _global_norm(grads)
        assert norm > 10.0 if clipped else norm < 1.0
        upd, state = update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
        _set_grads(tm, grads)
        applied = opt.step()
        opt.zero_grad()
        assert applied == (micro == accum - 1)
        if accum > 1:
            assert opt.mini_step == int(state.mini_step)
        _assert_params_equal(tm, params)
    assert opt.count == 2
    if accum > 1:
        assert all(float(a.abs().max()) == 0.0 for a in opt.acc)


def _global_norm(grads) -> float:
    return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in jax.tree.leaves(grads))))


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(accum):
    # Gradients of global norm ~300 >> clip 1.0: the clip binds.
    _optimizer_against_optax(accum, 0.3, clipped=True)


@pytest.mark.parametrize("accum,grad_scale", [(1, 1e-5), (3, 0.3)])
def test_optimizer_matches_optax_below_clip_and_over_three_micro_steps(
        accum, grad_scale):
    """The unclipped branch (global norm below 1.0, chosen on the device),
    and an average over three micro-steps (a division by 3)."""
    _optimizer_against_optax(accum, grad_scale, clipped=grad_scale > 0.1)


# ---- the trainer ----

def _trainer(tmp, epochs, seed=0, **kw):
    cfg = tconfig.PRESETS["smoke"]
    b = make_bundle(n_train_samples=8, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=SEQ_LEN)
    model = tconfig.build_model(cfg, b.vocab.size, device="cpu", seed=seed)
    tc = TrainerConfig(epochs=epochs, batch_size=6, val_batch_size=8,
                       warmup_steps=20, ref_pad_haps=N_PAD, log_freq=2,
                       output_dir=str(tmp), curriculum_every=1, patience=10,
                       grad_accum_steps=2, keep_checkpoints=1, **kw)
    return Trainer(model, ds, tc, val_ds=ds)


def test_trainer_fit_checkpoints_and_resumes_exactly(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path / "run", epochs=2, prefetch_ctx=True,
                       record_step_times=True)
    built = []
    build = trainer._window_ctx
    monkeypatch.setattr(trainer, "_window_ctx",
                        lambda ds, meta, *a: built.append(meta.window_idx)
                        or build(ds, meta, *a))
    result = trainer.fit()
    # prefetch_ctx builds the next window's context during the current
    # window and uses it: one build per window per pass (train, val)
    assert len(built) == 2 * 2 * 2
    assert len(trainer.step_marks) == 2      # the last pass: 2 val steps
    hist = result["history"]
    assert [r["epoch"] for r in hist] == [0, 1] and hist[1]["level"] == 1
    assert all(np.isfinite(r["train_loss"]) and 0 <= r["val_hap_f1"] <= 1
               for r in hist)
    assert trainer.step == 2 * 2 * 2      # 2 epochs x 2 windows x 2 batches
    assert trainer.optimizer.count == trainer.step // 2
    out = tmp_path / "run"
    rows = (out / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("epoch,level,train_")
    events = [line for line in (out / "events.jsonl").read_text()
              .splitlines()]
    assert sum('"train_epoch"' in e for e in events) == 2
    assert sum('"step"' in e for e in events) == 4   # log_freq 2, 4 a epoch
    best = os.path.realpath(out / "best")
    kept = {p.name for p in out.iterdir() if p.name.startswith("ckpt_ep")}
    # keep_checkpoints=1: the newest epoch and the best survive
    assert kept == {"ckpt_ep1", os.path.basename(best)}

    fresh = _trainer(tmp_path / "other", epochs=3, seed=9)
    fresh.restore_checkpoint(str(out / "ckpt_ep1"))
    assert (fresh.start_epoch, fresh.level, fresh.step) == (2, 2, 8)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"])
    for key in ("mu", "nu", "acc"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    assert dataclasses.asdict(fresh.stopper) == \
        dataclasses.asdict(trainer.stopper)


def test_resumed_run_draws_what_an_uninterrupted_one_would(tmp_path):
    """Dropout is on (smoke preset, 0.1): per-step generators seeded from
    (seed, step) make epoch 1 after a restore identical to epoch 1 of one
    uninterrupted run."""
    kw = dict(mask_schedule="cosine")     # the continuous mask ramp
    straight = _trainer(tmp_path / "a", epochs=2, **kw)
    straight.fit()
    first = _trainer(tmp_path / "b", epochs=2, **kw)
    first.cfg.epochs = 1
    first.fit()
    resumed = _trainer(tmp_path / "b", epochs=2, seed=4, **kw)
    resumed.restore_checkpoint(str(tmp_path / "b" / "ckpt_ep0"))
    resumed.fit()
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_trainer_paths_left_for_later_slices_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A 7"):
        _trainer(tmp_path, 1, shard_ctx=True)
    with pytest.raises(ValueError, match="rag_mode"):
        _trainer(tmp_path, 1, rag_mode="tokens")
