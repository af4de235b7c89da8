"""The port's V17 token-space RAG slice against the JAX package on the CPU:
the token window context and ``retrieve_tokens`` (same retrieved
segments), ``BERTWithRAG`` with the same flax weights, the token imputer,
one train step (loss and gradients), and a torch-only ``Trainer.fit`` in
token mode with an exact resume.  Small sizes (2 layers, 32 dims,
seq_len 138); inputs from numpy with fixed seeds; every tolerance is
stated where it is used."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu import config as jconfig
from rag_snvbert_tpu.data.pipeline import WindowDataset as JWindowDataset
from rag_snvbert_tpu.infer.imputer import Imputer as JImputer
from rag_snvbert_tpu.io.synthetic import make_bundle as jmake_bundle
from rag_snvbert_tpu.models import init_batch
from rag_snvbert_tpu.train import retrieval as jretrieval
from rag_snvbert_tpu.train import step as jstep
from rag_snvbert_tpu.train.schedule import make_optimizer as jmake_optimizer
from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch import ops
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.infer.imputer import Imputer
from rag_snvbert_tpu_torch.infer.serve import ImputationService
from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                           load_optax_adam_state)
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.models import BERTWithRAG
from rag_snvbert_tpu_torch.train import retrieval as tretrieval
from rag_snvbert_tpu_torch.train import step as tstep
from rag_snvbert_tpu_torch.train.schedule import make_optimizer
from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_modules import (  # noqa: F401  (autouse fixture)
    _perturb, torch_one_thread)
from test_torch_train import _flat, _key, _to_flax

DIMS, SEQ, N_PAD = 32, 138, 64
KW = dict(window_len=SEQ - 10, seq_len=SEQ, ref_pad_haps=N_PAD, batch_size=8)
BUNDLE = dict(n_train_samples=8, n_ref_samples=24, n_sites=200, n_windows=2,
              seed=3)
# float32 models on both sides; the frameworks differ only in summation
# order: outputs and probabilities to 1e-5 relative and absolute, the
# tolerance of tests/test_torch_serve.py (observed 5e-6 on the model's
# outputs, whose scale is ~5)
TOL = 1e-5


def _jcfg(dropout=0.0):
    """v17_token_rag cut to 2 layers x 32 dims x 4 heads at seq_len 138:
    post-LN, float32, attention dropout = dropout (the einsum path)."""
    c = jconfig.PRESETS["v17_token_rag"]
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, dims=DIMS, n_layers=2, attn_heads=4, seq_len=SEQ,
        dropout=dropout))


def _tcfg(dropout=0.0):
    return tconfig.RunConfig(model=tconfig.ModelConfig(
        **dataclasses.asdict(_jcfg(dropout).model)))


@functools.lru_cache(maxsize=None)
def _jax_params(vocab):
    ib = init_batch(1, SEQ, DIMS, with_rag_emb=False, with_rag_seg=True)
    params = jax.jit(_jcfg().build_model(vocab).init)(jax.random.key(0), ib)
    return _perturb(params["params"])


def _torch_model(vocab):
    tm = tconfig.build_model(_tcfg(), vocab, device="cpu")
    return load_flax_params(tm, jax.tree.map(np.asarray, _jax_params(vocab)))


@pytest.fixture(scope="module")
def setup():
    jb, tb = jmake_bundle(**BUNDLE), make_bundle(**BUNDLE)
    jm = _jcfg().build_model(jb.vocab.size)

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    keep = np.random.default_rng(0).random(tb.train.n_variants) > 0.4
    return dict(jb=jb, tb=tb, jm=jm, params=_jax_params(jb.vocab.size),
                embed_fn=embed_fn, tm=_torch_model(tb.vocab.size), keep=keep)


def _drop(vcf, keep):
    return dataclasses.replace(vcf, gt=vcf.gt[keep], pos=vcf.pos[keep],
                               chrom=vcf.chrom[keep], ref=vcf.ref[keep],
                               alt=vcf.alt[keep], ids=vcf.ids[keep])


# ---- model ----

def _batch(rng, vocab, b=3, k=1):
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    toks = lambda *s: rng.integers(0, vocab, s).astype(np.int32)  # noqa
    return {"hap_1": toks(b, SEQ), "hap_2": toks(b, SEQ),
            "rag_seg_h1": toks(b, k, SEQ), "rag_seg_h2": toks(b, k, SEQ),
            "pos": f(b, SEQ), "af": f(b, SEQ), "af_p": f(b, SEQ),
            "ref": f(b, SEQ), "het": f(b, SEQ), "hom": f(b, SEQ)}


@pytest.mark.parametrize("k", [1, 3])
def test_bert_with_rag_matches_flax(k):
    vocab = 9
    x = _batch(np.random.default_rng(k), vocab, k=k)
    jm = _jcfg().build_model(vocab)
    jouts = jax.jit(jm.apply)({"params": _jax_params(vocab)},
                              {n: jnp.asarray(v) for n, v in x.items()})
    tm = _torch_model(vocab)
    assert isinstance(tm.bert, BERTWithRAG)
    with torch.no_grad():
        touts = tm({n: (torch.from_numpy(v).long() if v.dtype == np.int32
                        else torch.from_numpy(v)) for n, v in x.items()})
    assert len(touts) == len(jouts) == 7
    for i, (a, b) in enumerate(zip(jouts, touts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL, err_msg=f"output {i}")


def test_flax_tree_loads_and_mismatches_raise():
    vocab = 9
    params = jax.tree.map(np.asarray, _jax_params(vocab))
    tm = _torch_model(vocab)
    fusion = params["bert"]["rag_fusion"]
    np.testing.assert_array_equal(
        tm.bert.rag_fusion.Dense_3.weight.detach().numpy(),
        fusion["Dense_3"]["kernel"].T)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(tconfig.build_model(_tcfg(), vocab, device="cpu"),
                         extra)
    bert = {n: v for n, v in params["bert"].items() if n != "rag_fusion"}
    with pytest.raises(KeyError, match="rag_fusion"):
        load_flax_params(tconfig.build_model(_tcfg(), vocab, device="cpu"),
                         dict(params, bert=bert))


def test_v17_preset_builds_the_jax_parameter_tree():
    """The full-width preset (192d, 10 layers, 6 heads): every flax leaf
    has a torch tensor of its shape (shapes only: nothing runs)."""
    cfg = jconfig.PRESETS["v17_token_rag"]
    ib = init_batch(1, cfg.model.seq_len, cfg.model.dims, with_rag_emb=False,
                    with_rag_seg=True)
    shapes = jax.eval_shape(cfg.build_model(20).init, jax.random.key(0), ib)
    tm = tconfig.build_model(tconfig.get_preset("v17_token_rag"), 20,
                             device="cpu")
    assert isinstance(tm.bert, BERTWithRAG) and not tm.training
    state = dict(tm.named_parameters())
    flat = _flat(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                              shapes["params"]))
    assert sorted(map(_key, flat)) == sorted(state)
    for path, leaf in flat.items():
        assert tuple(_to_flax(path, state[_key(path)]).shape) == leaf.shape


# ---- context and retrieval ----

def _contexts(s, mask_seed=0):
    jimp = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                    s["jb"].freq, use_pallas=False, rag_mode="token", **KW)
    timp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                   rag_mode="token", **KW)
    start, end = jimp.windows[0]
    mask = np.random.default_rng(mask_seed).random(end - start) > 0.5
    return (jimp._window_ctx(0, start, end, mask),
            timp._window_ctx(start, end, mask))


def test_token_context_matches_jax(setup):
    jctx, tctx = _contexts(setup)
    assert isinstance(tctx, tretrieval.TokenWindowContext)
    np.testing.assert_array_equal(tctx.ref_tokens_masked.numpy(),
                                  np.asarray(jctx.ref_tokens_masked))
    np.testing.assert_array_equal(tctx.ref_tokens.numpy(),
                                  np.asarray(jctx.ref_tokens))
    np.testing.assert_array_equal(tctx.ref_norms.numpy(),
                                  np.asarray(jctx.ref_norms))
    assert np.isinf(tctx.ref_norms.numpy()[48:]).all()
    # the int8 operand: masked tokens, zero columns up to a multiple of 16
    search = tctx.ref_search.numpy()
    assert search.dtype == np.int8 and search.shape == (N_PAD, 144)
    np.testing.assert_array_equal(search[:, :SEQ],
                                  np.asarray(jctx.ref_tokens_masked))
    assert (search[:, SEQ:] == 0).all()


@pytest.mark.parametrize("k", [1, 4])
def test_retrieved_segments_identical(setup, k):
    jctx, tctx = _contexts(setup, mask_seed=k)
    toks = np.asarray(jctx.ref_tokens_masked)
    rng = np.random.default_rng(k)
    q1 = toks[rng.integers(0, 48, 6)].copy()
    q2 = toks[rng.integers(0, 48, 6)].copy()
    q1[:, 20:40] = 5                           # queries off the rows too
    jout = jretrieval.retrieve_tokens({"hap_1": jnp.asarray(q1),
                                       "hap_2": jnp.asarray(q2)}, jctx, k,
                                      use_pallas=False)
    for use_kernel in (True, False):
        tout = tretrieval.retrieve_tokens(
            {"hap_1": torch.from_numpy(q1).long(),
             "hap_2": torch.from_numpy(q2).long()}, tctx, k, use_kernel)
        for name in ("rag_seg_h1", "rag_seg_h2"):
            assert tout[name].shape == (6, k, SEQ)
            np.testing.assert_array_equal(tout[name].numpy(),
                                          np.asarray(jout[name]))


def test_token_ids_beyond_int8_take_the_exact_path_on_the_cpu():
    """A reference token id above 127 leaves no int8 operand; on the CPU
    the search stays exact (on the card retrieve_tokens raises instead,
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(4)
    ref = rng.integers(5, 7, (40, 48)).astype(np.int32)
    ref[3, 0] = 200                       # position 0 is never masked
    wmask = np.r_[0, rng.integers(0, 2, 47)].astype(np.int32)
    jctx = jretrieval.build_token_window_ctx(jnp.asarray(ref),
                                             jnp.asarray(wmask))
    tctx = tretrieval.build_token_window_ctx(torch.from_numpy(ref).long(),
                                             torch.from_numpy(wmask))
    assert tctx.ref_search is None and not jctx.ids_fit_int8
    q = ref[[3, 9, 11]]
    jout = jretrieval.retrieve_tokens({"hap_1": jnp.asarray(q),
                                       "hap_2": jnp.asarray(q[::-1])}, jctx,
                                      3, use_pallas=False)
    tout = tretrieval.retrieve_tokens({"hap_1": torch.from_numpy(q).long(),
                                       "hap_2": torch.from_numpy(
                                           q[::-1].copy()).long()}, tctx, 3)
    np.testing.assert_array_equal(tout["rag_seg_h1"].numpy(),
                                  np.asarray(jout["rag_seg_h1"]))
    np.testing.assert_array_equal(tout["rag_seg_h2"].numpy(),
                                  np.asarray(jout["rag_seg_h2"]))


# ---- serving ----

@pytest.mark.parametrize("rag_k", [1, 2])
def test_token_impute_matches_jax(setup, rag_k):
    s = setup
    jres = JImputer(s["jm"], s["embed_fn"], s["params"], s["jb"].ref,
                    s["jb"].freq, use_pallas=False, rag_mode="token",
                    rag_k=rag_k, **KW).impute(_drop(s["jb"].train, s["keep"]))
    ops.reset_launches()
    tres = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                   rag_mode="token", rag_k=rag_k,
                   **KW).impute(_drop(s["tb"].train, s["keep"]))
    assert ops.launch_counts()["l2_topk_rf"] == 0     # CPU: plain version
    for f in ("hap1_prob", "hap2_prob", "gt_prob"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(tres.imputed_flag, jres.imputed_flag)


def test_token_service_answers_two_requests(setup):
    s = setup
    svc = ImputationService.create(s["tm"], s["tb"].ref, s["tb"].freq,
                                   device="cpu", rag_mode="token", **KW)
    gt = s["tb"].train.gt
    for seed in (4, 5):
        keep = np.random.default_rng(seed).random(
            s["tb"].train.n_variants) > 0.3
        res = svc.handle_target(_drop(s["tb"].train, keep))
        assert res.gt_prob.shape == (s["tb"].ref.n_variants,
                                     s["tb"].train.n_samples, 4)
        assert (res.imputed_flag == ~keep).all()
        np.testing.assert_array_equal(res.hap1_prob[keep],
                                      gt[keep, :, 0].astype(np.float32))
        np.testing.assert_allclose(res.gt_prob.sum(-1), 1.0, atol=1e-5)


def test_imputer_modes_left_for_later_slices_and_int8_vocab(setup):
    s = setup
    # the no-RAG mode is ported (no window context); a mode that does not
    # exist raises
    imp = Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                  rag_mode="none", **KW)
    assert imp._window_ctx(0, 10, np.zeros(10, bool)) is None
    with pytest.raises(ValueError, match="rag_mode"):
        Imputer(s["tm"], s["tb"].ref, s["tb"].freq, device="cpu",
                rag_mode="tokens", **KW)
    tretrieval.check_int8_vocab(s["tm"])
    wide = tconfig.build_model(_tcfg(), 200, device="cpu")
    with pytest.raises(ValueError, match="fit int8"):
        tretrieval.check_int8_vocab(wide)


# ---- training ----

def _datasets():
    jb, tb = jmake_bundle(**BUNDLE), make_bundle(**BUNDLE)
    jds = JWindowDataset(jb.train, jb.panel, jb.freq, jb.window.window_info,
                         jb.vocab, ref_vcf=jb.ref, seq_len=SEQ)
    tds = WindowDataset(tb.train, tb.panel, tb.freq, tb.window.window_info,
                        tb.vocab, ref_vcf=tb.ref, seq_len=SEQ)
    return jds, tds, tb.vocab.size


def test_token_train_step_matches_jax():
    jds, tds, vocab = _datasets()
    params = _jax_params(vocab)
    jm = _jcfg().build_model(vocab)
    meta = jds.windows[1]
    batch = jds.make_batch(meta, np.arange(4), level=2, seed=3, pad_to=6,
                           packed=True)
    toks, _, valid = jds.window_ref_tokens(meta, pad_haps_to=N_PAD)
    wmask = jds.window_mask(meta, 2, 3)
    jctx = jretrieval.build_token_window_ctx(
        jnp.asarray(toks), jnp.asarray(wmask), valid=jnp.asarray(valid))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    scfg = jstep.StepConfig(use_pallas=False)

    @jax.jit
    def loss_and_grads(p):
        def f(p_):
            return jstep._forward(jm.apply, None, p_, jbatch, jctx, scfg,
                                  deterministic=True, dropout_rng=None)[0]
        return jax.value_and_grad(f)(p)

    jloss, jgrads = loss_and_grads(params)
    # JAX's train_step keeps the RAG fusion's dropout (0.1 whatever the
    # config), so the reference is its deterministic loss and gradients
    # applied by the same TrainState (as tests/test_torch_train.py).
    state = jstep.TrainState.create(apply_fn=jm.apply, params=params,
                                    tx=jmake_optimizer(1e-3, 2e-3, 10))
    new_params = jax.tree.map(np.asarray, jax.jit(
        lambda st, g: st.apply_gradients(grads=g))(state, jgrads).params)

    tm = _torch_model(vocab)
    tm.bert.rag_fusion.drop.rate = 0.0
    tctx = tretrieval.build_token_window_ctx(
        torch.from_numpy(toks).long(), torch.from_numpy(wmask),
        valid=torch.from_numpy(valid))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg = tstep.StepConfig()
    ex = tstep.expand_packed(tbatch)
    seg = tretrieval.retrieve_tokens(ex, tctx)["rag_seg_h1"]
    jseg = jretrieval.retrieve_tokens(jstep.expand_packed(jbatch), jctx,
                                      use_pallas=False)["rag_seg_h1"]
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))

    tm.train()
    loss, _, _ = tstep._forward(tm, tbatch, tctx, cfg)
    loss.backward()
    # float32 on both sides, other summation orders: the loss to 1e-5
    # relative; each parameter's gradient to 1e-4 relative L2, against the
    # larger of its own norm and 1e-4 of the whole gradient's (the key
    # biases' gradients vanish in exact arithmetic: both sides hold float32
    # noise there) -- the tolerances of tests/test_torch_train.py.
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat = _flat(jax.tree.map(np.asarray, jgrads))
    named = dict(tm.named_parameters())
    assert sorted(map(_key, flat)) == sorted(named)
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in flat.values()))
    for path, g in flat.items():
        mine = _to_flax(path, named[_key(path)].grad)
        rel = np.linalg.norm(mine - g) / max(np.linalg.norm(g), 1e-4 * total)
        assert rel <= 1e-4, (_key(path), rel)

    tm.zero_grad()
    opt = make_optimizer(tm, 1e-3, 2e-3, 10)
    load_optax_adam_state(opt, jax.tree.map(np.asarray, state.opt_state))
    stats = tstep.train_step(tm, opt, tbatch, tctx, cfg)
    np.testing.assert_allclose(stats["loss"].item(), float(jloss), rtol=1e-5)
    # first Adam step: each element moves by ~lr = 1e-3 (bound lr, as in
    # tests/test_torch_train.py)
    for path, new in _flat(new_params).items():
        np.testing.assert_allclose(_to_flax(path, named[_key(path)]), new,
                                   rtol=0, atol=1e-3, err_msg=_key(path))


def _trainer(tmp, epochs, seed=0, **kw):
    b = make_bundle(n_train_samples=8, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=SEQ)
    # dropout on (0.1, the preset's), so a resume must draw what an
    # uninterrupted run draws
    model = tconfig.build_model(_tcfg(dropout=0.1), b.vocab.size,
                                device="cpu", seed=seed)
    tc = TrainerConfig(epochs=epochs, batch_size=6, val_batch_size=8,
                       warmup_steps=20, ref_pad_haps=32, log_freq=2,
                       output_dir=str(tmp), curriculum_every=1,
                       rag_mode="token", keep_checkpoints=1, **kw)
    return Trainer(model, ds, tc, val_ds=ds)


def test_token_trainer_fits_and_resumes_exactly(tmp_path):
    straight = _trainer(tmp_path / "a", epochs=2)
    built = []
    make = straight._window_ctx
    straight._window_ctx = lambda *a: built.append(make(*a)) or built[-1]
    hist = straight.fit()["history"]
    assert all(isinstance(c, tretrieval.TokenWindowContext) for c in built)
    assert len(built) == 2 * 2 * 2     # 2 epochs x (train, val) x 2 windows
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and 0 <= r["val_hap_f1"] <= 1
               for r in hist)
    assert straight.step == 2 * 2 * 2  # 2 epochs x 2 windows x 2 batches

    first = _trainer(tmp_path / "b", epochs=2)
    first.cfg.epochs = 1
    first.fit()
    resumed = _trainer(tmp_path / "b", epochs=2, seed=4)
    resumed.restore_checkpoint(str(tmp_path / "b" / "ckpt_ep0"))
    assert (resumed.start_epoch, resumed.step) == (1, 4)
    resumed.fit()
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
