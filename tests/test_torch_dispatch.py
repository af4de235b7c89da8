"""``steps_per_dispatch`` in the port (``train/trainer.py::_chunk_batches``,
``train/step.py::train_steps``, ``train/dispatch.py``) on the CPU, where a
chunk's body runs eagerly (on the card it is one CUDA graph replay,
``chip_smoke.py::phase_dispatch``):

  - the chunks and their shapes equal the JAX ``_chunk_batches``' on the
    same datasets, a multi-population cohort included;
  - ``Trainer.fit`` at K = 3 equals K = 1 bit for bit (parameters,
    optimizer state, every metrics.csv value but the seconds) with a
    short trailing chunk, under accumulation 2, in token mode and with
    block remat (dropout on); a resume lands on the same step;
  - ``train_steps`` over 3 stacked batches against three JAX updates in a
    ``lax.scan`` from the same parameters (dropout off): each loss (the
    first within 1e-5 relative, the later within 1e-4), the summed
    counters within one count and the parameters within 3 x lr;
  - the body reads nothing back to the host (``Tensor.item``, ``tolist``,
    ``cpu``, ``numpy``, ``__bool__``, ``__int__``, ``__float__`` raise
    while it runs): what keeps it capturable;
  - the optimizer's update rows from a buffer equal the host-scalar
    update bit for bit;
  - a gloo dp2 world at K = 3 matches one process at K = 1 at
    tests/test_mesh_trainer.py's tolerances, and the card's check refuses
    a gloo mesh.
"""

import csv
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from rag_snvbert_tpu_torch import config as tconfig
from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
from rag_snvbert_tpu_torch.io.synthetic import make_bundle
from rag_snvbert_tpu_torch.parallel.launch import spawn
from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
from rag_snvbert_tpu_torch.train import dispatch
from rag_snvbert_tpu_torch.train import step as tstep
from rag_snvbert_tpu_torch.train.schedule import Optimizer, make_optimizer
from rag_snvbert_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                 _chunk_batches)
from test_torch_modules import torch_one_thread  # noqa: F401

# The JAX package is imported inside the JAX-side functions: the dp2 test's
# ranks import this module and need none of it.
SEQ_LEN = 138

# ---- chunks ----

CHUNK_DATA = {
    # 10 samples at batch 4: 3 batches a window, 2 windows
    "plain": dict(bundle=dict(n_train_samples=10, n_ref_samples=12,
                              n_sites=256, n_windows=2, seed=7),
                  seq_len=SEQ_LEN),
    # tests/test_trainer_variants.py:185: three populations whose batches
    # differ in population composition
    "multi_pop": dict(bundle=dict(n_train_samples=10, n_ref_samples=10,
                                  n_sites=96, n_windows=2, n_pops=3,
                                  seed=7), seq_len=80),
}


def _both_datasets(name):
    from rag_snvbert_tpu.data.pipeline import WindowDataset as JWindowDataset
    from rag_snvbert_tpu.io.synthetic import make_bundle as jmake_bundle

    spec = CHUNK_DATA[name]
    out = []
    for mk, ds_cls in ((jmake_bundle, JWindowDataset),
                       (make_bundle, WindowDataset)):
        b = mk(**spec["bundle"])
        out.append(ds_cls(b.train, b.panel, b.freq, b.window.window_info,
                          b.vocab, ref_vcf=b.ref, seq_len=spec["seq_len"]))
    return out


@pytest.mark.parametrize("name,k", [("plain", 2), ("plain", 3),
                                    ("multi_pop", 2), ("multi_pop", 3)])
def test_chunk_batches_match_jax(name, k):
    from rag_snvbert_tpu.train import trainer as jtrainer

    jds, tds = _both_datasets(name)
    want = list(jtrainer._chunk_batches(
        jds.epoch_batches(4, 1, 2, shuffle=True, seed=3, packed=True), k))
    got = list(_chunk_batches(
        tds.epoch_batches(4, 1, 2, shuffle=True, seed=3, packed=True), k))
    assert len(got) == len(want)
    # 3 batches a window: chunks never span a window, the last is short
    assert [next(iter(b.values())).shape[0] for _, b in got] == \
        ([2, 1] * 2 if k == 2 else [3] * 2)
    for (jm, jb), (tm, tb) in zip(want, got):
        assert tm.window_idx == jm.window_idx
        assert sorted(tb) == sorted(jb)
        for key in jb:
            assert tb[key].dtype == jb[key].dtype, key
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    if name == "multi_pop":
        assert {b["feat_rows"].shape[1:] for _, b in got} == {(3, 80, 4)}


# ---- Trainer.fit at K = 3 against K = 1 ----

def _fit_trainer(tmp, k, accum=1, epochs=2, rag_mode="embedding",
                 remat=False, seed=0, n_samples=14):
    """The smoke preset (dropout 0.1) over ``n_samples`` at batch 4 in 2
    windows: at 14, 4 batches a window, so K = 3 gives chunks of 3 and
    1."""
    cfg = tconfig.PRESETS["smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rag_mode=rag_mode, remat=remat))
    b = make_bundle(n_train_samples=n_samples, n_ref_samples=12, n_sites=256,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=SEQ_LEN)
    model = tconfig.build_model(cfg, b.vocab.size, device="cpu", seed=seed)
    tc = TrainerConfig(epochs=epochs, batch_size=4, val_batch_size=8,
                       warmup_steps=20, ref_pad_haps=32, log_freq=2,
                       output_dir=str(tmp), curriculum_every=1,
                       grad_accum_steps=accum, steps_per_dispatch=k,
                       record_step_times=True, rag_mode=rag_mode,
                       keep_checkpoints=0)
    return Trainer(model, ds, tc, val_ds=ds)


def _csv_rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return [{k: v for k, v in r.items() if "seconds" not in k}
                for r in csv.DictReader(f)]


def _assert_same_state(a: Trainer, b: Trainer):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["count"], sa["mini_step"]) == (sb["count"], sb["mini_step"])
    for key in ("mu", "nu", "acc"):
        for name in sa[key] or {}:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert a.step == b.step


def _logged_batches(out_dir):
    with open(os.path.join(out_dir, "events.jsonl"), encoding="utf-8") as f:
        return [e["batch"] for e in map(json.loads, f)
                if e["event"] == "step"]


@pytest.mark.parametrize("accum,rag_mode,remat", [
    (1, "embedding", False), (2, "embedding", False), (1, "token", False),
    (2, "embedding", True), (1, "embedding", "save_ffn")],
    ids=["trailing", "accum2", "token", "remat", "remat_save_ffn"])
def test_fit_in_chunks_equals_single_steps(tmp_path, accum, rag_mode,
                                           remat):
    one = _fit_trainer(tmp_path / "k1", 1, accum, rag_mode=rag_mode,
                       remat=remat)
    three = _fit_trainer(tmp_path / "k3", 3, accum, rag_mode=rag_mode,
                         remat=remat)
    one.fit()
    three.fit()
    _assert_same_state(one, three)
    assert one.step == 2 * 2 * 4                # 2 epochs x 2 windows x 4
    assert _csv_rows(tmp_path / "k1" / "metrics.csv") == \
        _csv_rows(tmp_path / "k3" / "metrics.csv")
    # log_freq 2 checked after each dispatch, as JAX does: chunks end at
    # batches 3, 4, 7, 8 of an epoch
    assert _logged_batches(tmp_path / "k1") == [2, 4, 6, 8] * 2
    assert _logged_batches(tmp_path / "k3") == [4, 8] * 2
    # one step mark a dispatch: chunks of 3 and 1 in each window
    three._run_epoch(2, train=True)
    assert len(three.step_marks) == 4
    assert three.runner.graphs is None                # CPU: eager


def test_chunked_resume_lands_on_the_same_step(tmp_path):
    straight = _fit_trainer(tmp_path / "a", 3, accum=2)
    straight.fit()
    first = _fit_trainer(tmp_path / "b", 3, accum=2, epochs=1)
    first.fit()
    resumed = _fit_trainer(tmp_path / "b", 3, accum=2, seed=4)
    resumed.restore_checkpoint(str(tmp_path / "b" / "ckpt_ep0"))
    assert resumed.step == first.step == 8
    resumed.fit()
    _assert_same_state(straight, resumed)


def test_profiler_window_advances_by_chunks(tmp_path, monkeypatch):
    """The trace starts after the first dispatch and stops once
    ``profile_steps`` micro-steps have run since (JAX trainer.py:418-433):
    chunks of 3 and 1, so it holds the chunk of 1 and the next of 3."""
    trainer = _fit_trainer(tmp_path / "run", 3, epochs=1)
    trainer.cfg.profile_dir = str(tmp_path / "trace")
    trainer.cfg.profile_steps = 2
    marks = []
    real = dispatch.ChunkRunner.run

    def run(self, batches, ctx, step):
        marks.append((step, trainer.trace_path))
        return real(self, batches, ctx, step)

    monkeypatch.setattr(dispatch.ChunkRunner, "run", run)
    trainer.fit()
    assert [m[0] for m in marks] == [0, 3, 4, 7]
    # stopped after the chunk that began at step 4, before the last one
    assert marks[3][1] is not None and marks[2][1] is None
    assert os.path.exists(trainer.trace_path)


# ---- train_steps against JAX's scan ----

@pytest.fixture(scope="module")
def scan_case():
    """Three packed batches of one window and three JAX updates in a
    ``lax.scan`` (the deterministic ``_forward``, then
    ``TrainState.apply_gradients``), as test_train_step_matches_jax builds
    one."""
    import jax
    import jax.numpy as jnp

    from rag_snvbert_tpu.train import retrieval as jretrieval
    from rag_snvbert_tpu.train import step as jstep
    from rag_snvbert_tpu.train.schedule import \
        make_optimizer as jmake_optimizer
    from test_torch_train import _datasets, _jax_model_cfg, _jax_params

    jds, tds, vocab = _datasets()
    params = _jax_params(vocab)
    jm = _jax_model_cfg().build_model(vocab)

    def embed_fn(p, toks, af, deterministic, rngs=None):
        return jm.apply({"params": p}, toks, af, deterministic,
                        method=jm.embed, rngs=rngs)

    meta = jds.windows[1]
    batches = [jds.make_batch(meta, ids, level=2, seed=3, pad_to=4,
                              packed=True)
               for ids in (np.arange(4), np.arange(4, 8), np.arange(8, 10))]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    toks, af, valid = jds.window_ref_tokens(meta, pad_haps_to=32)
    ctx = jretrieval.encode_window_refs(
        embed_fn, params, jnp.asarray(toks), jnp.asarray(af),
        jnp.asarray(jds.window_mask(meta, 2, 3)), valid=jnp.asarray(valid))
    scfg = jstep.StepConfig(use_pallas=False)
    state = jstep.TrainState.create(apply_fn=jm.apply, params=params,
                                    tx=jmake_optimizer(1e-3, 2e-3, 10))

    @jax.jit
    def scan(state, jbatches):
        def body(st, batch):
            def f(p):
                return jstep._forward(jm.apply, embed_fn, p, batch, ctx,
                                      scfg, deterministic=True,
                                      dropout_rng=None)

            (loss, (_, counters)), grads = jax.value_and_grad(
                f, has_aux=True)(st.params)
            return st.apply_gradients(grads=grads), (loss, counters)

        return jax.lax.scan(body, state, jbatches)

    state, (losses, counters) = scan(
        state, {k: jnp.asarray(v) for k, v in stacked.items()})
    return dict(tds=tds, vocab=vocab, params=params, batches=stacked,
                losses=np.asarray(losses),
                counters=jax.tree.map(lambda c: np.asarray(c).sum(0),
                                      counters),
                new_params=jax.tree.map(np.asarray, state.params))


def test_train_steps_match_jax_scan(scan_case):
    from test_torch_train import (_flat, _key, _to_flax, _torch_ctx,
                                  _torch_model)

    c = scan_case
    tm = _torch_model(c["vocab"], c["params"])
    tm.bert.rag_fusion.drop.rate = 0.0   # JAX's is 0.1 whatever the config
    ctx = _torch_ctx(tm, c["tds"], c["tds"].windows[1])
    runner = dispatch.ChunkRunner(tm, make_optimizer(tm, 1e-3, 2e-3, 10),
                                  tstep.StepConfig(use_kernel=False), 0)
    out = runner.run({k: torch.from_numpy(v)
                      for k, v in c["batches"].items()}, ctx, 0)
    losses = out["loss"].numpy()
    # float32 on both sides, other summation orders: the first loss as
    # test_train_step_matches_jax holds it (1e-5), the later ones after
    # updates whose float32 differences they inherit (1e-4)
    np.testing.assert_allclose(losses[0], c["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], c["losses"][1:], rtol=1e-4)
    assert runner.optimizer.count == 3
    # the summed counters: argmax ties may fall apart, one count at most
    for path, want in _flat(c["counters"]).items():
        got = runner.acc["counters"]
        for p in path:
            got = got[p]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1,
                                   err_msg=str(path))
    # each Adam step moves an element by ~lr (1e-3 .. 1.2e-3 here), and
    # near-zero gradients may move it by another fraction of lr on the two
    # sides: three steps, 3 x lr
    named = dict(tm.named_parameters())
    for path, new in _flat(c["new_params"]).items():
        np.testing.assert_allclose(_to_flax(path, named[_key(path)]), new,
                                   rtol=0, atol=3e-3, err_msg=_key(path))


# ---- the body reads nothing back ----

_HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
               "__float__")


def _guarded(fn):
    """``fn`` with every Tensor host read raising while it runs."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

        def refuse(name):
            def read(*_a, **_k):
                raise AssertionError(f"Tensor.{name} inside the chunk body")
            return read

        for name in _HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        try:
            return fn(*args, **kwargs)
        finally:
            for name, f in saved.items():
                setattr(torch.Tensor, name, f)

    return run


@pytest.mark.parametrize("accum,rag_mode,remat", [
    (2, "embedding", False), (1, "token", False), (2, "embedding", True)],
    ids=["embedding", "token", "remat"])
def test_chunk_body_reads_nothing_back(tmp_path, monkeypatch, accum,
                                       rag_mode, remat):
    monkeypatch.setattr(dispatch, "train_steps",
                        _guarded(dispatch.train_steps))
    with pytest.raises(AssertionError, match="inside the chunk body"):
        _guarded(lambda: bool(torch.ones(())))()
    trainer = _fit_trainer(tmp_path, 3, accum, epochs=1, rag_mode=rag_mode,
                           remat=remat)
    trainer.fit()
    assert trainer.step == 8


# ---- the optimizer's update rows ----

def _host_scalar_update(opt: Optimizer, grads) -> None:
    """The update as it was before the rows moved to a buffer: the
    learning rate a Python scalar, the bias corrections 0-d fills."""
    norm = opt.grad_norm(grads)
    lr = opt.schedule(opt.count)
    opt.count += 1
    f32 = dict(dtype=torch.float32)
    bc1 = opt._scalar((1 - torch.tensor(opt.b1, **f32) ** opt.count).item())
    bc2 = opt._scalar((1 - torch.tensor(opt.b2, **f32) ** opt.count).item())
    below, one = norm < opt.clip_norm, opt._scalar(1.0)
    grads = torch._foreach_mul(
        torch._foreach_div(grads, torch.where(below, one, norm)),
        torch.where(below, one, opt._scalar(opt.clip_norm)))
    torch._foreach_mul_(opt.mu, opt.b1)
    torch._foreach_add_(opt.mu, torch._foreach_mul(grads, 1 - opt.b1))
    torch._foreach_mul_(opt.nu, opt.b2)
    torch._foreach_add_(opt.nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - opt.b2))
    den = torch._foreach_sqrt(torch._foreach_div(opt.nu, bc2))
    torch._foreach_add_(den, opt.eps)
    u = torch._foreach_div(torch._foreach_div(opt.mu, bc1), den)
    torch._foreach_add_(opt.params, torch._foreach_mul(u, -lr))


def _host_scalar_step(opt: Optimizer) -> None:
    grads = opt.grads()
    if opt.acc is not None:
        n = opt.mini_step
        delta = torch._foreach_sub(grads, opt.acc)
        torch._foreach_div_(delta, opt._scalar(n + 1))
        torch._foreach_add_(opt.acc, delta)
        if n < opt.accum_steps - 1:
            opt.mini_step = n + 1
            return
        grads = opt.acc
    _host_scalar_update(opt, grads)
    if opt.acc is not None:
        torch._foreach_zero_(opt.acc)
        opt.mini_step = 0


@pytest.mark.parametrize("accum,scale", [(1, 0.3), (1, 1e-4), (2, 0.3),
                                         (2, 1e-4)])
def test_optimizer_rows_equal_host_scalars(accum, scale):
    """``step()`` (rows as fills) and ``advance`` + ``apply`` with the rows
    in one buffer (the chunk runner's way) against the host-scalar update,
    from the same parameters and gradients over three updates; ``scale``
    0.3 clips (global norm ~10), 1e-4 does not."""
    rng = np.random.default_rng(accum)
    shapes = [(7, 5), (5,), (3, 4, 2), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32)
              for s in shapes]
    opts = [Optimizer([(str(i), torch.tensor(p)) for i, p in
                       enumerate(params)], 1e-3, 2e-3, 2,
                      accum_steps=accum) for _ in range(3)]
    for _ in range(3 * accum):
        grads = [torch.from_numpy(np.asarray(
            scale * rng.standard_normal(s), np.float32)) for s in shapes]
        for o in opts:
            for p, g in zip(o.params, grads):
                p.grad = g.clone()
        _host_scalar_step(opts[0])
        opts[1].step()
        n, row = opts[2].advance()
        buf = torch.from_numpy(np.stack([row])) if row is not None else None
        opts[2].apply(n, None if buf is None else tuple(buf[0].unbind()))
        for o in opts:
            o.zero_grad()
        for o in opts[1:]:
            assert (o.count, o.mini_step) == (opts[0].count,
                                              opts[0].mini_step)
            for key in ("params", "mu", "nu", "acc"):
                for a, b in zip(getattr(opts[0], key) or [],
                                getattr(o, key) or []):
                    assert torch.equal(a, b), key
    assert opts[0].count == 3


# ---- data parallelism ----

LOSS_REL = 1e-3
P_RTOL, P_ATOL = 2e-3, 2e-4


def _mesh_trainer(mesh, out_dir, k):
    """tests/test_torch_mesh_trainer.py's model over 20 samples at batch
    4: 5 batches a window, so K = 3 gives chunks of 3 and 2."""
    b = make_bundle(n_train_samples=20, n_ref_samples=12, n_sites=96,
                    n_windows=2, seed=11)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=80)
    model = tconfig.build_model(tconfig.RunConfig(model=tconfig.ModelConfig(
        dims=32, n_layers=1, attn_heads=4, seq_len=80)), b.vocab.size,
        device="cpu", seed=0)
    cfg = TrainerConfig(epochs=1, batch_size=4, val_batch_size=4,
                        warmup_steps=10, ref_pad_haps=32,
                        output_dir=str(out_dir), log_freq=1000,
                        prefetch_batches=0, steps_per_dispatch=k)
    return Trainer(model, ds, cfg, mesh=mesh)


def _dp2_world(rank, out_dir):
    mesh = make_mesh(2, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        dispatch.check_capturable(mesh)
    t = _mesh_trainer(mesh, os.path.join(out_dir, f"dp{rank}"), 3)
    loss = t.fit()["history"][0]["train_loss"]
    return loss, t.step, {k: v.numpy().copy()
                          for k, v in t.model.state_dict().items()}


def test_dp2_chunks_match_one_process(tmp_path):
    single = _mesh_trainer(None, tmp_path / "single", 1)
    want = single.fit()["history"][0]["train_loss"]
    runs = spawn(_dp2_world, 2, (str(tmp_path),), threads=1)
    for loss, step, params in runs:
        assert step == single.step == 10
        assert abs(loss - want) / max(abs(want), 1.0) < LOSS_REL
        for k, v in single.model.state_dict().items():
            np.testing.assert_allclose(params[k], v.numpy(), rtol=P_RTOL,
                                       atol=P_ATOL, err_msg=k)
