"""Command line of the port.

Port of rag_snvbert_tpu/cli/main.py with the same verbs, flags, outputs
and files, so what either package writes the other reads:
  prepare-data : VCF -> frequency table, window CSV, POP.json, sample split
  build-index  : reference VCF -> per-window rows, positions, population
                 labels and flat-L2 index shards (``--mode flat``) or rows
                 and positions only (``--mode intersect``)
  query        : per-window k-NN over a database (flat, intersect after
                 position intersection, partial = masked search over the
                 same index; ``--hamming`` for the intersect mode), with
                 per-window timing, ``--save-results`` and ``--verbose``
  train        : RAG (or no-RAG) training (src/train_embedding_rag.py),
                 checkpoints ``ckpt_ep{N}/state.pt``
  infer        : window-major imputation of a target VCF -> imputed VCF
                 (src/infer_embedding_rag.py)
  serve        : the persistent service: JSON-lines requests on stdin, or
                 HTTP with cross-request batching (``--http [HOST:]PORT``)
  emit-vcf     : the NPY probability matrices of ``infer --npy_prefix``
                 -> imputed VCF (generate_vcf.py)
  analyze      : a run's per-epoch table and metrics plot, a frequency
                 table's audit
  convert-ckpt : a reference (torch) checkpoint -> a port checkpoint
                 directory that ``infer``/``serve --model_path`` and
                 ``train --init-from`` take
  export-ckpt  : a port checkpoint -> a reference state_dict
The model and the index live on the card unless ``--device cpu`` is given
(the CLI form of the port's ``device="cpu"`` rule).  An orbax checkpoint of
the JAX package cannot be read here (no JAX): export it with the JAX
package's ``export-ckpt``, then ``convert-ckpt`` the file.

Scale-out (``query --index-shards``, ``train --data-parallel /
--index-shards / --tensor-parallel``, ``infer``/``serve --data-parallel``):
the verb runs on every rank of a process group, one rank per shard of the
mesh.  Under torchrun it joins the world it finds; otherwise it starts
that many local ranks itself (this process is rank 0).
``--dist-backend`` picks NCCL (the default on the card) or gloo (the CPU,
or ranks that share one card).  Rank 0 prints and writes the outputs.

Run as ``python -m rag_snvbert_tpu_torch.cli.main <verb> --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import is_writer


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="where the model or index lives: the card by "
                        "default, 'cpu' to run off the card")


def _add_dist_backend(p):
    p.add_argument("--dist-backend", dest="dist_backend", default=None,
                   choices=["nccl", "gloo"],
                   help="process-group backend of a run over several ranks: "
                        "nccl (the default on the card) or gloo (the only "
                        "one with --device cpu, and for ranks that share "
                        "one card)")


def _say(*a, **kw) -> None:
    """``print`` on rank 0 only."""
    if is_writer():
        print(*a, **kw)


def _world_size(args) -> int:
    """Ranks the verb's mesh needs (1: a single-process run)."""
    if args.cmd == "query":
        return args.index_shards
    if args.cmd == "train":
        return args.data_parallel * args.index_shards * args.tensor_parallel
    if args.cmd in ("infer", "serve"):
        return args.data_parallel
    return 1


def _backend(args) -> str:
    """The explicit backend: ``--dist-backend``, else nccl on the card and
    gloo with ``--device cpu`` (NCCL carries only CUDA tensors)."""
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if args.dist_backend is None:
        return "gloo" if cpu else "nccl"
    if args.dist_backend == "nccl" and cpu:
        raise SystemExit("--dist-backend nccl needs the card; pass "
                         "--dist-backend gloo with --device cpu")
    return args.dist_backend


def _mesh(args, n_data: int = 1, n_index: int = 1, n_model: int = 1):
    """The verb's mesh over the process group (None for one rank)."""
    if n_data * n_index * n_model == 1:
        return None
    from ..device import resolve_device
    from ..parallel.mesh import make_mesh

    return make_mesh(n_data, n_index, n_model,
                     device=resolve_device(args.device))


def _add_model_args(p):
    p.add_argument("--dims", type=int, default=384)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--attn-heads", type=int, default=12)
    p.add_argument("--seq-len", type=int, default=1030)
    p.add_argument("--rag-k", type=int, default=None)


# ---------------------------------------------------------------------------
# prepare-data
# ---------------------------------------------------------------------------

def cmd_prepare_data(args):
    from ..io.freq import FreqTable, build_freq_matrix
    from ..io.panel import PanelData
    from ..io.vcf import load_vcf_or_hdf5
    from ..io.windows import Window

    os.makedirs(args.out, exist_ok=True)
    data = load_vcf_or_hdf5(args.vcf)
    print(f"loaded {data.n_variants} sites x {data.n_samples} samples")
    panel = PanelData.from_file(args.panel)
    panel.save_pop_json(os.path.join(args.out, "POP.json"))
    pop_class = np.asarray([panel.pop_to_class[p] for p in panel.pop_list])
    freq = FreqTable(build_freq_matrix(data.gt, pop_class,
                                       len(panel.pop_to_class)), data.pos)
    freq.save(os.path.join(args.out, "freq"))
    print(f"freq table: {freq.freq.shape}")
    win = Window.fixed_stride(data.n_variants, args.window_len)
    win.save_csv(os.path.join(args.out, "windows.csv"))
    print(f"windows: {win.count} x <= {args.window_len} sites")
    if args.split_test_fraction > 0:
        tr, te = panel.split_stratified(args.split_test_fraction, args.seed)
        np.save(os.path.join(args.out, "train_samples.npy"), np.asarray(tr))
        np.save(os.path.join(args.out, "test_samples.npy"), np.asarray(te))
        print(f"split: {len(tr)} train / {len(te)} test samples")


# ---------------------------------------------------------------------------
# build-index
# ---------------------------------------------------------------------------

def cmd_build_index(args):
    """Genotype-space database: per window, the samples' rows
    ``[samples, win_len * 2]`` (``window_{w}.npy``), the positions, the
    population labels with ``--panel``, and with ``--mode flat`` the
    aligned flat-L2 index in ``--dtype`` storage (``window_{w}.idx.npz``);
    ``meta.json``."""
    from ..device import resolve_device
    from ..index.flat import FlatL2Index
    from ..io.vcf import load_vcf_or_hdf5
    from ..io.windows import Window

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    data = load_vcf_or_hdf5(args.vcf)
    pop_labels = None
    if args.panel:
        from ..io.panel import PanelData

        panel = PanelData.from_file(args.panel)
        if panel.n_samples != data.n_samples:
            raise SystemExit(f"panel has {panel.n_samples} samples, VCF "
                             f"{data.n_samples}")
        pop_labels = np.asarray(panel.pop_list, object)
    win = (Window.from_file(args.windows) if args.windows
           else Window.fixed_stride(data.n_variants, args.window_len))
    t0 = time.time()
    for w in range(win.count):
        s, e = win.bounds(w)
        flat = data.gt[s:e].transpose(1, 0, 2).reshape(data.n_samples, -1)
        np.save(os.path.join(args.out, f"window_{w}.npy"), flat)
        np.save(os.path.join(args.out, f"window_{w}_pos.npy"), data.pos[s:e])
        if pop_labels is not None:
            np.save(os.path.join(args.out, f"window_{w}_pop.npy"), pop_labels)
        if args.mode == "flat":
            if args.dtype == "packed":   # 8 binary genotypes a byte
                idx = FlatL2Index.build(flat.astype(np.int8), pack=8,
                                        align=True, device=device)
            else:
                dt = {"f32": torch.float32, "bf16": torch.bfloat16,
                      "int8": torch.int8}[args.dtype]
                idx = FlatL2Index.build(flat.astype(np.float32), dtype=dt,
                                        align=True, device=device)
            idx.save(os.path.join(args.out, f"window_{w}.idx"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    meta = {"windows": win.count, "n_samples": data.n_samples,
            "mode": args.mode, "build_seconds": round(time.time() - t0, 3)}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(json.dumps(meta))


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------

def cmd_query(args):
    """Batch query engine with per-window timing.  Modes: flat (persisted
    shards), intersect (position intersection, then a temporary index over
    the common sites; ``--hamming`` for the XOR + popcount engine),
    partial (masked search over the persisted index, no rebuild)."""
    from ..device import resolve_device
    from ..index.flat import FlatL2Index, HammingIndex
    from ..index.sharded import ShardedFlatL2Index
    from ..io.vcf import load_vcf_or_hdf5

    if args.index_shards > 1 and (args.mode == "partial" or args.hamming):
        raise SystemExit("--index-shards supports the L2 flat/intersect "
                         "modes (masked/partial search and Hamming run on "
                         "one rank)")
    device = resolve_device(args.device)
    mesh = _mesh(args, n_index=args.index_shards)

    def build_sharded(rows: np.ndarray, like: str | None):
        """The sharded index over the mesh, in the storage of the persisted
        index ``like`` (float32 without one)."""
        if like is None:
            return ShardedFlatL2Index.build(mesh, rows.astype(np.float32),
                                            device=device)
        z = np.load(like + ".npz")
        pack = int(z["pack"]) if "pack" in z else 1
        if pack > 1:
            return ShardedFlatL2Index.build(mesh, rows.astype(np.int8),
                                            pack=pack, device=device)
        tag = str(z["dtype"]) if "dtype" in z else "float32"
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8, "int4": "int4"}[tag]
        return ShardedFlatL2Index.build(mesh, rows.astype(np.float32),
                                        dtype=dt, device=device)
    data = load_vcf_or_hdf5(args.vcf)
    with open(os.path.join(args.db, "meta.json")) as f:
        meta = json.load(f)
    totals = {"build_t": 0.0, "search_t": 0.0, "n_queries": 0}
    for w in range(meta["windows"]):
        ref_flat = np.load(os.path.join(args.db, f"window_{w}.npy"))
        ref_pos = np.load(os.path.join(args.db, f"window_{w}_pos.npy"))
        t0 = time.time()
        # the target's row at each window position (valid where common)
        found = np.clip(np.searchsorted(data.pos, ref_pos), 0,
                        len(data.pos) - 1)
        common = data.pos[found] == ref_pos
        if args.mode == "intersect":
            ref_sub = ref_flat[:, np.repeat(common, 2)]
            q = data.gt[found[common]].transpose(1, 0, 2).reshape(
                data.n_samples, -1).astype(np.float32)
            if args.hamming:
                idx = HammingIndex.build(ref_sub, device=device)
                query = torch.from_numpy(q.astype(np.int8))
            elif mesh is not None:
                idx, query = build_sharded(ref_sub, like=None), q
            else:
                idx = FlatL2Index.build(ref_sub.astype(np.float32),
                                        device=device)
                query = q
            build_t = time.time() - t0
            t0 = time.time()
            vals, ids = idx.search(query, args.k)
        else:
            path = os.path.join(args.db, f"window_{w}.idx")
            # the .npy rows are the vectors the .idx was built from
            idx = (build_sharded(ref_flat, like=path) if mesh is not None
                   else FlatL2Index.load(path, device=device))
            g = data.gt[np.where(common, found, 0)]          # [n, S, 2]
            g = np.where(common[:, None, None], g, 0)
            q = g.transpose(1, 0, 2).reshape(data.n_samples,
                                              -1).astype(np.float32)
            build_t = time.time() - t0
            t0 = time.time()
            if args.mode == "partial":
                vals, ids = idx.masked_search(
                    q, np.repeat(common, 2).astype(np.float32), args.k)
            else:
                vals, ids = idx.search(q, args.k)
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        search_t = time.time() - t0
        totals["build_t"] += build_t
        totals["search_t"] += search_t
        totals["n_queries"] += q.shape[0]
        if args.save_results and is_writer():
            os.makedirs(args.save_results, exist_ok=True)
            np.save(os.path.join(args.save_results, f"window_{w}_ids.npy"),
                    ids)
            np.save(os.path.join(args.save_results, f"window_{w}_vals.npy"),
                    vals)
        if args.verbose and is_writer():
            # best hit, its population where the database has labels, and
            # target-vs-neighbour allele snippets (test_faiss.py's check)
            best = int(ids[0][0])
            line = (f"window {w}: build {build_t:.3f}s search "
                    f"{search_t:.3f}s best id {best} dist {vals[0][0]:.1f}")
            pop_path = os.path.join(args.db, f"window_{w}_pop.npy")
            if os.path.exists(pop_path):
                pops = np.load(pop_path, allow_pickle=True)
                if best < len(pops):
                    line += f" pop {pops[best]}"
            print(line)
            ref_rows = ref_sub if args.mode == "intersect" else ref_flat
            show = min(args.show_snp_len * 2, q.shape[1])
            print(f"  target snippet => "
                  f"{q[0, :show].astype(np.int8).tolist()}")
            print(f"  neighb snippet => "
                  f"{ref_rows[best, :show].astype(np.int8).tolist()}")
    totals["qps"] = round(totals["n_queries"]
                          / max(totals["search_t"], 1e-9), 1)
    _say(json.dumps(totals))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _resolve_trainer_config(args, base):
    """Preset-first hyperparameters: the preset supplies the versioned
    recipe (lr, batch, gamma, warmup, ...) and an explicit flag overrides
    it, so ``train --preset v17_token_rag`` reproduces the v17 recipe."""
    from ..train.trainer import TrainerConfig

    def pick(flag_value, preset_value):
        return preset_value if flag_value is None else flag_value

    return TrainerConfig(
        rag_mode=base.model.rag_mode,
        epochs=pick(args.epochs, base.epochs),
        batch_size=pick(args.train_batch_size, base.batch_size),
        val_batch_size=pick(args.val_batch_size, base.val_batch_size),
        init_lr=pick(args.init_lr, base.init_lr),
        max_lr=pick(args.lr, base.max_lr),
        warmup_steps=pick(args.warmup_steps, base.warmup_steps),
        grad_accum_steps=pick(args.grad_accum_steps, base.grad_accum_steps),
        focal_gamma=pick(args.focal_gamma, base.focal_gamma),
        use_recon_loss=base.use_recon_loss,
        rag_k=pick(args.rag_k, base.rag_k),
        rare_threshold=pick(args.rare_threshold, base.rare_threshold),
        patience=pick(args.patience, base.patience),
        min_delta=pick(args.min_delta, base.min_delta),
        output_dir=args.output_path,
        log_freq=args.log_freq, seed=args.seed,
        rng_impl=args.rng_impl, prefetch_ctx=args.prefetch_ctx,
        prefetch_batches=args.prefetch_batches,
        mask_schedule=args.mask_schedule,
        steps_per_dispatch=args.steps_per_dispatch,
        shard_ctx={"auto": "auto", "on": True, "off": False}[args.shard_ctx],
        ctx_merge=args.ctx_merge,
        profile_dir=args.profile_dir, profile_steps=args.profile_steps)


def cmd_train(args):
    import dataclasses

    from ..config import build_model, get_preset
    from ..data.pipeline import WindowDataset
    from ..device import resolve_device
    from ..io.panel import PanelData
    from ..io.vcf import load_vcf_or_hdf5
    from ..io.vocab import Vocab
    from ..io.windows import Window
    from ..interop import load_convert_meta
    from ..train.trainer import Trainer

    device = resolve_device(args.device)
    mesh = _mesh(args, args.data_parallel, args.index_shards,
                 args.tensor_parallel)
    preset = get_preset(args.preset) if args.preset else None
    base = preset or get_preset("v18_embedding_rag")
    if preset is None:
        base = dataclasses.replace(base, model=dataclasses.replace(
            base.model, dims=args.dims, n_layers=args.layers,
            attn_heads=args.attn_heads))

    train_vcf = load_vcf_or_hdf5(args.train_dataset)
    panel = PanelData.from_file(args.train_panel)
    win = Window.from_file(args.window_path)
    ref_vcf = load_vcf_or_hdf5(args.refpanel_path)
    freq = _load_freq(args.freq_path, ref_vcf)
    vocab = Vocab.from_panel_pops(panel.pop_list)
    train_ds = WindowDataset(train_vcf, panel, freq, win.window_info, vocab,
                             ref_vcf=ref_vcf, seq_len=args.seq_len)
    val_ds = None
    if args.val_dataset:
        val_vcf = load_vcf_or_hdf5(args.val_dataset)
        val_panel = PanelData.from_file(args.val_panel or args.train_panel)
        val_ds = WindowDataset(val_vcf, val_panel, freq, win.window_info,
                               vocab, ref_vcf=ref_vcf, seq_len=args.seq_len)
    # single-cohort train/val through prepare-data's stratified split
    train_ids = np.load(args.train_samples) if args.train_samples else None
    val_ids = np.load(args.val_samples) if args.val_samples else None

    init_meta = load_convert_meta(args.init_from) if args.init_from else None
    if init_meta is not None:
        # Fine-tuning a converted reference checkpoint: the architecture
        # comes from convert_meta.json (post-LN, frozen BatchNorm
        # statistics, per-block parameters); the rest of the model config
        # (dtypes, attention route) from the preset, and the trainer's
        # retrieval mode follows the checkpoint (JAX cli/main.py:382-407).
        if init_meta["vocab_size"] != vocab.size:
            raise SystemExit(
                f"converted checkpoint vocab_size={init_meta['vocab_size']} "
                f"!= panel vocab {vocab.size}: population sets differ")
        base = dataclasses.replace(base, model=dataclasses.replace(
            base.model, **_converted_arch(init_meta)))
    # weights from the run's seed, as the JAX trainer draws its init
    model = build_model(base, vocab.size, device=device, seed=args.seed)
    trainer = Trainer(model, train_ds, _resolve_trainer_config(args, base),
                      val_ds=val_ds, mesh=mesh, train_sample_ids=train_ids,
                      val_sample_ids=val_ids)
    if args.resume_path:
        trainer.restore_checkpoint(args.resume_path)
    elif args.init_from:
        trainer.init_params_from(args.init_from)
    result = trainer.fit()
    _say(json.dumps({"best": result["best"],
                     "best_epoch": result["best_epoch"]}))


# ---------------------------------------------------------------------------
# infer / serve
# ---------------------------------------------------------------------------

def _converted_arch(meta: dict) -> dict:
    """The ModelConfig fields a converted checkpoint fixes."""
    return dict(dims=meta["dims"], n_layers=meta["n_layers"],
                attn_heads=meta["attn_heads"], rag_mode=meta["rag_mode"],
                pre_ln=meta.get("pre_ln", False),
                pos_norm=meta.get("pos_norm", "frozen_batch"),
                compat_double_softmax=meta.get("compat_double_softmax",
                                               False),
                # converted parameters are per-block and unfused
                scan_layers=False, fused_qkv=False)


def _load_infer_model(args):
    """The model of ``--preset`` (or the model flags) with the parameters
    of ``--model_path``, a port checkpoint directory (``state.pt``: the
    trainer's ``ckpt_ep{N}``/``best``, of which only the ``params`` are
    read, or a converted reference checkpoint, whose architecture comes
    from its ``convert_meta.json`` as in JAX cli/main.py:466-495).
    Returns ``(model, rag_mode)``; shared by ``infer`` and ``serve``."""
    from ..config import ModelConfig, RunConfig, build_model, get_preset
    from ..device import resolve_device
    from ..interop import load_convert_meta

    state_path = os.path.join(args.model_path, "state.pt")
    if not os.path.exists(state_path):
        raise SystemExit(
            f"--model_path {args.model_path!r} holds no state.pt, so it is "
            "not a checkpoint of this package.  An orbax checkpoint of the "
            "JAX package cannot be read without JAX: write it out as a "
            "reference state_dict with the JAX package's export-ckpt, then "
            "convert that file with this package's convert-ckpt (ROADMAP "
            "Queue A, item A9)")
    device = resolve_device(args.device)
    cmeta = load_convert_meta(args.model_path)
    if args.panel:
        from ..io.panel import PanelData
        from ..io.vocab import Vocab

        vocab_size = Vocab.from_panel_pops(
            PanelData.from_file(args.panel).pop_list).size
    else:
        vocab_size = args.vocab_size
    rag_mode = args.rag_mode
    if cmeta is not None:
        # a converted reference checkpoint: the architecture it recorded;
        # dtypes and attention dropout from the flags
        if rag_mode is None:
            rag_mode = cmeta["rag_mode"]
        vocab_size = cmeta["vocab_size"]
        cfg = RunConfig(model=ModelConfig(
            **{**_converted_arch(cmeta), "rag_mode": rag_mode},
            bf16=args.bf16, score_bf16=args.score_bf16,
            attn_dropout=0.0 if args.no_attn_dropout else None))
    elif args.preset:
        cfg = get_preset(args.preset)
        if rag_mode is None:
            rag_mode = cfg.model.rag_mode
    else:
        if rag_mode is None:
            rag_mode = "embedding"
        cfg = RunConfig(model=ModelConfig(
            dims=args.dims, n_layers=args.layers, attn_heads=args.attn_heads,
            rag_mode=rag_mode, pre_ln=args.pre_ln,
            scan_layers=args.scan_layers, remat=args.remat, bf16=args.bf16,
            attn_dropout=0.0 if args.no_attn_dropout else None,
            score_bf16=args.score_bf16))
    model = build_model(cfg, vocab_size, device=device)
    # a trainer's checkpoint and a converted one hold the port model's
    # state_dict alike
    model.load_state_dict(torch.load(state_path, map_location=device,
                                     weights_only=True)["params"])
    return model, rag_mode


def _load_freq(path: str, ref_vcf):
    """A frequency table: prepare-data's ``freq.npz``, or a
    reference-format ``Freq.npy`` (``freq[4, P+1, V]`` whose columns follow
    the reference panel's site order, prepare_data_v4_0411.py:170-235)."""
    from ..io.freq import FreqTable

    if str(path).endswith(".npy"):
        return FreqTable.load_reference_npy(path, ref_vcf.pos)
    return FreqTable.load(path)


def _imputer_kw(args, rag_mode: str) -> dict:
    return dict(window_len=args.infer_window_len, seq_len=args.seq_len,
                rag_k=args.rag_k if args.rag_k is not None else 1,
                batch_size=args.batch_size, rag_mode=rag_mode,
                index_dir=args.index_dir, device=args.device,
                mesh=_mesh(args, args.data_parallel))


def cmd_infer(args):
    from ..infer.imputer import Imputer
    from ..io.vcf import load_vcf_or_hdf5

    model, rag_mode = _load_infer_model(args)
    ref_vcf = load_vcf_or_hdf5(args.refpanel_path)
    target = load_vcf_or_hdf5(args.target)
    freq = _load_freq(args.freq_path, ref_vcf)
    imp = Imputer(model, ref_vcf, freq, **_imputer_kw(args, rag_mode))
    if args.save_index_dir and is_writer():
        manifest = imp.save_window_indexes(args.save_index_dir, target)
        print(json.dumps({"saved_indexes": manifest}))
    if args.progressive_rounds > 1:
        res = imp.impute_progressive(target, rounds=args.progressive_rounds)
    else:
        res = imp.impute(target)
    if not is_writer():
        return
    if args.npy_prefix:
        res.save_npy(args.npy_prefix)
    res.write_vcf(args.output_vcf, ref_vcf, target.samples)
    print(json.dumps({"sites": int(res.pos.shape[0]),
                      "samples": len(target.samples),
                      "imputed_sites": int(res.imputed_flag.sum())}))


def cmd_serve(args):
    """The persistent service (infer/serve.py): model and reference panel
    load once, then JSON-lines requests on stdin -> responses on stdout,
    or HTTP with ``--http``.  Request: {"target": path, "output_vcf":
    path, "npy_prefix"?: path, "progressive_rounds"?: int}.  At the end,
    stderr gets ``{"served": N, "launches": {kernel: count}}``."""
    from .. import ops
    from ..infer.serve import BatchingImputationService, ImputationService
    from ..io.vcf import load_vcf_or_hdf5

    if args.http is not None:
        host, _, port = args.http.rpartition(":")
        if not port.isdigit():
            raise SystemExit(
                f"serve: --http expects [HOST:]PORT, got {args.http!r}")
    model, rag_mode = _load_infer_model(args)
    ref_vcf = load_vcf_or_hdf5(args.refpanel_path)
    freq = _load_freq(args.freq_path, ref_vcf)
    # HTTP: concurrent clients, cross-request batched scheduling; the
    # stdin JSON-lines loop is one request at a time by nature.
    svc_cls = (BatchingImputationService if args.http is not None
               else ImputationService)
    svc = svc_cls.create(model, ref_vcf, freq, **_imputer_kw(args, rag_mode))
    if not is_writer():          # a mesh's other ranks: rank 0's requests
        svc.follow()
        return
    try:
        if args.http is not None:
            from ..infer.httpd import serve_http

            serve_http(svc, host or "127.0.0.1", int(port))
            return
        print(json.dumps({"ready": True, "ref_sites": ref_vcf.n_variants}),
              flush=True)
        n = svc.serve_lines(sys.stdin, sys.stdout)
        print(json.dumps({"served": n, "launches": ops.launch_counts()}),
              file=sys.stderr)
    finally:
        svc.release()


# ---------------------------------------------------------------------------
# emit-vcf
# ---------------------------------------------------------------------------

def cmd_emit_vcf(args):
    """NPY probability matrices -> imputed VCF (generate_vcf.py:1-46: the
    save_npy_result layout of ``infer --npy_prefix``)."""
    from ..io.vcf import load_vcf_or_hdf5, write_imputed_vcf

    hap1 = np.load(args.npy_prefix + ".HAP1.npy")
    hap2 = np.load(args.npy_prefix + ".HAP2.npy")
    pos = np.load(args.npy_prefix + ".POS.npy")
    flag = np.load(args.npy_prefix + ".POS_Flag.npy")
    ref_vcf = load_vcf_or_hdf5(args.refpanel_path)
    samples = (args.samples.split(",") if args.samples
               else [f"S{i}" for i in range(hap1.shape[1])])
    write_imputed_vcf(args.output_vcf, ref_vcf.chrom, pos, ref_vcf.ref,
                      ref_vcf.alt, samples, hap1, hap2, imputed_flag=flag)
    print(json.dumps({"sites": int(pos.shape[0]), "samples": len(samples)}))


# ---------------------------------------------------------------------------
# analyze / convert-ckpt / export-ckpt
# ---------------------------------------------------------------------------

def cmd_analyze(args):
    """Training-run analysis: the per-epoch table, the metrics plot and a
    frequency-table audit (scripts/analyze_training_log.py /
    plot_metrics_csv.py / test_fq.py).  The plot needs matplotlib: without
    it the table is printed and the verb fails naming matplotlib, unless
    ``--no-plot`` is given."""
    from ..utils.analyze import (epoch_summary, format_table, inspect_freq,
                                 plot_metrics)

    if args.run_dir:
        print(format_table(epoch_summary(args.run_dir)), flush=True)
        if not args.no_plot:
            print(f"plot: {plot_metrics(args.run_dir)}")
    if args.freq_path:
        print(json.dumps(inspect_freq(args.freq_path), indent=2))


def cmd_convert_ckpt(args):
    """Reference torch checkpoint -> a port checkpoint directory
    (``state.pt`` + ``convert_meta.json``) for ``infer``/``serve
    --model_path`` and ``train --init-from``.  Takes raw state_dict pickles
    and, with ``--ref-src`` (the RAG-SNVBERT source whose classes the
    pickle names), the reference trainer's whole-module pickles
    (src/main/pretrain_with_val_optimized.py:524-548)."""
    from ..interop import (convert_state_dict, load_torch_checkpoint,
                           save_converted)

    sd, heads = load_torch_checkpoint(args.torch_ckpt, ref_src=args.ref_src)
    params, meta = convert_state_dict(sd, rag_mode=args.rag_mode)
    meta["attn_heads"] = args.attn_heads or heads
    if meta["attn_heads"] is None:
        raise SystemExit("attention head count is not recoverable from a "
                         "raw state_dict: pass --attn-heads")
    save_converted(params, meta, args.out)
    print(json.dumps({k: meta[k] for k in
                      ("dims", "n_layers", "attn_heads", "vocab_size",
                       "rag_mode")} | {"out": os.path.abspath(args.out)}))


def cmd_export_ckpt(args):
    """A port checkpoint (a trainer's ``ckpt_ep{N}`` or a converted one) ->
    reference torch state_dict, the reverse of convert-ckpt: load it in the
    reference codebase with ``model.load_state_dict(torch.load(path))``.
    Exact for ``pos_norm="frozen_batch"`` models (converted or fine-tuned
    reference checkpoints); GroupNorm models need ``--approx-pos-norm``
    (the position branch's numerics differ)."""
    from ..interop import export_state_dict, load_params_checkpoint

    params = load_params_checkpoint(args.ckpt)
    sd = export_state_dict(params, approx_pos_norm=args.approx_pos_norm)
    # np.array keeps the 0-d res_scale tensors 0-d (np.ascontiguousarray,
    # as the JAX package's export-ckpt writes them, makes them [1], which
    # the reference's load_state_dict refuses)
    torch.save({k: torch.from_numpy(np.array(v, order="C")) for k, v
                in sd.items()}, args.out)
    print(json.dumps({"keys": len(sd), "out": os.path.abspath(args.out)}))


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rag-snvbert-tpu-torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prepare-data")
    pp.add_argument("--vcf", required=True)
    pp.add_argument("--panel", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--window-len", type=int, default=1020)
    pp.add_argument("--split-test-fraction", type=float, default=0.0)
    pp.add_argument("--seed", type=int, default=0)
    pp.set_defaults(fn=cmd_prepare_data)

    pb = sub.add_parser("build-index")
    pb.add_argument("--vcf", required=True)
    pb.add_argument("--out", required=True)
    pb.add_argument("--windows", default=None)
    pb.add_argument("--window-len", type=int, default=1020)
    pb.add_argument("--mode", choices=["flat", "intersect"], default="flat")
    pb.add_argument("--dtype", choices=["f32", "bf16", "int8", "packed"],
                    default="f32",
                    help="index storage: int8 is exact for binary genotypes "
                         "and searched by the int8 kernel; packed stores 8 "
                         "genotypes a byte, still exact L2")
    pb.add_argument("--panel", default=None,
                    help="panel file: stores per-row population labels "
                         "(window_*_pop.npy) for query --verbose")
    _add_device(pb)
    pb.set_defaults(fn=cmd_build_index)

    pq = sub.add_parser("query")
    pq.add_argument("--vcf", required=True, help="target samples VCF/H5")
    pq.add_argument("--db", required=True)
    pq.add_argument("--k", type=int, default=10)
    pq.add_argument("--mode", choices=["flat", "intersect", "partial"],
                    default="flat")
    pq.add_argument("--hamming", action="store_true",
                    help="binary XOR + popcount engine (the reference's "
                         "IndexBinaryFlat); ranks 0/1 data as L2 does")
    pq.add_argument("--verbose", action="store_true",
                    help="per-window best-hit line with the neighbour's "
                         "population and allele snippets")
    pq.add_argument("--save-results", dest="save_results", default=None,
                    help="directory for per-window ids/distances .npy")
    pq.add_argument("--index-shards", dest="index_shards", type=int,
                    default=1,
                    help="shard each window's index over this many ranks "
                         "(mesh 'index' axis; exact candidate merge), the "
                         "offline counterpart of train --index-shards")
    pq.add_argument("--show-snp-len", type=int, default=10,
                    help="alleles per snippet in --verbose output")
    _add_device(pq)
    _add_dist_backend(pq)
    pq.set_defaults(fn=cmd_query)

    pt = sub.add_parser("train")
    pt.add_argument("--preset", default=None,
                    help="named config preset (rag_snvbert_tpu_torch/"
                         "config.py)")
    pt.add_argument("--train_dataset", required=True)
    pt.add_argument("--train_panel", required=True)
    pt.add_argument("--val_dataset", default=None)
    pt.add_argument("--val_panel", default=None)
    pt.add_argument("--refpanel_path", required=True)
    pt.add_argument("--freq_path", required=True)
    pt.add_argument("--window_path", required=True)
    _add_model_args(pt)
    # Run hyperparameters default to None: unset flags inherit the preset's
    # recipe (or the v18 defaults without --preset); set flags override.
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--train_batch_size", type=int, default=None)
    pt.add_argument("--val_batch_size", type=int, default=None)
    pt.add_argument("--lr", type=float, default=None)
    pt.add_argument("--init_lr", type=float, default=None)
    pt.add_argument("--warmup_steps", type=int, default=None)
    pt.add_argument("--grad_accum_steps", type=int, default=None)
    pt.add_argument("--focal_gamma", type=float, default=None)
    pt.add_argument("--patience", type=int, default=None)
    pt.add_argument("--min_delta", type=float, default=None)
    pt.add_argument("--rare_threshold", type=float, default=None)
    pt.add_argument("--resume_path", default=None)
    pt.add_argument("--init-from", dest="init_from", default=None,
                    help="warm-start the weights from a checkpoint dir (a "
                         "converted reference checkpoint or another run's "
                         "ckpt_ep*) with a fresh optimizer")
    pt.add_argument("--output_path", required=True)
    pt.add_argument("--log_freq", type=int, default=500)
    pt.add_argument("--seed", type=int, default=42)
    pt.add_argument("--train-samples", dest="train_samples", default=None,
                    help=".npy sample-index subset for training "
                         "(prepare-data --split-test-fraction output)")
    pt.add_argument("--val-samples", dest="val_samples", default=None,
                    help=".npy sample-index subset for validation on the "
                         "training cohort (single-VCF train/val)")
    pt.add_argument("--data-parallel", dest="data_parallel", type=int,
                    default=1, help="ranks on the mesh data axis (each "
                    "takes its rows of every batch)")
    pt.add_argument("--index-shards", dest="index_shards", type=int,
                    default=1, help="ranks on the mesh index axis "
                    "(shards the retrieval context)")
    pt.add_argument("--tensor-parallel", dest="tensor_parallel", type=int,
                    default=1, help="ranks on the mesh model axis "
                    "(Megatron encoder tensor parallelism; must divide "
                    "dims and the FFN width; a rank whose columns split "
                    "a head gathers that head's columns)")
    pt.add_argument("--shard-ctx", dest="shard_ctx",
                    choices=["auto", "on", "off"], default="auto",
                    help="shard the window context over the index axis "
                         "('auto': when --index-shards > 1)")
    pt.add_argument("--ctx-merge", dest="ctx_merge",
                    choices=["all_gather", "ring"], default="all_gather")
    pt.add_argument("--prefetch-ctx", dest="prefetch_ctx",
                    action="store_true",
                    help="build the next window's retrieval context behind "
                         "the current window's steps")
    pt.add_argument("--prefetch-batches", dest="prefetch_batches", type=int,
                    default=2, help="host batch prefetch depth (0 = sync)")
    pt.add_argument("--steps-per-dispatch", dest="steps_per_dispatch",
                    type=int, default=1,
                    help="training micro-steps per dispatch: chunks of up "
                         "to K same-window batches, each one CUDA graph "
                         "replay on the card, with the semantics of K "
                         "single steps")
    pt.add_argument("--rng-impl", dest="rng_impl",
                    choices=["rbg", "threefry2x32"], default="rbg")
    pt.add_argument("--mask-schedule", dest="mask_schedule",
                    choices=["level", "cosine", "linear", "exponential"],
                    default="level")
    pt.add_argument("--profile-dir", dest="profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of "
                         "--profile-steps steady micro-steps of the first "
                         "epoch here")
    pt.add_argument("--profile-steps", dest="profile_steps", type=int,
                    default=4)
    _add_device(pt)
    _add_dist_backend(pt)
    pt.set_defaults(fn=cmd_train)

    def add_infer_model_args(p):
        p.add_argument("--refpanel_path", required=True)
        p.add_argument("--freq_path", required=True)
        p.add_argument("--model_path", required=True,
                       help="a checkpoint dir of the port (the trainer's "
                            "ckpt_ep{N} or best, or convert-ckpt's output: "
                            "state.pt)")
        p.add_argument("--vocab_size", type=int, default=12,
                       help="used only when --panel is not given")
        p.add_argument("--panel", default=None,
                       help="panel file to derive the vocab size from")
        _add_model_args(p)
        p.add_argument("--infer_window_len", type=int, default=1020)
        p.add_argument("--preset", default=None)
        p.add_argument("--pre_ln", action="store_true")
        p.add_argument("--scan_layers", action="store_true")
        p.add_argument("--remat", action="store_true")
        p.add_argument("--bf16", action="store_true")
        p.add_argument("--score_bf16", action="store_true")
        p.add_argument("--no_attn_dropout", action="store_true")
        p.add_argument("--batch_size", type=int, default=32)
        p.add_argument("--data-parallel", dest="data_parallel", type=int,
                       default=1, help="split each query batch over this "
                       "many ranks (mesh data axis) for serving scale-out")
        p.add_argument("--rag-mode", dest="rag_mode", default=None,
                       choices=["embedding", "token", "none"],
                       help="retrieval mode; defaults to the preset's (or "
                            "embedding): 'token' serves v17_token_rag "
                            "checkpoints, 'none' the no-RAG presets")
        p.add_argument("--index-dir", dest="index_dir", default=None,
                       help="load persisted per-window embedding indexes "
                            "(written by --save-index-dir) instead of "
                            "re-encoding the reference panel")
        _add_device(p)
        _add_dist_backend(p)

    pi = sub.add_parser("infer")
    pi.add_argument("--target", required=True)
    pi.add_argument("--output_vcf", required=True)
    pi.add_argument("--npy_prefix", default=None)
    add_infer_model_args(pi)
    pi.add_argument("--progressive_rounds", type=int, default=1)
    pi.add_argument("--save-index-dir", dest="save_index_dir", default=None,
                    help="persist per-window embedding indexes for this "
                         "target's mask pattern, then impute")
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("serve", help="persistent imputation service "
                        "(JSON-lines requests on stdin, or --http)")
    add_infer_model_args(ps)
    ps.add_argument("--http", default=None, metavar="[HOST:]PORT",
                    help="serve over HTTP (GET /health, POST /impute) "
                         "instead of stdin/stdout JSON lines")
    ps.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("emit-vcf")
    pe.add_argument("--npy_prefix", required=True)
    pe.add_argument("--refpanel_path", required=True)
    pe.add_argument("--output_vcf", required=True)
    pe.add_argument("--samples", default=None,
                    help="comma-separated sample names")
    pe.set_defaults(fn=cmd_emit_vcf)

    pa = sub.add_parser("analyze")
    pa.add_argument("--run_dir", default=None)
    pa.add_argument("--freq_path", default=None)
    pa.add_argument("--no-plot", dest="no_plot", action="store_true",
                    help="print the table without drawing metrics.png "
                         "(the plot needs matplotlib)")
    pa.set_defaults(fn=cmd_analyze)

    pc = sub.add_parser("convert-ckpt", help="convert a trained reference "
                        "(torch) checkpoint for this package")
    pc.add_argument("--torch_ckpt", required=True,
                    help="reference checkpoint (whole-module pickle, e.g. "
                         "rag_bert.model.ep12, or a raw state_dict)")
    pc.add_argument("--out", required=True, help="output checkpoint dir "
                    "(usable as infer/serve --model_path)")
    pc.add_argument("--ref-src", dest="ref_src", default=None,
                    help="RAG-SNVBERT repo root, required to unpickle "
                         "whole-module checkpoints")
    pc.add_argument("--attn-heads", dest="attn_heads", type=int, default=None,
                    help="needed only for raw state_dicts (not inferable "
                         "from tensor shapes)")
    pc.add_argument("--rag-mode", dest="rag_mode", default=None,
                    choices=["embedding", "token", "none"],
                    help="override auto-detection (V17 token checkpoints "
                         "share V18's parameter surface: pass 'token')")
    pc.set_defaults(fn=cmd_convert_ckpt)

    px = sub.add_parser("export-ckpt", help="export a checkpoint as a "
                        "reference (torch) state_dict")
    px.add_argument("--ckpt", required=True,
                    help="trainer checkpoint dir or converted checkpoint dir")
    px.add_argument("--out", required=True, help="output .pt path")
    px.add_argument("--approx-pos-norm", dest="approx_pos_norm",
                    action="store_true",
                    help="allow exporting GroupNorm-trained models with "
                         "identity-stats BatchNorm (numerics differ in the "
                         "position branch)")
    px.set_defaults(fn=cmd_export_ckpt)
    return p


def _rank_main(rank: int, argv: list) -> None:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    world = _world_size(args)
    if world > 1 and not dist.is_initialized():
        from ..parallel.launch import run_with_local_ranks
        from ..parallel.mesh import init_distributed

        backend = _backend(args)
        if "WORLD_SIZE" not in os.environ:      # not under torchrun
            return run_with_local_ranks(_rank_main, world, (argv,), backend)
        init_distributed(backend)
        if dist.get_world_size() != world:
            raise SystemExit(f"the mesh needs {world} ranks; torchrun "
                             f"started {dist.get_world_size()}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
