"""Reference (torch) checkpoint <-> the port's models.

The counterpart of the numpy half of rag_snvbert_tpu/interop/torch_ckpt.py,
for users with *trained* reference checkpoints: the reference trainer
pickles the whole module (``torch.save(self.model.cpu(), path)``,
src/main/pretrain_with_val_optimized.py:524-548), so a checkpoint is a
``BERTFoundationModel`` holding one of the three encoder variants
(src/model/bert.py: BERT / BERTWithRAG / BERTWithEmbeddingRAG, all with
the same parameter surface; the RAG variants add ``rag_fusion``).
``convert_state_dict`` maps that state_dict onto the flax-layout numpy tree
of the JAX package (the same tree, key for key and bit for bit), and
``interop.load_flax_params`` loads that tree into the port's model; so one
set of layout rules serves both packages and both directions.

Weight-layout rules (torch -> flax):
  - ``nn.Linear``     weight [out, in]     -> Dense kernel [in, out] (T)
  - ``nn.Conv1d``     weight [out, in, k]  -> Conv kernel [k, in, out]
  - ``nn.LayerNorm``  weight/bias          -> scale/bias
  - ``nn.BatchNorm1d``weight/bias/running_* -> FrozenBatchNorm
    scale/bias/mean/var (the port keeps mean/var as buffers): eval-mode
    statistics, numerically identical to torch eval BN
  - ``nn.Embedding``  weight               -> Embed embedding
  - buffers: ``embedding.position.pe`` is not copied (the sinusoidal
    table is recomputed, models/embeddings.py); ``num_batches_tracked``
    dropped.

The converted model is built with ``pos_norm="frozen_batch"`` and post-LN
topology, as ``convert_meta.json`` records (``infer --model_path <dir>``
reads it).  A converted checkpoint is the port's: ``<dir>/state.pt`` with
``{"params": state_dict}`` beside ``convert_meta.json``.  An orbax
checkpoint of the JAX package cannot be read without JAX; its route is the
JAX package's ``export-ckpt`` (a reference state_dict), then this
package's ``convert-ckpt``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np
import torch

META_NAME = "convert_meta.json"

# Source-key suffixes that are deliberately not converted.
_SKIPPED_SUFFIXES = ("num_batches_tracked",)
_SKIPPED_KEYS = ("embedding.position.pe",)


def _lin(sd: dict, src: str, dst: dict) -> None:
    dst["kernel"] = np.ascontiguousarray(sd.pop(src + ".weight").T)
    dst["bias"] = sd.pop(src + ".bias")


def _ln(sd: dict, src: str, dst: dict) -> None:
    dst["scale"] = sd.pop(src + ".weight")
    dst["bias"] = sd.pop(src + ".bias")


def _conv(sd: dict, src: str, dst: dict) -> None:
    dst["kernel"] = np.ascontiguousarray(
        sd.pop(src + ".weight").transpose(2, 1, 0))
    dst["bias"] = sd.pop(src + ".bias")


def _bn(sd: dict, src: str, dst: dict) -> None:
    dst["scale"] = sd.pop(src + ".weight")
    dst["bias"] = sd.pop(src + ".bias")
    dst["mean"] = sd.pop(src + ".running_mean")
    dst["var"] = sd.pop(src + ".running_var")


def _node(tree: dict, *path: str) -> dict:
    for p in path:
        tree = tree.setdefault(p, {})
    return tree


def convert_state_dict(sd: dict[str, np.ndarray],
                       rag_mode: str | None = None
                       ) -> tuple[dict, dict[str, Any]]:
    """Convert a reference state_dict (str -> np.ndarray) to flax params.

    Returns ``(params, meta)`` where params is the tree for
    ``{"params": params}`` and meta records the architecture inferred
    from the tensors (dims, n_layers, vocab_size, rag_mode; attn_heads
    is NOT inferable from shapes and is left None for the caller).

    ``rag_mode``: "embedding" | "token" | "none" | None (auto).  The
    token and embedding variants have identical parameter surfaces, so
    auto-detection maps any ``rag_fusion.*`` presence to "embedding";
    pass "token" explicitly for V17 checkpoints.

    Raises ValueError on unknown/missing keys so structure drift fails
    loudly instead of producing a silently-wrong model.
    """
    sd = dict(sd)  # consumed destructively
    # Normalize prefixes: DataParallel "module.", foundation "bert.".
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
    with_heads = any(k.startswith("hap_classifier.") for k in sd)
    bp = "bert." if any(k.startswith("bert.") for k in sd) else ""
    for k in list(sd):
        if k.endswith(_SKIPPED_SUFFIXES) or k[len(bp) if k.startswith(bp)
                                              else 0:] in _SKIPPED_KEYS:
            sd.pop(k)

    has_rag = any(k.startswith(bp + "rag_fusion.") for k in sd)
    if rag_mode is None:
        rag_mode = "embedding" if has_rag else "none"
    if (rag_mode != "none") != has_rag:
        raise ValueError(f"rag_mode={rag_mode!r} but checkpoint "
                         f"{'has' if has_rag else 'lacks'} rag_fusion.*")

    tok = sd[bp + "embedding.tokenizer.weight"]
    vocab_size, dims = tok.shape
    n_layers = 1 + max(int(k.split(".")[1 + bool(bp)])
                       for k in sd if ".transformer_blocks." in "." + k)

    params: dict = {}
    bert = _node(params, "bert") if with_heads else params
    e = bp + "embedding."
    emb = _node(bert, "embedding")
    emb["Embed_0"] = {"embedding": sd.pop(e + "tokenizer.weight")}
    afe = _node(emb, "AFEmbedding_0")
    afe["basis_freqs"] = sd.pop(e + "af_embedding.basis_freqs")
    _lin(sd, e + "af_embedding.projection.0", _node(afe, "Dense_0"))
    _ln(sd, e + "af_embedding.projection.1", _node(afe, "LayerNorm_0"))
    _lin(sd, e + "af_embedding.projection.3", _node(afe, "Dense_1"))

    f = bp + "emb_fusion."
    fus = _node(bert, "emb_fusion")
    pf = _node(fus, "pos_feat")
    for i in (1, 2, 3):
        _conv(sd, f + f"pos_feat.conv{i}", _node(pf, f"Conv_{i - 1}"))
    for i in (1, 2):
        _bn(sd, f + f"pos_feat.norm{i}", _node(pf, f"FrozenBatchNorm_{i - 1}"))
    _lin(sd, f + "fusion", _node(fus, "fusion"))
    _ln(sd, f + "norm", _node(fus, "LayerNorm_0"))

    enc = _node(bert, "encoder")
    for i in range(n_layers):
        t = bp + f"transformer_blocks.{i}."
        blk = _node(enc, f"block_{i}")
        att = _node(blk, "attention")
        for j, name in enumerate(("query", "key", "value")):
            _lin(sd, t + f"attention.linear_layers.{j}", _node(att, name))
        _lin(sd, t + "attention.output_layer", _node(att, "output"))
        ff = _node(blk, "feed_forward")
        _lin(sd, t + "feed_forward.w_1", _node(ff, "w_1"))
        _lin(sd, t + "feed_forward.w_2", _node(ff, "w_2"))
        _ln(sd, t + "feed_forward.norm", _node(ff, "LayerNorm_0"))
        # post-LN block: LayerNorm_0 follows attention (input_sublayer),
        # LayerNorm_1 follows the FFN (output_sublayer)
        _ln(sd, t + "input_sublayer.norm", _node(blk, "LayerNorm_0"))
        _ln(sd, t + "output_sublayer.norm", _node(blk, "LayerNorm_1"))

    if has_rag:
        r = bp + "rag_fusion."
        rf = _node(bert, "rag_fusion")
        rf["res_scale"] = sd.pop(r + "res_scale").reshape(())
        afi = _node(rf, "af_interaction")
        afi["res_scale"] = sd.pop(r + "af_interaction.res_scale").reshape(())
        _lin(sd, r + "af_interaction.gate_net.0", _node(afi, "Dense_0"))
        _lin(sd, r + "af_interaction.gate_net.2", _node(afi, "Dense_1"))
        _lin(sd, r + "af_interaction.joint_encoder.0", _node(afi, "Dense_2"))
        _ln(sd, r + "af_interaction.joint_encoder.1",
            _node(afi, "LayerNorm_0"))
        _lin(sd, r + "af_adapter.0", _node(rf, "Dense_0"))
        _lin(sd, r + "af_adapter.3", _node(rf, "Dense_1"))
        _lin(sd, r + "pooling.0", _node(rf, "pooling"))
        _lin(sd, r + "fusion.0", _node(rf, "Dense_2"))
        _lin(sd, r + "fusion.3", _node(rf, "Dense_3"))
        _ln(sd, r + "fusion.4", _node(rf, "LayerNorm_0"))

    if with_heads:
        hc = _node(params, "hap_classifier")
        _lin(sd, "hap_classifier.af_fusion.0", _node(hc, "Dense_0"))
        _lin(sd, "hap_classifier.af_fusion.2", _node(hc, "Dense_1"))
        _ln(sd, "hap_classifier.af_fusion.3", _node(hc, "LayerNorm_0"))
        _lin(sd, "hap_classifier.net.0", _node(hc, "Dense_2"))
        _lin(sd, "hap_classifier.net.2", _node(hc, "Dense_3"))
        gc = _node(params, "gt_classifier")
        _lin(sd, "gt_classifier.gf_fusion", _node(gc, "Dense_0"))
        _ln(sd, "gt_classifier.gf_norm", _node(gc, "LayerNorm_0"))
        _lin(sd, "gt_classifier.layer.w_1", _node(gc, "Dense_1"))
        _ln(sd, "gt_classifier.layer.norm", _node(gc, "LayerNorm_1"))
        _lin(sd, "gt_classifier.layer.w_2", _node(gc, "Dense_2"))
        _lin(sd, "gt_classifier.classifier", _node(gc, "Dense_3"))

    if sd:
        raise ValueError(f"unconverted reference keys: {sorted(sd)[:8]}"
                         f"{'...' if len(sd) > 8 else ''}")
    params = _as_f32(params)
    meta = {"dims": int(dims), "n_layers": int(n_layers),
            "vocab_size": int(vocab_size), "rag_mode": rag_mode,
            "attn_heads": None, "with_heads": with_heads,
            "pos_norm": "frozen_batch", "pre_ln": False,
            "compat_double_softmax": False}
    return params, meta


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype != np.float32 else a


def expected_reference_keys(n_layers: int, dims: int, vocab_size: int,
                            with_rag: bool = True, with_heads: bool = True,
                            num_basis: int = 32) -> dict[str, tuple]:
    """The reference checkpoint's key -> shape contract (foundation model,
    src/model/*).  Used by the interop tests to synthesize state_dicts
    without importing torch or the reference code, and as the documented
    source of truth for what ``convert_state_dict`` consumes."""
    d, h = dims, 4 * dims
    bp = "bert." if with_heads else ""
    keys: dict[str, tuple] = {}

    def lin(name, o, i):
        keys[name + ".weight"] = (o, i)
        keys[name + ".bias"] = (o,)

    def ln(name, c):
        keys[name + ".weight"] = (c,)
        keys[name + ".bias"] = (c,)

    keys[bp + "embedding.tokenizer.weight"] = (vocab_size, d)
    keys[bp + "embedding.position.pe"] = (1, 1030, d)
    keys[bp + "embedding.af_embedding.basis_freqs"] = (num_basis,)
    lin(bp + "embedding.af_embedding.projection.0", d, 2 * num_basis)
    ln(bp + "embedding.af_embedding.projection.1", d)
    lin(bp + "embedding.af_embedding.projection.3", d, d)
    keys[bp + "emb_fusion.pos_feat.conv1.weight"] = (4, 1, 9)
    keys[bp + "emb_fusion.pos_feat.conv1.bias"] = (4,)
    keys[bp + "emb_fusion.pos_feat.conv2.weight"] = (4, 4, 9)
    keys[bp + "emb_fusion.pos_feat.conv2.bias"] = (4,)
    keys[bp + "emb_fusion.pos_feat.conv3.weight"] = (1, 4, 9)
    keys[bp + "emb_fusion.pos_feat.conv3.bias"] = (1,)
    for i in (1, 2):
        n = bp + f"emb_fusion.pos_feat.norm{i}"
        ln(n, 4)
        keys[n + ".running_mean"] = (4,)
        keys[n + ".running_var"] = (4,)
        keys[n + ".num_batches_tracked"] = ()
    lin(bp + "emb_fusion.fusion", d, d + 2)
    ln(bp + "emb_fusion.norm", d)
    for i in range(n_layers):
        t = bp + f"transformer_blocks.{i}."
        for j in range(3):
            lin(t + f"attention.linear_layers.{j}", d, d)
        lin(t + "attention.output_layer", d, d)
        lin(t + "feed_forward.w_1", h, d)
        lin(t + "feed_forward.w_2", d, h)
        ln(t + "feed_forward.norm", h)
        ln(t + "input_sublayer.norm", d)
        ln(t + "output_sublayer.norm", d)
    if with_rag:
        r = bp + "rag_fusion."
        keys[r + "res_scale"] = ()
        keys[r + "af_interaction.res_scale"] = ()
        lin(r + "af_interaction.gate_net.0", 32, 2)
        lin(r + "af_interaction.gate_net.2", d, 32)
        lin(r + "af_interaction.joint_encoder.0", d, 2)
        ln(r + "af_interaction.joint_encoder.1", d)
        lin(r + "af_adapter.0", h, d)
        lin(r + "af_adapter.3", d, h)
        lin(r + "pooling.0", 1, d)
        lin(r + "fusion.0", h, 2 * d)
        lin(r + "fusion.3", d, h)
        ln(r + "fusion.4", d)
    if with_heads:
        lin("hap_classifier.af_fusion.0", h, d + 2)
        lin("hap_classifier.af_fusion.2", d, h)
        ln("hap_classifier.af_fusion.3", d)
        lin("hap_classifier.net.0", h, d)
        lin("hap_classifier.net.2", 2, h)
        lin("gt_classifier.gf_fusion", 16, 7)
        ln("gt_classifier.gf_norm", 16)
        lin("gt_classifier.layer.w_1", 16, 16)
        lin("gt_classifier.layer.w_2", 16, 16)
        ln("gt_classifier.layer.norm", 16)
        lin("gt_classifier.classifier", 4, 16)
    return keys


# Unpickling a whole-module reference checkpoint imports the reference
# package, whose __init__ pulls in the full genomics stack
# (src/__init__.py -> src/dataset/dataset.py: allel, faiss, vcfpy, ...).
# None of that is needed to resolve the model classes, so any of these
# that aren't installed are satisfied with attribute-producing stubs for
# the duration of the load.
_REF_HEAVY_DEPS = ("allel", "faiss", "vcfpy", "pysam", "matplotlib",
                   "matplotlib.pyplot", "seaborn", "sklearn",
                   "sklearn.model_selection", "sklearn.metrics", "tqdm",
                   "h5py", "scipy", "scipy.stats", "pandas")


def _stub_missing_modules(names=_REF_HEAVY_DEPS) -> list[str]:
    """sys.modules stubs for any of ``names`` that aren't importable;
    returns the inserted keys so the caller can remove them again."""
    import importlib.util
    import sys
    import types

    class _Stub(types.ModuleType):
        __path__: list = []

        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            return type(name, (), {})

    inserted = []
    for mod in names:
        if mod in sys.modules:
            continue
        try:
            if importlib.util.find_spec(mod) is not None:
                continue
        except (ImportError, ValueError):
            pass
        sys.modules[mod] = _Stub(mod)
        inserted.append(mod)
    return inserted


def load_torch_checkpoint(path: str, ref_src: str | None = None
                          ) -> tuple[dict[str, np.ndarray], int | None]:
    """Load a reference checkpoint into (state_dict-of-numpy, attn_heads).

    A raw state_dict pickle (tensors only) loads with ``weights_only=True``.
    A whole-module pickle (the reference trainer's) runs the reference's
    classes to unpickle, so it loads only with ``ref_src``, the root of the
    RAG-SNVBERT source the user names (``weights_only=False``; its missing
    heavyweight dependencies are stubbed for the duration of the load).
    ``attn_heads`` is read from the module when available (shapes alone
    cannot determine it), else None.
    """
    import sys

    if not ref_src:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{path} holds more than tensors (a whole-module pickle of "
                "the reference trainer?): it loads only with ref_src (CLI "
                "--ref-src), the RAG-SNVBERT source its classes come from; "
                "loading it runs that code") from e
    else:
        root = os.path.abspath(ref_src)
        sys.path.insert(0, root)
        stubbed = _stub_missing_modules()
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        finally:
            sys.path.remove(root)
            for mod in stubbed:
                sys.modules.pop(mod, None)
    attn_heads = None
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        bert = getattr(obj, "bert", obj)
        attn_heads = getattr(bert, "attn_heads", None)
        if attn_heads is None:
            # BERT stores heads on each MHA: dims // per-head dims
            blocks = getattr(bert, "transformer_blocks", None)
            if blocks is not None and len(blocks):
                mha = blocks[0].attention
                attn_heads = getattr(mha, "heads", None)
        obj = obj.state_dict()
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v) for k, v in obj.items()}
    return sd, int(attn_heads) if attn_heads is not None else None


def save_converted(params: dict, meta: dict[str, Any], out_dir: str) -> None:
    """Write converted params as a port checkpoint directory:
    ``state.pt`` with ``{"params": state_dict}`` (what ``infer --model_path``
    and ``Trainer.init_params_from`` read) and ``convert_meta.json``, which
    the CLI uses to rebuild the matching architecture.  The state_dict's
    keys and layouts are the port model's, by ``load_flax_params``'s
    rules."""
    from .flax_params import _leaves, _to_torch_layout, _torch_key

    os.makedirs(out_dir, exist_ok=True)
    state = {_torch_key(p): torch.from_numpy(
        np.array(_to_torch_layout(p[-1], a), order="C"))
        for p, a in _leaves(params).items()}
    tmp = os.path.join(out_dir, "state.pt.tmp")
    torch.save({"params": state}, tmp)
    os.replace(tmp, os.path.join(out_dir, "state.pt"))
    with open(os.path.join(out_dir, META_NAME), "w") as fh:
        json.dump(meta, fh, indent=1)


# ---------------------------------------------------------------------------
# Reverse direction: flax params -> reference (torch) state_dict
# ---------------------------------------------------------------------------

def _take(tree: dict, *path: str):
    """Pop ``tree[path[0]]...[path[-1]]``, pruning emptied dicts, so a
    full export leaves an empty tree (leftovers = loud failure)."""
    node, parents = tree, []
    for p in path[:-1]:
        parents.append((node, p))
        node = node[p]
    leaf = node.pop(path[-1])
    for parent, key in reversed(parents):
        if not parent[key]:
            parent.pop(key)
    return leaf


def _np_sinusoidal(max_len: int, dims: int) -> np.ndarray:
    """Regenerate the reference's pe buffer
    (src/model/embedding/position.py:24-33) with torch's own float32 ops,
    so the exported buffer is bit-identical to a reference-initialized
    one."""
    import math

    position = torch.arange(0, max_len).float().unsqueeze(1)
    div_term = (torch.arange(0, dims, 2).float()
                * -(math.log(10000.0) / dims)).exp()
    pe = torch.zeros([max_len, dims]).float()
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe.numpy()


def export_state_dict(params: dict, max_len: int = 1030,
                      approx_pos_norm: bool = False
                      ) -> dict[str, np.ndarray]:
    """Flax params -> reference torch state_dict (the inverse of
    ``convert_state_dict``), so a model trained or fine-tuned here can be
    loaded back into the reference codebase with
    ``model.load_state_dict(torch.load(path))``.

    Exact for ``pos_norm="frozen_batch"`` models (converted or
    fine-tuned reference checkpoints): FrozenBatchNorm mean/var become
    running_mean/running_var, eval-mode numerics identical.  Natively
    trained models use GroupNorm, which torch BatchNorm1d cannot
    represent — pass ``approx_pos_norm=True`` to map scale/bias onto
    identity-stats BN (running_mean=0, running_var=1; numerics differ
    through the 2-channel position branch) or retrain with
    ``pos_norm="frozen_batch"`` for exactness.

    The ``embedding.position.pe`` buffer is regenerated (same sinusoid
    as src/model/embedding/position.py:9-38); works only for per-block
    (``scan_layers=False``, unfused-QKV) parameter trees and raises
    ValueError listing any leftover leaves otherwise.
    """
    import copy

    params = copy.deepcopy(_numpy_tree(params))
    with_heads = "hap_classifier" in params
    bert = params["bert"] if with_heads else params
    has_rag = "rag_fusion" in bert
    n_layers = sum(k.startswith("block_") for k in bert["encoder"])
    vocab_size, dims = bert["embedding"]["Embed_0"]["embedding"].shape
    bp = "bert." if with_heads else ""
    sd: dict[str, np.ndarray] = {}

    def lin(dst, *path):
        node = _take(params, *path)
        sd[dst + ".weight"] = np.ascontiguousarray(node.pop("kernel").T)
        sd[dst + ".bias"] = node.pop("bias")
        assert not node, (dst, sorted(node))

    def ln(dst, *path):
        node = _take(params, *path)
        sd[dst + ".weight"] = node.pop("scale")
        sd[dst + ".bias"] = node.pop("bias")
        assert not node, (dst, sorted(node))

    def conv(dst, *path):
        node = _take(params, *path)
        sd[dst + ".weight"] = np.ascontiguousarray(
            node.pop("kernel").transpose(2, 1, 0))
        sd[dst + ".bias"] = node.pop("bias")
        assert not node, (dst, sorted(node))

    e = bp + "embedding."
    emb_path = (["bert"] if with_heads else []) + ["embedding"]
    sd[e + "tokenizer.weight"] = _take(params, *emb_path, "Embed_0",
                                       "embedding")
    sd[e + "position.pe"] = _np_sinusoidal(max_len, dims)[None]
    sd[e + "af_embedding.basis_freqs"] = _take(params, *emb_path,
                                               "AFEmbedding_0", "basis_freqs")
    afe = emb_path + ["AFEmbedding_0"]
    lin(e + "af_embedding.projection.0", *afe, "Dense_0")
    ln(e + "af_embedding.projection.1", *afe, "LayerNorm_0")
    lin(e + "af_embedding.projection.3", *afe, "Dense_1")

    f = bp + "emb_fusion."
    fus_path = (["bert"] if with_heads else []) + ["emb_fusion"]
    pf = fus_path + ["pos_feat"]
    for i in (1, 2, 3):
        conv(f + f"pos_feat.conv{i}", *pf, f"Conv_{i - 1}")
    pf_node = _take(params, *pf) if "pos_feat" in _node(
        params, *fus_path) else {}
    for i in (1, 2):
        dst = f + f"pos_feat.norm{i}"
        frozen = pf_node.pop(f"FrozenBatchNorm_{i - 1}", None)
        group = pf_node.pop(f"GroupNorm_{i - 1}", None)
        if frozen is not None:
            sd[dst + ".weight"] = frozen["scale"]
            sd[dst + ".bias"] = frozen["bias"]
            sd[dst + ".running_mean"] = frozen["mean"]
            sd[dst + ".running_var"] = frozen["var"]
        elif not approx_pos_norm:
            raise ValueError(
                "params lack FrozenBatchNorm position stats (model was "
                "trained with pos_norm='group' or 'none'); pass "
                "approx_pos_norm=True to export identity-stats BatchNorm "
                "(position-branch numerics will differ) or fine-tune with "
                "pos_norm='frozen_batch'")
        else:
            c = 4  # PositionFeatModule hidden_channels
            sd[dst + ".weight"] = (group["scale"] if group is not None
                                   else np.ones(c, np.float32))
            sd[dst + ".bias"] = (group["bias"] if group is not None
                                 else np.zeros(c, np.float32))
            sd[dst + ".running_mean"] = np.zeros(c, np.float32)
            sd[dst + ".running_var"] = np.ones(c, np.float32)
        sd[dst + ".num_batches_tracked"] = np.asarray(0, np.int64)
    if pf_node:
        raise ValueError(f"unexported pos_feat leaves: {sorted(pf_node)}")
    lin(f + "fusion", *fus_path, "fusion")
    ln(f + "norm", *fus_path, "LayerNorm_0")

    enc = (["bert"] if with_heads else []) + ["encoder"]
    for i in range(n_layers):
        t = bp + f"transformer_blocks.{i}."
        blk = enc + [f"block_{i}"]
        for j, name in enumerate(("query", "key", "value")):
            lin(t + f"attention.linear_layers.{j}", *blk, "attention", name)
        lin(t + "attention.output_layer", *blk, "attention", "output")
        lin(t + "feed_forward.w_1", *blk, "feed_forward", "w_1")
        lin(t + "feed_forward.w_2", *blk, "feed_forward", "w_2")
        ln(t + "feed_forward.norm", *blk, "feed_forward", "LayerNorm_0")
        ln(t + "input_sublayer.norm", *blk, "LayerNorm_0")
        ln(t + "output_sublayer.norm", *blk, "LayerNorm_1")

    if has_rag:
        r = bp + "rag_fusion."
        rf = (["bert"] if with_heads else []) + ["rag_fusion"]
        sd[r + "res_scale"] = _take(params, *rf, "res_scale").reshape(())
        afi = rf + ["af_interaction"]
        sd[r + "af_interaction.res_scale"] = _take(
            params, *afi, "res_scale").reshape(())
        lin(r + "af_interaction.gate_net.0", *afi, "Dense_0")
        lin(r + "af_interaction.gate_net.2", *afi, "Dense_1")
        lin(r + "af_interaction.joint_encoder.0", *afi, "Dense_2")
        ln(r + "af_interaction.joint_encoder.1", *afi, "LayerNorm_0")
        lin(r + "af_adapter.0", *rf, "Dense_0")
        lin(r + "af_adapter.3", *rf, "Dense_1")
        lin(r + "pooling.0", *rf, "pooling")
        lin(r + "fusion.0", *rf, "Dense_2")
        lin(r + "fusion.3", *rf, "Dense_3")
        ln(r + "fusion.4", *rf, "LayerNorm_0")

    if with_heads:
        lin("hap_classifier.af_fusion.0", "hap_classifier", "Dense_0")
        lin("hap_classifier.af_fusion.2", "hap_classifier", "Dense_1")
        ln("hap_classifier.af_fusion.3", "hap_classifier", "LayerNorm_0")
        lin("hap_classifier.net.0", "hap_classifier", "Dense_2")
        lin("hap_classifier.net.2", "hap_classifier", "Dense_3")
        lin("gt_classifier.gf_fusion", "gt_classifier", "Dense_0")
        ln("gt_classifier.gf_norm", "gt_classifier", "LayerNorm_0")
        lin("gt_classifier.layer.w_1", "gt_classifier", "Dense_1")
        ln("gt_classifier.layer.norm", "gt_classifier", "LayerNorm_1")
        lin("gt_classifier.layer.w_2", "gt_classifier", "Dense_2")
        lin("gt_classifier.classifier", "gt_classifier", "Dense_3")

    if params:
        leftovers = sorted(_tree_paths(params))[:8]
        raise ValueError(
            "unexported params (scan_layers=True / fused_qkv=True trees "
            f"are not exportable — retrain per-block): {leftovers}")

    expected = set(expected_reference_keys(
        n_layers, dims, vocab_size, with_rag=has_rag, with_heads=with_heads,
        num_basis=sd[e + "af_embedding.basis_freqs"].shape[0]))
    assert set(sd) == expected, (
        sorted(expected - set(sd)), sorted(set(sd) - expected))
    return sd


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _tree_paths(v, prefix + k + ".")
        return out
    return [prefix.rstrip(".")]


def load_params_checkpoint(path: str) -> dict:
    """The flax-layout numpy tree of a port checkpoint directory: a
    trainer checkpoint ({params, opt_state, step, epoch, level, ...}) or a
    converted one ({params})."""
    from ..utils.ckpt import restore_tree
    from .flax_params import flax_params_of

    restored = restore_tree(path)
    return flax_params_of(restored.get("params", restored))


def load_convert_meta(model_path: str) -> dict[str, Any] | None:
    p = os.path.join(model_path, META_NAME)
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return json.load(fh)
