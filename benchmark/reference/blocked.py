"""The training micro-step of ``train.py``, computed so that it fits the card
at upstream V18's batch 24.

``train.micro_step`` keeps every encoder block's activations for the
backward pass; with 12 heads of 32 at L = 1030 a block keeps the float32
scores, probabilities, keep mask and dropped probabilities ``[48, 12, L,
L]``, 88 GB over 12 blocks.  Here the blocks run without autograd in the
forward pass, each keeping only its input and its dropout generator's
state at entry; the backward pass runs them again with autograd from the
top block down, the generator set back to that state, so that each block
draws the forward's masks again.  Every product and every draw is
``train.micro_step``'s, in the same order (the modules are ``model.py``'s;
the forward is ``model.BERT.forward`` and ``FoundationModel.forward`` cut
at the encoder), so the two agree to rounding.  Float32 with TF32 off; it
imports nothing of the program."""

from __future__ import annotations

import torch

from . import model as ref_model
from . import retrieval
from .train import step_seed, to_device


def _encoder_input(bert, x: dict) -> torch.Tensor:
    """``BERT.forward`` up to the encoder: the encoder's input."""
    b = x["hap_1"].shape[0]
    af2 = torch.cat([x["af"], x["af"]], 0)
    pos2 = torch.cat([x["pos"], x["pos"]], 0)
    if bert.rag_mode == "token":
        segs = torch.cat([x["rag_seg_h1"], x["rag_seg_h2"]], 0)
        k, l = segs.shape[1], segs.shape[2]
        af_all = torch.cat([af2, af2.repeat_interleave(k, 0)], 0)
        pos_all = torch.cat([pos2, pos2.repeat_interleave(k, 0)], 0)
        toks = torch.cat([x["hap_1"], x["hap_2"], segs.reshape(-1, l)], 0)
        return bert.emb_fusion(bert.embed(toks, af_all), pos_all, af_all)
    af_p2 = torch.cat([x["af_p"], x["af_p"]], 0)
    rag1, rag2 = x["rag_emb_h1"].mean(1), x["rag_emb_h2"].mean(1)
    streams = torch.cat([x["query_emb"], rag1, rag2], 0)
    fused = bert.emb_fusion(streams, torch.cat([pos2, pos2], 0),
                            torch.cat([af2, af2], 0))
    return bert.rag_fusion(fused[: 2 * b], fused[2 * b:][:, None], af2, af_p2)


def _encoder_output(bert, x: dict, enc: torch.Tensor):
    """The rest of ``BERT.forward``: ``(h1, h2)``."""
    b = x["hap_1"].shape[0]
    if bert.rag_mode != "token":
        return enc[:b], enc[b:]
    k, l = x["rag_seg_h1"].shape[1], x["rag_seg_h1"].shape[2]
    rag = enc[2 * b:].reshape(2 * b, k, l, -1)
    af2 = torch.cat([x["af"], x["af"]], 0)
    af_p2 = torch.cat([x["af_p"], x["af_p"]], 0)
    h = bert.rag_fusion(enc[: 2 * b], rag, af2, af_p2)
    return h[:b], h[b:]


def _heads(model, x: dict, h1, h2):
    """``FoundationModel.forward``'s heads: ``(hap_1, hap_2, gt)``."""
    hap_1 = model.hap_classifier(h1, x["af"], x["af_p"])
    hap_2 = model.hap_classifier(h2, x["af"], x["af_p"])
    gt = model.gt_classifier(torch.softmax(hap_1, -1),
                             torch.softmax(hap_2, -1), x["ref"], x["het"],
                             x["hom"])
    return hap_1, hap_2, gt


def micro_step(model, batch: dict, ctx, seed: int, step: int,
               rag_mode: str, device, keep_rows=None):
    """``train.micro_step``'s ``(loss, {name: gradient})`` (the same
    arguments), with the encoder's blocks recomputed in the backward
    pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.train()
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    ref_model.set_generator(model, gen)
    model.zero_grad(set_to_none=True)
    x = to_device(batch, device)
    scale = 1.0
    if keep_rows is not None:
        scale = x["hap_1"].shape[0] / len(keep_rows)
        x = {k: (v[keep_rows] if v.dim() > 1 else v) for k, v in x.items()}
    x = {k: (v.float() if v.is_floating_point() else v)
         for k, v in x.items()}
    if rag_mode == "token":
        x = retrieval.retrieve_tokens(x, *ctx)
    else:
        x = retrieval.retrieve_embedding(model, x, ctx)
    bert = model.bert
    blocks = [getattr(bert.encoder, f"block_{i}")
              for i in range(bert.encoder.n_layers)]
    h = _encoder_input(bert, x)
    entries, top = [], h.detach()
    with torch.no_grad():
        for block in blocks:
            entries.append((top, gen.get_state()))
            top = block(top)
    top.requires_grad_()
    loss = ref_model.total_loss(
        _heads(model, x, *_encoder_output(bert, x, top)), x) * scale
    loss.backward()
    grad, after = top.grad, gen.get_state()
    while blocks:
        block, (inp, state) = blocks.pop(), entries.pop()
        gen.set_state(state)
        inp.requires_grad_()
        block(inp).backward(grad)
        grad = inp.grad
        del inp
    gen.set_state(after)
    h.backward(grad)
    grads = {k: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    ref_model.set_generator(model, None)
    return float(loss.detach()), grads
