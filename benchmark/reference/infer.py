"""Imputation by the reference: one window of target samples whose
missing sites are masked, the window's context built for that missing-site
pattern, the model in eval mode.

A target haplotype's query is its known alleles at the sites it has and
MASK at the sites it lacks; the per-site features are the global pool's
(frequencies, genotype shares); the reference rows are masked at the same
missing sites.  Returns P(allele 1) of each haplotype and the four
genotype probabilities at each of the window's sites."""

from __future__ import annotations

import numpy as np
import torch

from . import data, retrieval


@torch.no_grad()
def impute_window(model, panel, w: int, gt: np.ndarray, present: np.ndarray,
                  rag_mode: str, pad_haps: int, L: int, device,
                  batch: int = 16) -> dict:
    """``gt`` ``[S_w, n, 2]`` the targets' alleles at window ``w``'s sites
    (read only where ``present``); returns ``hap1``, ``hap2`` ``[S_w, n]``
    and ``gt`` ``[S_w, n, 4]`` float64."""
    model.eval()
    wins = data.Windows(panel, L)
    sl = wins.sites(w)
    n_sites = sl.stop - sl.start
    miss = ~present
    wmask = data.pad(miss.astype(np.int64), L)
    toks, valid = wins.ref_tokens(w, pad_haps)
    toks = torch.as_tensor(toks, device=device)
    wmask_t = torch.as_tensor(wmask, device=device)
    valid = torch.as_tensor(valid, device=device)
    af = torch.as_tensor(data.pad(wins.af(w), L), device=device).float()
    if rag_mode == "token":
        ctx = (toks, wmask_t, valid)
    else:
        ctx = retrieval.embedding_context(model, toks, wmask_t, af, valid)
    feats = wins.features(w, -1)             # the global pool
    out = {"hap1": [], "hap2": [], "gt": []}
    n = gt.shape[1]
    for b0 in range(0, n, batch):
        g = gt[:, b0: b0 + batch].astype(np.int64)
        nb = g.shape[1]
        h1 = np.where(present[:, None], g[..., 0], 0).T
        h2 = np.where(present[:, None], g[..., 1], 0).T
        x = {"hap_1": data.tokens(h1, L, wmask),
             "hap_2": data.tokens(h2, L, wmask)}
        x.update({k: np.repeat(v[None], nb, 0) for k, v in feats.items()})
        x = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
             for k, v in x.items()}
        x = {k: (v.float() if v.is_floating_point() else v)
             for k, v in x.items()}
        if rag_mode == "token":
            x = retrieval.retrieve_tokens(x, *ctx)
        else:
            x = retrieval.retrieve_embedding(model, x, ctx)
        o = model(x)
        body = slice(1, 1 + n_sites)
        out["hap1"].append(torch.softmax(o[0], -1)[:, body, 1].T.double())
        out["hap2"].append(torch.softmax(o[1], -1)[:, body, 1].T.double())
        out["gt"].append(torch.softmax(o[2], -1)[:, body].transpose(0, 1)
                         .double())
    return {k: torch.cat(v, 1).cpu().numpy() for k, v in out.items()}


def answer_gaps(got: dict, want: dict, miss: np.ndarray) -> np.ndarray:
    """Per target sample (column), the mean over the window's missing
    sites of the largest gap among its probabilities (both haplotypes'
    P(allele 1) and the four genotype probabilities)."""
    g = np.maximum(np.abs(got["hap1"] - want["hap1"]),
                   np.abs(got["hap2"] - want["hap2"]))
    g = np.maximum(g, np.abs(got["gt"] - want["gt"]).max(-1))
    return g[miss].mean(0)


def widest_gap(got: dict, want: dict, miss: np.ndarray) -> float:
    g = np.maximum(np.abs(got["hap1"] - want["hap1"]),
                   np.abs(got["hap2"] - want["hap2"]))
    g = np.maximum(g, np.abs(got["gt"] - want["gt"]).max(-1))
    return float(g[miss].max())
