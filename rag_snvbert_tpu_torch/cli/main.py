"""Command line of the port: the offline index verbs and data preparation.

Port of rag_snvbert_tpu/cli/main.py's ``prepare-data``, ``build-index`` and
``query`` (:55-345, parsers :722-765), with the same flags, outputs and
files, so a database built by either package is queried by the other:
  prepare-data : VCF -> frequency table, window CSV, POP.json, sample split
  build-index  : reference VCF -> per-window rows, positions, population
                 labels and flat-L2 index shards (``--mode flat``) or rows
                 and positions only (``--mode intersect``)
  query        : per-window k-NN over a database (flat, intersect after
                 position intersection, partial = masked search over the
                 same index; ``--hamming`` for the intersect mode), with
                 per-window timing, ``--save-results`` and ``--verbose``
The index lives on the card unless ``--device cpu`` is given (the CLI form
of the port's ``device="cpu"`` rule).  The other verbs of the JAX command
line exit with the ROADMAP item that ports them.

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

NOT_PORTED = {"train": "A9", "infer": "A9", "serve": "A9", "emit-vcf": "A9",
              "analyze": "A9", "convert-ckpt": "A9", "export-ckpt": "A9"}


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="where the index lives: the card by default, "
                        "'cpu' to run off the card")


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
    from ..io.vcf import load_vcf_or_hdf5

    if args.index_shards > 1:
        raise SystemExit("--index-shards > 1: the sharded index is not "
                         "ported yet (ROADMAP Queue A, item A7)")
    device = resolve_device(args.device)
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
            else:
                idx = FlatL2Index.build(ref_sub.astype(np.float32),
                                        device=device)
                query = q
            build_t = time.time() - t0
            t0 = time.time()
            vals, ids = idx.search(query, args.k)
        else:
            idx = FlatL2Index.load(os.path.join(args.db, f"window_{w}.idx"),
                                   device=device)
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
        if args.save_results:
            os.makedirs(args.save_results, exist_ok=True)
            np.save(os.path.join(args.save_results, f"window_{w}_ids.npy"),
                    ids)
            np.save(os.path.join(args.save_results, f"window_{w}_vals.npy"),
                    vals)
        if args.verbose:
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
    print(json.dumps(totals))


# ---------------------------------------------------------------------------

def _not_ported(verb: str, item: str, args) -> None:
    raise SystemExit(f"{verb}: not ported to rag_snvbert_tpu_torch yet "
                     f"(ROADMAP Queue A, item {item})")


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
                    default=1, help="> 1 is not ported yet (Queue A, A7)")
    pq.add_argument("--show-snp-len", type=int, default=10,
                    help="alleles per snippet in --verbose output")
    _add_device(pq)
    pq.set_defaults(fn=cmd_query)

    for verb, item in NOT_PORTED.items():
        sp = sub.add_parser(verb, help=f"not ported yet (Queue A, {item})")
        sp.set_defaults(fn=lambda args, v=verb, i=item: _not_ported(v, i,
                                                                     args))
    return p


def main(argv=None):
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.cmd not in NOT_PORTED:   # those exit with their item
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
