"""Probe 2: raster order and CTA tile of the int8 products.

The port of tools/probe_mxu2.py.  The TPU probe swept the grid's loop
order (``qfirst``: query tiles slowest, refs streamed once a query tile;
``rfirst``: ref tiles slowest, refs streamed once), a "parallel" first
grid dimension and tile sizes.  On the card the loop order is the raster
order of the persistent grid's output tiles: ``qfirst`` makes the blocks in
flight share a query tile, so the 1.36 GB of refs come from device memory
once a query tile (8 times at B = 1024 with 128-row tiles); ``rfirst``
makes them share ref tiles, read once and then from L2.  ``par`` has no
meaning here (all blocks run at once): that case runs as its order twin,
and its row says so.  tq, tn and td decide only the output's padding and
columns.  Besides the TPU probe's seven cases: ``qfirst`` at every CTA
tile with 128-byte stages.  Cases are checked as in probe_mxu.

Run on the card: python -m rag_snvbert_tpu_torch.tools.probe_mxu2
"""

from __future__ import annotations

from ..ops import int8_probe as probe
from .probe_mxu import B, D, N, Rows, bernoulli, kernel_case, need_card

TPU_CASES = (("qfirst", 256, 1024, 2048, False),
             ("rfirst", 256, 1024, 2048, False),
             ("rfirst", 1024, 512, 2048, False),
             ("rfirst", 1024, 1024, 2048, False),
             ("rfirst", 512, 2048, 2048, False),
             ("rfirst", 1024, 2048, 2048, False),
             ("rfirst", 1024, 1024, 2048, True))


def run() -> list[dict]:
    need_card()
    refs = bernoulli((N, D), 0)
    q = bernoulli((B, D), 1)
    rows = Rows()
    for order, tq, tn, td, par in TPU_CASES:
        r = kernel_case(f"{order}_{tq}x{tn}x{td}{'_par' if par else ''}", q,
                        refs, tq, tn, order=order)
        if par:
            r["note"] = (f"runs as {order}: a persistent grid has no "
                         "sequential dimension to mark parallel")
        rows.add(r)
    for tile in probe.TILES["direct"]:
        if tile[2] == 128 and tile != probe.DEFAULT_TILE["direct"]:
            rows.add(kernel_case(f"qfirst_cta_{tile[0]}x{tile[1]}", q, refs,
                                 256, 1024, tile=tile, order="qfirst"))
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
