"""Probe 3: operand layout and width of the int8 products.

The port of tools/probe_mxu3.py, at d = 2048: refs ``[N, D]`` (``base``)
or stored transposed ``[D, N]`` (``rT``), int8 or int4 operands; the TPU
kernel resets its accumulator only at the first query tile of each ref
tile, so the output is a running sum over query tiles.  On the card:

  - ``rT``: wgmma takes 8-bit operands K-major only (its transpose
    immediate exists for 16-bit types), so the kernel transposes each
    landed ref tile in shared memory; the row prices that pass;
  - int4: wgmma has no 4-bit form on sm_90a.  The refs are packed to
    nibbles inside the call (as the TPU probe's ``astype(int4)`` runs
    inside its call; ``pack_ms`` times that pass alone) and unpacked to
    int8 in shared memory before the int8 products;
  - ``xla_int8`` is ``torch._int_mm`` reduced by ``.sum()`` as the TPU
    probe's XLA row was; ``xla_int4`` has no PyTorch call.

Cases are checked as in probe_mxu.

Run on the card: python -m rag_snvbert_tpu_torch.tools.probe_mxu3
"""

from __future__ import annotations

from ..ops import int8_probe as probe
from .probe_mxu import (B, N, Rows, bernoulli, kernel_case, library_int4,
                        library_int8, need_card, time_ms)

D = 2048
TQ = 1024
# (case, refs^T?, int4?, tn, CTA tile): the TPU probe's tiles were
# 1024 x 1024 (and tn = 512 for rT_i8_512)
TPU_CASES = (("base_i8", False, False, 1024, probe.DEFAULT_TILE["direct"]),
             ("rT_i8", True, False, 1024, (128, 128, 128)),
             ("rT_i8_512", True, False, 512, (128, 192, 128)),
             ("base_i4", False, True, 1024, probe.DEFAULT_TILE["int4"]),
             ("rT_i4", True, True, 1024, probe.DEFAULT_TILE["int4"]))


def run() -> list[dict]:
    need_card()
    refs = bernoulli((N, D), 0)
    refs_t = refs.t().contiguous()
    q = bernoulli((B, D), 1)
    rows = Rows()
    rows.add(library_int8(q, refs, "sum"))
    rows.add(library_int4())
    for name, trans, int4, tn, tile in TPU_CASES:
        r = kernel_case(name, q, refs_t if trans else refs, TQ, tn,
                        trans=trans, int4=int4, running=True, tile=tile)
        if int4:
            src = refs_t if trans else refs
            r["pack_ms"] = round(time_ms(
                lambda: probe.pack_int4(src, trans=trans)), 4)
            r["route"] = ("refs packed to nibbles in the call, unpacked to "
                          "int8 in shared memory, int8 wgmma")
        if trans and not int4:
            r["route"] = "ref tiles transposed in shared memory"
        rows.add(r)
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
