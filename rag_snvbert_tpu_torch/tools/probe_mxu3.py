"""Probe 3: operand layout and width of the int8 products.

The port of tools/probe_mxu3.py, at d = 2048: refs ``[N, D]`` (``base``)
or stored transposed ``[D, N]`` (``rT``), int8 or int4 operands; the TPU
kernel resets its accumulator only at the first query tile of each ref
tile, so the output is a running sum over query tiles.  On the card:

  - ``rT``: wgmma takes 8-bit operands from shared memory K-major only (its
    transpose immediate exists for 16-bit types), so the kernel turns the
    product around: the ref tile lands as it is stored ([d, refs]) and each
    consumer thread gathers its own A fragment from it into registers
    (wgmma with A from registers); the row prices that gather;
  - int4: wgmma has no 4-bit form on sm_90a.  The refs are packed to
    nibbles inside the call (as the TPU probe's ``astype(int4)`` runs
    inside its call; ``pack_ms`` times that pass alone: a coalesced pass
    for refs, a tiled transpose through shared memory for refs^T), and each
    consumer thread widens its A fragment to int8 in registers;
  - ``xla_int8`` is ``torch._int_mm`` reduced by ``.sum()`` as the TPU
    probe's XLA row was; ``xla_int4`` has no PyTorch call.

A ``trans`` or ``int4`` CTA tile is BR refs x BQ query rows (the refs are
wgmma's A operand there); a direct tile BM query rows x BN refs.
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
             ("rT_i8", True, False, 1024, probe.DEFAULT_TILE["trans"]),
             ("rT_i8_512", True, False, 512, probe.DEFAULT_TILE["trans"]),
             ("base_i4", False, True, 1024, probe.DEFAULT_TILE["int4"]),
             ("rT_i4", True, True, 1024, probe.DEFAULT_TILE["int4"]))
ROUTES = {"trans": "refs^T tiles by TMA as stored, each consumer thread "
                   "gathering its A fragment into registers (wgmma with A "
                   "from registers)",
          "int4": "refs packed to nibbles in the call (refs^T: a tiled "
                  "transpose through shared memory), widened to int8 in "
                  "the consumers' registers (wgmma with A from registers)"}


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
            launches = probe.pack_int4.launches
            r["pack_ms"] = round(time_ms(
                lambda: probe.pack_int4(src, trans=trans)), 4)
            r["pack_launches"] += probe.pack_int4.launches - launches
        if trans or int4:
            r["route"] = ROUTES["int4" if int4 else "trans"]
        rows.add(r)
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
