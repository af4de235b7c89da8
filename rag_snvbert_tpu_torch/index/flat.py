"""Device-resident exact flat indexes: L2 and Hamming.

Port of rag_snvbert_tpu/index/flat.py: the replacement for the reference's
FAISS surface (``faiss.IndexFlatL2`` -> ``FlatL2Index``,
``faiss.IndexBinaryFlat`` over packed haplotypes -> ``HammingIndex``,
``write_index``/``read_index`` -> ``save``/``load``).  An exact flat index is
the vector matrix plus cached squared norms on the card.  ``save`` writes,
and ``load`` reads, the JAX package's npz fields, so an index written by
either package serves the other.

Searches on the card go through the port's kernels or raise; nothing falls
back to the plain version (``ops`` module docstrings):

  storage             search / masked_search on the card
  pack 2/4/8          ``ops.l2_topk_rf(pack=...)`` (any B: no chunking)
  int8 / int4         ``ops.l2_topk_rf`` when 4 B N > 2^28 or
                      ``use_pallas=True``, else the plain torch path
  bf16                ``ops.l2_topk`` when N <= 49,152 and d % 8 == 0, else
                      ``ops.l2_topk_float``; below the size rule, plain
  float32             ``ops.l2_topk_float``; below the size rule, plain
  any, k > 128        ``ops.l2_ref.l2_topk_streaming`` (torch ops)

``use_pallas`` keeps the JAX argument's name and means "the hand-written
kernel": ``None`` decides by the size rule, ``False`` takes the plain path
(the cross-check), ``True`` the kernel.  ``approx=True`` is answered
exactly: the TPU's PartialReduce (``lax.approx_max_k``) has no counterpart
here, and packed storage ignores the flag in the JAX package too.
``int4`` storage has no torch dtype: it is held as int8 values with
``int4=True``, searched as int8 (the values are the same) and saved with
the ``int4`` tag.  Entry points (``build``, ``load``) run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import l2_ref
from ..ops.l2_topk import _MAX_N as L2_TOPK_MAX_N
from ..ops.l2_topk import l2_topk
from ..ops.l2_topk_float import l2_topk_float
from ..ops.l2_topk_rf import MAX_K, l2_topk_rf
from ..ops.planar import (default_tn, pack_planar, planar_sq_norms,
                          planar_unpack, ref_alignment)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}
_NORM_CHUNK = 65536   # rows a step when norms are summed on the card


def _row_sums(rows: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """``fn`` over ``_NORM_CHUNK`` rows at a time: float32 temporaries of a
    chunk, never of the whole matrix."""
    return torch.cat([fn(rows[s: s + _NORM_CHUNK])
                      for s in range(0, rows.shape[0], _NORM_CHUNK)]) \
        if rows.shape[0] else rows.new_zeros(0, dtype=torch.float32)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device)


@dataclasses.dataclass
class FlatL2Index:
    """Exact squared-L2 flat index resident on a device.

    ``vectors``: [N, d]; ``norms``: [N] float32 squared norms (+inf marks
    rows that must never be retrieved ahead of a finite one: padding and
    tombstones).  ``n_real`` / ``d_real`` are set when the storage is padded
    to the TPU kernel's tiles (``build(align=True)``: padding rows +inf,
    padding columns zero); ``ntotal`` / ``d`` report the logical sizes.
    ``pack > 1``: ``vectors`` is planar-packed int8 (``ops.planar``), pack
    values a byte; ``d_real`` is always set.  ``int4``: int8 ``vectors``
    hold int4 storage's values."""

    vectors: torch.Tensor
    norms: torch.Tensor
    n_real: int | None = None
    d_real: int | None = None
    pack: int = 1
    int4: bool = False

    @property
    def ntotal(self) -> int:
        return self.vectors.shape[0] if self.n_real is None else self.n_real

    @property
    def d(self) -> int:
        return self.vectors.shape[1] if self.d_real is None else self.d_real

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @classmethod
    def build(cls, vectors, dtype=torch.float32, align: bool = False,
              pack: int = 1, device=None) -> "FlatL2Index":
        """``vectors [N, d]`` (numpy or torch) stored as ``dtype`` (a torch
        dtype or ``"int4"``); ``device=None`` is the card."""
        device = resolve_device(device)
        if pack > 1:
            return cls._build_packed(vectors, pack, align, device)
        int4 = dtype == "int4"
        store = torch.int8 if int4 else dtype
        v = _as_tensor(vectors, device).to(store)
        if not v.dtype.is_floating_point:
            # The TPU kernel pre-doubles queries in the storage dtype, so
            # the JAX package admits |v| <= 63 (int8) and |v| <= 3 (int4);
            # the port's kernel does not double, but the contract is kept.
            bound = 3 if int4 else 63
            lo_v, hi_v = (int(x) for x in torch.aminmax(v)) if v.numel() \
                else (0, 0)
            mx = max(-lo_v, hi_v)              # no int8 abs(-128) wrap
            if mx > bound:
                raise ValueError(
                    f"max |value| {mx} > {bound}: doubling would wrap in "
                    f"{'int4' if int4 else 'int8'} — store as float or a "
                    "wider int")
        if not align:
            return cls(vectors=v, norms=_row_sums(v, l2_ref.squared_norms),
                       int4=int4)
        n, d = v.shape
        n_mult, dp = ref_alignment(d, dtype)
        np_ = -(-n // n_mult) * n_mult
        v = F.pad(v, (0, dp - d, 0, np_ - n))
        norms = _row_sums(v, l2_ref.squared_norms)
        norms[n:] = float("inf")
        return cls(vectors=v, norms=norms, n_real=n if np_ != n else None,
                   d_real=d if dp != d else None, int4=int4)

    @classmethod
    def _build_packed(cls, vectors, pack: int, align: bool,
                      device: torch.device) -> "FlatL2Index":
        """Planar-packed storage: pack values an int8 byte (8 for binary
        genotypes, 4 for dosage 0..3, 2 for small ints)."""
        v = _as_tensor(vectors, device)
        if v.dtype.is_floating_point or v.dtype == torch.bool:
            raise TypeError(
                f"packed storage needs integer input, got "
                f"{str(v.dtype).removeprefix('torch.')} (pack_planar would "
                "silently floor floats)")
        hi = 1 << (8 // pack)
        lo_v, hi_v = (int(x) for x in torch.aminmax(v)) if v.numel() \
            else (0, 0)
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"pack={pack} admits values in [0, {hi}); "
                             f"data spans [{lo_v}, {hi_v}]")
        n, d = v.shape
        packed = pack_planar(v, pack)
        norms = planar_sq_norms(packed, pack)
        if not align:
            return cls(vectors=packed, norms=norms, d_real=d, pack=pack)
        n_mult = default_tn(torch.int8)
        np_ = -(-n // n_mult) * n_mult
        packed = F.pad(packed, (0, 0, 0, np_ - n))
        norms = F.pad(norms, (0, np_ - n), value=float("inf"))
        return cls(vectors=packed, norms=norms,
                   n_real=n if np_ != n else None, d_real=d, pack=pack)

    # Above this [B, N] distance-matrix size (bytes of float32) the kernel
    # takes over from the plain matmul + sort (JAX: _PALLAS_BYTES).
    _KERNEL_BYTES = 1 << 28

    def _use_kernel(self, use_pallas: bool | None, b: int) -> bool:
        if use_pallas is None:
            return (self.vectors.is_cuda
                    and 4 * b * self.ntotal > self._KERNEL_BYTES)
        return use_pallas

    def _unpack(self, rows: torch.Tensor) -> torch.Tensor:
        return planar_unpack(rows, self.pack, self.d)

    def search(self, queries, k: int, use_pallas: bool | None = None,
               approx: bool = False, recall_target: float = 0.95,
               compute: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """k-NN search -> (squared distances [B, k] float32, ids [B, k]
        int32), ascending, ties to the lower id.  ``approx`` and
        ``recall_target`` are accepted and answered exactly (module
        docstring).  ``compute`` (packed storage only): "int4" or "int8",
        the JAX package's MXU operand type; the card computes int8 either
        way, with the same results (default "int4" for pack >= 4, as in
        the JAX package)."""
        q = _as_tensor(queries, self.device)
        if self.pack > 1:
            if k > MAX_K:
                return l2_ref.l2_topk_streaming(
                    q[:, : self.d], self.vectors, k, r_norms=self.norms,
                    unpack=self._unpack)
            if use_pallas is False or not self.vectors.is_cuda:
                return self._search_unpacked_plain(q, self.norms, k)
            if compute is None and self.pack >= 4:
                compute = "int4"
            return l2_topk_rf(q.to(torch.int8).contiguous(), self.vectors,
                              self.norms, k, pack=self.pack, compute=compute)
        q = q.to(self.vectors.dtype)
        if q.shape[1] != self.vectors.shape[1]:   # aligned storage
            q = F.pad(q, (0, self.vectors.shape[1] - q.shape[1]))
        q = q.contiguous()
        if k > MAX_K:
            return l2_ref.l2_topk_streaming(q, self.vectors, k,
                                            r_norms=self.norms)
        if self._use_kernel(use_pallas, q.shape[0]):
            return self._kernel(q, self.norms, k)
        return l2_ref.topk_smallest(
            l2_ref.l2_distances(q, self.vectors, r_norms=self.norms), k)

    def _kernel(self, q: torch.Tensor, norms: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The kernel for unpacked storage (the plain version for CPU
        tensors, as every wrapper does)."""
        v = self.vectors
        if v.dtype == torch.int8:
            return l2_topk_rf(q, v, norms, k)
        if v.dtype == torch.bfloat16 and v.shape[0] <= L2_TOPK_MAX_N \
                and v.shape[1] % 8 == 0:
            return l2_topk(q, v, norms, k)
        return l2_topk_float(q, v, norms, k)

    def _search_unpacked_plain(self, q: torch.Tensor, norms: torch.Tensor,
                               k: int, packed: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain path of packed storage: unpack the planes, then the
        float32 matmul + sort oracle."""
        v = self._unpack(self.vectors if packed is None else packed)
        qf = q[:, : self.d].float()
        d = l2_ref.l2_distances(qf, v.float(), r_norms=norms)
        return l2_ref.topk_smallest(d, k)

    def masked_search(self, queries, dim_mask, k: int,
                      use_pallas: bool | None = None,
                      compute: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact k-NN over the unmasked dimensions (``dim_mask [d]``, 1 =
        the dimension takes part): queries are masked elementwise and the
        norms corrected, so the resident index is searched as it is
        (masked dimensions contribute q_i = 0, and r_i^2 leaves the norm).
        Tombstones (+inf norms) stay +inf."""
        q = _as_tensor(queries, self.device)
        dm = _as_tensor(dim_mask, self.device)
        if self.pack > 1:
            # AND with the planar-packed mask zeroes masked values in place
            bits = 8 // self.pack
            m = dm.to(torch.int32)
            pm = pack_planar((m * ((1 << bits) - 1))[None, :], self.pack)[0]
            rm = self.vectors & pm[None, :]
            masked_norms = planar_sq_norms(rm, self.pack)
            masked_norms = torch.where(torch.isinf(self.norms), self.norms,
                                       masked_norms)
            qm = q * m[None, : q.shape[1]]
            if k > MAX_K:
                return l2_ref.l2_topk_streaming(
                    qm[:, : self.d], rm, k, r_norms=masked_norms,
                    unpack=self._unpack)
            if use_pallas is False or not self.vectors.is_cuda:
                return self._search_unpacked_plain(qm, masked_norms, k,
                                                   packed=rm)
            if compute is None and self.pack >= 4:
                compute = "int4"
            return l2_topk_rf(qm.to(torch.int8).contiguous(), rm,
                              masked_norms, k, pack=self.pack,
                              compute=compute)
        m = dm.to(self.vectors.dtype)
        qm = q.to(self.vectors.dtype) * m[None, :]
        if qm.shape[1] != self.vectors.shape[1]:   # aligned storage
            pad_d = self.vectors.shape[1] - qm.shape[1]
            qm = F.pad(qm, (0, pad_d))
            m = F.pad(m, (0, pad_d))
        qm = qm.contiguous()
        mf = m.float()
        masked_norms = _row_sums(
            self.vectors, lambda r: torch.matmul(r.float() * r.float(), mf))
        masked_norms = torch.where(torch.isinf(self.norms), self.norms,
                                   masked_norms)
        if k > MAX_K:
            return l2_ref.l2_topk_streaming(qm, self.vectors, k,
                                            r_norms=masked_norms)
        if self._use_kernel(use_pallas, qm.shape[0]):
            return self._kernel(qm, masked_norms, k)
        return l2_ref.topk_smallest(
            l2_ref.l2_distances(qm, self.vectors, r_norms=masked_norms), k)

    # ---- persistence (the JAX package's npz fields) ----

    def save(self, path: str) -> None:
        """``vectors`` (bf16 as float32 with the ``bfloat16`` tag, int4 as
        int8 with the ``int4`` tag), ``norms``, ``dtype``, ``n_real`` /
        ``d_real`` (-1 for none) and ``pack``; ``.npz`` is appended."""
        v = self.vectors
        name = "int4" if self.int4 else _DTYPE_NAMES[v.dtype]
        if v.dtype == torch.bfloat16:
            v = v.float()
        np.savez(path, vectors=v.cpu().numpy(),
                 norms=self.norms.cpu().numpy(), dtype=np.asarray(name),
                 n_real=np.asarray(-1 if self.n_real is None else self.n_real),
                 d_real=np.asarray(-1 if self.d_real is None else self.d_real),
                 pack=np.asarray(self.pack))

    @classmethod
    def load(cls, path: str, device=None) -> "FlatL2Index":
        """Read a file of either package; files from before the ``dtype``
        / ``n_real`` / ``d_real`` / ``pack`` fields keep their npz dtype,
        are not aligned and not packed."""
        device = resolve_device(device)
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        v = torch.from_numpy(z["vectors"]).to(device)
        tag = str(z["dtype"]) if "dtype" in z else None
        if tag == "bfloat16":
            v = v.to(torch.bfloat16)

        def real(key):
            if key not in z:
                return None
            val = int(z[key])
            return None if val < 0 else val

        return cls(vectors=v, norms=torch.from_numpy(z["norms"]).to(device),
                   n_real=real("n_real"), d_real=real("d_real"),
                   pack=int(z["pack"]) if "pack" in z else 1,
                   int4=tag == "int4")


@dataclasses.dataclass
class HammingIndex:
    """Exact Hamming-distance flat index over bit-packed haplotypes.

    ``packed [N, ceil(d / 32)]``: LSB-first 32-bit words
    (``ops.l2_ref.pack_bits``) held as int64; ``valid [N]``: False rows are
    never retrieved.  Distances are XOR + popcount (torch ops: the JAX
    package has no kernel here either).  Replaces faiss.IndexBinaryFlat."""

    packed: torch.Tensor
    valid: torch.Tensor

    @property
    def ntotal(self) -> int:
        return self.packed.shape[0]

    @classmethod
    def build(cls, bits, device=None) -> "HammingIndex":
        """``bits [N, d]`` 0/1.  Host (numpy) input is packed on the host
        (``pack_bits_np``: no ``[N, d]`` int64 intermediate on the card)."""
        device = resolve_device(device)
        if isinstance(bits, np.ndarray):
            packed = torch.from_numpy(
                l2_ref.pack_bits_np(bits).astype(np.int64)).to(device)
        else:
            packed = l2_ref.pack_bits(bits.to(device))
        return cls(packed=packed,
                   valid=torch.ones(packed.shape[0], dtype=torch.bool,
                                    device=device))

    # Above this [B, N, words] XOR-tensor size (bytes of uint32, the JAX
    # package's rule) the streaming scan takes over.
    _STREAM_BYTES = 1 << 30

    def search(self, query_bits, k: int, streaming: bool | None = None,
               chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (Hamming distances [B, k] int32, ids [B, k] int32)."""
        qp = l2_ref.pack_bits(_as_tensor(query_bits, self.packed.device))
        if streaming is None:
            streaming = (4 * qp.shape[0] * self.packed.shape[0]
                         * self.packed.shape[1] > self._STREAM_BYTES)
        if streaming:
            return l2_ref.hamming_topk_streaming(qp, self.packed, k,
                                                 valid=self.valid,
                                                 chunk=chunk)
        d = l2_ref.hamming_distances(qp, self.packed)
        d = torch.where(self.valid[None, :], d,
                        torch.full_like(d, torch.iinfo(torch.int32).max))
        return l2_ref.topk_smallest(d, k)

    def save(self, path: str) -> None:
        """``packed`` as uint32 words (the JAX layout) and ``valid``."""
        np.savez(path, packed=self.packed.cpu().numpy().astype(np.uint32),
                 valid=self.valid.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "HammingIndex":
        device = resolve_device(device)
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(packed=torch.from_numpy(
            z["packed"].astype(np.int64)).to(device),
            valid=torch.from_numpy(z["valid"]).to(device))
