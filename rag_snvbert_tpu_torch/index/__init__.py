"""Offline exact flat indexes (port of rag_snvbert_tpu/index/): L2 over
float32, bf16, int8, int4 or planar-packed storage, and Hamming over packed
bits.  The sharded index (``index/sharded.py``) is Queue A 7."""

from .flat import FlatL2Index, HammingIndex
