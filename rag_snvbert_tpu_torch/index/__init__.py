"""Offline exact flat indexes (port of rag_snvbert_tpu/index/): L2 over
float32, bf16, int8, int4 or planar-packed storage, and Hamming over packed
bits; ``ShardedFlatL2Index`` splits an L2 index's rows over the ranks of a
mesh's ``index`` axis (``index/sharded.py``)."""

from .flat import FlatL2Index, HammingIndex
from .sharded import ShardedFlatL2Index
