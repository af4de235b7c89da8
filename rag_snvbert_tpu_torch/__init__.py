"""rag_snvbert_tpu_torch: the PyTorch / CUDA port of rag_snvbert_tpu.

It serves and trains the V18 embedding-RAG and the V17 token-RAG models on
an NVIDIA H100 through kernels written by hand for Hopper (``csrc/``):
fused attention forward and backward and two exact L2 top-k searches.  The
JAX package beside it is the reference the tests hold this one against;
nothing here imports it, JAX or flax.

Entry points (``config.build_model``, ``infer.imputer.Imputer``,
``infer.serve.ImputationService.create``) run on the card unless the
caller passes ``device="cpu"``.
"""
