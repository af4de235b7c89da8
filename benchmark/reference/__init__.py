"""The plain reference: float32 PyTorch (TF32 off) and numpy, independent
of the program.  ``model``: the encoder families, heads and loss;
``data``: tokens, masks and batches; ``train``: the optimizer and a
micro-step; ``retrieval``: window contexts and exact L2 search.  Nothing
here imports ``rag_snvbert_tpu_torch`` or JAX."""
