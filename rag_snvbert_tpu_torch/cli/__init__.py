"""The port's command line (``python -m rag_snvbert_tpu_torch.cli.main``)."""
