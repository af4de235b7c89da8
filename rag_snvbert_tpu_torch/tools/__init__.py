"""Measurement scripts for the card, run as ``python -m
rag_snvbert_tpu_torch.tools.<name>``; nothing here runs at import time."""
