"""Measurement and quality scripts (the card's kernel A/B and probes, the
convergence run, its ceilings and trace summary), run as ``python -m
rag_snvbert_tpu_torch.tools.<name>``; nothing here runs at import time."""
