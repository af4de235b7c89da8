"""Training: retrieval, losses, metrics, optimizer, steps, trainer (torch)."""
