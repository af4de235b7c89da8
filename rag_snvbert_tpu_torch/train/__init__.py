"""Retrieval for training and serving (torch)."""
