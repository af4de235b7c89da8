"""Host-side data: tokenization, masking, window-major batches, prefetch
(numpy only)."""
