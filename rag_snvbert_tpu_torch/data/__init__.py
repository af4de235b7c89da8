"""Host-side tokenization and prefetching (numpy only)."""
