"""Window-major imputation and the in-process service (torch)."""
