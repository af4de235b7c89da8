"""Small sizes for the benchmark's CPU tests: every cell's configuration
and traffic cut to a few sites, samples and layers, which the program runs
with its plain kernels.  ``bf16: False`` makes the program compute in
float32, so that it must agree with the reference to rounding."""

import pytest

TINY = {"dims": 32, "n_layers": 2, "attn_heads": 2, "seq_len": 40,
        "sites_per_window": 30, "n_windows": 2, "n_ref_samples": 20,
        "ref_pad_haps": 48, "samples_per_window": 16, "batch_size": 4,
        "cohort_samples": 10, "check_samples": 6, "rate": 20.0,
        "trace_seconds": 0.5}
# V17's head count must divide its width.
TINY_BY_CONFIG = {"v17_token_rag": {"dims": 24}}


def tiny(cell: str, **extra) -> dict:
    from benchmark import harness

    config = harness.Cell.load(cell).spec["config"]
    return {**TINY, **TINY_BY_CONFIG.get(config, {}), **extra}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
