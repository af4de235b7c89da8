"""Weight interchange with the JAX package (numpy trees, no JAX import)."""

from .flax_params import load_flax_params

__all__ = ["load_flax_params"]
