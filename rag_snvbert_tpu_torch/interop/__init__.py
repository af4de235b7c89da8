"""Weight interchange with the JAX package (numpy trees, no JAX import)."""

from .flax_params import load_flax_params, load_optax_adam_state

__all__ = ["load_flax_params", "load_optax_adam_state"]
