"""Weight interchange with the JAX package and with reference (torch)
checkpoints (numpy trees, no JAX import)."""

from .flax_params import (flax_params_of, leaf_shapes, load_flax_params,
                          load_optax_adam_state, params_from_keystr_npz)
from .torch_ckpt import (convert_state_dict, expected_reference_keys,
                         export_state_dict, load_convert_meta,
                         load_params_checkpoint, load_torch_checkpoint,
                         save_converted)

__all__ = ["convert_state_dict", "expected_reference_keys",
           "export_state_dict", "flax_params_of", "leaf_shapes",
           "load_convert_meta", "load_flax_params", "load_optax_adam_state",
           "load_params_checkpoint", "load_torch_checkpoint",
           "params_from_keystr_npz", "save_converted"]
