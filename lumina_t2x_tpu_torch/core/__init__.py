from .checkpoint import state_dict_from_jax_params

__all__ = ["state_dict_from_jax_params"]
