"""Interop with the JAX package's parameter layout."""

from .jax_params import (  # noqa: F401
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
)
