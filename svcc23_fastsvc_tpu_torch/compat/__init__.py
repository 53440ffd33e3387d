"""Interop with the JAX package's parameter layout."""

from .jax_params import (  # noqa: F401
    downsample_block_state_dict_from_jax,
    generator_state_dict_from_jax,
    hnusfgan_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
    tacotron2_state_dict_from_jax,
)
