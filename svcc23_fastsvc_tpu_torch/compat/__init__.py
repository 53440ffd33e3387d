"""Interop with the JAX package's parameter layout."""

from .jax_params import (  # noqa: F401
    conformer_ppg_state_dict_from_jax,
    downsample_block_state_dict_from_jax,
    generator_state_dict_from_jax,
    hifigan_msd_mpd_state_dict_from_jax,
    hnusfgan_state_dict_from_jax,
    hubert_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
    subfreq_discriminator_state_dict_from_jax,
    tacotron2_state_dict_from_jax,
    xvector_state_dict_from_jax,
)
