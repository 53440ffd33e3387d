"""Training losses."""

from .adversarial import (  # noqa: F401
    discriminator_adversarial_loss,
    generator_adversarial_loss,
)
from .masked import masked_mse_loss  # noqa: F401
from .stft_loss import MultiResolutionSTFTLoss, stft_loss  # noqa: F401
