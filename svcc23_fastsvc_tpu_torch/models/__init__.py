"""Models of the port."""

from .fastsvc import (  # noqa: F401
    DownsampleBlock,
    FastSVCGenerator,
    FiLMBlock,
    MelGANDiscriminator,
    MelGANMultiScaleDiscriminator,
    UpsampleBlock,
)
