"""Models of the port."""

from .fastsvc import (  # noqa: F401
    DownsampleBlock,
    FastSVCGenerator,
    FiLMBlock,
    MelGANDiscriminator,
    MelGANMultiScaleDiscriminator,
    UpsampleBlock,
)
from .hnusfgan import HNUSFGANGenerator  # noqa: F401
from .tacotron2 import (  # noqa: F401
    MultiSubFreqDiscriminator,
    SubFreqDiscriminator,
    Tacotron2,
)
