"""Conv classifier config — the KFC experimental family (1602.01407 §5).
Mirrors ``repro/configs/conv_classifier.py``.

A small strided CNN + softmax head over synthetic class-template images
(:class:`repro_torch.data.pipeline.SyntheticImageData`), consumed by
:class:`repro_torch.models.convnet.ConvNet`: the vehicle of the
``ConvKronecker`` curvature blocks (2-D patch statistics, the homogeneous
bias, every ``inv_mode``) end to end through ``KFACEngine`` and ``Trainer``.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvClassifierConfig:
    name: str = "conv-classifier"
    image_size: int = 32
    channels: int = 3
    n_classes: int = 10
    # (out_channels, kernel, stride) per layer; "SAME" padding, strided
    # downsampling (no pooling — every parameter sits in a Kronecker block)
    conv: Tuple[Tuple[int, int, int], ...] = ((32, 3, 1), (32, 3, 2),
                                              (64, 3, 2))
    nonlin: str = "relu"


CONFIG = ConvClassifierConfig()


def reduced() -> ConvClassifierConfig:
    return ConvClassifierConfig(name="conv-classifier-reduced",
                                image_size=8, channels=2, n_classes=4,
                                conv=((8, 3, 1), (8, 3, 2)), nonlin="relu")
