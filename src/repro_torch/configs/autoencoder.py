"""The paper's own benchmark family (S13): deep autoencoders in the style of
Hinton & Salakhutdinov (2006).  Mirrors ``repro/configs/autoencoder.py``."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AutoencoderConfig:
    name: str = "mnist-autoencoder"
    # MNIST autoencoder from Hinton & Salakhutdinov (2006) as used in S13
    encoder: Tuple[int, ...] = (784, 1000, 500, 250, 30)
    # decoder mirrors the encoder
    nonlin: str = "tanh"          # paper networks use tanh/logistic units
    loss: str = "bernoulli"       # cross-entropy reconstruction


CONFIG = AutoencoderConfig()


def reduced() -> AutoencoderConfig:
    return AutoencoderConfig(name="autoencoder-reduced",
                             encoder=(64, 32, 16, 8), nonlin="tanh",
                             loss="bernoulli")
