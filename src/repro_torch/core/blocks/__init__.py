from repro_torch.core.blocks.base import (CurvatureBlock, build_blocks,
                                          register, resolve)
from repro_torch.core.blocks.chain import TridiagChain
from repro_torch.core.blocks.conv import ConvKronecker
from repro_torch.core.blocks.kron import (BlockDiagKronecker, DenseKronecker,
                                          DiagFactor)
from repro_torch.core.blocks.special import Embed, Head

__all__ = ["BlockDiagKronecker", "ConvKronecker", "CurvatureBlock",
           "DenseKronecker", "DiagFactor", "Embed", "Head", "TridiagChain",
           "build_blocks", "register", "resolve"]
