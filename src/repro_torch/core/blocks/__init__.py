from repro_torch.core.blocks.base import (CurvatureBlock, build_blocks,
                                          register, resolve)
from repro_torch.core.blocks.kron import DenseKronecker

__all__ = ["CurvatureBlock", "DenseKronecker", "build_blocks", "register",
           "resolve"]
