"""Plain im2col of a convolution's raw input, in the tap-major layout the
KFC blocks, the models and the ``patch_factor`` plain version share:
torch only, no tagging (``models/conv.py`` builds the tagged layer on it).

Padding follows lax: ``"SAME"`` gives ``ceil(T / s)`` outputs and puts the
odd pad on the high side (whisper's conv2, T 3000, k 3, s 2, pads (0, 1));
``"VALID"`` pads nothing.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def conv_out_len(t: int, k: int, stride: int, padding: str) -> int:
    """Output length of one conv dim (lax "SAME"/"VALID" rules)."""
    if padding == "SAME":
        return -(-t // stride)
    return max(0, (t - k) // stride + 1)


def conv_pad_amounts(t: int, k: int, stride: int, padding: str):
    """(lo, hi) zero-padding of one conv dim under lax "SAME"/"VALID"
    (``repro/kernels/patch_factor.py::conv_pad_amounts``)."""
    if padding == "VALID":
        return 0, 0
    out = -(-t // stride)
    total = max((out - 1) * stride + k - t, 0)
    return total // 2, total - total // 2


def extract_patches(x, spatial: Tuple[int, ...], stride: Tuple[int, ...],
                    padding: str = "VALID"):
    """im2col in the tap-major layout: x ``(B, *S, C)`` -> ``(B, T_out,
    prod(K)*C)`` with feature ``k * C + c``, ``k`` row-major over the taps
    (``(kh, kw)`` for a 2-D conv), ``T_out`` the output positions flattened
    row-major.  Each spatial dim is padded as lax pads it, then unfolded
    (``Tensor.unfold`` appends the taps after the channels, the order of
    ``F.unfold`` and of lax's ``conv_general_dilated_patches``, which the
    reference transposes; so does this)."""
    nd = len(spatial)
    if x.dim() != nd + 2 or len(stride) != nd:
        raise ValueError(f"extract_patches: x {tuple(x.shape)} for a "
                         f"{nd}-D conv with stride {tuple(stride)}")
    b, c = x.shape[0], x.shape[-1]
    sizes = x.shape[1:-1]
    outs = [conv_out_len(t, k, s, padding)
            for t, k, s in zip(sizes, spatial, stride)]
    taps = math.prod(spatial)
    if 0 in outs:                                # a dim with t < k, VALID
        return x.new_zeros(b, 0, taps * c)
    pads = []
    for t, k, s in reversed(list(zip(sizes, spatial, stride))):
        pads += conv_pad_amounts(t, k, s, padding)
    xp = F.pad(x, (0, 0, *pads)) if any(pads) else x
    p = xp
    for i, (k, s) in enumerate(zip(spatial, stride)):
        p = p.unfold(1 + i, k, s)                # (B, *S_out, C, *K)
    # (B, *S_out, C, *K) -> (B, *S_out, *K, C)
    p = p.movedim(1 + nd, -1)
    return p.reshape(b, math.prod(outs), taps * c)


def append_homog(p):
    """Homogeneous coordinate: ``â = [patch; 1]`` (bias = last weight row)."""
    return torch.cat([p, p.new_ones(*p.shape[:-1], 1)], dim=-1)


def patch_rows(x, spatial: Tuple[int, ...], stride: Tuple[int, ...],
               padding: str, has_bias: bool):
    """The ``(B·T_out, prod(K)*C [+1])`` im2col rows of a conv's raw input
    x, with the homogeneous column when the layer has a bias: the rows
    whose ``Σ â âᵀ`` is the layer's Ā."""
    p = extract_patches(x, spatial, stride, padding)
    p = p.reshape(-1, p.shape[-1])
    return append_homog(p) if has_bias else p
