"""Convolution layers with KFC curvature tags (Grosse & Martens 1602.01407);
mirrors ``repro/models/conv.py`` for 1-D convolutions (whisper's mel stem).

A convolution is a dense map over im2col *patches*: each output position is
one "token" whose features are the receptive field flattened **tap-major**
(``feature = k * C + c``), so the weight is a ``(K*C [+1], d_out)`` matrix
with the bias as its last row, and every K-FAC code path applies unchanged.
The forward computes the conv as ``patches @ W[:-1] + W[-1]``, so the weight
gradient is ``Σ_t patch_t g_tᵀ`` by construction.

Padding follows lax: ``"SAME"`` gives ``ceil(T / s)`` outputs and puts the
odd pad on the high side (whisper's conv2, T 3000, k 3, s 2, pads (0, 1));
``"VALID"`` pads nothing.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import factors as FA
from repro_torch.core.tags import LayerMeta, Tagger


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
    """im2col of a 1-D conv in the tap-major layout: x ``(B, T, C)`` ->
    ``(B, T_out, K*C)`` with feature ``k * C + c``."""
    if len(spatial) != 1:
        raise NotImplementedError("only 1-D convolutions are ported")
    (k,), (s,) = spatial, stride
    b, t, c = x.shape
    if conv_out_len(t, k, s, padding) == 0:      # t < k, VALID
        return x.new_zeros(b, 0, k * c)
    lo, hi = conv_pad_amounts(t, k, s, padding)
    xp = F.pad(x, (0, 0, lo, hi)) if lo or hi else x
    p = xp.unfold(1, k, s)                       # (B, T_out, C, K)
    return p.transpose(-1, -2).reshape(b, p.shape[1], k * c)


def append_homog(p):
    """Homogeneous coordinate: ``â = [patch; 1]`` (bias = last weight row)."""
    return torch.cat([p, p.new_ones(*p.shape[:-1], 1)], dim=-1)


def conv(tg: Tagger, name: str, w, x, *, spatial: Tuple[int, ...],
         stride: Tuple[int, ...], padding: str = "VALID", bias: bool = True):
    """K-FAC-tagged convolution ``s = patches(x) @ W[:-1] + W[-1]``.

    x: ``(B, T, C)``; w: ``(K*C [+1], d_out)``.  Returns ``(B, T_out,
    d_out)``; the tag records the raw input (``Tagger.tag_conv``)."""
    p = extract_patches(x, spatial, stride, padding)
    s = p @ (w[:-1] if bias else w)
    if bias:
        s = s + w[-1]
    return tg.tag_conv(name, x, s)


def conv_meta(name: str, path: Tuple, *, spatial: Tuple[int, ...],
              stride: Tuple[int, ...], c_in: int, d_out: int,
              padding: str = "VALID", bias: bool = True) -> LayerMeta:
    """LayerMeta for one KFC conv block (kind="conv", tap-major weight)."""
    d_in = math.prod(spatial) * c_in
    return LayerMeta(name=name, param_path=path, d_in=d_in, d_out=d_out,
                     kind="conv", a_kind=FA.factor_layout(d_in),
                     g_kind=FA.factor_layout(d_out), has_bias=bias,
                     conv_spatial=tuple(spatial), conv_stride=tuple(stride),
                     conv_in=c_in, conv_pad=padding)
