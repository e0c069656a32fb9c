"""Convolution layers with KFC curvature tags (Grosse & Martens 1602.01407);
mirrors ``repro/models/conv.py``: 1-D convolutions (whisper's mel stem) and
2-D ones (the conv classifier, ``models/convnet.py``).

A convolution is a dense map over im2col *patches*: each output position is
one "token" whose features are the receptive field flattened **tap-major**
(``feature = k * C + c``), so the weight is a ``(K*C [+1], d_out)`` matrix
with the bias as its last row, and every K-FAC code path applies unchanged.
The forward computes the conv as ``patches @ W[:-1] + W[-1]``, so the weight
gradient is ``Σ_t patch_t g_tᵀ`` by construction.

The im2col itself, with lax's padding, is ``core/patches.py`` (torch only,
shared with the KFC blocks and the ``patch_factor`` plain version); its
names are re-exported here.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core import factors as FA
from repro_torch.core.patches import (append_homog, conv_out_len,  # noqa: F401
                                      conv_pad_amounts, extract_patches,
                                      patch_rows)
from repro_torch.core.tags import LayerMeta, Tagger


def conv(tg: Tagger, name: str, w, x, *, spatial: Tuple[int, ...],
         stride: Tuple[int, ...], padding: str = "VALID", bias: bool = True):
    """K-FAC-tagged convolution ``s = patches(x) @ W[:-1] + W[-1]``.

    x: ``(B, *S, C)``; w: ``(prod(K)*C [+1], d_out)``.  Returns ``(B,
    T_out, d_out)``, the spatial dims flattened; the tag records the raw
    input (``Tagger.tag_conv``)."""
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
