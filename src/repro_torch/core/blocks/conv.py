"""KFC convolution curvature blocks (Grosse & Martens, arXiv:1602.01407);
mirrors ``repro/core/blocks/conv.py``.

A conv layer's Fisher block is Kronecker-factored over *patches*: with the
weight stored as a ``(K·C [+1], d_out)`` matrix over tap-major im2col
features (``models/conv.py``), ``Ā`` is the spatially-summed patch second
moment with the homogeneous coordinate ``â = [patch; 1]`` and ``G`` the
pre-activation gradient second moment over the same output positions, both
normalized by the optimizer's global N (every output position is a
"token", KFC's spatially-uncorrelated-derivatives assumption).

The record is the RAW conv input (``{"cx": x}`` from ``Tagger.tag_conv``).
For a 1-D conv (B, T, C) on every shape the A side is
``kernels.patch_factor.patch_factor_update``: the ``patch_factor`` kernel
on the card reads the patches from x itself, so no im2col buffer is made
(the reference's Pallas route declines unless ``patch_tile_ok`` holds, and
falls back to explicit patches; the port has no such gate).  A 2-D conv
(B, H, W, C) takes explicit patches and :class:`DenseKronecker`'s
``factor_update`` route, as the reference's own fallback does.  A record
contracted in the forward (``{"aa"}``, ``fused_stats``) passes through to
the dense blend.  The G side goes through ``factor_update`` exactly as a
dense layer's; preconditioning is :class:`DenseKronecker`'s.
"""
from __future__ import annotations

from repro_torch.core.blocks.base import register
from repro_torch.core.blocks.kron import DenseKronecker
from repro_torch.kernels.patch_factor import patch_factor_update
from repro_torch.core.patches import patch_rows


@register
class ConvKronecker(DenseKronecker):
    """KFC conv block: patch-factor statistics over output positions."""

    kinds = ("conv",)
    priority = 10

    def _dense_rec(self, rec):
        """The record in dense form: the im2col rows of the raw input (or
        an ``{"aa"}`` contraction, unchanged)."""
        if "aa" in rec:
            return rec
        m = self.meta
        return {"a": patch_rows(rec["cx"], m.conv_spatial, m.conv_stride,
                                m.conv_pad, m.has_bias)}

    def stats_contrib(self, rec, gprobe, n):
        return super().stats_contrib(self._dense_rec(rec), gprobe, n)

    def update_factors(self, old, rec, gprobe, n, eps):
        m = self.meta
        if self._fused(rec, gprobe) or len(m.conv_spatial) != 1:
            return super().update_factors(old, self._dense_rec(rec), gprobe,
                                          n, eps)
        (taps,), (stride,) = m.conv_spatial, m.conv_stride
        a_new = patch_factor_update(
            rec["cx"], old["a"], taps=taps, stride=stride,
            padding=m.conv_pad, has_bias=m.has_bias,
            alpha=(1.0 - eps) / n, beta=eps)
        return {"a": a_new, "g": self._g_side(old["g"], gprobe, n, eps)}
