"""Curvature blocks for the LM's embedding and head (mirrors
``repro/core/blocks/special.py``).

  * :class:`Embed` — embedding lookups: Ā is the diagonal of token
    frequencies (a one-hot input's second moment, ``index_add_``), G is
    dense on d_model.
  * :class:`Head`  — the LM head: the chunked head loss records a contracted
    ``aa`` over the hidden states and a diagonal ``gdiag`` over the vocab
    side (the full vocab² G would be unstorable), already divided by N.

The reference sends neither to a kernel; their statistics and applies are
plain tensor code here too.  The MoE ``Expert`` block waits for its slice.
"""
from __future__ import annotations

from repro_torch.core import factors as F
from repro_torch.core.blocks.base import CurvatureBlock, register


@register
class Embed(CurvatureBlock):
    """Embedding block: diagonal Ā of token counts, dense G."""

    kinds = ("embed",)

    def stats_contrib(self, rec, gprobe, n):
        m = self.meta
        a_c = F.embed_diag_counts(rec["ids"], rec["mask"], m.d_in) / n
        return {"a": a_c, "g": F.g_from_cotangent(gprobe, m, n)}


@register
class Head(CurvatureBlock):
    """LM-head block: contracted dense Ā, diagonal vocab-side G."""

    kinds = ("head",)

    def stats_contrib(self, rec, gprobe, n):
        return {"a": rec["aa"] / n, "g": rec["gdiag"]}
