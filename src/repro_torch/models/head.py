"""LM head for serving (mirrors ``repro/models/head.py::head_logits``).
``lm_head_loss`` belongs to training and comes with it."""
from __future__ import annotations

import torch

from repro_torch.models.layers import softcap


def head_logits(h, w_head, logit_cap: float = 0.0):
    """Unchunked logits for serving (decode steps have tiny N)."""
    logits = torch.matmul(h, w_head)
    return softcap(logits.float(), logit_cap)
