"""Backward-pass fusion of the factor statistics (paper S5, one pass);
mirrors ``repro/core/fused.py``.

The two-pass layout records raw activations in the forward and raw probe
cotangents out of the backward, then sweeps over both a second time to form
``Ā += ā āᵀ`` / ``G += g gᵀ``: every recorded ``(N, d)`` tensor is written
by the statistics pass and read back by ``update_factors``.  With
``KFACConfig.fused_stats`` the contractions ride the passes themselves:

  * **A side**: the ``Tagger``'s contract hook records ``{"aa": Σ ā āᵀ}``
    in the forward (:func:`dense_a_contract`, :func:`conv_a_contract`);
  * **G side**: :func:`apply_gprobe`, an identity whose backward returns
    ``{"gg": Σ cot cotᵀ}`` as the probe's gradient, so the per-example
    ``dL/ds`` is contracted the moment autograd produces it, instead of
    coming back as an ``(N, d_out)`` probe gradient and being re-read.

Every contraction is the ``factor_update`` wrapper at α = 1, β = 0 into a
zero (``patch_factor_update`` for a 1-D conv's raw input): the kernel on
the card, the plain version on the CPU.  The blocks see ``{"aa"}`` records
and ``{"gg"}`` gprobes and blend them straight into the decayed factors,
``ε·old + (1−ε)·aa/n`` and ``ε·old + (1−ε)·gg·n``.

Eligibility (:func:`fused_eligible`, wired in ``KFACEngine``): dense and
conv layers with full/full factors and no stack or expert lead dims.
``inv_mode="tridiag"`` on a chain model disables fusion: the chain's cross
moments need the raw per-layer records.
"""
from __future__ import annotations

import torch

from repro_torch.core.tags import LayerMeta
from repro_torch.kernels.factor_update import factor_update
from repro_torch.kernels.patch_factor import patch_factor_update
from repro_torch.core.patches import patch_rows


def fused_eligible(meta: LayerMeta) -> bool:
    """Layers whose statistics can contract in-pass: plain dense/conv maps
    with full two-sided factors and no stack / expert lead dims."""
    return (meta.kind in ("dense", "conv") and meta.n_stack == 0
            and meta.n_expert == 0 and meta.a_kind == "full"
            and meta.g_kind == "full")


def _xtx(x2):
    """``Σ xᵀx`` over the rows of x2 (N, d), through ``factor_update``."""
    d = x2.shape[-1]
    zero = torch.zeros(d, d, dtype=torch.float32, device=x2.device)
    return factor_update(x2, zero, alpha=1.0, beta=0.0)


def dense_a_contract(meta: LayerMeta):
    """In-forward Ā contraction of a dense layer: ``ā`` (..., a_dim) →
    ``Σ ā āᵀ`` (a_dim, a_dim), recorded as ``{"aa": ...}``."""

    def fn(a):
        return _xtx(a.reshape(-1, a.shape[-1]))

    return fn


def conv_a_contract(meta: LayerMeta):
    """In-forward Ā contraction of a KFC conv layer, from the RAW input: a
    1-D conv through ``patch_factor_update`` (no im2col buffer), a 2-D one
    through explicit patches plus the homogeneous column, then
    ``factor_update``."""

    def fn(x):
        if len(meta.conv_spatial) == 1:
            (taps,), (stride,) = meta.conv_spatial, meta.conv_stride
            zero = torch.zeros(meta.a_dim, meta.a_dim, dtype=torch.float32,
                               device=x.device)
            return patch_factor_update(
                x, zero, taps=taps, stride=stride, padding=meta.conv_pad,
                has_bias=meta.has_bias, alpha=1.0, beta=0.0)
        return _xtx(patch_rows(x, meta.conv_spatial, meta.conv_stride,
                               meta.conv_pad, meta.has_bias))

    return fn


def g_contract(meta: LayerMeta):
    """In-backward G contraction: probe cotangent ``ds`` (..., g_dim) →
    ``Σ cot cotᵀ`` (g_dim, g_dim), the ``{"gg"}`` probe's gradient through
    :func:`apply_gprobe`."""

    def fn(ds):
        return _xtx(ds.reshape(-1, ds.shape[-1]))

    return fn


def einsum_gg(ds):
    """The plain G contraction ``Σ ds dsᵀ``: the tests' reference for
    :func:`g_contract` and :func:`apply_gprobe`.  No path of the port calls
    it: a Tagger given a ``{"gg"}`` probe and no gcontract entry raises."""
    d2 = ds.reshape(-1, ds.shape[-1]).float()
    return d2.T @ d2


def gg_probe(meta: LayerMeta, device):
    """The fused layer's probe: a ``(g_dim, g_dim)`` zero that requires grad
    and whose gradient is the contracted second moment."""
    return {"gg": torch.zeros(meta.g_dim, meta.g_dim, dtype=torch.float32,
                              device=device, requires_grad=True)}


class _GProbe(torch.autograd.Function):
    """Identity on ``s``; the gradient of ``probe_gg`` is ``contract(ds)``."""

    @staticmethod
    def forward(ctx, s, probe_gg, contract):
        ctx.contract = contract
        return s.view_as(s)

    @staticmethod
    def backward(ctx, ds):
        return ds, ctx.contract(ds.detach()), None


def apply_gprobe(s, probe_gg, contract):
    """``s`` (a new view of it) whose backward gives ``probe_gg`` the
    gradient ``contract(ds)``: the zero-probe trick with the G-side
    contraction folded into the backward pass."""
    return _GProbe.apply(s, probe_gg, contract)
