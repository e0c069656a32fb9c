"""Curvature as a product: the training-time EKFAC state exported as a
:class:`CurvatureBundle` beside the checkpoints (mirrors
``repro/curvature``).  The bundle's consumers, the influence engine and
the Laplace head, wait for their slice."""
from repro_torch.curvature.bundle import (
    BUNDLE_SCHEMA,
    BundleWriter,
    CurvatureBundle,
    load_bundle,
    save_bundle,
    snapshot_bundle,
)

__all__ = [
    "BUNDLE_SCHEMA",
    "BundleWriter",
    "CurvatureBundle",
    "load_bundle",
    "save_bundle",
    "snapshot_bundle",
]
