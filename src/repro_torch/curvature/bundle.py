"""Curvature bundles: the optimizer's EKFAC state as a serving artifact.

Mirrors ``repro/curvature/bundle.py``.  A *bundle* is the optimizer-free
snapshot of the Fisher approximation K-FAC maintains during training: per
block the factor eigenbases ``Q_A, Q_G`` and the eigenbasis diagonals
``s`` / ``damp`` (George et al. 1806.03884: the damped inverse apply is
``Q_A [(Q_Aᵀ V Q_G)/(s+damp)] Q_Gᵀ``), the diagonal curvature of untagged
params, and the damping ``(lam, gamma, eta)`` the state was taken under.
Loading one needs no optimizer, model or engine: :func:`load_bundle`
rebuilds the :class:`~repro_torch.core.tags.LayerMeta` of each block from
the manifest.

On-disk layout (the reference's, so that each package loads the other's)::

    <path>/
      arrays.npz     — "eig::<block>::{qa,qg,s,damp}" + "diag::<param-key>"
      manifest.json  — schema, step, lam/gamma/eta, dtype, per-block metas
      COMMIT         — written last; absence marks a torn bundle

Bundles are written next to the checkpoint step directories (the
checkpoint manifest's ``curvature_bundle`` pointer, schema 4), never inside
them: the checkpointer renames its step directory on its writer thread.

Export does not block the training step: :func:`snapshot_bundle` keeps
references to the state's tensors on the training thread, and
:class:`BundleWriter` copies them to the host and writes them on a daemon
thread.  That is safe because no stage of the port writes a state tensor in
place: every engine stage returns new tensors (each kernel writes a fresh
output, and the embedding's ``index_add_`` counts go into a fresh tensor,
``core/factors.py``), so a snapshot's tensors keep the values they had at
the step.  The thread's copies are queued on the default stream, behind
the training thread's kernels that computed them.

``dtype="bfloat16"`` stores the bases as the uint16 bit pattern of
``tensor.to(torch.bfloat16)`` (round to nearest even, the pattern
``ml_dtypes.bfloat16`` gives) and reads them back to float32; ``s`` and
``damp`` stay float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.tags import LayerMeta
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_with_keys

BUNDLE_SCHEMA = 1
_EIG_KEYS = ("qa", "qg", "s", "damp")
_BASIS_KEYS = ("qa", "qg")          # the only keys eligible for bf16 storage
_TUPLE_FIELDS = ("param_path", "conv_spatial", "conv_stride")


@dataclasses.dataclass
class CurvatureBundle:
    """In-memory bundle: eigen state + metas + damping metadata.

    ``eigen[name]`` is the per-block ``{"qa", "qg", "s", "damp"}`` dict
    (``qa``/``qg`` are None on diagonal factor sides — identity rotation);
    ``diag`` maps flat ``"::"``-joined param paths of *untagged* params to
    their running squared-gradient diagonal.
    """

    step: int
    lam: float
    gamma: float
    eta: float
    metas: Dict[str, LayerMeta]
    eigen: Dict[str, Dict[str, Any]]
    diag: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema: int = BUNDLE_SCHEMA

    @property
    def block_names(self):
        return sorted(self.eigen)


def _meta_to_json(meta: LayerMeta) -> dict:
    return dataclasses.asdict(meta)


def _meta_from_json(d: dict) -> LayerMeta:
    d = dict(d)
    for f in _TUPLE_FIELDS:
        if f in d:
            d[f] = tuple(d[f])
    return LayerMeta(**d)


# ---------------------------------------------------------------------------
# snapshot (training side — needs the engine; loading never does)
# ---------------------------------------------------------------------------

def snapshot_bundle(engine, state) -> Optional[CurvatureBundle]:
    """The engine's current curvature as a bundle of references to device
    tensors; hand it to :class:`BundleWriter`.

    In ``inv_mode="eigen"`` the live EKFAC state is referenced as it is;
    the other modes compute a fresh eigen state from the running factors
    (one eigh per factor), right after which ``apply_eigen`` equals the
    damped eigh inverse: stacked (a leading layer dim), ``block`` (bases
    (S, nb, db, db)) and ``diag`` (no basis: None) sides alike, in the
    reference's layout.  Returns None for optimizers without curvature
    blocks (the first-order baselines)."""
    blocks = getattr(engine, "blocks", None)
    if not blocks:
        return None
    eigen = {}
    for name, blk in blocks.items():
        if getattr(engine, "eigen", False) and name in state.inv:
            eigen[name] = dict(state.inv[name])
        else:
            eigen[name] = blk.eigen_state(state.factors[name], state.gamma)
    # tagged params carry a (0,) placeholder
    diag = {key: leaf for key, leaf in flatten_with_keys(state.diag).items()
            if leaf.numel() > 0}
    return CurvatureBundle(
        step=int(state.step), lam=float(state.lam), gamma=float(state.gamma),
        eta=float(getattr(engine.cfg, "eta", 0.0)),
        metas={name: blk.meta for name, blk in blocks.items()},
        eigen=eigen, diag=diag)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _host(v) -> np.ndarray:
    """A float32 host copy; card tensors are copied on this thread's
    current stream (the default stream), behind the kernels that made
    them."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit pattern of its bfloat16 rounding."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_float(bits: np.ndarray) -> np.ndarray:
    """The uint16 bit pattern of bfloat16 values -> float32."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


def _to_store(arr: np.ndarray, key: str, dtype: str) -> np.ndarray:
    if dtype == "bfloat16" and key in _BASIS_KEYS:
        return bf16_bits(arr)
    return arr


def _from_store(arr: np.ndarray, key: str, dtype: str) -> np.ndarray:
    if dtype == "bfloat16" and key in _BASIS_KEYS:
        return bf16_float(arr)
    return arr


def save_bundle(bundle: CurvatureBundle, path: str,
                dtype: str = "float32") -> str:
    """Serialize ``bundle`` at ``path`` (atomic: tmp dir + rename + COMMIT).

    ``dtype``: "float32" | "bfloat16" — storage precision of the
    eigen*bases* only; diagonals always stay float32."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown bundle dtype {dtype!r}")
    arrays: Dict[str, np.ndarray] = {}
    for name in bundle.block_names:
        for k in _EIG_KEYS:
            v = bundle.eigen[name].get(k)
            if v is None:
                continue
            arrays[f"eig::{name}::{k}"] = _to_store(_host(v), k, dtype)
    for key, v in bundle.diag.items():
        arrays[f"diag::{key}"] = _host(v)
    manifest = {
        "schema": bundle.schema, "step": bundle.step,
        "lam": bundle.lam, "gamma": bundle.gamma, "eta": bundle.eta,
        "dtype": dtype,
        "blocks": {name: _meta_to_json(bundle.metas[name])
                   for name in bundle.block_names},
        "keys": sorted(arrays), "time": time.time(),
    }
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return path


def load_bundle(path: str, device="cuda") -> CurvatureBundle:
    """Load a bundle written by either package's ``save_bundle`` —
    engine-free: the block metas come from the manifest.  Its arrays
    become float32 tensors on ``device``."""
    device = resolve_device(device)
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed curvature bundle at {path!r}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    if man["schema"] > BUNDLE_SCHEMA:
        raise ValueError(f"bundle at {path!r} has schema {man['schema']} > "
                         f"supported {BUNDLE_SCHEMA}")
    dtype = man.get("dtype", "float32")
    metas = {name: _meta_from_json(d) for name, d in man["blocks"].items()}
    eigen: Dict[str, Dict[str, Any]] = {
        name: {k: None for k in _EIG_KEYS} for name in metas}
    diag: Dict[str, Any] = {}
    put = lambda a: torch.from_numpy(a).to(device)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key in z.files:
            if key.startswith("eig::"):
                _, name, k = key.split("::", 2)
                eigen[name][k] = put(_from_store(z[key], k, dtype))
            elif key.startswith("diag::"):
                diag[key[len("diag::"):]] = put(z[key])
    return CurvatureBundle(
        step=int(man["step"]), lam=float(man["lam"]),
        gamma=float(man["gamma"]), eta=float(man["eta"]),
        metas=metas, eigen=eigen, diag=diag, schema=int(man["schema"]))


# ---------------------------------------------------------------------------
# non-blocking export
# ---------------------------------------------------------------------------

class BundleWriter:
    """Background bundle serializer (one in flight at a time, like the
    Checkpointer's async save).  ``write_async`` returns at once; the
    daemon thread copies the snapshot's tensors to the host and writes
    them while training goes on.  ``write_s`` is the last write's
    seconds on the thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.write_s: Optional[float] = None

    def _write(self, bundle, path, dtype):
        t0 = time.perf_counter()
        save_bundle(bundle, path, dtype)
        self.write_s = time.perf_counter() - t0

    def write_async(self, path: str, bundle: CurvatureBundle,
                    dtype: str = "float32") -> str:
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(bundle, path, dtype), daemon=True)
        self._thread.start()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
