"""Native checkpointing: atomic, async; mirrors ``repro/training/checkpoint.py``.

Layout (the reference's, so that each package restores the other's)::

    <dir>/step_<N>/
      arrays.npz      — flat {path-key: np.ndarray}
      manifest.json   — step, schema version, keys, time [, curvature_bundle]
      COMMIT          — written last; absence marks a torn checkpoint

A leaf's key is its path in the tree, the parts (dict key, dataclass
field, sequence index) joined by ``"::"``
(``repro_torch.utils.tree.flatten_with_keys``): ``params::W0``,
``state::inv::layer0::a_inv``, ``state::inner::1::W0``.

State-schema versions (``manifest.json["schema"]``), as in the reference:
  1 (no ``schema`` key): the optimizer state was a raw dict; the keys are
     name-based, so it restores into the dataclass template unchanged.
  2: the typed ``KFACState`` / ``TransformState``.
  3: ``KFACState`` gained ``staleness`` and ``inv_pending``; restoring an
     older checkpoint keeps the template's values for those leaves.
     ``inv_pending`` exists only in the overlap refresh mode, so it stays
     defaultable at schema 3 too, and a checkpoint's extra leaves (an
     overlap run's buffer restored into a serial template) are dropped.
  4: the manifest may point at the curvature bundle exported at this step
     (``curvature_bundle``, relative to the checkpoint directory; bundles
     live in a sibling ``curvature/`` directory, never inside the step
     directory, which is renamed on the writer thread).
A schema above 4 is refused.

Restore places each leaf on its template leaf's device, or on ``device``
when one is given, so a checkpoint written from the card restores on the
CPU and the reverse: the port's counterpart of the reference's
``shardings=`` re-mesh.  Sharded restore waits for the distributed slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import (SEP, flatten_with_keys,
                                    unflatten_with_keys)

__all__ = ["SCHEMA_VERSION", "SEP", "Checkpointer"]

SCHEMA_VERSION = 4

# state fields that did not exist before schema 3: restoring an older
# checkpoint keeps the template's (fresh-init) values for these
_V3_FIELDS = ("staleness", "inv_pending")
# ... and fields whose *presence* depends on run config, not schema:
# inv_pending only exists in refresh_mode="overlap" states
_MODE_FIELDS = ("inv_pending",)


def host_copy(tree) -> Dict[str, np.ndarray]:
    """``{key: numpy array}`` of every leaf, copied off the tree's tensors.
    Card tensors go to pinned host memory without blocking, each copy
    queued on the current stream, and one ``torch.cuda.synchronize`` waits
    for all of them; CPU tensors are cloned, so later writes to them cannot
    reach the copy."""
    flat = flatten_with_keys(tree)
    out, on_card = {}, False
    for key, leaf in flat.items():
        if not isinstance(leaf, torch.Tensor):
            out[key] = np.asarray(leaf)
            continue
        leaf = leaf.detach()
        if leaf.is_cuda:
            on_card = True
            out[key] = leaf.to("cpu", non_blocking=True)
        else:
            out[key] = leaf.clone()
    if on_card:
        torch.cuda.synchronize()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


class Checkpointer:
    """Atomic step checkpoints under ``directory``, ``keep`` of them kept.

    ``stats`` holds the last save's and restore's costs: ``save_host_ms``
    (the blocking copy to host), ``write_s`` (``np.savez`` and the rename,
    on the writer thread when asynchronous), ``bytes``, ``restore_read_s``
    (reading ``arrays.npz``) and ``restore_device_s`` (the leaves put on
    their devices)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.stats: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree, block: bool = False,
             curvature_bundle: Optional[str] = None):
        """``curvature_bundle``: optional manifest pointer (schema 4) to a
        bundle exported for this step, as a path relative to ``self.dir``
        (the bundle itself is written separately — see
        ``repro_torch.curvature.bundle.BundleWriter``).  The copy to host
        is synchronous; only the write runs on the thread."""
        t0 = time.perf_counter()
        host = host_copy(tree)
        self.stats["save_host_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["bytes"] = sum(int(v.nbytes) for v in host.values())
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, curvature_bundle),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, curvature_bundle)

    def _write(self, step: int, host: Dict[str, np.ndarray],
               curvature_bundle: Optional[str] = None):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: v for k, v in host.items()})
        manifest = {"step": step, "schema": SCHEMA_VERSION,
                    "keys": sorted(host), "time": time.time()}
        if curvature_bundle is not None:
            manifest["curvature_bundle"] = curvature_bundle
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        self.stats["write_s"] = time.perf_counter() - t0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
            # drop the step's curvature bundle (sibling dir) with it
            shutil.rmtree(
                os.path.join(self.dir, "curvature", f"step_{s:08d}"),
                ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, d)
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                out.append(int(d[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def bundle_path(self, step: Optional[int] = None) -> Optional[str]:
        """Absolute path of the curvature bundle the manifest points at
        (schema 4), or None — older schemas, runs without curvature
        export, or a torn/missing bundle all report None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        man = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        if not os.path.exists(man):
            return None
        with open(man) as f:
            rel = json.load(f).get("curvature_bundle")
        if rel is None:
            return None
        full = os.path.join(self.dir, rel)
        if not os.path.exists(os.path.join(full, "COMMIT")):
            return None
        return full

    def restore(self, template, step: Optional[int] = None, device=None):
        """``(step, tree)``: ``template``'s structure with the checkpoint's
        leaves (their stored dtypes), each on its template leaf's device,
        or on ``device`` when given; ``(None, None)`` without a
        checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        man_path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(man_path) as f:
            schema = json.load(f).get("schema", 1)
        if schema > SCHEMA_VERSION:
            raise ValueError(f"checkpoint at step {step} has schema "
                             f"{schema} > supported {SCHEMA_VERSION}")
        t0 = time.perf_counter()
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        t1 = time.perf_counter()
        target = None if device is None else torch.device(device)

        def put(tmpl, arr):
            dev = target if target is not None else tmpl.device
            return torch.from_numpy(arr).to(dev)

        tree = unflatten_with_keys(
            template, flat, put,
            defaultable=_V3_FIELDS if schema < 3 else _MODE_FIELDS)
        leaves = flatten_with_keys(tree)
        if target is not None:
            # the template's values kept by a schema migration move too
            tree = unflatten_with_keys(tree, leaves,
                                       lambda _, x: x.to(target))
            leaves = flatten_with_keys(tree)
        if any(x.is_cuda for x in leaves.values()):
            torch.cuda.synchronize()
        self.stats["restore_read_s"] = t1 - t0
        self.stats["restore_device_s"] = time.perf_counter() - t1
        return step, tree
