"""Curvature bundles of the LMs (``curvature/bundle.py``) against the JAX
package's, on the CPU: reduced smollm-135m in blkdiag (a fresh eigh of
the running factors, stacked bases), gemma2-2b at ``max_factor_dim`` 64 in
eigen mode (block bases (S, nb, db, db) on the d_ff sides) and whisper-small
in eigen mode (no basis on a diagonal side: the embedding's Ā, the head's
Ḡ).

Each state is the port's after 3 K-FAC steps of the launcher's setup from
JAX's weights; JAX snapshots the same state (its arrays carried across),
so an eigen state is the same arrays in both bundles and a blkdiag one
is each package's own eigh of the same factors.  Held here:

* the port's bundle has JAX's key set, shapes, dtypes and metas
  (``probe_tshard`` included), and equal ``s`` / ``damp`` (1e-4 where each
  package ran its own eigh; bit for bit where the state was referenced);
* each package loads the other's files bit for bit;
* on each bundle, whichever package wrote it, JAX's ``apply_eigen`` and
  the port's give the same U for a fixed V within 1e-5.
"""
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import inverse as jinverse
from repro.curvature import bundle as jbundle
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.core import inverse
from repro_torch.curvature import bundle as pbundle
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from repro_torch.utils import tree as T
from test_torch_lm_eigen_trajectory import KFAC, setup
from test_torch_whisper_parity import _close, _head_uniforms

torch.set_num_threads(1)

CASES = {"smollm_blkdiag": ("smollm-135m", 8192, {}),
         "gemma2_64_eigen": ("gemma2-2b", 64, {"inv_mode": "eigen"}),
         "whisper_eigen": ("whisper-small", 8192, {"inv_mode": "eigen"})}


@functools.lru_cache(maxsize=None)
def _trained(case):
    """(JAX engine, the state as JAX arrays, port engine, port state)."""
    arch, mfd, kw = CASES[case]
    s = setup(arch, mfd)
    cfg = dict(KFAC, max_factor_dim=mfd, **kw)
    opt = kfac(s["lm"], KFACConfig(**cfg), device="cpu")
    tr = Trainer(s["lm"], opt, TrainConfig(steps=3, seed=0,
                                           log_every=10_000),
                 noise=lambda step, shape: _head_uniforms(0, step, shape),
                 device="cpu")
    state = tr.fit(s["params"], s["data"], steps=3,
                   log=lambda *_: None)["state"]
    jx = lambda t: T.tree_map(lambda x: jnp.asarray(x.numpy()), t)
    jstate = types.SimpleNamespace(
        step=jnp.asarray(int(state.step)), lam=jnp.asarray(float(state.lam)),
        gamma=jnp.asarray(float(state.gamma)), factors=jx(state.factors),
        inv=jx(dict(state.inv)), diag=jx(state.diag))
    return JEngine(s["jl"], JKFACConfig(**cfg)), jstate, opt.engine, state


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _bundles(case):
    jeng, js, peng, ps = _trained(case)
    return (jbundle.snapshot_bundle(jeng, js),
            pbundle.snapshot_bundle(peng, ps))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_bundle_matches_jaxs(case, tmp_path):
    want, got = _bundles(case)
    eigen = CASES[case][2].get("inv_mode") == "eigen"
    assert (got.step, got.lam, got.gamma, got.eta) == (
        want.step, want.lam, want.gamma, want.eta)
    assert {n: dataclasses.asdict(m) for n, m in got.metas.items()} == {
        n: dataclasses.asdict(m) for n, m in want.metas.items()}
    assert any(m.probe_tshard for m in got.metas.values())
    for name in want.block_names:
        for k, w in want.eigen[name].items():
            g = got.eigen[name][k]
            assert (g is None) == (w is None), (name, k)
            if w is None:
                continue
            assert tuple(g.shape) == w.shape, (name, k)
            if eigen:
                np.testing.assert_array_equal(_host(g), _host(w))
            elif k in ("s", "damp"):
                _close(g, np.asarray(w), rtol=1e-4)
    pbundle.save_bundle(got, str(tmp_path / "p"))
    jbundle.save_bundle(want, str(tmp_path / "j"))
    with np.load(tmp_path / "p" / "arrays.npz") as zp, \
            np.load(tmp_path / "j" / "arrays.npz") as zj:
        assert set(zp.files) == set(zj.files)
        for key in zj.files:
            assert zp[key].shape == zj[key].shape, key
            assert zp[key].dtype == zj[key].dtype == np.float32, key
    if CASES[case][0] == "gemma2-2b":
        assert got.eigen["blk0.mlp.gate"]["qg"].dim() == 4
    if CASES[case][0] == "whisper-small":
        assert got.eigen["embed"]["qa"] is None
        assert got.eigen["lm_head"]["qg"] is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_loads_the_others_lm_bundle(case, tmp_path):
    want, got = _bundles(case)
    pbundle.save_bundle(got, str(tmp_path / "p"))
    jbundle.save_bundle(want, str(tmp_path / "j"))
    for written, loaded in (
            (got, jbundle.load_bundle(str(tmp_path / "p"))),
            (want, pbundle.load_bundle(str(tmp_path / "j"), device="cpu"))):
        assert loaded.block_names == written.block_names
        assert loaded.metas == {n: type(next(iter(loaded.metas.values())))(
            **dataclasses.asdict(m)) for n, m in written.metas.items()}
        for name in written.block_names:
            for k, v in written.eigen[name].items():
                if v is None:
                    assert loaded.eigen[name][k] is None, (name, k)
                else:
                    np.testing.assert_array_equal(
                        _host(loaded.eigen[name][k]), _host(v))
        assert set(loaded.diag) == set(written.diag)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_bundle_apply_is_jaxs(case, tmp_path):
    """Whichever package wrote the bundle, JAX's ``apply_eigen`` and the
    port's, each reading it with its own loader, give the same U of a
    fixed V within 1e-5."""
    want, got = _bundles(case)
    pbundle.save_bundle(got, str(tmp_path / "p"))
    jbundle.save_bundle(want, str(tmp_path / "j"))
    rng = np.random.default_rng(3)
    for path in ("p", "j"):
        pb = pbundle.load_bundle(str(tmp_path / path), device="cpu")
        jb = jbundle.load_bundle(str(tmp_path / path))
        for name in pb.block_names:
            meta = pb.metas[name]
            lead = (meta.n_stack,) if meta.n_stack else ()
            v = rng.standard_normal(lead + (meta.a_dim, meta.g_dim)).astype(
                np.float32)
            u = inverse.apply_eigen(meta, pb.eigen[name], torch.from_numpy(v))
            _close(u, np.asarray(jinverse.apply_eigen(
                jb.metas[name], jb.eigen[name], v)))
